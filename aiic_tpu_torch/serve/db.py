"""Queue database layer — a copy of ``aiic_tpu.serve.db`` (no JAX in it).

Three collections (apartments, images, analysis_results) and a status-field
work queue (``analysis_status``: 'pending' -> 'completed'/'not_interior',
'failed' after repeated load failures, with a dead-letter record), in two
interchangeable backends with the same method contracts:

- :class:`InMemoryDB` — dependency-free, the default;
- :class:`MongoDB` — a thin pymongo adapter (pymongo imported only when a
  Mongo URI is given, by argument or ``MONGO_URI``).
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Any, Dict, List, Optional


class InMemoryDB:
    """Mongo-semantics in-memory store."""

    def __init__(self):
        self.apartments: Dict[Any, Dict[str, Any]] = {}
        self.images: Dict[Any, Dict[str, Any]] = {}
        self.analysis_results: Dict[Any, Dict[str, Any]] = {}
        self.dead_letters: List[Dict[str, Any]] = []

    # -- writes used by seeders/tests --------------------------------------
    def insert_apartment(self, _id, title="", **kw):
        self.apartments[_id] = {"_id": _id, "title": title, **kw}

    def insert_image(self, _id, apartment_id, url, status="pending", **kw):
        self.images[_id] = {
            "_id": _id, "apartment_id": apartment_id, "url": url,
            "analysis_status": status, **kw,
        }

    # -- reference API (main_API.py:27-124 contracts) ----------------------
    def get_pending_apartments(self) -> List[Dict[str, Any]]:
        out = []
        for apt in self.apartments.values():
            pending = [
                im for im in self.images.values()
                if im["apartment_id"] == apt["_id"] and im["analysis_status"] == "pending"
            ]
            if pending:
                out.append({"_id": apt["_id"], "title": apt.get("title", ""),
                            "pending_count": len(pending)})
        return out

    def get_apartment_with_images(self, apartment_id) -> Optional[Dict[str, Any]]:
        apt = self.apartments.get(apartment_id)
        if not apt:
            return None
        images = [
            dict(im) for im in self.images.values()
            if im["apartment_id"] == apartment_id and im["analysis_status"] == "pending"
        ]
        return {"id": apt["_id"], "title": apt.get("title", ""), "images": images}

    def get_images_for_apartment(self, apartment_id,
                                 statuses=None) -> List[Dict[str, Any]]:
        """ALL images of an apartment (optionally filtered by status) — the
        read the worker's aggregate uses so a restart mid-apartment still
        produces totals over the whole apartment, not just the re-drained
        remainder (crash-recovery, SURVEY.md §5c)."""
        return [
            dict(im) for im in self.images.values()
            if im["apartment_id"] == apartment_id
            and (statuses is None or im["analysis_status"] in statuses)
        ]

    def update_image_analysis(self, image_id, room_type, style, confidence) -> None:
        im = self.images.get(image_id)
        if im is None:
            return
        im.update(
            room_type=room_type,
            style=style,
            analysis_status="completed" if room_type != "not_interior" else "not_interior",
            analysis_confidence=float(confidence),
            analyzed_at=datetime.now(),
        )

    def mark_image_attempt(self, image_id, error: str, max_attempts: int = 3) -> None:
        """Failure accounting with dead-lettering: after ``max_attempts``
        failed loads an image moves to 'failed' instead of being retried
        forever (the reference retries pending items indefinitely,
        SURVEY.md §5c). The terminal failure also writes a queryable
        dead-letter RECORD (not only a counter)."""
        im = self.images.get(image_id)
        if im is None:
            return
        attempts = im.get("attempts", 0) + 1
        im["attempts"] = attempts
        im["last_error"] = error
        if attempts >= max_attempts:
            im["analysis_status"] = "failed"
            self.record_dead_letter(image_id, error, source="worker",
                                    attempts=attempts)

    def record_dead_letter(self, image_id, error: str, source: str = "worker",
                           **extra) -> None:
        """Persist one dead-letter record so failed work is queryable
        (GET /dead-letters) instead of existing only as a metrics counter."""
        self.dead_letters.append({
            "image_id": image_id, "error": str(error), "source": source,
            "dead_lettered_at": datetime.now(), **extra,
        })

    def list_dead_letters(self) -> List[Dict[str, Any]]:
        out = []
        for d in self.dead_letters:
            d = dict(d)
            if isinstance(d.get("dead_lettered_at"), datetime):
                d["dead_lettered_at"] = d["dead_lettered_at"].isoformat()
            out.append(d)
        return out

    def save_apartment_analysis(self, apartment_id, analysis_result: Dict[str, Any]) -> None:
        self.analysis_results[apartment_id] = {
            "_id": apartment_id,
            "apartment_id": apartment_id,
            "overall_style": analysis_result["overall_style"],
            "room_distribution": analysis_result["room_distribution"],
            "analyzed_images": analysis_result["interior_images"],
            "total_images": analysis_result["total_images"],
            "analysis_date": datetime.now(),
            "confidence": analysis_result["overall_style"]["confidence"],
        }

    def export_analysis_results(self, output_file: str = "analysis_export.json") -> str:
        results = []
        for r in self.analysis_results.values():
            r = dict(r)
            r["_id"] = str(r["_id"])
            if isinstance(r.get("analysis_date"), datetime):
                r["analysis_date"] = r["analysis_date"].isoformat()
            results.append(r)
        with open(output_file, "w", encoding="utf-8") as f:
            json.dump(results, f, ensure_ascii=False, indent=2)
        return output_file

    # -- extra read surface for the REST layer -----------------------------
    def list_results(self) -> List[Dict[str, Any]]:
        out = []
        for r in self.analysis_results.values():
            r = dict(r)
            r["_id"] = str(r["_id"])
            if isinstance(r.get("analysis_date"), datetime):
                r["analysis_date"] = r["analysis_date"].isoformat()
            out.append(r)
        return out

    def list_apartments(self) -> List[Dict[str, Any]]:
        return [dict(a) for a in self.apartments.values()]


class MongoDB:
    """pymongo adapter with the same contracts (used when available)."""

    def __init__(self, uri: str):
        from pymongo import MongoClient  # imported only when a URI is given

        self.client = MongoClient(uri)
        self.db = self.client.interior_analysis
        self.apartments = self.db.apartments
        self.images = self.db.images
        self.analysis_results = self.db.analysis_results
        self.dead_letters = self.db.dead_letters

    # -- writes used by seeders/tests (same contract as InMemoryDB) ---------
    def insert_apartment(self, _id, title="", **kw):
        self.apartments.update_one(
            {"_id": _id}, {"$set": {"title": title, **kw}}, upsert=True
        )

    def insert_image(self, _id, apartment_id, url, status="pending", **kw):
        self.images.update_one(
            {"_id": _id},
            {"$set": {"apartment_id": apartment_id, "url": url,
                      "analysis_status": status, **kw}},
            upsert=True,
        )

    def get_pending_apartments(self):
        pipeline = [
            {"$lookup": {
                "from": "images",
                "let": {"apt_id": "$_id"},
                "pipeline": [{"$match": {
                    "$expr": {"$eq": ["$apartment_id", "$$apt_id"]},
                    "analysis_status": "pending",
                }}],
                "as": "pending_images",
            }},
            {"$match": {"pending_images.0": {"$exists": True}}},
            {"$project": {"_id": 1, "title": 1, "pending_count": {"$size": "$pending_images"}}},
        ]
        return list(self.apartments.aggregate(pipeline))

    def get_apartment_with_images(self, apartment_id):
        apt = self.apartments.find_one({"_id": apartment_id})
        if not apt:
            return None
        images = list(self.images.find({"apartment_id": apartment_id,
                                        "analysis_status": "pending"}))
        return {"id": apt["_id"], "title": apt.get("title", ""), "images": images}

    def get_images_for_apartment(self, apartment_id, statuses=None):
        q: Dict[str, Any] = {"apartment_id": apartment_id}
        if statuses is not None:
            q["analysis_status"] = {"$in": list(statuses)}
        return list(self.images.find(q))

    def update_image_analysis(self, image_id, room_type, style, confidence):
        self.images.update_one({"_id": image_id}, {"$set": {
            "room_type": room_type, "style": style,
            "analysis_status": "completed" if room_type != "not_interior" else "not_interior",
            "analysis_confidence": float(confidence), "analyzed_at": datetime.now(),
        }})

    def mark_image_attempt(self, image_id, error, max_attempts=3):
        im = self.images.find_one({"_id": image_id}) or {}
        attempts = im.get("attempts", 0) + 1
        update = {"attempts": attempts, "last_error": error}
        if attempts >= max_attempts:
            update["analysis_status"] = "failed"
            self.record_dead_letter(image_id, error, source="worker",
                                    attempts=attempts)
        self.images.update_one({"_id": image_id}, {"$set": update})

    def record_dead_letter(self, image_id, error, source="worker", **extra):
        self.dead_letters.insert_one({
            "image_id": image_id, "error": str(error), "source": source,
            "dead_lettered_at": datetime.now(), **extra,
        })

    def list_dead_letters(self):
        out = []
        for d in self.dead_letters.find():
            d["_id"] = str(d["_id"])
            if "dead_lettered_at" in d:
                d["dead_lettered_at"] = d["dead_lettered_at"].isoformat()
            out.append(d)
        return out

    def save_apartment_analysis(self, apartment_id, analysis_result):
        self.analysis_results.update_one(
            {"apartment_id": apartment_id},
            {"$set": {
                "overall_style": analysis_result["overall_style"],
                "room_distribution": analysis_result["room_distribution"],
                "analyzed_images": analysis_result["interior_images"],
                "total_images": analysis_result["total_images"],
                "analysis_date": datetime.now(),
                "confidence": analysis_result["overall_style"]["confidence"],
            }},
            upsert=True,
        )

    def export_analysis_results(self, output_file="analysis_export.json"):
        results = list(self.analysis_results.find())
        for r in results:
            r["_id"] = str(r["_id"])
            if "analysis_date" in r:
                r["analysis_date"] = r["analysis_date"].isoformat()
        with open(output_file, "w", encoding="utf-8") as f:
            json.dump(results, f, ensure_ascii=False, indent=2)
        return output_file

    def list_results(self):
        results = list(self.analysis_results.find())
        for r in results:
            r["_id"] = str(r["_id"])
            if "analysis_date" in r:
                r["analysis_date"] = r["analysis_date"].isoformat()
        return results

    def list_apartments(self):
        return list(self.apartments.find())


def connect_db(uri: Optional[str] = None):
    """Mongo when a URI is given/available and pymongo imports; otherwise the
    in-memory backend."""
    uri = uri or os.environ.get("MONGO_URI")
    if uri:
        try:
            return MongoDB(uri)
        except ImportError:
            pass
    return InMemoryDB()


def seed_demo_data(db) -> None:
    """Demo seed mirroring the reference's init-mongo.js content (2 apartments,
    3 pending images) — which docker-compose never actually mounted
    (SURVEY.md §3 integration gaps)."""
    db.insert_apartment("apt1", title="Mieszkanie 3-pokojowe, Centrum")
    db.insert_apartment("apt2", title="Kawalerka, Stare Miasto")
    db.insert_image("img1", "apt1", "https://example.com/apt1_salon.jpg")
    db.insert_image("img2", "apt1", "https://example.com/apt1_kuchnia.jpg")
    db.insert_image("img3", "apt2", "https://example.com/apt2_pokoj.jpg")
