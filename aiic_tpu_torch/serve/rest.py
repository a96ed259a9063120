"""REST API surface — the port of ``aiic_tpu.serve.rest``.

Endpoint-compatible with the reference Express server (api-server/app.js:
``GET / /health /test /apartments /process-pending /process/:id /results
/export``) on the stdlib ThreadingHTTPServer, plus ``/ready``, ``/metrics``,
``/dead-letters`` and the inference endpoints ``POST /analyze`` (image
bytes) and ``POST /analyze-batch`` (JSON: urls / images_b64) that feed the
dynamic batcher. Status codes, headers (``Retry-After`` on 503) and body
caps are the JAX package's.
"""

from __future__ import annotations

import json
import threading
from datetime import datetime
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from aiic_tpu_torch.serve.db import InMemoryDB


def make_server(
    db=None,
    analyze_fn: Optional[Callable[[bytes], Dict[str, Any]]] = None,
    port: int = 3000,
    host: str = "127.0.0.1",
    ready_fn: Optional[Callable[[], bool]] = None,
    analyze_batch_fn: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server. ``analyze_fn`` maps raw image bytes
    to a result dict (wired to the batcher by the CLI); ``analyze_batch_fn``
    maps a parsed JSON payload (``{"urls": [...], "images_b64": [...]}``) to
    ``{"results": [...]}`` — the multi-image path that amortizes per-request
    HTTP overhead (POST /analyze-batch). ``ready_fn`` backs ``GET /ready`` —
    load balancers should gate traffic on it; ``/health`` stays
    liveness-only (the server accepts connections while the model is still
    warming, reference gap noted in SURVEY §5c)."""
    db = db if db is not None else InMemoryDB()

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: under HTTP/1.0 every response closes the
        # connection, so clients that reuse connections hit resets under
        # concurrency. Safe because _json always sends Content-Length.
        protocol_version = "HTTP/1.1"

        def _json(self, obj, code: int = 200, headers: Optional[Dict[str, str]] = None):
            body = json.dumps(obj, ensure_ascii=False, default=str).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Access-Control-Allow-Origin", "*")
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet by default
            pass

        def _discard_body(self):
            """Early-return POST paths must not leave the request body
            unread on a keep-alive connection — the leftover bytes would be
            parsed as the next request's start-line, desyncing the client.
            Drain small bodies; for large (or unparseable) lengths just
            close the connection instead of reading megabytes to discard."""
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                length = -1
            if 0 < length <= 1 << 20:
                remaining = length
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 65536))
                    if not chunk:
                        break
                    remaining -= len(chunk)
            elif length != 0:
                self.close_connection = True

        def do_GET(self):
            if self.path == "/":
                self._json({
                    "message": "Interior Analysis API is running!",
                    "endpoints": {
                        "health": "/health", "ready": "/ready", "test": "/test",
                        "apartments": "/apartments",
                        "process_pending": "/process-pending",
                        "process_id": "/process/:id",
                        "results": "/results", "export": "/export",
                        "dead_letters": "/dead-letters",
                        "analyze": "POST /analyze (image bytes)",
                        "analyze_batch":
                            "POST /analyze-batch (JSON: urls / images_b64)",
                    },
                    "timestamp": datetime.now().isoformat(),
                })
            elif self.path == "/health":
                self._json({"status": "OK", "message": "API is working!",
                            "timestamp": datetime.now().isoformat()})
            elif self.path == "/ready":
                ready = bool(ready_fn()) if ready_fn is not None else True
                self._json({"ready": ready,
                            "timestamp": datetime.now().isoformat()},
                           200 if ready else 503)
            elif self.path == "/test":
                self._json({"message": "Hello World! Test successful!"})
            elif self.path == "/apartments":
                self._json({"apartments": db.list_apartments()})
            elif self.path == "/process-pending":
                self._json({"pending": db.get_pending_apartments()})
            elif self.path.startswith("/process/"):
                apt_id = self.path[len("/process/"):]
                apt = db.get_apartment_with_images(apt_id)
                if apt is None:
                    self._json({"error": f"apartment {apt_id} not found"}, 404)
                else:
                    self._json(apt)
            elif self.path == "/results":
                self._json({"results": db.list_results()})
            elif self.path == "/dead-letters":
                # queryable dead-letter records (worker terminal failures +
                # timed-out REST requests), not only a metrics counter
                if hasattr(db, "list_dead_letters"):
                    self._json({"dead_letters": db.list_dead_letters()})
                else:
                    self._json({"dead_letters": [],
                                "note": "backend does not persist dead letters"})
            elif self.path == "/export":
                path = db.export_analysis_results()
                self._json({"exported": path})
            elif self.path == "/metrics":
                from aiic_tpu_torch.serve.metrics import GLOBAL_METRICS

                self._json(GLOBAL_METRICS.snapshot())
            else:
                self._json({"error": "not found"}, 404)

        def _respond_analyzed(self, call, endpoint: str):
            """Run ``call`` and map analysis failures to HTTP codes (shared
            by the single and batch analyze endpoints). Records the
            request's wall time under ``endpoint`` so /metrics exposes live
            p50/p95/p99 per endpoint."""
            import time as _time

            from aiic_tpu_torch.serve.metrics import GLOBAL_METRICS

            t0 = _time.perf_counter()
            try:
                result = call()
                GLOBAL_METRICS.observe_latency(
                    endpoint, _time.perf_counter() - t0)
                self._json(result)
            except TimeoutError as e:
                # error latencies live in their own histogram — folding a
                # 30 s timeout into the success p95 would make the tail
                # unreadable
                GLOBAL_METRICS.observe_latency(
                    f"{endpoint}_error", _time.perf_counter() - t0)
                self._json({"error": f"analysis timed out: {e}",
                            "dead_lettered": True}, 504)
            except ValueError as e:
                GLOBAL_METRICS.observe_latency(
                    f"{endpoint}_error", _time.perf_counter() - t0)
                self._json({"error": str(e)}, 400)
            except Exception as e:
                from aiic_tpu_torch.serve.batcher import BatcherOverloaded

                GLOBAL_METRICS.observe_latency(
                    f"{endpoint}_error", _time.perf_counter() - t0)
                if isinstance(e, BatcherOverloaded):
                    # Admission control: fast-fail instead of queueing
                    # doomed work; clients should back off and retry.
                    self._json({"error": str(e)}, 503,
                               headers={"Retry-After": "1"})
                else:
                    self._json({"error": str(e)}, 500)

        def do_POST(self):
            if self.path == "/analyze":
                if analyze_fn is None:
                    self._discard_body()
                    self._json({"error": "no analyzer attached"}, 503)
                    return
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0 or length > 64 * 1024 * 1024:
                    self._discard_body()
                    self._json({"error": "bad content length"}, 400)
                    return
                data = self.rfile.read(length)
                self._respond_analyzed(lambda: analyze_fn(data), "analyze")
            elif self.path == "/analyze-batch":
                if analyze_batch_fn is None:
                    self._discard_body()
                    self._json({"error": "no analyzer attached"}, 503)
                    return
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0 or length > 512 * 1024 * 1024:
                    self._discard_body()
                    self._json({"error": "bad content length"}, 400)
                    return
                data = self.rfile.read(length)
                try:
                    payload = json.loads(data)
                    if not isinstance(payload, dict):
                        raise ValueError("payload must be a JSON object")
                except ValueError as e:
                    self._json({"error": f"bad JSON payload: {e}"}, 400)
                    return
                self._respond_analyzed(
                    lambda: analyze_batch_fn(payload), "analyze_batch")
            else:
                self._discard_body()
                self._json({"error": "not found"}, 404)

    class Server(ThreadingHTTPServer):
        # socketserver's default accept backlog is 5: a burst of clients
        # overflows it and the overflow connections get RST. daemon_threads
        # so a hung client never blocks interpreter shutdown.
        request_queue_size = 128
        daemon_threads = True

    return Server((host, port), Handler)


def serve_forever_in_thread(server: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t
