"""Batch-analysis CLI — the port of ``aiic_tpu.cli.main``.

    python -m aiic_tpu_torch.cli.main --analyze-csv photos.csv [--use-lora]

Flag-compatible with the reference analyzer entry point (main.py:584-613):
``--analyze-csv --max-images --use-lora --lora-weights --batch-size
--no-filter-interiors --confidence-threshold``, plus the shared engine flags
(:class:`aiic_tpu_torch.cli.common.EngineArgs`, ``--device`` among them).

Output: ``analysis_results_{N}.json`` with the reference's record schema
keyed by ``{offer_id}_{seq}`` (main.py:516-578).
"""

from __future__ import annotations

import argparse
import json
import sys


def analyze_images_from_csv(
    csv_path: str,
    use_lora: bool = False,
    lora_weights: str | None = None,
    max_images: int | None = None,
    batch_size: int = 16,
    filter_interiors: bool = True,
    confidence_threshold: float = 0.3,
    dataset_json: str = "interior_dataset.json",
    weights: str | None = None,
    dtype: str = "float32",
    quantize: bool = False,
    out_path: str | None = None,
    fast_decode: bool = False,
    wire_format: str = "hwc",
    analyzer=None,
    engine: "EngineArgs | None" = None,
    log=print,
):
    """``analyzer``/``engine`` override the keyword knobs when given: the
    CLI entry builds one EngineArgs (the shared three-CLI config surface)
    and passes it here; the keyword form stays for library callers."""
    from aiic_tpu_torch.cli.common import EngineArgs
    from aiic_tpu_torch.data.images import load_images_from_csv

    images = load_images_from_csv(csv_path, max_images)
    urls = [d["url"] for d in images]
    log(f"loaded {len(urls)} urls from {csv_path}")

    if analyzer is None:
        if engine is None:
            engine = EngineArgs(
                weights=weights, dataset_json=dataset_json, dtype=dtype,
                quantize=quantize, use_lora=use_lora,
                lora_weights=lora_weights, wire_format=wire_format,
                fast_decode=fast_decode,
                # keyword form keeps the reference's hardwired inference
                # geometry (main.py:521-522) and no cache side effects
                lora_rank=4, lora_alpha=8, text_cache="none",
            )
        analyzer = engine.build_analyzer(log=log)
    results = analyzer.analyze_images_batch(
        urls,
        batch_size=batch_size,
        filter_interiors=filter_interiors,
        confidence_threshold=confidence_threshold,
        fast_decode=fast_decode,
    )

    out = {}
    interior_count = non_interior_count = 0
    for d in images:
        url = d["url"]
        key = f"{d['offer_id']}_{d['seq']}"
        r = results.get(url)
        if r is not None:
            out[key] = {
                "url": url, "offer_id": d["offer_id"], "seq": d["seq"],
                "is_interior": r["is_interior"],
                "interior_confidence": r.get("interior_confidence", 0.0),
                "detected_category": r.get("detected_category", "unknown"),
                "reason": r.get("reason", ""),
                "analysis": r.get("analysis", {}),
            }
            interior_count += int(bool(r["is_interior"]))
            non_interior_count += int(not r["is_interior"])
        else:
            out[key] = {
                "url": url, "offer_id": d["offer_id"], "seq": d["seq"],
                "is_interior": False, "interior_confidence": 0.0,
                "detected_category": "not processed",
                "reason": "Image not processed due to error",
                "analysis": {},
            }
            non_interior_count += 1

    out_path = out_path or f"analysis_results_{len(images)}.json"
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(out, f, ensure_ascii=False, indent=2)
    log(f"interiors: {interior_count}  non-interiors: {non_interior_count}  -> {out_path}")
    return out


def build_parser() -> argparse.ArgumentParser:
    from aiic_tpu_torch.cli.common import EngineArgs

    p = argparse.ArgumentParser(description="Batched interior-image analysis (PyTorch port)")
    p.add_argument("--analyze-csv", type=str, help="csv with offer_id,seq,url columns")
    p.add_argument("--max-images", type=int)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--no-filter-interiors", action="store_true")
    p.add_argument("--confidence-threshold", type=float, default=0.3)
    p.add_argument("--output", type=str, help="output JSON path")
    # shared engine surface (cli/common.py): fp32 parity default,
    # the reference's shipped checkpoint as the default adapter
    EngineArgs.add_args(
        p, dtype_default="float32",
        lora_weights_default="lora_models/comprehensive_lora.pth")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    if not args.analyze_csv:
        print("run with --analyze-csv photos.csv [--use-lora --lora-weights path]")
        return 1
    from aiic_tpu_torch.cli.common import EngineArgs

    analyze_images_from_csv(
        args.analyze_csv,
        max_images=args.max_images,
        batch_size=args.batch_size,
        filter_interiors=not args.no_filter_interiors,
        confidence_threshold=args.confidence_threshold,
        fast_decode=args.fast_decode,
        out_path=args.output,
        engine=EngineArgs.from_args(args),
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
