"""Quickstart on the PyTorch port: the framework surface in one runnable
script, the twin of ``examples/quickstart.py``.

    python examples/torch_quickstart.py [--reference DIR] [--weights W] [--device cuda|cpu]

``--reference`` is a reference tree: ``interior_dataset.json``,
``interior_sample.jpg``, ``dataset_images/*.jpg`` and
``lora_models/comprehensive_lora.pth`` (default: the current directory;
nothing is downloaded). Runs on the card unless ``--device cpu`` (default
``$AIIC_PLATFORM``, else ``cuda``), with random ViT-B/16 weights unless
``--weights`` names a CLIP checkpoint (OpenAI .pt, HF directory or .npz).
The last line printed is ``{"quickstart": "ok"}``.
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(ref: str, *, config=None, params=None, device="cuda", save_path=None,
        log=print) -> dict:
    """Steps 1-5 of the quickstart on the reference tree ``ref``: the engine
    (dataset vocabulary, the shipped LoRA adapters folded in, bf16), the
    detector on the sample, ``analyze_images_batch`` on eight files, one
    epoch of ``train_lora``, and the REST app (``POST /analyze``, ``POST
    /analyze-batch`` with URLs and base64, ``GET /metrics``). Returns what
    each step produced."""
    import base64
    import glob
    import urllib.request

    import torch
    from PIL import Image

    from aiic_tpu_torch.engine import InteriorAnalyzer
    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.serve.app import build_serving_app
    from aiic_tpu_torch.serve.db import InMemoryDB
    from aiic_tpu_torch.serve.rest import serve_forever_in_thread
    from aiic_tpu_torch.train import TrainConfig, train_lora

    config = config or VIT_B_16
    save_path = save_path or os.path.join(tempfile.gettempdir(), "quickstart_adapters.pth")
    out: dict = {}

    # 1) Build the engine: dataset vocabulary + shipped LoRA adapters folded in.
    analyzer = InteriorAnalyzer(
        params=params,
        config=config,
        dataset_json=os.path.join(ref, "interior_dataset.json"),
        use_lora=True,
        lora_weights_path=os.path.join(ref, "lora_models", "comprehensive_lora.pth"),
        dtype=torch.bfloat16,
        device=device,
    )
    log(f"engine ready: {len(analyzer.category_names)} attribute categories, "
        f"LoRA folded: {analyzer.use_lora}")

    # 2) Single-image detector verdict (reference 3-tuple contract).
    sample = os.path.join(ref, "interior_sample.jpg")
    out["verdict"] = analyzer.is_interior_image(Image.open(sample))
    log(f"detector: {out['verdict']}")

    # 3) Batched analysis over files with the reference's JSON result schema.
    paths = sorted(glob.glob(os.path.join(ref, "dataset_images", "*.jpg")))[:8]
    out["paths"] = paths
    out["results"] = analyzer.analyze_images_batch(paths, filter_interiors=False)
    one = out["results"][paths[0]]
    log(f"top style: {one['analysis']['styles'][0]} | top room: "
        f"{one['analysis']['room_types'][0]}")

    # 4) Train LoRA adapters for one epoch.
    trained = train_lora(
        os.path.join(ref, "interior_dataset.json"), save_path, config=config,
        cfg=TrainConfig(epochs=1, batch_size=16, rank=4, alpha=8, attach=("c_fc", "c_proj")),
        image_root=ref, device=device, log=log)
    out["best_val_loss"] = trained["best_val_loss"]
    log(f"trained: best val loss {trained['best_val_loss']:.4f} (checkpoint: {save_path})")

    # 5) Production serving: REST + dynamic batcher, single-image and
    #    multi-image protocols, live latency quantiles on /metrics.
    server, batcher, _warmed = build_serving_app(
        analyzer, db=InMemoryDB(), port=0, max_batch=8,
        warm_buckets=(1, 8), warm_async=False, log=lambda *_: None)
    serve_forever_in_thread(server)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with open(sample, "rb") as f:
            img = f.read()
        req = urllib.request.Request(base + "/analyze", data=img, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            out["rest"] = json.loads(r.read().decode())
        log(f"REST verdict: {out['rest']['is_interior']} | category: "
            f"{out['rest']['detected_category']}")
        breq = urllib.request.Request(
            base + "/analyze-batch",
            data=json.dumps({"urls": paths[:2],
                             "images_b64": [base64.b64encode(img).decode()]}).encode(),
            method="POST")
        with urllib.request.urlopen(breq, timeout=120) as r:
            out["rest_batch"] = json.loads(r.read().decode())["results"]
        log(f"REST batch: {len(out['rest_batch'])} results, "
            f"keys={sorted(out['rest_batch'][0])}")
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            out["metrics"] = json.loads(r.read().decode())
        log(f"live p50: {out['metrics'].get('analyze_p50_ms')} ms")
    finally:
        server.shutdown()
        batcher.close()
    return out


def main():
    from aiic_tpu_torch.utils.platform import apply_platform_env, require_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", default=".")
    ap.add_argument("--weights")
    ap.add_argument("--device", default=apply_platform_env(),
                    help="torch device (default $AIIC_PLATFORM, else cuda; cpu runs the plain "
                         "versions)")
    ap.add_argument("--save-path", help="the trained adapters (default: the temporary "
                                        "directory's quickstart_adapters.pth)")
    args = ap.parse_args()

    import torch

    from aiic_tpu_torch.models.config import VIT_B_16
    from aiic_tpu_torch.models.init import load_clip_weights

    require_device(args.device)
    params = (load_clip_weights(args.weights, VIT_B_16, device=torch.device(args.device))
              if args.weights else None)
    run(args.reference, params=params, device=args.device, save_path=args.save_path)
    print(json.dumps({"quickstart": "ok"}))


if __name__ == "__main__":
    main()
