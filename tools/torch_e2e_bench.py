#!/usr/bin/env python3
"""End-to-end pipeline benchmark of the PyTorch port: JPEG files -> decode
and resize on the host -> prefetch queue -> uint8 copy -> classify on the
device, through the engine's ``analyze_images_batch`` — the twin of
``tools/e2e_bench.py``.

    python3 tools/torch_e2e_bench.py [repeat] [batch] [mode]
        [--reference DIR] [--model vit_b_16|tiny] [--device cuda|cpu]

mode (the JAX tool's):
  stream (default) — the streaming path over every ``dataset_images/*.jpg``
  device           — decode-only host, the bicubic resize on the device, over
                     the 256x256 images (one fixed geometry)
  stream256        — the streaming path over the same 256x256 images
  fast             — the streaming path with fast_decode=True
  url              — every JPEG served over loopback HTTP and streamed through
                     the engine's URL loader (fetch || decode || dispatch)
  urlfast          — url with fast_decode=True

``--reference`` (default ``$AIIC_REF``, else ``.``) holds ``dataset_images/``.
The engine is ``InteriorAnalyzer(training_data=[], dtype=torch.bfloat16,
max_batch=batch)`` (bf16, the HWC wire: row 5 on the card), warmed at
``batch``; a warm pass, then the measured pass with a fresh ``StageTimer``.
Images are counted per path occurrence. Prints the JAX tool's one JSON
line; the card's name and power limit and the decoder that ran (native or
the Python fallback) go to stderr. ``--model tiny`` (TINY_TEST) is for the
tests; ``--device`` (default ``$AIIC_PLATFORM``, else ``cuda``) exits
without a card unless it is ``cpu``. ``main(argv)`` returns the printed
record in a list.
"""

import argparse
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODES = ("stream", "device", "stream256", "fast", "url", "urlfast")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> list:
    from aiic_tpu_torch.utils.platform import apply_platform_env, device_line, require_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("repeat", nargs="?", type=int, default=2)
    ap.add_argument("batch", nargs="?", type=int, default=64)
    ap.add_argument("mode", nargs="?", default="stream", choices=MODES)
    ap.add_argument("--reference", default=os.environ.get("AIIC_REF", "."),
                    help="reference tree with dataset_images/ (default $AIIC_REF, else .)")
    ap.add_argument("--model", default="vit_b_16", choices=["vit_b_16", "tiny"],
                    help="tiny (TINY_TEST) is for the tests")
    ap.add_argument("--device", default=apply_platform_env(),
                    help="torch device (default $AIIC_PLATFORM, else cuda; cpu runs the plain "
                         "versions)")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    mode = args.mode

    import torch

    from aiic_tpu_torch.data.native_loader import native_available
    from aiic_tpu_torch.engine import InteriorAnalyzer
    from aiic_tpu_torch.models.config import TINY_TEST, VIT_B_16
    from aiic_tpu_torch.utils.profiling import StageTimer

    img_dir = os.path.join(args.reference, "dataset_images")
    paths = sorted(glob.glob(os.path.join(img_dir, "*.jpg")))
    if mode in ("device", "stream256"):
        # the fixed-geometry subset: the bucketable case device resize targets;
        # stream256 is its host-resize control
        from PIL import Image

        paths = [p for p in paths if Image.open(p).size == (256, 256)]
    srv = None
    if mode in ("url", "urlfast"):
        import functools
        import threading
        from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

        class Quiet(SimpleHTTPRequestHandler):
            def log_message(self, *a):
                pass

        srv = ThreadingHTTPServer(("127.0.0.1", 0), functools.partial(Quiet, directory=img_dir))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        port = srv.server_address[1]
        paths = [f"http://127.0.0.1:{port}/{os.path.basename(p)}" for p in paths]
    paths = paths * args.repeat
    log(f"device={device} ({device_line(device)}); decoder: "
        f"{'native' if native_available() else 'the Python fallback (no native decoder built)'}"
        f"; {len(paths)} paths, mode={mode}")

    try:
        config = {"vit_b_16": VIT_B_16, "tiny": TINY_TEST}[args.model]
        analyzer = InteriorAnalyzer(config=config, training_data=[], dtype=torch.bfloat16,
                                    max_batch=args.batch, device=device)
        analyzer.warmup([args.batch])

        # a warm pass, then the measured pass on a fresh timer
        fast = mode in ("fast", "urlfast")
        analyzer.analyze_images_batch(paths, filter_interiors=False,
                                      device_resize=(mode == "device"), fast_decode=fast)
        analyzer.metrics.stages = StageTimer()
        t0 = time.perf_counter()
        res = analyzer.analyze_images_batch(paths, filter_interiors=False,
                                            device_resize=(mode == "device"), fast_decode=fast)
        dt = time.perf_counter() - t0
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()

    # count per path OCCURRENCE: repeated paths collapse in the result dict
    # but each occurrence was decoded and classified
    n = sum(1 for p in paths if res[p]["detected_category"] != "load error")
    stages = {k: round(v["total_s"], 3)
              for k, v in analyzer.metrics.stages.summary().items()}
    rec = {
        "metric": f"e2e_jpeg_to_verdict_images_per_sec_{mode}",
        "value": round(n / dt, 1),
        "unit": "img/s",
        "images": n,
        "seconds": round(dt, 2),
        "stage_seconds": stages,
    }
    print(json.dumps(rec), flush=True)
    return [rec]


if __name__ == "__main__":
    main()
