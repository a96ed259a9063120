#!/usr/bin/env python3
"""Does ``torch.profiler`` keep every kernel of a trace as a process ages?

    python3 tools/profiler_loss.py [seconds=200]

Every 15 s of bf16 matmuls on the card, traces ``chip_smoke.PROFILE_ITERS``
calls of ten 4096^2 matmuls twice through ``chip_smoke._profile``: as they
come, and opened with the ``PROFILE_LEAD_IN`` spin kernels that
``chip_smoke._device_ms_by_kernel`` uses; prints one JSON line per round
with the kernel records each trace kept (20 a call: two kernels a matmul)
and whether ``chip_smoke._kept_both_ends`` took the trace for whole. Then
fifteen traces of each kind in a row. Needs a CUDA card; builds none of the
port's kernels.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    seconds = float(argv[0]) if argv else 200.0
    import torch

    from chip_smoke import PROFILE_ITERS, PROFILE_LEAD_IN, _cuda_kernels, _kept_both_ends, _profile

    if not torch.cuda.is_available():
        raise SystemExit("profiler_loss: needs a CUDA card")
    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)

    def fn():
        for _ in range(10):
            a @ a

    def kept(lead_in: int) -> list:
        fn()
        torch.cuda.synchronize()
        kernels = _cuda_kernels(_profile(fn, lead_in))
        return [sum("spin_kernel" not in ev.name for ev in kernels), _kept_both_ends(kernels)]

    print(json.dumps({"torch": torch.__version__, "card": torch.cuda.get_device_name(0),
                      "records_per_trace": 20 * PROFILE_ITERS}), flush=True)
    t0 = time.time()
    while time.time() - t0 < seconds:
        print(json.dumps({"t_s": round(time.time() - t0, 1), "plain": kept(0),
                          "lead_in": kept(PROFILE_LEAD_IN)}), flush=True)
        t1 = time.time()
        while time.time() - t1 < 15:
            fn()
            torch.cuda.synchronize()
    for kind, lead_in in (("plain", 0), ("lead_in", PROFILE_LEAD_IN)):
        print(json.dumps({f"in_a_row_{kind}": [kept(lead_in) for _ in range(15)]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
