"""``attn_core_roofline.serve`` (%): the least time of the attention
core's work for every call dispatched while the trace ran (QK^T and PV at
bf16 peak; q, k, v read once and o written once; ``counts.image_call``,
``where == "attn_core"``), over the device time of the tensor-core core's
kernels (``attn_core_mma_kernel``), the work scaled down by the share of
the expected launches that the trace holds. Layer: kernels."""

from h100_bench import counts

NEEDLE = "attn_core_mma_kernel"


def read(run):
    if run.trace is None:
        return None
    t = run.trace.device_s(NEEDLE)
    if t <= 0:
        return None
    bound, expected = 0.0, 0
    for b in run.traced_calls:
        products = [p for p in counts.image_call(run.cfg, run.engine, b) if p.where == "attn_core"]
        bound += counts.least_s(products)
        expected += len(products)
    if not expected:
        return None
    # a launch the trace lost takes its time out: take its work out likewise
    return 100.0 * bound * min(1.0, run.trace.launches(NEEDLE) / expected) / t
