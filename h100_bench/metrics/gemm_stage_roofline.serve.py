"""``gemm_stage_roofline.serve`` (%): the least time of the products the
wgmma GEMM stage ran for every call dispatched while the trace ran (each
call at its padded bucket; ``counts.image_call``, products ``where ==
"stage"``), over the device time of the stage's kernels
(``wgmma_stage_kernel``) in the trace, the work scaled down by the share
of the expected launches that the trace holds. Layer: kernels."""

from h100_bench import counts

NEEDLE = "wgmma_stage_kernel"


def read(run):
    if run.trace is None:
        return None
    t = run.trace.device_s(NEEDLE)
    if t <= 0:
        return None
    bound, expected = 0.0, 0
    for b in run.traced_calls:
        products = [p for p in counts.image_call(run.cfg, run.engine, b) if p.where == "stage"]
        bound += counts.least_s(products)
        expected += len(products)
    if not expected:
        return None
    # a launch the trace lost takes its time out: take its work out likewise
    return 100.0 * bound * min(1.0, run.trace.launches(NEEDLE) / expected) / t
