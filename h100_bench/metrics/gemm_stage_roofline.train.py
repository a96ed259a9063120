"""``gemm_stage_roofline.train`` (%): the least time of the products the wgmma
GEMM stage ran in the traced steps (rows 11-12, 11 launches a text block a
step: forward QKV, out-projection, c_fc, c_proj epilogues ``EpiQkv``,
``EpiY1``, ``EpiFc``, ``EpiY``; the backward's recomputed QKV,
out-projection and c_fc, then ``EpiDfq`` and three ``EpiLoRAOut``;
``counts.train_step``), over the device time of ``wgmma_stage_kernel``,
the work scaled down by the share of the expected launches that the trace
holds. Layer: kernels."""

from h100_bench import counts

NEEDLE = "wgmma_stage_kernel"


def read(run):
    if run.trace is None:
        return None
    t = run.trace.device_s(NEEDLE)
    if t <= 0:
        return None
    products = [p for p in counts.train_step(run.cfg, run.train, run.traffic["batch"])
                if p.where in ("stage", "recompute", "unneeded")]
    expected = len(products) * len(run.traced_calls)
    bound = counts.least_s(products) * len(run.traced_calls)
    if not expected:
        return None
    # a launch the trace lost takes its time out: take its work out likewise
    return 100.0 * bound * min(1.0, run.trace.launches(NEEDLE) / expected) / t
