"""``mfu.train`` (%): the model's operations of the window's LoRA steps
(``counts.train_step``: each text block's forward and the backward's
activation gradients, the causal attention core, the rank-r products; not
the recomputed forward products, nor the first block's input gradient,
which the loss does not need), as the least time at bf16 peak, over the
window's seconds. Layer: model step."""

from h100_bench import counts


def read(run):
    per_step = counts.peak_s(counts.train_step(run.cfg, run.train, run.traffic["batch"]),
                             exclude=("recompute", "unneeded"))
    return 100.0 * run.steps * per_step / run.window_s
