"""``mfu.serve`` (%): the model's operations for the images answered in
the window, counted from the configuration's shapes (``counts.image_call``,
the last block on the CLS row as the program computes it), as the least
time at the peaks of the precisions they run in, over the window's seconds.
Layer: model step."""

from h100_bench import counts


def read(run):
    per_image = counts.peak_s(counts.image_call(run.cfg, run.engine, 1))
    return 100.0 * run.images * per_image / run.window_s
