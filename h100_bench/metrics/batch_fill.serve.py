"""``batch_fill.serve`` (%): the batcher's counters over the window
(``DynamicBatcher.metrics`` ``images_total`` / ``batches_total``) over
``max_batch``. Layer: batcher."""


def read(run):
    c = run.counters
    if not c.get("batches_total"):
        return None
    return 100.0 * c["images_total"] / c["batches_total"] / c["max_batch"]
