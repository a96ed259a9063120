"""``p95_ms.serve`` (ms): the 95th percentile (numpy's linear) of every
request's time from its submission to its future's callback, over the
requests resolved in the window. The closed loop keeps the worker at its
capacity, so this tail follows the throughput (Little: 768 outstanding over
the requests served a second) and swings between runs. Layer: batcher."""


def read(run):
    return run.e2e.get("p95_ms")
