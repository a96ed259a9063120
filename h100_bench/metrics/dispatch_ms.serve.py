"""``dispatch_ms.serve`` (ms): the engine's ``dispatch`` stage (the
analyzer's ``metrics.stages``: pad, host-to-device copy, enqueue of the
classify program), mean per call over the window. Layer: engine
dispatch/fetch."""


def read(run):
    c = run.counters
    if not c.get("dispatch_count"):
        return None
    return 1e3 * c["dispatch_s"] / c["dispatch_count"]
