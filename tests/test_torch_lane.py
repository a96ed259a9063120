"""The engine lane (``aiic_tpu_torch.parallel.lane``) in one process, on a
world of one rank (a gloo group on an in-process store) around a stub engine
whose calls block on events: calls take their turn in the order they
arrive, a fetch waits for the device after its turn, a failed collective
breaks the lane, and the command header carries what a follower needs.
The lane over two ranks is tests/test_torch_multihost.py's and
tests/test_torch_cli.py's.
"""

import threading
import time

import numpy as np
import pytest
import torch.distributed as dist

from aiic_tpu_torch.parallel import create_mesh
from aiic_tpu_torch.parallel import lane as lane_mod
from aiic_tpu_torch.parallel.lane import EngineLane, LaneError
from aiic_tpu_torch.serve.metrics import Metrics

WAIT = 20.0


class StubEngine:
    """The engine surface the lane calls; each call is logged, and a call
    named in ``hold`` waits for its event first."""

    def __init__(self):
        self.metrics = Metrics()
        self.calls, self.hold = [], {}
        self.config = "stub-config"

    def _held(self, name):
        if name in self.hold:
            assert self.hold[name].wait(WAIT)

    def dispatch_pixels(self, pixels, max_batch=None):
        self._held("dispatch")
        self.calls.append(("dispatch", int(pixels.sum())))
        return [("pending", int(pixels.sum()))]

    def _start_fetch(self, pending):
        self.calls.append(("fetch issued", pending[0][1]))

        def finish():
            self._held("fetch wait")
            self.calls.append(("fetch done", pending[0][1]))
            return {"rows": np.asarray([pending[0][1]])}
        return finish

    def warmup(self, batch_sizes=None):
        self._held("warmup")
        self.calls.append(("warmup", batch_sizes))


@pytest.fixture
def lane():
    create_mesh(1, device="cpu")
    engine = StubEngine()
    yield EngineLane(engine, log=lambda *_: None), engine


def _until(cond):
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.001)


def _thread(fn):
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    return t


def _px(v):
    return np.full((1, 2, 2, 3), v, np.uint8)


def test_calls_take_their_turn_in_order_of_arrival(lane):
    """While the warmup holds the lane, a dispatch that arrives first runs
    first, though a later one arrives while it waits: a call whose caller
    gave up still runs in its place."""
    ln, engine = lane
    engine.hold["warmup"] = threading.Event()
    warm = _thread(lambda: ln.warmup([1, 2]))
    _until(lambda: ln._tickets == 1)
    first = _thread(lambda: ln.dispatch_pixels(_px(1)))
    _until(lambda: ln._tickets == 2)
    second = _thread(lambda: ln.dispatch_pixels(_px(2)))
    _until(lambda: ln._tickets == 3)
    engine.hold["warmup"].set()
    for t in (warm, first, second):
        t.join(WAIT)
        assert not t.is_alive()
    assert engine.calls == [("warmup", [1, 2]), ("dispatch", 12), ("dispatch", 24)]


def test_fetch_waits_for_the_device_after_its_turn(lane):
    """A fetch issues its gathers in its turn and waits outside it: the next
    dispatch runs while the fetch still waits."""
    ln, engine = lane
    handle = ln.dispatch_pixels(_px(1))
    engine.hold["fetch wait"] = threading.Event()
    box = {}
    fetch = _thread(lambda: box.setdefault("res", ln.fetch_results(handle)))
    nxt = _thread(lambda: box.setdefault("next", ln.dispatch_pixels(_px(3))))
    nxt.join(WAIT)
    assert not nxt.is_alive() and box["next"].seq == 1
    assert ("fetch done", 12) not in engine.calls
    engine.hold["fetch wait"].set()
    fetch.join(WAIT)
    assert not fetch.is_alive()
    assert box["res"]["rows"].tolist() == [12]
    assert engine.calls == [("dispatch", 12), ("fetch issued", 12), ("dispatch", 36),
                            ("fetch done", 12)]
    assert engine.metrics.stages.counts["lane_wait"] == 3


def test_a_failed_collective_breaks_the_lane(lane, monkeypatch):
    """A send that fails sets ``broken`` and keeps the error; every later
    call raises LaneError, and ``close`` sends nothing."""
    ln, engine = lane

    def fail(*a, **k):
        raise RuntimeError("Connection closed by peer")
    monkeypatch.setattr(lane_mod.dist, "broadcast", fail)
    with pytest.raises(RuntimeError, match="closed by peer"):
        ln.dispatch_pixels(_px(1))
    assert ln.broken.is_set() and "closed by peer" in repr(ln.error)
    with pytest.raises(LaneError, match="broke"):
        ln.warmup()
    ln.close()
    assert engine.calls == []


def test_close_stops_the_lane_once(lane):
    ln, engine = lane
    ln.close()
    ln.close()
    with pytest.raises(LaneError, match="closed"):
        ln.dispatch_pixels(_px(1))
    assert engine.calls == []


def test_reads_through_to_the_engine_but_not_the_unled_entry_points(lane):
    ln, _ = lane
    assert ln.config == "stub-config"
    with pytest.raises(AttributeError, match="not led through the engine lane"):
        ln.analyze_images_batch


@pytest.mark.parametrize("cmd", [
    dict(op=lane_mod.DISPATCH, seq=7, max_batch=64,
         pixels=np.arange(2 * 3 * 4 * 5, dtype=np.uint8).reshape(2, 3, 4, 5)),
    dict(op=lane_mod.DISPATCH, seq=8, max_batch=None,
         pixels=np.linspace(-1, 1, 24, dtype=np.float32).reshape(2, 3, 4)),
    dict(op=lane_mod.FETCH, seq=9),
    dict(op=lane_mod.WARMUP, seq=0, sizes=[1, 2, 4, 8, 16, 32, 64, 128, 256, 512]),
    dict(op=lane_mod.WARMUP, seq=0, sizes=None),
    dict(op=lane_mod.STOP, seq=0),
], ids=["u8", "f32", "fetch", "warmup", "warmup_default", "stop"])
def test_command_reaches_a_follower_whole(lane, monkeypatch, cmd):
    """What rank 0 sends (``_send``) is what a follower receives
    (``_receive``): the broadcasts replayed in order into the follower's
    buffers."""
    ln, _ = lane
    sent = []
    monkeypatch.setattr(lane_mod.dist, "broadcast",
                        lambda t, src, group: sent.append(t.clone()))
    ln._send(cmd["op"], cmd["seq"], cmd.get("max_batch"), pixels=cmd.get("pixels"),
             sizes=cmd.get("sizes"))
    replay = iter(sent)
    monkeypatch.setattr(lane_mod.dist, "broadcast",
                        lambda t, src, group: t.copy_(next(replay)))
    op, seq, max_batch, pixels, sizes = ln._receive()
    assert (op, seq, max_batch, sizes) == (cmd["op"], cmd["seq"], cmd.get("max_batch"),
                                           cmd.get("sizes"))
    if "pixels" in cmd:
        assert pixels.dtype == cmd["pixels"].dtype
        np.testing.assert_array_equal(pixels, cmd["pixels"])
    else:
        assert pixels is None
    assert next(replay, None) is None


def test_the_lane_refuses_what_it_cannot_send(lane):
    ln, engine = lane
    with pytest.raises(ValueError, match="pixels"):
        ln.dispatch_pixels(np.zeros((1, 2), np.int32))
    with pytest.raises(ValueError, match="warmup buckets"):
        ln.warmup(list(range(1, 40)))
    assert not ln.broken.is_set() and engine.calls == []
    assert dist.get_world_size() == 1
