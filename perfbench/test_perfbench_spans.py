"""The readers of the program's spans and timed events
(``perfbench/metrics/*`` with source ``program_span``): each against a
hand-computed value on spans and events laid out here, each with nothing
to read, and all of them after a whole tiny run on the CPU with the
recorder on."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench.conftest import tiny_spec
from perfbench.run import Run, reader
from zonos_vibes_tpu_torch.utils import tracing

SEED = 2 ** 31 + 4242
NEW = ("step_device_ms", "emit_device_ms", "segment_host_ms", "admit_share", "emit_miss_share",
       "capture_s")
MS = 1_000_000  # ns


def at(s: float) -> int:
    return int(s * 1e9)


class Spans:
    """Span records as ``tracing.spans`` gives them."""

    def __init__(self):
        self.all = []

    def add(self, name, t0, t1, parent=None, rid=None, device_ms=None, device=False, **attrs):
        s = {"name": name, "id": len(self.all) + 1, "parent": parent and parent["id"],
             "rid": rid, "t0": t0, "t1": t1, "device": device or device_ms is not None,
             "device_ms": device_ms, "attrs": attrs}
        self.all.append(s)
        return s

    def read(self, lo=None, hi=None):
        return [s for s in self.all if (lo is None or s["t1"] >= lo) and (hi is None or s["t0"] < hi)]


def layout(cpu: bool = False) -> Spans:
    """Two pool segments inside the stretch (12 s .. 14 s of the window
    10 s .. 20 s), one that starts before it, and three streaming rows'
    chunks. ``cpu``: no device time."""
    d = (lambda ms: None) if cpu else (lambda ms: ms)
    sp = Spans()
    seg = sp.add("pool_segment", at(12.1), at(12.1) + 300 * MS, streams=3)
    steps = sp.add("steps", seg["t0"], seg["t0"] + 250 * MS, seg, n=43)
    t = seg["t0"]
    for n, ms in ((9, 45.0), (9, 46.0), (25, 125.0)):  # runs of steps, a read before each
        sp.add("read_running", t, t + 2 * MS, steps)
        sp.add("replay", t + 2 * MS, t + 60 * MS, steps, device_ms=d(ms), device=True, n=n)
        t += 60 * MS
    sp.add("flush", t, t + MS, steps, device_ms=d(4.0), device=True)
    sp.add("emit", seg["t0"] + 251 * MS, seg["t0"] + 260 * MS, seg, device_ms=d(40.0),
           device=True)
    sp.add("read", seg["t0"] + 260 * MS, seg["t0"] + 290 * MS, seg)
    sp.add("vocode", seg["t0"] + 290 * MS, seg["t0"] + 295 * MS, seg, device_ms=d(10.0),
           device=True)  # a finished row's tail
    seg2 = sp.add("pool_segment", at(12.5), at(12.5) + 300 * MS, streams=3)
    steps2 = sp.add("steps", seg2["t0"], seg2["t0"] + 260 * MS, seg2, n=43)
    sp.add("replay", seg2["t0"], seg2["t0"] + 250 * MS, steps2, device_ms=d(246.0), device=True,
           n=43)
    sp.add("flush", seg2["t0"] + 250 * MS, seg2["t0"] + 251 * MS, steps2, device_ms=d(4.0),
           device=True)
    sp.add("emit", seg2["t0"] + 260 * MS, seg2["t0"] + 280 * MS, seg2, device_ms=d(30.0),
           device=True)
    early = sp.add("pool_segment", at(11.9), at(12.2))  # not wholly in the stretch
    e_steps = sp.add("steps", early["t0"], early["t1"], early, n=1)
    sp.add("replay", early["t0"], early["t1"], e_steps, device_ms=d(1.0), device=True, n=1)
    for i, (rid, frames) in enumerate([("a", [0, 5, 0, 5, 0]), ("b", [4, 4]), ("c", [0, 0])]):
        emitted = 0
        for j, f in enumerate(frames):
            emitted += f
            t = at(12.2) + (10 * j + i) * MS
            sp.add("chunk", t, t, seg, rid=rid, frames=f, slot=i, emitted=emitted)
    return sp


class Events:
    """``perfbench/lib/observe.Observer``'s logged events: two admissions in
    the window, one before it."""

    def __init__(self, admits=((9.5, 80.0), (11.0, 150.0), (15.0, 100.0))):
        self.events = [(t, "pool_admit", {"admit_ms": ms, "queue_wait_ms": 1.0})
                       for t, ms in admits]

    def events_named(self, name, t0, t1):
        return [f for t, e, f in self.events if e == name and t0 <= t < t1]


def ctx(stretch=(12.0, 14.0), events=None):
    return SimpleNamespace(window=(10.0, 20.0), stretch_span=stretch, seconds=10.0,
                           obs=events if events is not None else Events())


@pytest.fixture
def program(monkeypatch):
    """The recorder off and its spans and phases replaced by ``set``'s."""
    state = {"spans": Spans(), "phases": {}}

    def set_(spans=None, phases=None):
        state["spans"] = spans or Spans()
        state["phases"] = phases or {}

    monkeypatch.setattr(tracing, "spans", lambda lo=None, hi=None: state["spans"].read(lo, hi))
    monkeypatch.setattr(tracing, "timings_snapshot", lambda: state["phases"])
    monkeypatch.setattr(tracing, "enabled", lambda: False)
    return set_


def test_each_reader_on_spans_laid_out_by_hand(program):
    program(layout(), {"graph_capture": {"total_s": 1.5}, "kernel_load": {"total_s": 0.25},
                       "kernel_build": {"total_s": 45.0}, "warmup": {"total_s": 9.0}})
    c = ctx()
    # The replays and flushes under the steps; the reads between them are the host's.
    assert reader("step_device_ms")(c) == pytest.approx((216.0 + 4.0 + 246.0 + 4.0) / 86)
    assert reader("emit_device_ms")(c) == pytest.approx((40.0 + 30.0) / 2)
    # Wall less every device span under the segment: 300 - 270, 300 - 280.
    assert reader("segment_host_ms")(c) == pytest.approx((30.0 + 20.0) / 2)
    # 150 + 100 ms of admission in a window of 10 s.
    assert reader("admit_share")(c) == pytest.approx(100.0 * 0.25 / 10.0)
    # Once a row has shipped: a [5, 0, 5, 0], b [4, 4]; c never started.
    assert reader("emit_miss_share")(c) == pytest.approx(100.0 * 2 / 6)
    # Without the build.
    assert reader("capture_s")(c) == pytest.approx(1.75)


def test_a_stream_segment_reads_its_vocoder(program):
    sp = Spans()
    seg = sp.add("stream_segment", at(12.1), at(12.1) + 200 * MS, rid="s")
    sp.add("prefill", seg["t0"], seg["t0"] + 20 * MS, seg, device_ms=15.0)
    steps = sp.add("steps", seg["t0"] + 20 * MS, seg["t0"] + 190 * MS, seg, n=43)
    sp.add("replay", seg["t0"] + 20 * MS, seg["t0"] + 120 * MS, steps, device_ms=95.0, n=25)
    sp.add("replay", seg["t0"] + 121 * MS, seg["t0"] + 189 * MS, steps, device_ms=65.0, n=18)
    sp.add("vocode", seg["t0"] + 190 * MS, seg["t0"] + 198 * MS, seg, device_ms=6.0)
    sp.add("read", seg["t0"] + 198 * MS, seg["t0"] + 199 * MS, seg)
    program(sp)
    c = ctx(events=Events(()))
    assert reader("step_device_ms")(c) == pytest.approx(160.0 / 43)
    assert reader("emit_device_ms")(c) == pytest.approx(6.0)
    assert reader("segment_host_ms")(c) == pytest.approx(200.0 - 181.0)
    assert reader("admit_share")(c) is None
    assert reader("emit_miss_share")(c) is None


def test_no_device_time_reads_none(program):
    program(layout(cpu=True))
    c = ctx()
    for name in ("step_device_ms", "emit_device_ms", "segment_host_ms"):
        assert reader(name)(c) is None, name
    assert reader("admit_share")(c) == pytest.approx(2.5)
    assert reader("emit_miss_share")(c) == pytest.approx(100.0 * 2 / 6)


def test_nothing_to_read_is_none(program, monkeypatch):
    spans_only = [name for name in NEW if name not in ("capture_s", "admit_share")]
    program(layout())
    assert all(reader(name)(ctx(stretch=None)) is None for name in spans_only)
    program(Spans(), {})
    assert all(reader(name)(ctx(events=Events(()))) is None for name in NEW)
    # A program without the recorder (the version before it).
    monkeypatch.delattr(tracing, "spans")
    program(layout())
    assert all(reader(name)(ctx()) is None for name in spans_only)


def test_readers_on_a_whole_tiny_run(monkeypatch):
    """A whole tiny traced run on the CPU with the recorder switched on (the
    traced stretch's profiler needs the card, so a stand-in takes its
    place): the run reports only the new metrics that read no device time,
    and over the run's spans each new reader gives a number, or None where
    it reads device time (and the CPU captures no graph and loads no
    kernel). Whether the run is correct is the fault tests' matter."""
    from perfbench.lib import observe, trace

    class NoStretch:
        result = error = host_span = None
        stop_s = reduce_s = 0.0

        def __init__(self, *a):
            pass

        def before_advance(self, kind):
            pass

        def finish(self):
            pass

    monkeypatch.setattr(trace, "Stretch", NoStretch)
    observers = []
    init = observe.Observer.__init__

    def keep(self):
        init(self)
        observers.append(self)

    monkeypatch.setattr(observe.Observer, "__init__", keep)
    tracing.reset()
    tracing.enable()
    try:
        out = Run(tiny_spec(), SEED, 3.0, traced=True, device="cpu").execute()
        spans = tracing.spans()
        whole = SimpleNamespace(window=(min(s["t0"] for s in spans) / 1e9,
                                        max(s["t1"] for s in spans) / 1e9 + 1e-3),
                                obs=observers[0])
        got = {name: reader(name)(whole) for name in NEW}
    finally:
        tracing.disable()
        tracing.reset()
    assert {"pool_segment", "steps", "read_running", "replay", "flush", "emit", "read", "chunk",
            "admit"} <= {s["name"] for s in spans}
    assert set(out["metrics"]) & set(NEW) <= {"admit_share", "emit_miss_share"}
    assert 0.0 < got["admit_share"] < 100.0
    assert 0.0 <= got["emit_miss_share"] <= 100.0
    assert got["step_device_ms"] is got["emit_device_ms"] is got["segment_host_ms"] is None
    assert got["capture_s"] is None
