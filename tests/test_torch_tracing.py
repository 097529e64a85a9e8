"""The port's span recorder (``zonos_vibes_tpu_torch/utils/tracing.py``) on
the CPU: off by default, parents and request ids across threads, its clock
against the profiler's, and the spans of the tiny pooled server of
tests/test_torch_server.py (a pooled stream, and a stream that finds the
pool full)."""

import json
import sys
import threading
import time

import pytest
import torch

from tests.test_torch_server import EMO, HOP, _get, _post, _start, _url
from tests.test_torch_server import pipe, weights  # noqa: F401 (fixtures)
from zonos_vibes_tpu_torch.utils import tracing


@pytest.fixture
def recorder():
    """Spans on and the recorder empty; off again afterwards."""
    tracing.reset()
    tracing.enable()
    try:
        yield tracing
    finally:
        tracing.disable()
        tracing.reset()


def test_off_records_nothing():
    tracing.disable()
    tracing.reset()
    assert not tracing.enabled()
    with tracing.span("a", rid="r", device=True, k=1) as sp:
        sp.set(more=2)
        tracing.mark("m")
    tracing.begin("b", rid="r").end(x=1)
    assert sp is tracing.NOOP
    assert tracing.spans() == []
    # Phases and counters stay on.
    with tracing.phase("p"):
        pass
    tracing.count("n")
    assert tracing.timings_snapshot()["p"]["count"] == 1
    assert tracing.counters_snapshot() == {"n": 1}
    tracing.reset()


def test_parents_and_rid_across_threads(recorder):
    req = tracing.begin("request", rid="q1")
    queued = tracing.begin("queue", parent=req)

    def worker():
        queued.end()
        with tracing.span("admit", parent=req) as admit:
            with tracing.span("prefill", device=True):
                pass
            tracing.mark("chunk", frames=3)
        admit.set(slot=0)

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    req.end(path="pool")
    by = {s["name"]: s for s in tracing.spans()}
    assert set(by) == {"request", "queue", "admit", "prefill", "chunk"}
    assert {s["rid"] for s in by.values()} == {"q1"}
    assert by["request"]["parent"] is None
    assert by["queue"]["parent"] == by["admit"]["parent"] == by["request"]["id"]
    assert by["prefill"]["parent"] == by["chunk"]["parent"] == by["admit"]["id"]
    assert by["admit"]["attrs"] == {"slot": 0} and by["request"]["attrs"] == {"path": "pool"}
    assert by["chunk"]["attrs"] == {"frames": 3} and by["chunk"]["t0"] == by["chunk"]["t1"]
    assert by["prefill"]["device_ms"] is None  # the CPU has no device time
    assert by["request"]["t0"] <= by["queue"]["t0"] <= by["queue"]["t1"] <= by["admit"]["t0"]
    # Read over a window: only what overlaps it.
    assert tracing.spans(by["request"]["t1"] + 1, by["request"]["t1"] + 10) == []


def test_spans_read_while_the_worker_closes_device_spans(recorder):
    """A reader thread calling ``spans()`` while the worker closes device
    spans: both resolve device times, and neither may fail. The events are
    stand-ins that report done (the CPU has no CUDA event)."""

    class Done:
        def record(self, stream=None):
            pass

        def query(self):
            return True

        def elapsed_time(self, end):
            return 1.5

    stop, errors = threading.Event(), []

    def read():
        while not stop.is_set():
            try:
                tracing.spans()
            except Exception as e:  # noqa: BLE001 (the failure under test)
                errors.append(e)
                return

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    reader = threading.Thread(target=read)
    reader.start()
    try:
        for _ in range(40 * tracing._RESOLVE_EVERY):
            sp = tracing.Span("replay", None, None, None, {})
            sp._start()
            sp._ev = (Done(), Done())
            sp._stop()
    finally:
        stop.set()
        reader.join()
        sys.setswitchinterval(switch)
    assert errors == []
    got = tracing.spans()
    assert len(got) == 40 * tracing._RESOLVE_EVERY
    assert {s["device_ms"] for s in got} == {1.5}


def test_to_trace_clock_lands_on_the_profilers_record(recorder):
    act = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(20):
            with tracing.span("probe"):
                torch.ones(4).sum()
    starts = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == "probe")
    spans = sorted(s["t0"] for s in tracing.spans() if s["name"] == "probe")
    assert len(starts) == len(spans) == 20
    # The last of them, past the first calls' warm-up.
    for want, got in list(zip(starts, spans))[-5:]:
        assert abs(tracing.to_trace_clock(got) - want) < 50_000, (got, want)


def test_a_profiler_session_turns_spans_on():
    tracing.disable()
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("inside"):
            pass
    with tracing.span("after"):
        pass
    assert [s["name"] for s in tracing.spans()] == ["inside"]
    tracing.reset()


def _tree(spans):
    by_id = {s["id"]: s for s in spans}
    kids = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)
    return by_id, kids


def test_a_pooled_stream_yields_its_spans(pipe, recorder):  # noqa: F811
    srv = _start(pipe, pooled=True, pool_slots=2, segment_steps=6)
    try:
        status, _, body = _post(_url(srv), {"text": "Spans of a stream.", "emotion": EMO,
                                            "max_new_tokens": 30, "stream": True,
                                            "request_id": "s1"})
        assert status == 200 and body.startswith(b"RIFF")
        deadline = time.monotonic() + 30
        while not any(s["name"] == "request" for s in tracing.spans()):
            assert time.monotonic() < deadline
            time.sleep(0.05)
    finally:
        srv.shutdown()
    spans = tracing.spans()
    by_id, kids = _tree(spans)
    mine = [s for s in spans if s["rid"] == "s1"]
    (req,) = [s for s in mine if s["name"] == "request"]
    assert req["attrs"]["path"] == "pool" and "reason" not in req["attrs"]
    assert "admit" in {s["name"] for s in kids[req["id"]]}
    (admit,) = [s for s in mine if s["name"] == "admit"]
    assert {s["name"] for s in kids[admit["id"]]} == {"phonemize", "conditioning", "prefill",
                                                      "join"}
    chunks = sorted((s for s in mine if s["name"] == "chunk"), key=lambda s: s["t0"])
    assert {"slot", "frames", "valid", "emitted", "final"} <= set(chunks[0]["attrs"])
    # One record per segment, the last with the withheld tail: every frame streamed.
    assert sum(c["attrs"]["frames"] for c in chunks) * HOP * 2 == len(body) - 44
    assert [c["attrs"]["final"] for c in chunks] == [False] * (len(chunks) - 1) + [True]
    segs = [by_id[c["parent"]] for c in chunks]
    assert {s["name"] for s in segs} == {"pool_segment"}
    for seg in segs:
        names = {s["name"] for s in kids[seg["id"]]}
        assert {"steps", "emit", "read"} <= names
        (steps,) = [s for s in kids[seg["id"]] if s["name"] == "steps"]
        under = kids[steps["id"]]
        assert {"read_running", "replay", "flush"} == {s["name"] for s in under}
        # The steps' device work is their runs and the flush; the reads are the host's.
        assert not steps["device"] and all(s["device"] == (s["name"] != "read_running")
                                           for s in under)
        assert sum(s["attrs"]["n"] for s in under if s["name"] == "replay") == steps["attrs"]["n"]
        assert steps["attrs"]["n"] > 0 and seg["attrs"]["streams"] >= 1
    assert {"worker_wait"} <= {s["name"] for s in spans}


def test_a_stream_that_finds_the_pool_full(pipe, recorder):  # noqa: F811
    """One slot: of two streams taken in one batch, the second takes a
    stream job, and says why."""
    srv = _start(pipe, pooled=True, pool_slots=1, segment_steps=6, batch_window_s=2.0)
    results = {}

    def post(rid):
        results[rid] = _post(_url(srv), {"text": f"Stream {rid}.", "emotion": EMO,
                                         "max_new_tokens": 20, "stream": True,
                                         "request_id": rid})

    try:
        threads = [threading.Thread(target=post, args=(rid,)) for rid in ("a", "b")]
        for t in threads:
            t.start()
            time.sleep(0.3)
        for t in threads:
            t.join(timeout=240)
        assert results["a"][0] == results["b"][0] == 200
        m = json.loads(_get(srv, "/metrics")[1])
    finally:
        srv.shutdown()
    assert m["counters"]["pool_full_fallbacks"] == 1
    reqs = {s["rid"]: s for s in tracing.spans() if s["name"] == "request"}
    assert reqs["a"]["attrs"]["path"] == "pool"
    assert reqs["b"]["attrs"]["path"] == "stream_job"
    assert reqs["b"]["attrs"]["reason"] == "pool_full"
    segs = [s for s in tracing.spans() if s["name"] == "stream_segment"]
    assert segs and {s["rid"] for s in segs} == {"b"}
    assert all(s["parent"] == reqs["b"]["id"] for s in segs)
