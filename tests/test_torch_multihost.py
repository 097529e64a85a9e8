"""The port's multi-process runtime (``zonos_vibes_tpu_torch/parallel/multihost.py``)
on the CPU: tests/test_multihost.py's cases for the port, and the heartbeat
over two spawned gloo ranks, one of them late past the deadline.

The heartbeat is an all-reduce over a process group (JAX's a ``psum`` over
the mesh); one process without a group probes a one-rank group of its own.
The server's ``--heartbeat-interval-s`` starts the monitor, and ``/healthz``
answers 503 once a probe fails (the collective stubbed, as JAX's tests stub
the device call). The replay buffer hands back what JAX's does for the same
sequence of calls.
"""

import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from torch_parallel_workers import run_tasks, Ranks
from zonos_vibes_tpu.parallel.multihost import ReplayBuffer as JReplayBuffer
from zonos_vibes_tpu_torch import config as tcfg
from zonos_vibes_tpu_torch.models.dac import DACConfig
from zonos_vibes_tpu_torch.parallel import multihost
from zonos_vibes_tpu_torch.parallel.multihost import (
    Heartbeat,
    HeartbeatMonitor,
    ReplayBuffer,
    initialize_runtime,
    is_coordinator,
)
from zonos_vibes_tpu_torch.pipeline import ZonosPipeline
from zonos_vibes_tpu_torch.serve import server as tserver


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Two gloo ranks: a probe together, one that rank 1 joins only after
    twice the 0.5 s deadline, one together again."""
    return Ranks(run_tasks, 2, ([("heartbeat", (1, 0.5))],), tmp_path_factory.mktemp("pg"))


def test_heartbeat_over_two_ranks_detects_a_late_rank(two_ranks):
    results = [r[0] for r in two_ranks.results()]
    assert results == [[True, False, True], [True, True, True]]


def test_initialize_runtime_single_process_noop(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_runtime() is False
    assert not torch.distributed.is_initialized()
    assert is_coordinator()


def test_heartbeat_probe_one_rank_group():
    hb = Heartbeat(timeout_s=30.0)
    assert hb.world == 1
    assert hb.probe() is True


def test_heartbeat_detects_hang():
    hb = Heartbeat(timeout_s=0.2)

    def hang():
        time.sleep(2.0)
        return hb.world

    hb._device_call = hang  # a stalled collective
    assert hb.probe() is False


def test_heartbeat_wedged_probe_does_not_leak_threads():
    """Probes against a wedged collective return False at once on the one
    worker, without new threads; the worker recovers when the wedge clears."""
    hb = Heartbeat(timeout_s=0.1)
    release = threading.Event()
    real_call = hb._device_call

    def wedged():
        release.wait()
        return real_call()

    hb._device_call = wedged
    assert hb.probe() is False
    n_threads = threading.active_count()
    for _ in range(10):
        assert hb.probe() is False
    assert threading.active_count() == n_threads
    release.set()
    hb._device_call = real_call
    deadline = time.monotonic() + 5.0
    ok = False
    while time.monotonic() < deadline and not ok:
        ok = hb.probe()
    assert ok


def test_heartbeat_detects_short_world():
    hb = Heartbeat(timeout_s=5.0)
    hb.world = 999  # as if ranks went missing
    assert hb.probe() is False


def test_monitor_fires_once_and_recovers():
    state = {"ok": False, "failures": []}
    mon = HeartbeatMonitor(lambda: state["ok"], interval_s=0.02,
                           on_failure=state["failures"].append).start()
    try:
        deadline = time.monotonic() + 2.0
        while mon.healthy and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not mon.healthy
        time.sleep(0.1)  # further failed probes must not fire again
        assert state["failures"] == ["heartbeat probe failed"]
        state["ok"] = True
        deadline = time.monotonic() + 2.0
        while not mon.healthy and time.monotonic() < deadline:
            time.sleep(0.01)
        assert mon.healthy
    finally:
        mon.stop()


def test_replay_buffer_matches_jax():
    ops = [("checkout", "a"), ("checkout", "b"), ("checkout", "c"), ("ack", 1), ("pending",),
           ("drain",), ("pending",), ("ack", 0), ("drain",), ("checkout", "d"), ("drain",)]
    seen = []
    for rb in (JReplayBuffer(), ReplayBuffer()):
        out = [getattr(rb, op)(*args) for op, *args in ops]
        seen.append((out, rb.replayed_total))
    assert seen[0] == seen[1]
    assert seen[1][0][5] == ["a", "c"] and seen[1][1] == 3


def test_server_heartbeat_flag_drives_healthz(monkeypatch):
    """``--heartbeat-interval-s 1``: the server starts, ``/healthz`` answers
    200, and once a probe fails (the collective stubbed to come back short)
    503."""
    cfg = tcfg.ZonosConfig(
        backbone=tcfg.BackboneConfig(d_model=64, n_layer=2, attn_mlp_d_intermediate=128,
                                     attn_cfg=tcfg._freeze({"num_heads": 4, "num_heads_kv": 2})),
        prefix_conditioner=tcfg.PrefixConditionerConfig.from_dict(
            {"projection": "linear",
             "conditioners": [{"type": "EspeakPhonemeConditioner", "name": "espeak"}]}))
    tiny = ZonosPipeline.from_config(
        cfg, device="cpu", dtype=torch.float32,
        dac_config=DACConfig(encoder_hidden_size=8, downsampling_ratios=(2, 4),
                             decoder_hidden_size=32, n_codebooks=9, codebook_size=1024,
                             codebook_dim=4))
    state = {"ok": True}
    real_call = Heartbeat._device_call
    monkeypatch.setattr(Heartbeat, "_device_call",
                        lambda self: real_call(self) if state["ok"] else 0)
    monkeypatch.setattr(ZonosPipeline, "from_config", classmethod(lambda cls, *a, **k: tiny))
    built = []
    monkeypatch.setattr(tserver.TTSServer, "serve_forever", lambda self: built.append(self))
    tserver.main(["--device", "cpu", "--host", "127.0.0.1", "--port", "0",
                  "--heartbeat-interval-s", "1"])
    (srv,) = built
    assert isinstance(srv.monitor, multihost.HeartbeatMonitor)
    srv.start_background()
    try:
        url = f"http://127.0.0.1:{srv.port}/healthz"
        with urllib.request.urlopen(url, timeout=10) as r:
            assert r.status == 200
        state["ok"] = False
        deadline = time.monotonic() + 10.0
        while srv.monitor.healthy and time.monotonic() < deadline:
            time.sleep(0.05)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url, timeout=10)
        assert e.value.code == 503
    finally:
        srv.monitor.stop()
        srv.shutdown()
