"""Multi-process runtime: process-group start-up, liveness by heartbeat, and
replay of work in flight (the JAX package's ``parallel/multihost.py``).

* :func:`initialize_runtime`: ``torch.distributed.init_process_group`` when
  launched as several processes (``torchrun``'s ``MASTER_ADDR``,
  ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``, or explicit arguments); a
  no-op for one process. The backend is the caller's: NCCL when each rank
  owns a card, gloo on the CPU or for ranks sharing a card.
* :class:`Heartbeat`: liveness as a collective. An all-reduce of ones over
  the group must return the world size within a deadline; a hung or lost
  rank stalls it, so the probe fails exactly when real collectives would.
* :class:`HeartbeatMonitor`: a daemon thread probing every ``interval_s``;
  it flips ``healthy`` and calls ``on_failure`` once on the first failure.
  The server answers ``/healthz`` with 503 while it is unhealthy.
* :class:`ReplayBuffer`: requests checked out by a generation step; after a
  failure the ones never acknowledged are handed back, oldest first, for
  re-dispatch (inference recovers by reload and replay).
"""

from __future__ import annotations

import datetime
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 120.0


def initialize_runtime(init_method: str | None = None, world_size: int | None = None,
                       rank: int | None = None, *, backend: str = "nccl",
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the process group if this is one of several processes; returns
    True when it runs multi-process.

    Resolution: explicit arguments, then ``torchrun``'s environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); one process
    (no world size above 1) is a no-op. ``timeout_s`` bounds every
    collective (gloo's default is 30 minutes)."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world_size <= 1:
        return False
    if rank is None:
        rank = int(os.environ["RANK"])
    if init_method is None:
        init_method = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    kwargs: dict[str, Any] = {}
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return True


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


# ---------------------------------------------------------------------------
# Heartbeat: liveness as a collective
# ---------------------------------------------------------------------------

class Heartbeat:
    """One-collective liveness probe over a process group.

    ``probe()`` all-reduces a one (a CPU tensor) from every rank and checks
    the sum is the world size. Every rank must probe, in the same order.
    The group is the heartbeat's own: a new gloo group over every rank of
    the initialised process group (every rank constructs its ``Heartbeat``
    together), kept apart from the groups that serve requests; without a
    process group, a one-rank gloo group of this process alone.

    The collective runs on ONE persistent daemon worker, not a thread per
    probe: while a probe is wedged on a stalled collective, later
    ``probe()`` calls return False at once without stacking threads behind
    it; the worker serves probes again if the wedged call ever completes,
    and its stale result is discarded."""

    def __init__(self, timeout_s: float = 10.0):
        if dist.is_initialized():
            self.group = dist.new_group(backend="gloo")
        else:
            self.group = dist.ProcessGroupGloo(
                dist.HashStore(), 0, 1, datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
        self.timeout_s = timeout_s
        self.world = self.group.size()
        self._req: queue.Queue[None] = queue.Queue()
        self._resp: queue.Queue[int | None] = queue.Queue()
        self._inflight = 0  # submitted minus consumed or discarded responses
        self._worker = threading.Thread(target=self._serve, daemon=True)
        self._worker.start()

    def _device_call(self) -> int:
        """The blocking collective; replaced in tests to stall it."""
        ones = torch.ones(1, dtype=torch.int32)
        dist.all_reduce(ones, group=self.group)
        return int(ones.item())

    def _serve(self):
        while True:
            self._req.get()
            try:
                val: int | None = self._device_call()
            except Exception:  # noqa: BLE001 (a failed collective is an unhealthy probe)
                val = None
            self._resp.put(val)

    def probe(self) -> bool:
        """True iff the collective completed in time over the whole group."""
        while self._inflight:  # discard the results of probes that timed out
            try:
                self._resp.get_nowait()
                self._inflight -= 1
            except queue.Empty:
                break
        if self._inflight:
            # A probe is still wedged: unhealthy, and nothing more is queued
            # behind it.
            return False
        self._req.put(None)
        self._inflight += 1
        try:
            val = self._resp.get(timeout=self.timeout_s)
        except queue.Empty:
            return False
        self._inflight -= 1
        return val == self.world


class HeartbeatMonitor:
    """Daemon thread probing liveness every ``interval_s``; sets ``healthy``
    and calls ``on_failure(reason)`` once on the first failed probe.
    ``probe_fn`` is a :class:`Heartbeat`'s ``probe`` or any check."""

    def __init__(self, probe_fn: Callable[[], bool], interval_s: float = 5.0,
                 on_failure: Callable[[str], None] | None = None):
        self.probe_fn = probe_fn
        self.interval_s = interval_s
        self.on_failure = on_failure
        self.healthy = True
        self.last_probe_at: float | None = None
        self.probes_total = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self._thread.join(self.interval_s + 1.0)

    def _loop(self):
        while not self._stop.is_set():
            try:
                ok = self.probe_fn()
            except Exception:  # noqa: BLE001 (a failing probe means unhealthy)
                ok = False
            self.probes_total += 1
            self.last_probe_at = time.monotonic()
            if not ok and self.healthy:
                self.healthy = False
                if self.on_failure is not None:
                    self.on_failure("heartbeat probe failed")
            elif ok:
                self.healthy = True
            self._stop.wait(self.interval_s)


# ---------------------------------------------------------------------------
# Replay: inference recovers by reload and replay
# ---------------------------------------------------------------------------

@dataclass
class _InFlight:
    token: int
    payload: Any
    checked_out_at: float = field(default_factory=time.monotonic)


class ReplayBuffer:
    """Work between dispatch and completion.

    ``checkout(payload) -> token`` before a generation step, ``ack(token)``
    once its results are safely returned; after a failure ``drain()`` hands
    back every payload not acknowledged, oldest first. Thread-safe: the
    server's worker and the heartbeat monitor may use it together."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next = 0
        self._inflight: dict[int, _InFlight] = {}
        self.replayed_total = 0

    def checkout(self, payload: Any) -> int:
        with self._lock:
            token = self._next
            self._next += 1
            self._inflight[token] = _InFlight(token, payload)
            return token

    def ack(self, token: int) -> None:
        with self._lock:
            self._inflight.pop(token, None)

    def pending(self) -> int:
        with self._lock:
            return len(self._inflight)

    def drain(self) -> list[Any]:
        with self._lock:
            items = sorted(self._inflight.values(), key=lambda x: x.token)
            self._inflight.clear()
            self.replayed_total += len(items)
            return [i.payload for i in items]
