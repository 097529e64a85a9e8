"""Phase timers, counters and structured logs (the JAX package's
``utils/tracing.py``).

* ``phase(name)``: a context manager timing a pipeline phase into a
  process-global registry (phonemize, conditioning, generate, vocode, ...),
  also marked as a ``torch.profiler.record_function`` range so it shows in
  a profiler trace.
* ``start_trace(logdir)`` / ``stop_trace()``: a ``torch.profiler`` capture
  of the CPU and the card, written as a Chrome trace into ``logdir``.
* ``rtf_report()``: audio seconds against compute seconds, per phase.
* ``log_event``: one JSON line per event on stderr.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from collections import defaultdict

import torch

_LOCK = threading.Lock()
_TIMINGS: dict[str, list[float]] = defaultdict(list)
_COUNTERS: dict[str, float] = defaultdict(float)
_PROFILER = {"prof": None, "logdir": None}


@contextlib.contextmanager
def phase(name: str, annotate_trace: bool = True):
    """Time a pipeline phase; nest freely."""
    ctx = (torch.profiler.record_function(name) if annotate_trace
           else contextlib.nullcontext())
    t0 = time.perf_counter()
    with ctx:
        yield
    dt = time.perf_counter() - t0
    with _LOCK:
        _TIMINGS[name].append(dt)


def add_counter(name: str, value: float) -> None:
    with _LOCK:
        _COUNTERS[name] += value


def timings_snapshot() -> dict:
    with _LOCK:
        return {
            name: {
                "count": len(v),
                "total_s": round(sum(v), 4),
                "mean_s": round(sum(v) / len(v), 4) if v else 0.0,
                "last_s": round(v[-1], 4) if v else 0.0,
            }
            for name, v in _TIMINGS.items()
        }


def counters_snapshot() -> dict:
    with _LOCK:
        return dict(_COUNTERS)


def rtf_report() -> dict:
    """Audio-seconds per compute-second, overall and per phase."""
    snap = timings_snapshot()
    audio_s = counters_snapshot().get("audio_seconds", 0.0)
    compute_s = sum(p["total_s"] for p in snap.values())
    return {
        "audio_seconds": round(audio_s, 3),
        "compute_seconds": round(compute_s, 3),
        "rtf": round(audio_s / compute_s, 3) if compute_s else 0.0,
        "phases": snap,
    }


def reset() -> None:
    with _LOCK:
        _TIMINGS.clear()
        _COUNTERS.clear()


def log_event(event: str, **fields) -> None:
    """One JSON line per event to stderr (structured logging)."""
    rec = {"ts": round(time.time(), 3), "event": event, **fields}
    print(json.dumps(rec), file=sys.stderr, flush=True)


def start_trace(logdir: str) -> None:
    """Start a ``torch.profiler`` capture of the CPU and, when there is
    one, the card; :func:`stop_trace` writes it to ``logdir``."""
    if _PROFILER["prof"] is not None:
        raise RuntimeError("a trace is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _PROFILER.update(prof=prof, logdir=logdir)


def stop_trace() -> str:
    """Stop the capture and write ``trace.json`` (Chrome trace format) into
    the ``logdir`` given to :func:`start_trace`; returns its path."""
    prof, logdir = _PROFILER["prof"], _PROFILER["logdir"]
    if prof is None:
        raise RuntimeError("no trace is running")
    _PROFILER.update(prof=None, logdir=None)
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    return path
