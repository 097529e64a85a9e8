"""Spans, phase timers, counters and structured logs (the JAX package's
``utils/tracing.py``, grown into a span recorder).

* ``span(name, rid=None, device=False, **attrs)``: a context manager that
  records one span: its name and id, its parent's id (the span open on the
  same thread, or ``parent=``), the request id (``rid``, else the
  parent's), host start and end on ``time.monotonic_ns()`` and its
  attributes. It is also a ``torch.profiler.record_function`` range of the
  same name. ``device`` (``True`` or the work's ``torch.device``) also
  records a CUDA event on the current stream at entry and at exit; the
  device duration is resolved from them without a device read of its own
  (when the spans are read, or once an event is seen done), and is
  ``None`` on the CPU. ``begin(...)``/``Span.end()`` make a span that
  crosses threads (no profiler range); ``mark(name, **attrs)`` records an
  instant under the open span.
* Spans are off by default: ``enable()``/``disable()`` switch them, and
  they are also on while a ``torch.profiler`` session runs in the process
  (its ranges then carry the spans, and the spans lie over its trace).
  While off, ``span()`` checks two flags and returns a shared no-op:
  nothing is recorded and no CUDA event is made. Closed spans stay in a
  bounded buffer; ``spans(t0_ns, t1_ns)`` reads them (from any thread).
* ``to_trace_clock(ns)``: a monotonic time on the profiler's clock (the
  Unix epoch), from an offset measured at import and at ``enable()``.
* ``phase(name)``: a span that also times the phase into the process-wide
  registry that ``/metrics`` serves as ``phases`` (always on).
* ``count(name, n=1)``: counters, always on (``/metrics``' ``counters``).
* ``log_event``: one JSON line per event on stderr.
"""

from __future__ import annotations

import itertools
import json
import sys
import threading
import time
from collections import deque

import torch
import torch.autograd.profiler as _profiler

MAX_SPANS = 200_000  # closed spans kept, oldest dropped first
_RESOLVE_EVERY = 256  # device spans closed between sweeps of the finished events

_LOCK = threading.Lock()
_RESOLVE_LOCK = threading.Lock()  # one thread at a time drains _PENDING
_TIMINGS: dict[str, list] = {}  # name -> [count, total s, last s]
_COUNTERS: dict[str, int] = {}
_BUFFER: deque = deque(maxlen=MAX_SPANS)
_PENDING: deque = deque()  # closed spans whose device duration is not resolved yet
_IDS = itertools.count(1)
_DEVICE_SPANS = itertools.count(1)
_TLS = threading.local()
_on = False
_clock = {"offset_ns": 0}


def _measure_offset() -> None:
    """``time.time_ns() - time.monotonic_ns()``, from the tightest of a
    few bracketed readings."""
    best = None
    for _ in range(5):
        m0 = time.monotonic_ns()
        t = time.time_ns()
        m1 = time.monotonic_ns()
        if best is None or m1 - m0 < best[0]:
            best = (m1 - m0, t - (m0 + m1) // 2)
    _clock["offset_ns"] = best[1]


_measure_offset()


def to_trace_clock(ns: int) -> int:
    """A ``time.monotonic_ns()`` reading on the profiler's clock."""
    return ns + _clock["offset_ns"]


def enable() -> None:
    global _on
    _measure_offset()
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    """Whether spans were switched on by :func:`enable` (a running
    profiler session turns them on besides)."""
    return _on


def _stack() -> list:
    s = getattr(_TLS, "stack", None)
    if s is None:
        s = _TLS.stack = []
    return s


class Span:
    __slots__ = ("name", "id", "parent", "rid", "t0", "t1", "attrs", "device", "device_ms",
                 "_dev", "_ev", "_rf")

    def __init__(self, name: str, rid, device, parent, attrs: dict):
        if parent is None or parent is NOOP:
            stack = _stack()
            parent = stack[-1] if stack else None
        self.name, self.id, self.attrs = name, next(_IDS), attrs
        self.parent = parent.id if parent is not None else None
        self.rid = rid if rid is not None else (parent.rid if parent is not None else None)
        self.t0 = self.t1 = None
        self.device = device is not None and device is not False
        self.device_ms = None
        self._dev = device
        self._ev = self._rf = None

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def _start(self) -> None:
        self.t0 = time.monotonic_ns()
        dev = self._dev
        if self.device and getattr(dev, "type", "cuda") == "cuda" and (
                torch.cuda.is_available() and not torch.cuda.is_current_stream_capturing()):
            stream = torch.cuda.current_stream(dev if dev is not True else None)
            self._ev = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
            self._ev[0].record(stream)
            self._dev = stream

    def _stop(self) -> None:
        self.t1 = time.monotonic_ns()
        if self._ev is not None:
            self._ev[1].record(self._dev)
        self._dev = None
        _BUFFER.append(self)
        if self._ev is not None:
            _PENDING.append(self)
            if next(_DEVICE_SPANS) % _RESOLVE_EVERY == 0:
                _resolve()

    def end(self, **attrs) -> None:
        """Close a span made by :func:`begin` (on any thread)."""
        if self.t1 is None:
            self.attrs.update(attrs)
            self._stop()

    def __enter__(self) -> "Span":
        _stack().append(self)
        self._rf = _profiler.record_function(self.name)
        self._rf.__enter__()
        self._start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._stop()
        self._rf.__exit__(exc_type, exc, tb)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()

    def record(self) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent, "rid": self.rid,
                "t0": self.t0, "t1": self.t1, "device": self.device, "device_ms": self.device_ms,
                "attrs": dict(self.attrs)}


class _Noop:
    """What :func:`span` and :func:`begin` give while spans are off."""

    __slots__ = ()
    id = rid = None

    def set(self, **attrs) -> None:
        pass

    def end(self, **attrs) -> None:
        pass

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc) -> None:
        pass


NOOP = _Noop()


def _recording() -> bool:
    """Whether spans record now."""
    return _on or getattr(_profiler, "_is_profiler_enabled", False)


def span(name: str, rid=None, device=False, parent=None, **attrs):
    """A span (module docstring) to use as a context manager; its value has
    ``set(**attrs)``."""
    if not (_on or getattr(_profiler, "_is_profiler_enabled", False)):
        return NOOP
    return Span(name, rid, device, parent, attrs)


def begin(name: str, rid=None, parent=None, **attrs):
    """A started span that any thread may close with ``end(**attrs)``; it
    opens no profiler range and takes no device events."""
    if not _recording():
        return NOOP
    sp = Span(name, rid, None, parent, attrs)
    sp._start()
    return sp


def mark(name: str, rid=None, **attrs) -> None:
    """An instant record under the span open on this thread."""
    if not _recording():
        return
    sp = Span(name, rid, None, None, attrs)
    sp.t0 = sp.t1 = time.monotonic_ns()
    _BUFFER.append(sp)


def _resolve() -> None:
    """Device durations of the closed spans whose exit event has
    completed (``query`` reads no value back and waits for nothing). The
    worker closing spans and a reader calling :func:`spans` may both get
    here: one drains at a time."""
    with _RESOLVE_LOCK:
        for _ in range(len(_PENDING)):
            sp = _PENDING.popleft()
            ev = sp._ev
            if ev is None:
                continue
            if ev[1].query():
                sp.device_ms = ev[0].elapsed_time(ev[1])
                sp._ev = None
            else:
                _PENDING.append(sp)


def spans(t0_ns: int | None = None, t1_ns: int | None = None) -> list[dict]:
    """The closed spans that overlap ``[t0_ns, t1_ns)`` (monotonic), as
    dicts: ``name``, ``id``, ``parent``, ``rid``, ``t0``, ``t1`` (ns),
    ``device`` (device time was asked for), ``device_ms`` (None on the CPU,
    or while the device has not reached the exit event) and ``attrs``."""
    _resolve()
    lo = -1 if t0_ns is None else t0_ns
    hi = float("inf") if t1_ns is None else t1_ns
    return [sp.record() for sp in list(_BUFFER) if sp.t1 >= lo and sp.t0 < hi]


class _Phase:
    __slots__ = ("name", "sp", "t0")

    def __init__(self, name: str, sp):
        self.name, self.sp = name, sp

    def __enter__(self):
        self.sp.__enter__()
        self.t0 = time.perf_counter()
        return self.sp

    def __exit__(self, exc_type, exc, tb) -> None:
        dt = time.perf_counter() - self.t0
        self.sp.__exit__(exc_type, exc, tb)
        with _LOCK:
            agg = _TIMINGS.setdefault(self.name, [0, 0.0, 0.0])
            agg[0] += 1
            agg[1] += dt
            agg[2] = dt


def phase(name: str, device=False, **attrs) -> _Phase:
    """A span that also times the phase into the ``phases`` registry;
    nest freely."""
    return _Phase(name, span(name, device=device, **attrs))


def count(name: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def timings_snapshot() -> dict:
    with _LOCK:
        return {
            name: {
                "count": c,
                "total_s": round(total, 4),
                "mean_s": round(total / c, 4) if c else 0.0,
                "last_s": round(last, 4),
            }
            for name, (c, total, last) in _TIMINGS.items()
        }


def counters_snapshot() -> dict:
    with _LOCK:
        return dict(_COUNTERS)


def reset() -> None:
    """Clear the phases, the counters and the recorded spans."""
    with _LOCK:
        _TIMINGS.clear()
        _COUNTERS.clear()
    _BUFFER.clear()
    with _RESOLVE_LOCK:
        _PENDING.clear()


def log_event(event: str, **fields) -> None:
    """One JSON line per event to stderr (structured logging)."""
    rec = {"ts": round(time.time(), 3), "event": event, **fields}
    print(json.dumps(rec), file=sys.stderr, flush=True)
