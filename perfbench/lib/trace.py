"""The traced stretch: one ``torch.profiler`` session (CPU and CUDA
activities) over one whole round of the server's worker: started at the
first advance of the given kind (a pool segment where the cell pools, a
stream job's segment where it does not) at or after ``start_at``, and
stopped, the device synchronised, at the first advance of that kind at
least ``min_s`` later, so the stretch holds every job's segment of a round
(or after the run, when none comes). Only sums and interval unions are kept: device time
by kernel name, the union of the device's busy intervals, and the idle gaps
between them with the program's own phase annotation (``utils/tracing``'s
``record_function`` ranges) that the host was inside.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

START, STOP = "perfbench.stretch_start", "perfbench.stretch_stop"


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")() * 1000)


def _annotation(e) -> bool:
    f = getattr(e, "is_user_annotation", None)
    if f is not None and f():
        return True
    kind = getattr(e, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


def warm() -> None:
    """One short session at set-up: a process's first session can miss
    kernels while CUPTI starts."""
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act):
        torch.ones(1 << 16, device="cuda").sum().item()


class Stretch:
    def __init__(self, start_at: float, min_s: float, kind: str):
        self.start_at, self.min_s, self.kind = start_at, min_s, kind
        self.prof = None
        self.t0 = self.t1 = None
        self.result: dict | None = None
        self.error: str | None = None
        self._stopped = None
        self.done = False
        self.stop_s = self.reduce_s = 0.0

    def before_advance(self, kind: str) -> None:
        """Called by the worker before each advance of a job of ``kind``
        (``pool`` or ``stream``); never lets a profiler fault reach the
        server's job (it is reported and the stretch ends)."""
        if kind != self.kind:
            return
        try:
            self._step()
        except Exception:  # noqa: BLE001 (boundary: the served path must go on)
            import traceback

            self.error = traceback.format_exc()[-3000:]
            self.prof = None
            self.result = self.result or {"busy_s": 0.0, "window_s": 0.0, "by_kernel": {},
                                          "idle": {}, "kernels": 0}

    def _step(self) -> None:
        now = time.monotonic()
        if self.prof is None and not self.done and now >= self.start_at:
            act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self.prof = torch.profiler.profile(activities=act)
            self.prof.start()
            with torch.profiler.record_function(START):
                pass
            self.t0 = time.monotonic()
        elif self.prof is not None and now >= self.t0 + self.min_s:
            self.stop()

    def stop(self) -> None:
        """End the session (on the worker, at an advance): the device
        synchronised, the stop marker, the profiler stopped. Its events are
        reduced later, off the served path, by :meth:`finish`."""
        if self.prof is None:
            return
        torch.cuda.synchronize()
        self.t1 = time.monotonic()
        with torch.profiler.record_function(STOP):
            pass
        prof, self.prof = self.prof, None
        self.done = True  # one session a run
        prof.stop()
        self.stop_s = time.monotonic() - self.t1
        self._stopped = prof

    def finish(self) -> None:
        """After the window: stop the session if no advance came to stop
        it (the profiler's state belongs to the thread that started it, so
        this can fail, and is reported), and reduce its events."""
        try:
            self.stop()
        except RuntimeError:
            import traceback

            self.error = traceback.format_exc()[-3000:]
        prof, self._stopped = self._stopped, None
        if prof is not None and self.result is None:
            t = time.monotonic()
            self.result = reduce(prof)
            self.reduce_s = time.monotonic() - t

    @property
    def host_span(self) -> tuple[float, float] | None:
        return None if self.t0 is None or self.t1 is None else (self.t0, self.t1)


def reduce(prof) -> dict:
    """Sums over the stretch between the start and stop markers: device
    seconds by kernel name, busy seconds (the union of device intervals),
    the stretch's length, and the idle gaps named by the program phase the
    host was in at each gap's middle (``host: none`` outside every phase)."""
    events = prof.profiler.kineto_results.events()
    dev, phases = [], []
    lo = hi = None
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if _annotation(e):  # a program phase drawn on the device's row, not an operation
                continue
            s = _ns(e, "start")
            dev.append((s, s + _ns(e, "duration"), name))
        elif name == START:
            lo = _ns(e, "start")
        elif name == STOP:
            hi = _ns(e, "start")
        elif not name.startswith(("aten::", "cuda", "cu", "void", "Memcpy", "Memset")):
            s = _ns(e, "start")
            phases.append((s, s + _ns(e, "duration"), name))
    if lo is None or hi is None or hi <= lo:
        return {"busy_s": 0.0, "window_s": 0.0, "by_kernel": {}, "idle": {}, "kernels": 0}
    by_kernel: dict[str, float] = defaultdict(float)
    spans = []
    for s, t, name in dev:
        s, t = max(s, lo), min(t, hi)
        if t > s:
            by_kernel[name] += (t - s) / 1e9
            spans.append((s, t))
    spans.sort()
    busy, gaps, cur_s, cur_t = 0, [], None, None
    prev_end = lo
    for s, t in spans:
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy += cur_t - cur_s
            if s > prev_end:
                gaps.append((prev_end, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
        prev_end = max(prev_end, t)
    if cur_t is not None:
        busy += cur_t - cur_s
    if hi > prev_end:
        gaps.append((prev_end, hi))
    phases.sort()
    idle: dict[str, float] = defaultdict(float)
    for a, b in gaps:
        if b - a < 20_000:  # under 20 us: the launch gaps inside a step
            idle["between kernels (< 20 us)"] += (b - a) / 1e9
            continue
        mid = (a + b) // 2
        inside = [p for p in phases if p[0] <= mid < p[1]]
        label = min(inside, key=lambda p: p[1] - p[0])[2] if inside else "none"
        idle[f"host: {label}"] += (b - a) / 1e9
    return {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9, "by_kernel": dict(by_kernel),
            "idle": dict(idle), "kernels": len(spans)}


def kernel_seconds(result: dict | None, match) -> float | None:
    """Device seconds of the kernels whose names ``match`` accepts; None
    when none ran in the stretch."""
    if not result:
        return None
    hits = [v for k, v in result["by_kernel"].items() if match(k)]
    return sum(hits) if hits else None
