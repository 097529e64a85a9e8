"""What the harness observes inside the served process, without editing a
file of the program: wrappers installed around a few of its functions for
the length of a run.

* ``utils/tracing.log_event``: every structured event the server logs
  (``pool_admit``, ``pool_segment``, ...), kept with the monotonic time it
  was logged at, then passed on unchanged;
* the request a worker-thread call serves (``_PoolJob.admit``,
  ``_StreamJob.advance``): the payload's ``request_id``;
* the phoneme ids each request's conditioning was built from
  (``pipe.prepare_conditioning``), and the codes each request was served
  (a pool row's delayed codes and step when it finishes,
  ``_PoolJob._finish_row``; a stream job's last result,
  ``DecodeEngine.generate_stream``): device tensors, read after the window;
* the decode steps run (``StepGraph.run``: rows, and where each row's
  cache stood, from the pool's joins, releases and segments), and every
  prefill (``_prefill_state``), on the host clock;
* a ``torch.profiler`` session over whole advances of the worker near the
  window's end, when the run is traced (``perfbench/lib/trace.py``).
"""

from __future__ import annotations

import functools
import threading
import time


class Observer:
    def __init__(self):
        self.lock = threading.Lock()
        self.tls = threading.local()
        self.events: list[tuple] = []  # (t, name, fields)
        self.phonemes: dict[str, object] = {}  # rid -> [1, L] ids (device)
        self.codes: dict[str, dict] = {}  # rid -> {"delayed" | "codes": tensor, ...}
        self.steps: list[dict] = []  # one per StepGraph.run
        self.prefills: list[tuple] = []  # (t, rows, positions, cache length)
        self.slots: dict[int, list] = {}  # pool slot -> [position, flush base]
        self.profiler = None  # perfbench.lib.trace.Stretch, when traced
        self.failures: list[str] = []  # tracebacks of the jobs the server failed
        self._undo: list = []

    # -- installation ------------------------------------------------------

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self._undo.append((owner, name, orig))

    def install(self, pipe) -> None:
        from zonos_vibes_tpu_torch.engine import generate as gmod
        from zonos_vibes_tpu_torch.engine import graphs as grmod
        from zonos_vibes_tpu_torch.engine import pool as pmod
        from zonos_vibes_tpu_torch.serve import server as smod
        from zonos_vibes_tpu_torch.utils import tracing as tmod

        obs = self

        def log_event(orig):
            @functools.wraps(orig)
            def f(event, **fields):
                with obs.lock:
                    obs.events.append((time.monotonic(), event, fields))
                return orig(event, **fields)
            return f

        def with_rid(get_rid, advance=None):
            def make(orig):
                @functools.wraps(orig)
                def f(self, *a, **kw):
                    prev = getattr(obs.tls, "rid", None)
                    obs.tls.rid = get_rid(self, *a)
                    if advance and obs.profiler is not None:
                        obs.profiler.before_advance(advance)
                    try:
                        return orig(self, *a, **kw)
                    finally:
                        obs.tls.rid = prev
                return f
            return make

        def rid_of(req):
            return req.payload.get("request_id")

        def prepare(orig):
            @functools.wraps(orig)
            def f(cond_dict, *a, **kw):
                rid = getattr(obs.tls, "rid", None)
                if rid is not None:
                    obs.phonemes[rid] = cond_dict["espeak"]
                return orig(cond_dict, *a, **kw)
            return f

        def finish_row(orig):
            @functools.wraps(orig)
            def f(self, slot, *a, **kw):
                row = self.rows.get(slot)
                if row is not None:
                    obs.codes[rid_of(row["req"])] = {
                        "delayed": self.pool["delayed"][slot].clone(),
                        "step": self.pool["step"][slot].clone()}
                return orig(self, slot, *a, **kw)
            return f

        def gen_stream(orig):
            @functools.wraps(orig)
            def f(self, *a, **kw):
                it = orig(self, *a, **kw)
                try:
                    for res in it:
                        rid = getattr(obs.tls, "rid", None)
                        if rid is not None:
                            obs.codes[rid] = {"codes": res.codes[0], "valid": res.valid_length}
                        yield res
                finally:
                    it.close()
            return f

        def step_run(orig):
            @functools.wraps(orig)
            def f(self, n):
                rec = obs._step_shape(self.step)
                t0 = time.monotonic()
                out = orig(self, n)
                rec.update(t0=t0, t1=time.monotonic(), n=n)
                if rec["kind"] == "pool":
                    obs.advance_slots(n)
                with obs.lock:
                    obs.steps.append(rec)
                return out
            return f

        def pool_steps(orig):
            @functools.wraps(orig)
            def f(model, params, pool, base_seed, n_steps):
                for s in obs.slots.values():
                    s[1] = s[0]  # the previous segment's flush made the ring empty
                return orig(model, params, pool, base_seed, n_steps)
            return f

        def join(orig):
            @functools.wraps(orig)
            def f(pool, req_state, slot, cond_len, *a, **kw):
                pos = int(cond_len) + int(req_state.offset)
                obs.slots[int(slot)] = [pos, pos]
                return orig(pool, req_state, slot, cond_len, *a, **kw)
            return f

        def release(orig):
            @functools.wraps(orig)
            def f(pool, slot, *a, **kw):
                obs.slots.pop(int(slot), None)
                return orig(pool, slot, *a, **kw)
            return f

        def prefill(orig):
            @functools.wraps(orig)
            def f(model, params, prefix_conditioning, audio_prefix_codes, *a, **kw):
                two_b, cond_len = prefix_conditioning.shape[:2]
                with obs.lock:
                    obs.prefills.append((time.monotonic(), int(two_b),
                                         int(cond_len + audio_prefix_codes.shape[-1] + 1)))
                return orig(model, params, prefix_conditioning, audio_prefix_codes, *a, **kw)
            return f

        def failed(orig):
            @functools.wraps(orig)
            def f(self, e, *a, **kw):
                import traceback

                obs.failures.append("".join(traceback.format_exception(e))[-3000:])
                return orig(self, e, *a, **kw)
            return f

        self._patch(tmod, "log_event", log_event)
        self._patch(smod._PoolJob, "fail", failed)
        self._patch(smod._StreamJob, "fail", failed)
        self._patch(smod._PoolJob, "admit", with_rid(lambda self, req, *a: rid_of(req)))
        self._patch(smod._PoolJob, "advance", with_rid(lambda self: None, "pool"))
        self._patch(smod._StreamJob, "advance", with_rid(lambda self: rid_of(self.req), "stream"))
        self._patch(smod._PoolJob, "_finish_row", finish_row)
        self._patch(gmod.DecodeEngine, "generate_stream", gen_stream)
        self._patch(grmod.StepGraph, "run", step_run)
        self._patch(pmod, "pool_steps", pool_steps)
        self._patch(pmod, "join", join)
        self._patch(pmod, "release_row", release)
        self._patch(gmod, "_prefill_state", prefill)
        self._patch(pmod, "_prefill_state", prefill)
        pipe.prepare_conditioning = prepare(pipe.prepare_conditioning)

    def uninstall(self) -> None:
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()

    # -- the steps' shapes ---------------------------------------------------

    def _step_shape(self, step) -> dict:
        """Rows of a decode step (CFG rows included) and, per request, where
        its cache stands at the first of the steps: ``(position, ring
        length)`` for the pool's joined slots (the ring holds the positions
        since the last flush), ``(position, 0)`` for a solo step. Taken from
        the step's own arguments."""
        args = getattr(step, "args", ())
        if len(args) >= 3 and isinstance(args[2], dict) and "delayed" in args[2]:
            rows = [(p, p - b) for p, b in self.slots.values()]
            return {"kind": "pool", "rows": 2 * args[2]["delayed"].shape[0], "active": rows}
        s = args[2] if len(args) >= 3 else None
        if s is not None and hasattr(s, "delayed"):
            cond_len = args[3]
            return {"kind": "solo", "rows": 2 * s.delayed.shape[0],
                    "active": [(int(cond_len) + int(s.offset), 0)] * s.delayed.shape[0]}
        return {"kind": "other", "rows": 0, "active": []}

    def advance_slots(self, n: int) -> None:
        for s in self.slots.values():
            s[0] += n

    # -- after the run ---------------------------------------------------------

    def events_named(self, name: str, t0: float, t1: float) -> list[dict]:
        return [f for t, e, f in self.events if e == name and t0 <= t < t1]
