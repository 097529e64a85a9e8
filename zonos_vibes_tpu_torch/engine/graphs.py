"""CUDA graphs over one decode step: the port's counterpart of ``jax.jit``
over the JAX package's decode loop.

:class:`StepGraph` runs a step function ``n`` times. The function takes no
argument and reads and writes, in place, only tensors that outlive it (the
decode state, the cache, the parameters), so one capture of it serves every
later step. On the card:

* the first step runs eagerly on a side stream. That grows the cuBLAS
  handles and the kernels' per-device workspaces
  (``ops/cuda/decode_attention._workspace``, ``ops/cuda/mamba_step._workspace``,
  ``ops/cuda/qmm._counters``) to the step's shapes, so nothing grows
  during the capture;
* the next step is captured on that stream (a capture runs nothing) and
  replayed, and so is every step after it, on the current stream;
* a capture or replay that fails raises: nothing falls back to the eager
  step.

The kernels' ctypes wrappers launch on ``torch.cuda.current_stream``, which
is the capture stream during a capture, and those launched with
programmatic dependent launch (``qmm_int8`` at M <= 2, the Mamba step) keep
their programmatic edge in the graph (CUDA 12.3 or later). A step that
draws from a ``torch.Generator`` of the card has it registered with the
graph, so each replay draws what the eager step would.

Launch counts: a wrapper counts its launch in ``build.LAUNCHES`` when it is
called, which during a capture launches nothing and during a replay does not
happen. So the counts a capture adds are taken back out and kept as
:attr:`StepGraph.step_launches`, and each replay adds them once: the
counters keep counting the kernels that ran.
"""

from __future__ import annotations

import time

import torch

from ..ops.cuda import build, decode_attention, mamba_step, qmm


def _workspaces() -> tuple:
    """Every per-device workspace the kernels' wrappers hold now. A graph
    keeps the ones it captured alive: a later call at larger shapes replaces
    a module's buffer, and the graph's copy of the old pointer must stay
    valid (the buffers' tickets and counters reset themselves after every
    launch, so two buffers serve as well as one)."""
    return (tuple(decode_attention._WORKSPACES.values()),
            tuple(mamba_step._WORKSPACES.values()), tuple(qmm._COUNTERS.values()))


class StepGraph:
    """``step`` run eagerly (``enabled=False``, and always on the CPU) or
    through one captured CUDA graph. ``generator`` is the card's
    ``torch.Generator`` the step draws from, if any."""

    def __init__(self, step, device: torch.device, enabled: bool,
                 generator: torch.Generator | None = None):
        if enabled and device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}: pass "
                             f"cuda_graphs=False (or leave it unset) on the CPU")
        self.step = step
        self.device = device
        self.enabled = enabled
        self.generator = generator
        self.stream = None
        self.graph = None
        self.replays = 0  # steps run by replaying the graph
        self.capture_seconds = 0.0  # host time of the capture, instantiation included
        self.step_launches: dict[str, int] = {}  # kernel launches in one replay
        self._pinned = ()

    def run(self, n: int) -> None:
        """Run ``n`` steps on the current stream, in order."""
        if not self.enabled:
            for _ in range(n):
                self.step()
            return
        if n > 0 and self.stream is None:
            self._warm_up()
            n -= 1
        if n > 0 and self.graph is None:
            self._capture()
        for _ in range(n):
            self.graph.replay()
        self.replays += n
        for name, count in self.step_launches.items():
            build.LAUNCHES[name] += count * n

    def _warm_up(self) -> None:
        current = torch.cuda.current_stream(self.device)
        self.stream = torch.cuda.Stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            self.step()
        current.wait_stream(self.stream)

    def _capture(self) -> None:
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        gen = self.generator
        if gen is not None and gen.device.type == "cuda" and (
                gen not in torch.cuda.default_generators):  # a default one registers itself
            graph.register_generator_state(gen)
        before = dict(build.LAUNCHES)
        try:
            with torch.cuda.graph(graph, stream=self.stream):
                self.step()
        finally:
            captured = {name: build.LAUNCHES[name] - n for name, n in before.items()}
            build.LAUNCHES.update(before)
        self.step_launches = {name: n for name, n in captured.items() if n}
        self._pinned = _workspaces()
        self.graph = graph
        self.capture_seconds = time.perf_counter() - t0
