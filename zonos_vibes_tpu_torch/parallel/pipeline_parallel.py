"""Generic pipeline-parallel stage runner (the JAX package's
``parallel/pipeline_parallel.py``): GPipe-style microbatching.

A stack of stages is cut over the ranks of one group: rank ``r`` holds stage
``r``'s parameters, and microbatches flow rank to rank along an open chain.
The standard inference schedule: ``n_micro + n - 1`` ticks, at tick ``t``
rank ``r`` works on microbatch ``t - r`` when there is one (the fill and
drain bubbles). JAX runs every rank through every tick under ``shard_map``
and masks the idle ones; here a rank just skips them, and the blocking
receive is the tick's synchronisation. The last rank's outputs reach every
rank by one broadcast (JAX: a masked ``psum``).
"""

from __future__ import annotations

from typing import Callable

import torch

from .comm import Comm


def pipeline_apply(stage_fn: Callable, stage_params, microbatches: torch.Tensor,
                   comm: Comm) -> torch.Tensor:
    """Run ``microbatches [n_micro, ...]`` (every rank's the same) through
    the ``comm.size`` stages; ``stage_params`` is this rank's stage and
    ``stage_fn(params, x)`` keeps ``x``'s shape. Returns the last stage's
    ``[n_micro, ...]`` on every rank."""
    r, n = comm.rank, comm.size
    n_micro = microbatches.shape[0]
    outputs = torch.zeros_like(microbatches)
    x = torch.empty_like(microbatches[0])
    for t in range(n_micro + n - 1):
        m = t - r
        if not 0 <= m < n_micro:
            continue
        if r == 0:
            x = microbatches[m]
        else:
            comm.recv_(x, src=r - 1)
        y = stage_fn(stage_params, x)
        if r < n - 1:
            comm.send(y, dst=r + 1)
        else:
            outputs[m] = y
    return comm.broadcast_(outputs, src=n - 1)
