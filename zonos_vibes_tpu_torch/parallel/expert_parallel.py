"""Expert-parallel dispatch over the ``expert`` axis (the JAX package's
``parallel/expert_parallel.py``).

Zonos has no mixture of experts, and no shipped checkpoint runs this; the
layer keeps the dispatch so that an MoE backbone drops in. Top-1 routing
with a fixed capacity, exchanged by two all-to-alls (each rank sends
``O(capacity * D)``, not a broadcast):

* the ``T`` tokens are split over the ``n`` ranks (``T`` padded to a multiple
  of ``n``; padding rows claim no capacity), rank ``r`` holding rows
  ``[r T / n, (r + 1) T / n)``;
* each rank packs its tokens into a destination-major buffer ``[n, cap, D]``
  (Switch-style: tokens past the capacity are dropped and pass through
  unchanged);
* the first all-to-all makes it source-major: each rank now holds the
  tokens routed to its expert from every rank, and its expert transforms
  them;
* the second all-to-all (its own inverse) brings the outputs home, where
  they are unpacked into token order.

Capacity holds per (source rank, expert): ``capacity // n`` slots, the
usual granularity for data-split Switch routing.
"""

from __future__ import annotations

from typing import Callable

import torch

from .comm import Comm


def expert_dispatch(expert_fn: Callable, expert_params, tokens: torch.Tensor,
                    router_logits: torch.Tensor, comm: Comm,
                    capacity: int | None = None) -> torch.Tensor:
    """Route ``tokens [T, D]`` (every rank's the same) through the experts,
    rank ``r`` holding expert ``r``'s ``expert_params``. Returns ``[T, D]``
    on every rank: each token through its top-1 expert, or unchanged where
    the capacity dropped it. ``capacity`` is the per-expert budget (default
    ``max(n, 2 T / n)``), held at ``capacity // n`` per source rank."""
    n, r = comm.size, comm.rank
    t, d = tokens.shape
    if capacity is None:
        capacity = max(n, (2 * t) // n)
    cap = max(1, capacity // n)
    pad = -t % n
    t_loc = (t + pad) // n
    x = torch.nn.functional.pad(tokens, (0, 0, 0, pad))[r * t_loc: (r + 1) * t_loc]
    logits = torch.nn.functional.pad(router_logits, (0, 0, 0, pad))[r * t_loc: (r + 1) * t_loc]

    valid = r * t_loc + torch.arange(t_loc, device=tokens.device) < t
    choice = logits.argmax(dim=-1)
    onehot = torch.nn.functional.one_hot(choice, n) * valid[:, None]
    # Each token's slot among this rank's tokens for its expert; -1 unrouted.
    pos = (torch.cumsum(onehot, dim=0) * onehot - 1).gather(1, choice[:, None])[:, 0]
    keep = (pos >= 0) & (pos < cap)
    idx_e, idx_c = choice[keep], pos[keep]

    buf = torch.zeros((n, cap, d), dtype=tokens.dtype, device=tokens.device)
    buf[idx_e, idx_c] = x[keep]
    mine = comm.all_to_all(buf, split_dim=0, concat_dim=0)  # row i: rank i's tokens for me
    out = expert_fn(expert_params, mine.reshape(n * cap, d)).reshape(n, cap, d)
    back = comm.all_to_all(out, split_dim=0, concat_dim=0)  # destination-major again
    y = x.clone()
    y[keep] = back[idx_e, idx_c]
    return comm.all_gather(y, dim=0)[:t]
