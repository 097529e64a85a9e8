"""The parallel engine's long-prefill route (the JAX package's
``parallel/sp_generate.py``).

A prefill of ``S_real = cond + prefix + 1 >= sp_threshold`` positions runs
sequence-parallel over the model axis (:func:`.sp_prefill.sp_prefill_forward`,
ring or Ulysses), writes the standard decode cache (a tensor-parallel
rank's heads) and hands off to the engine's unchanged decode loop: the
engine's prefill already sets the flushed prefix to ``S_real``
(``engine/generate._prefill_state``), the JAX route's ``stage_base =
S_real``. Everything around the backbone pass (delay pattern, first-frame
sampling, the EOS machinery) is the engine's own, so the two routes differ
only in the order of fp32 sums.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import BackboneConfig
from .comm import Comm
from .sp_prefill import sp_prefill_forward


def sp_prefill_last(params: dict, cfg: BackboneConfig, hidden: torch.Tensor, cache: dict,
                    comm: Comm, method: str, rope: torch.Tensor) -> torch.Tensor:
    """``hidden [B, S_real, D]`` (every rank of ``comm`` holds it whole) ->
    the final-normed hidden state at ``S_real - 1``, ``[B, 1, D]``, on every
    rank; ``cache`` written at ``[0, S_real)`` (and at the padding).

    The sequence is right-padded with zeros to a multiple of the group's
    size. Padded queries give outputs nobody reads (the logits come from
    the real last position); padded K/V land at cache positions from
    ``S_real`` on, past every decode step's bound, and the first stage flush
    overwrites them."""
    n, r = comm.size, comm.rank
    S_real = hidden.shape[1]
    pad = -S_real % n
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
    chunk = hidden.shape[1] // n
    out = sp_prefill_forward(params, cfg, hidden[:, r * chunk: (r + 1) * chunk], cache, comm,
                             method, rope, gather_weights=n > 1)
    owner, idx = divmod(S_real - 1, chunk)
    last = (out[:, idx: idx + 1].contiguous() if r == owner
            else torch.empty((out.shape[0], 1, out.shape[2]), dtype=out.dtype,
                             device=out.device))
    return comm.broadcast_(last, src=owner)
