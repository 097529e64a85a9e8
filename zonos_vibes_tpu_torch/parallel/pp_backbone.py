"""Pipeline parallelism on the Zonos transformer backbone (the JAX package's
``parallel/pp_backbone.py``).

The layer stack is cut into contiguous stages over the ``pipe`` group: rank
``r`` owns layers ``[r L / n, (r + 1) L / n)`` (``sharding.pp_slices``) and
exactly those layers' KV cache and stage. Hidden states pass rank to rank
(:class:`.comm.Comm` send/receive, JAX's ``ppermute``), microbatched over
the batch rows: with ``n_micro`` microbatches the tick schedule of
:mod:`.pipeline_parallel` applies, ``n_micro = 1`` is stage-sequential (the
single-card order of operations, so the same codes) and ``n_micro >= n``
keeps every stage busy. The final norm, the embeddings, the heads and
sampling run outside the pipeline, on every rank, in the engine's ordinary
program: only the model's backbone is swapped.

The cache is allocated microbatch-major, as the JAX module notes a real
slice should be: one buffer of ``n_micro * L_stage`` layers of ``B /
n_micro`` rows, microbatch ``m``'s layers at ``[m L_stage, (m + 1)
L_stage)``. Each microbatch's slice is then whole layers, which the
decode-attention kernel reads by its layer index (trap: the layer that
decode attention reads from its ``[L, 3]`` device scalars is the
stage-local one, here ``m L_stage + l``), and the engine's stage flush
(``models/backbone.flush_kv_stage``) runs per stage on all of them.
"""

from __future__ import annotations

import torch

from ..config import BackboneConfig
from ..models.backbone import stack_forward
from ..ops.norms import layer_norm
from .comm import Comm
from .sharding import allocate_local_cache


class PipelinedTransformerBackbone:
    """The transformer backbone's interface (``allocate_cache``, ``forward``)
    over this rank's pipeline stage."""

    def __init__(self, cfg: BackboneConfig, pipe: Comm, n_micro: int = 1):
        if cfg.n_layer % pipe.size:
            raise ValueError(f"{cfg.n_layer} layers do not split over {pipe.size} stages")
        self.cfg = cfg
        self.pipe = pipe
        self.n_micro = n_micro
        self.stage_layers = cfg.n_layer // pipe.size

    def allocate_cache(self, batch: int, max_seqlen: int, dtype, device) -> dict:
        """``batch`` rows (this data rank's) in ``n_micro`` microbatches."""
        if batch % self.n_micro:
            raise ValueError(f"batch {batch} does not split into {self.n_micro} microbatches")
        return allocate_local_cache(self.cfg, batch // self.n_micro, max_seqlen, dtype, device,
                                    layers=self.n_micro * self.stage_layers)

    def forward(self, params, hidden, cache, offset, rope, stage_base=None, *, positions=None,
                pool_base=None, capture_fc2=False):
        """``hidden [B, S, D]`` (every stage's the same rows) -> the final-normed
        ``[B, S, D]`` on every rank of the pipe group; the stage's cache updated
        in place."""
        if positions is not None or pool_base is not None or capture_fc2:
            raise NotImplementedError("the pipelined backbone runs the solo prefill and "
                                      "decode only")
        r, n = self.pipe.rank, self.pipe.size
        B = hidden.shape[0]
        bm = B // self.n_micro
        out = torch.empty_like(hidden)
        x = torch.empty_like(hidden[:bm])
        for t in range(self.n_micro + n - 1):
            m = t - r
            if not 0 <= m < self.n_micro:
                continue
            rows = slice(m * bm, (m + 1) * bm)
            if r == 0:
                x = hidden[rows]
            else:
                self.pipe.recv_(x, src=r - 1)
            y = stack_forward(params["layers"], self.cfg, x, cache, offset, rope, stage_base,
                              layer0=m * self.stage_layers)
            if r < n - 1:
                self.pipe.send(y, dst=r + 1)
            else:
                out[rows] = y
        self.pipe.broadcast_(out, src=n - 1)
        nf = params["norm_f"]
        return layer_norm(out, nf["weight"], nf["bias"], self.cfg.norm_epsilon)
