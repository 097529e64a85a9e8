"""Generation over a device mesh: ``ParallelEngine`` (data and tensor
parallelism, and the sequence-parallel long prefill) and ``PipelineEngine``
(pipeline stages, with data parallelism): the JAX package's
``parallel/engine.py``.

JAX drives one jitted ``generate_jit`` over sharded inputs, GSPMD adding the
collectives, and drives it through ``PipelinedZonosModel`` for pipeline
stages. The port drives its own ``engine/generate.DecodeEngine`` on every
rank through a swapped model, :class:`ParallelZonosModel`: the rank's slices
of the weights (``sharding.shard_zonos_params``), a rank-local backbone
(tensor-parallel or pipelined) over a rank-local cache, and the heads'
logits gathered from the ranks before the CFG mix. Every rank then holds
the same logits and samples the same tokens with a generator seeded the
same, so the whole decode loop, its stage flushes and its stop test run
unchanged and in step on every rank. Under NCCL the decode step, its
collectives included, is captured as one CUDA graph as on one card; under
gloo (ranks sharing a card, or the CPU) it runs eagerly.

Scope: both backbones (the hybrid through
:class:`TensorParallelHybridBackbone`) with float, int8, int4 or
mixed-width weights and a float KV cache, over ``data x model``; the
transformer also over ``pipe x data``. What stays out raises, naming its
reason, and runs on no other path: the hybrid under a pipe axis (JAX
asserts it), the sequence-parallel prefill on the hybrid or on quantized
weights (JAX refuses both), an int8 KV cache (JAX's engines never pass
``kv_int8``), the pooled decode (JAX's engines have no pooled entry), and a
model axis that does not divide the heads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from ..config import MeshConfig
from ..engine.generate import DecodeEngine, GenerateResult
from ..models.backbone import transformer_forward
from ..models.mamba_backbone import HybridBackbone, Mamba2Spec, attention_geometry
from ..models.zonos import ZonosModel
from ..ops.sampling import SamplingParams
from .comm import Comm
from .multihost import DEFAULT_TIMEOUT_S, initialize_runtime
from .pp_backbone import PipelinedTransformerBackbone
from .sharding import (DATA, MODEL, PIPE, allocate_local_cache, check_supported, make_mesh,
                       shard_zonos_params)
from .sp_generate import sp_prefill_last

# Not ported, on purpose (ROADMAP.md queue 1): JAX's ParallelEngine calls
# generate_jit without kv_int8, and PipelineEngine inherits that call.
_NO_KV_INT8 = ("an int8 KV cache under the parallel layer is not ported: JAX's parallel "
               "engines never pass kv_int8 (zonos_vibes_tpu/parallel/engine.py:125-137; "
               "ROADMAP.md queue 1, not ported on purpose)")


def initialize_multihost(init_method: str | None = None, world_size: int | None = None,
                         rank: int | None = None, *, backend: str = "nccl",
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Multi-process start-up (:func:`.multihost.initialize_runtime`); a
    no-op when the process group exists already or for one process."""
    if not dist.is_initialized():
        initialize_runtime(init_method, world_size, rank, backend=backend, timeout_s=timeout_s)


class TensorParallelBackbone:
    """The transformer backbone over one model rank's heads and FFN columns:
    out_proj and fc2 row-parallel, their fp32 partials summed over the
    model axis. With a model axis of one rank the projections are the
    single card's (nothing to sum)."""

    def __init__(self, cfg, model_axis: Comm):
        n = model_axis.size
        self.cfg = cfg
        self.model_axis = model_axis
        # Local head counts, passed explicitly: never a BackboneConfig with
        # num_heads / n (models/backbone._block's trap).
        self.heads = (cfg.num_heads // n, cfg.num_heads_kv // n)
        self.reduce = model_axis.all_reduce_ if n > 1 else None

    def allocate_cache(self, batch: int, max_seqlen: int, dtype, device) -> dict:
        return allocate_local_cache(self.cfg, batch, max_seqlen, dtype, device,
                                    model=self.model_axis.size)

    def forward(self, params, hidden, cache, offset, rope, stage_base=None, *, positions=None,
                pool_base=None, capture_fc2=False):
        if positions is not None or pool_base is not None or capture_fc2:
            raise NotImplementedError("the tensor-parallel backbone runs the solo prefill and "
                                      "decode only")
        return transformer_forward(params, self.cfg, hidden, cache, offset, rope, stage_base,
                                   heads=self.heads, reduce=self.reduce)


class TensorParallelHybridBackbone(HybridBackbone):
    """The hybrid backbone over one model rank's heads: its attention heads,
    its Mamba heads with their slice of d_inner, and every row-parallel
    projection (Mamba and attention out_proj, fc2) summed over the model
    axis, the Mamba gated norm folded into that sum
    (``models/mamba_backbone``). With a model axis of one rank it is the
    single card's backbone. Its cache is the rank's: K/V of its ``Hkv / n``
    heads, the fp32 SSM state at its ``d_inner`` and the conv cache at its
    ``conv_dim`` (its x channels and all of B | C). Trap: hybrid attention
    at TP 4 holds one KV head per rank (the flagship's 16/4 heads: 8/2 at
    TP 2, 4/1 at TP 4); a model axis that does not divide the KV heads
    raises (``sharding.check_supported``)."""

    def __init__(self, cfg, model_axis: Comm):
        n = model_axis.size
        hq, hkv, _, _ = attention_geometry(cfg)
        nheads = Mamba2Spec(cfg.d_model, cfg.ssm_cfg_dict).nheads
        # Local head counts, passed explicitly (HybridBackbone's trap).
        super().__init__(cfg, heads=(hq // n, hkv // n), mamba_heads=nheads // n,
                         reduce=model_axis.all_reduce_ if n > 1 else None)


@dataclass(frozen=True, eq=False)
class ParallelZonosModel(ZonosModel):
    """One rank's :class:`ZonosModel`: ``local_backbone`` over this data
    rank's rows, the heads over this model rank's vocab columns. What the
    engine sees is the single-card model's: the full ``[2B, ...]`` batch in,
    the full ``[2B, K, V]`` logits out (:meth:`forward_logits`)."""

    local_backbone: Any = None
    data: Comm | None = None
    model_axis: Comm | None = None
    sp_prefill: str | None = None
    sp_threshold: int = 512

    @property
    def backbone(self):
        return self.local_backbone

    def allocate_cache(self, batch_size: int, max_seqlen: int, dtype, device,
                       kv_int8: bool = False, state_bf16: bool = False,
                       pool_ring: bool = False) -> dict:
        if kv_int8:  # reached only by a DecodeEngine built by hand on this model
            raise NotImplementedError(_NO_KV_INT8)
        if state_bf16 or pool_ring:
            raise ValueError("the parallel layer's cache is the solo decode's (state_bf16 and "
                             "the pool's rings are pool options)")
        if batch_size % self.data.size:
            raise ValueError(f"batch {batch_size} does not split over a data axis of "
                             f"{self.data.size}")
        return self.local_backbone.allocate_cache(batch_size // self.data.size, max_seqlen,
                                                  dtype, device)

    def forward_logits(self, params: dict, hidden, cache: dict, offset, rope, stage_base=None, *,
                       positions=None, pool_base=None) -> torch.Tensor:
        if positions is not None or pool_base is not None:
            raise NotImplementedError("the pooled decode under the parallel layer is not "
                                      "ported: JAX's parallel engines have no pooled entry")
        b = hidden.shape[0] // self.data.size
        h = hidden[self.data.rank * b: (self.data.rank + 1) * b]
        S = h.shape[1]
        if (self.sp_prefill is not None and S > 1 and S >= self.sp_threshold
                and isinstance(offset, int) and offset == 0):
            last = sp_prefill_last(params["backbone"], self.config.backbone, h, cache,
                                   self.model_axis, self.sp_prefill, rope)
        else:
            last = self.local_backbone.forward(params["backbone"], h, cache, offset, rope,
                                               stage_base)[:, -1:]
        # Heads shard on the vocab: this rank's columns, then every rank's.
        logits = self.model_axis.all_gather(self.apply_heads(params, last)[:, :, 0, :], dim=-1)
        # Trap: the CFG pair under the data axis. The cond and uncond rows
        # live on different data ranks, so the rows are gathered before the
        # CFG mix (compute_logits); every rank then samples identical tokens
        # from identical logits with an identically seeded generator.
        return self.data.all_gather(logits, dim=0)


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return {k: _to_device(v, device) for k, v in tree.items()}


class ParallelEngine:
    """Generation over a ``(data, model)`` mesh of the initialised process
    group, whose world size is ``mesh_config.num_devices``; every rank
    constructs it with the same full ``params`` and calls :meth:`generate`
    with the same arguments (a generator seeded the same).

    ``model`` is either backbone: the hybrid runs through
    :class:`TensorParallelHybridBackbone`. ``params`` may hold float,
    int8, int4 or mixed-width projections (``ops/quant``).

    ``sp_prefill`` (``"ring"`` or ``"ulysses"``; the transformer with bf16
    or fp32 weights, a model axis of 2 or more) sends a first prefill of at least
    ``sp_threshold`` positions through the sequence-parallel route
    (:mod:`.sp_generate`); shorter prefills stay dense.

    ``device`` (default: the current card) holds this rank's slices and
    cache. ``cuda_graphs`` as ``DecodeEngine``'s, under NCCL; under gloo the
    step runs eagerly and ``cuda_graphs=True`` raises."""

    pipelined = False  # whether a pipe axis stages the layers (PipelineEngine)

    def __init__(self, model: ZonosModel, mesh_config: MeshConfig, params: dict,
                 sp_prefill: str | None = None, sp_threshold: int = 512, *,
                 kv_int8: bool = False, device=None, cuda_graphs: bool | None = None):
        cfg = model.config.backbone
        if kv_int8:
            raise NotImplementedError(_NO_KV_INT8)
        check_supported(cfg, mesh_config.model)
        if mesh_config.pipe > 1 and not self.pipelined:
            raise ValueError("a pipe axis runs through PipelineEngine")
        if sp_prefill is not None:
            if cfg.is_hybrid:  # as JAX's ParallelEngine refuses it
                raise ValueError("sp_prefill supports the transformer backbone, not the hybrid")
            if sp_prefill not in ("ring", "ulysses"):
                raise ValueError(f"sp_prefill must be 'ring', 'ulysses' or None, got "
                                 f"{sp_prefill!r}")
            if mesh_config.model < 2:
                raise ValueError("sp_prefill splits the sequence over the model axis (needs "
                                 "model >= 2)")
            if "weight" not in params["backbone"]["layers"]["in_proj"]:
                raise ValueError("sp_prefill is a float prefill path (quantized weights "
                                 "decode after a dense prefill)")
        self.device = torch.device(device if device is not None else "cuda")
        self.backend = dist.get_backend()
        if cuda_graphs and self.backend != "nccl":
            raise ValueError("CUDA graphs capture NCCL collectives: under gloo the decode step "
                             "runs eagerly (cuda_graphs=False or None)")
        self.mesh_config = mesh_config
        self.mesh = make_mesh(mesh_config, self.device.type)
        self.data = Comm(self.mesh.get_group(DATA))
        self.model_axis = Comm(self.mesh.get_group(MODEL))
        self.params = _to_device(shard_zonos_params(params, self.mesh, cfg), self.device)
        self.model = ParallelZonosModel(model.config, local_backbone=self._backbone(cfg),
                                        data=self.data, model_axis=self.model_axis,
                                        sp_prefill=sp_prefill, sp_threshold=sp_threshold)
        graphs = cuda_graphs if self.backend == "nccl" else False
        self.engine = DecodeEngine(self.model, cuda_graphs=graphs)

    def _backbone(self, cfg):
        if cfg.is_hybrid:
            return TensorParallelHybridBackbone(cfg, self.model_axis)
        return TensorParallelBackbone(cfg, self.model_axis)

    def generate(self, prefix_conditioning: torch.Tensor,
                 audio_prefix_codes: torch.Tensor | None = None, *,
                 generator: torch.Generator | None = None, max_new_tokens: int = 86 * 30,
                 cfg_scale: float = 2.0, sampling_params: SamplingParams | dict | None = None,
                 disable_eos: bool = False) -> GenerateResult:
        """``DecodeEngine.generate`` over the mesh: ``prefix_conditioning [2B,
        Lc, D]`` (cond rows, then uncond) whole on every rank; ``2B`` must
        split over the data axis."""
        if audio_prefix_codes is not None:
            audio_prefix_codes = audio_prefix_codes.to(self.device)
        return self.engine.generate(
            self.params, prefix_conditioning.to(self.device), audio_prefix_codes,
            generator=generator, max_new_tokens=max_new_tokens, cfg_scale=cfg_scale,
            sampling_params=sampling_params, disable_eos=disable_eos)


class PipelineEngine(ParallelEngine):
    """Generation with the backbone's layers staged over the ``pipe`` axis
    (:mod:`.pp_backbone`), composed with ``data``; ``model`` must be 1 (a
    tensor-parallel stage is not ported, as in JAX). ``n_micro``
    microbatches split each data rank's rows."""

    pipelined = True

    def __init__(self, model: ZonosModel, mesh_config: MeshConfig, params: dict,
                 n_micro: int = 1, *, device=None, cuda_graphs: bool | None = None):
        if model.config.backbone.is_hybrid:
            raise ValueError("the pipelined backbone is the transformer's: JAX asserts it "
                             "(zonos_vibes_tpu/parallel/pp_backbone.py:136, \"PP backbone "
                             "requires empty ssm_cfg\")")
        if mesh_config.pipe < 2:
            raise ValueError("PipelineEngine needs a pipe axis >= 2")
        if mesh_config.model != 1:
            raise ValueError("PipelineEngine composes pipe x data only")
        self.n_micro = n_micro
        super().__init__(model, mesh_config, params, device=device, cuda_graphs=cuda_graphs)

    def _backbone(self, cfg):
        return PipelinedTransformerBackbone(cfg, Comm(self.mesh.get_group(PIPE)), self.n_micro)
