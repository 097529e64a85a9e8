"""Hybrid (Mamba-2 + attention) backbone: the JAX package's
``models/mamba_backbone.py`` in PyTorch.

Every layer is a Mamba-2 mixer except ``attn_layer_idx``, which are GQA
attention (with a SwiGLU MLP when ``attn_mlp_d_intermediate > 0``). Blocks
add the residual in fp32 (``residual_in_fp32``) and normalise with RMSNorm:

    residual = hidden + residual; hidden = Mixer(Norm(residual))
    [MLP]    residual = hidden + residual; hidden = MLP(Norm2(residual))
    out = NormF(hidden + residual)

Mixers:

* **Mamba-2** (``ops/mamba.py``): fused in_proj -> (z, xBC, dt); causal
  depthwise conv + SiLU on xBC; the SSD chunked scan (prefill) or the fused
  decode step (``ops/cuda/mamba_step.py``), with per-head A, D and softplus
  dt; gated RMSNorm ``rmsnorm(y * silu(z))``; out_proj.
* **Attention**: GQA with rotate-half RoPE on the first ``rotary_emb_dim``
  features of each head (``ops/rope.apply_rope_half``).

Layout (the JAX package keeps a list of per-layer dicts and per-layer
caches; the port stacks them by kind, so the stacked decode kernels take a
layer index):

* parameters ``{"mamba": {leaf: [M, ...]}, "attn": {leaf: [L_attn, ...]},
  "norm_f": {...}}``, a kind present only if the config has such layers
  (``utils/checkpoint.params_from_jax`` stacks the JAX list);
* cache ``k``, ``v`` ``[L_attn, B, T, Hkv*Dh]`` (time-major, as the
  transformer's), ``conv`` ``[M, B, d_conv - 1, conv_dim]`` and ``ssm``
  ``[M, B, d_state, d_inner]`` (lane-transposed, fp32 or bf16 storage);
  with ``pool_ring`` also ``k_stage``, ``v_stage`` ``[L_attn, B, STAGE,
  Hkv*Dh]``, the pool's per-row rings.

Decode modes of :meth:`HybridBackbone.forward` (``S == 1``):

* solo: the token's columns are written at ``offset`` and every row
  attends ``[0, offset + 1)`` (no stage, as in JAX);
* pooled ring (``positions`` and ``pool_base``): row ``b`` attends its
  flushed prefix ``[0, pool_base[b])``, its ring rows and itself; its
  columns land in ring slot ``positions[b] - pool_base[b]``, stored by each
  attention layer's decode-attention call;
* stage-less pooled (``positions`` only): row ``b`` attends ``[0,
  positions[b])`` and itself; its columns are written at ``positions[b]``
  after the stack, one indexed copy per K and V.

On a CUDA device the Mamba decode step runs the fused kernel (42 launches
per step at the flagship), attention runs the decode-attention kernels
(rows 11, 6 and 12 of the kernel table) and the prefill-attention kernel;
on the CPU the same wrappers run their plain versions.

Under tensor parallelism (``parallel/``) the backbone holds one model
rank's heads: explicit attention and Mamba head counts (never a rank-local
``BackboneConfig``) and a row-parallel ``reduce`` that sums the fp32
partials of every Mamba out_proj, attention out_proj and fc2, rounded once.
The Mamba mixer's gated RMSNorm spans every rank's heads, so its scale is
folded into that one reduction (:meth:`HybridBackbone._norm_fold`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import BackboneConfig
from ..ops.attention import update_kv_cache
from ..ops.cuda.decode_attention import (
    decode_attention_pooled_staged,
    decode_attention_pooled_unstaged,
    decode_attention_unstaged,
)
from ..ops.cuda.mamba_step import ssd_gate_step_layered
from ..ops.cuda.prefill_attention import prefill_attention
from ..ops.mamba import (
    causal_conv1d,
    causal_conv1d_step,
    ssd_chunked,
    state_from_lanes,
    state_to_lanes,
)
from ..ops.mlp import swiglu_mid
from ..ops.norms import layer_norm, rms_norm
from ..ops.quant import proj_matmul, proj_matmul_f32
from ..ops.rope import apply_rope_half
from .backbone import KV_STAGE, _row_parallel


class Mamba2Spec:
    """Static geometry from ``ssm_cfg`` (Mamba2 module defaults).

    ``nheads`` (default: every head) are the heads a mixer holds: a
    tensor-parallel rank's. ``d_inner``, ``conv_dim`` and ``d_in_proj`` are
    then the rank's widths; ``norm_dim`` stays the full ``d_inner``, over
    which the gated RMSNorm normalises."""

    def __init__(self, d_model: int, ssm_cfg: dict, nheads: int | None = None):
        self.d_model = d_model
        self.d_state = ssm_cfg.get("d_state", 128)
        self.d_conv = ssm_cfg.get("d_conv", 4)
        self.expand = ssm_cfg.get("expand", 2)
        self.headdim = ssm_cfg.get("headdim", 64)
        self.ngroups = ssm_cfg.get("ngroups", 1)
        self.chunk = ssm_cfg.get("chunk_size", 64)
        self.norm_dim = self.expand * d_model
        if self.norm_dim % self.headdim:
            raise ValueError("d_inner must be a multiple of headdim")
        if self.ngroups != 1:
            raise NotImplementedError("ngroups > 1 is not ported (every Zonos config has 1)")
        self.nheads = self.norm_dim // self.headdim if nheads is None else nheads
        self.d_inner = self.nheads * self.headdim
        self.conv_dim = self.d_inner + 2 * self.ngroups * self.d_state
        self.d_in_proj = 2 * self.d_inner + 2 * self.ngroups * self.d_state + self.nheads


def attention_geometry(cfg: BackboneConfig) -> tuple[int, int, int, int]:
    """The hybrid attention's ``(num_heads, num_heads_kv, head_dim,
    rotary_dim)`` from ``attn_cfg`` (JAX's ``HybridBackbone`` defaults, which
    differ from ``BackboneConfig``'s transformer properties)."""
    acfg = cfg.attn_cfg_dict
    hq = acfg.get("num_heads", 16)
    dh = acfg.get("head_dim", cfg.d_model // hq)
    return hq, acfg.get("num_heads_kv", hq), dh, acfg.get("rotary_emb_dim", dh // 2)


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i``'s parameters from a stacked ``{name: {leaf: [n, ...]}}``."""
    return {name: ({k: t[i] for k, t in leaf.items()} if isinstance(leaf, dict) else leaf[i])
            for name, leaf in tree.items()}


class HybridBackbone:
    """The hybrid stack over stacked parameters and caches (the JAX package's
    ``HybridBackbone``).

    For one tensor-parallel rank (``parallel/engine``): ``heads`` ``(Hq,
    Hkv)`` and ``mamba_heads`` are the attention and Mamba heads the
    rank's parameters hold, and ``reduce`` sums its row-parallel fp32
    partials over the model axis (default: every head, no reduction).
    Trap: head counts never come from a rank-local ``BackboneConfig``; the
    attention reads its heads from ``attn_cfg`` and ``Mamba2Spec`` derives
    ``nheads`` and ``d_inner`` from ``d_model``, so a config cut by ``n``
    would give the rank the wrong widths."""

    def __init__(self, cfg: BackboneConfig, *, heads: tuple[int, int] | None = None,
                 mamba_heads: int | None = None, reduce=None):
        self.cfg = cfg
        self.ssm = Mamba2Spec(cfg.d_model, cfg.ssm_cfg_dict, mamba_heads)
        hq, hkv, self.head_dim, self.rotary_dim = attention_geometry(cfg)
        self.num_heads, self.num_heads_kv = heads if heads is not None else (hq, hkv)
        self.reduce = reduce
        self.mlp_dim = cfg.attn_mlp_d_intermediate
        self.d_intermediate = cfg.d_intermediate
        attn = set(cfg.attn_layer_idx)
        # Layer i -> ("attn", j) or ("mamba", m): its plane in the stacks.
        self.plan, counts = [], {"attn": 0, "mamba": 0}
        for i in range(cfg.n_layer):
            kind = "attn" if i in attn else "mamba"
            self.plan.append((kind, counts[kind]))
            counts[kind] += 1
        self.n_attn, self.n_mamba = counts["attn"], counts["mamba"]

    # -- parameters and cache -------------------------------------------------

    def init(self, gen: torch.Generator, dtype, device) -> dict:
        """Random parameters with the shapes of the JAX ``init`` (normal /
        sqrt(fan_in) weights, conv kernels normal * 0.2, unit norms, A_log 0,
        D 1, dt_bias 0), drawn from ``gen`` one layer at a time."""
        cfg, s = self.cfg, self.ssm
        D = cfg.d_model
        f32 = torch.float32

        def dense(n, din, dout):
            w = torch.empty((n, din, dout), dtype=dtype, device=device)
            for i in range(n):
                w[i] = (torch.randn((din, dout), generator=gen, device=device, dtype=f32)
                        / din ** 0.5).to(dtype)
            return {"weight": w}

        def norm(n, width=D):
            p = {"weight": torch.ones((n, width), dtype=dtype, device=device)}
            if not cfg.rms_norm:
                p["bias"] = torch.zeros((n, width), dtype=dtype, device=device)
            return p

        def mlp(n, d_ff):
            return {"norm2": norm(n), "fc1": dense(n, D, 2 * d_ff), "fc2": dense(n, d_ff, D)}

        out = {}
        M, La = self.n_mamba, self.n_attn
        if M:
            conv = torch.randn((M, s.d_conv, s.conv_dim), generator=gen, device=device,
                               dtype=f32) * 0.2
            out["mamba"] = {
                "norm": norm(M),
                "in_proj": dense(M, D, s.d_in_proj),
                "conv1d": {"weight": conv.to(dtype),
                           "bias": torch.zeros((M, s.conv_dim), dtype=dtype, device=device)},
                "dt_bias": torch.zeros((M, s.nheads), dtype=f32, device=device),
                "A_log": torch.zeros((M, s.nheads), dtype=f32, device=device),
                "D": torch.ones((M, s.nheads), dtype=f32, device=device),
                "ssm_norm": {"weight": torch.ones((M, s.d_inner), dtype=dtype, device=device)},
                "out_proj": dense(M, s.d_inner, D),
                **(mlp(M, self.d_intermediate) if self.d_intermediate > 0 else {}),
            }
        if La:
            Hq, Hkv, Dh = self.num_heads, self.num_heads_kv, self.head_dim
            out["attn"] = {
                "norm": norm(La),
                "in_proj": dense(La, D, (Hq + 2 * Hkv) * Dh),
                "out_proj": dense(La, Hq * Dh, D),
                **(mlp(La, self.mlp_dim) if self.mlp_dim > 0 else {}),
            }
        nf = {"weight": torch.ones((D,), dtype=dtype, device=device)}
        if not cfg.rms_norm:
            nf["bias"] = torch.zeros((D,), dtype=dtype, device=device)
        out["norm_f"] = nf
        return out

    def allocate_cache(self, batch: int, max_seqlen: int, dtype, device,
                       state_dtype=torch.float32, pool_ring: bool = False) -> dict:
        """Zeroed cache (module docstring). ``state_dtype`` is the SSM
        state's storage type: fp32, or bf16 for pooled serving (the
        recurrence still computes in fp32). ``pool_ring`` adds the pool's
        per-row ring stages."""
        s = self.ssm
        W = self.num_heads_kv * self.head_dim
        La, M = self.n_attn, self.n_mamba

        def zeros(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        cache = {"k": zeros((La, batch, max_seqlen, W)), "v": zeros((La, batch, max_seqlen, W)),
                 "conv": zeros((M, batch, s.d_conv - 1, s.conv_dim)),
                 "ssm": zeros((M, batch, s.d_state, s.d_inner), state_dtype)}
        if pool_ring:
            stage = min(KV_STAGE, max_seqlen)
            cache["k_stage"] = zeros((La, batch, stage, W))
            cache["v_stage"] = zeros((La, batch, stage, W))
        return cache

    # -- mixers ---------------------------------------------------------------

    def _norm(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.rms_norm:
            return rms_norm(x, p["weight"], self.cfg.norm_epsilon)
        return layer_norm(x, p["weight"], p.get("bias"), self.cfg.norm_epsilon)

    def _norm_fold(self, gw: torch.Tensor, ss: torch.Tensor, out_proj: dict,
                   dtype) -> torch.Tensor:
        """A head-sharded mixer's gated RMSNorm and row-parallel out_proj in
        one all-reduce. Trap: the gated RMSNorm spans all heads, so no rank
        can normalise alone. Trap: the norm's scale factors through the
        row-parallel out_proj: ``rsqrt(mean(g^2) + eps)`` is one scalar per
        token row, so ``out_proj(g * w * s) = s * out_proj(g * w)`` (int8 and
        int4 column scales commute with it too). The rank's fp32 partial
        ``[..., D]`` of ``out_proj(g * w)`` travels with its rows' sums of
        ``g^2`` as one extra column; after the sum the rows are scaled by
        ``rsqrt(total / d_inner + eps)`` over the full ``d_inner`` (never the
        rank's width) and rounded once. ``g * w`` (``gw``) is rounded before
        the scale rather than after: a rounding-size difference from the
        single card."""
        part = proj_matmul_f32(gw, out_proj)
        both = self.reduce(torch.cat([part, ss[..., None]], dim=-1))
        scale = torch.reciprocal(torch.sqrt(both[..., -1:] / self.ssm.norm_dim
                                            + self.cfg.norm_epsilon))
        return (both[..., :-1] * scale).to(dtype)

    def _mamba_mixer(self, lp: dict, x: torch.Tensor, cache: dict, m: int) -> torch.Tensor:
        """Mamba-2 mixer of plane ``m``; updates its conv and SSM state in
        place. Under tensor parallelism (``reduce``) the rank's heads, with
        the gated norm folded into the out_proj's reduction."""
        s = self.ssm
        B, S, _ = x.shape
        # A tensor-parallel rank's int4 in_proj may carry zero pad columns
        # past its z | x | B | C | dt (parallel/sharding): dropped here.
        z, xBC, dt = proj_matmul(x, lp["in_proj"])[..., :s.d_in_proj].split(
            [s.d_inner, s.conv_dim, s.nheads], dim=-1)
        dt = F.softplus(dt.float() + lp["dt_bias"])  # [B, S, H]
        A = -torch.exp(lp["A_log"].float())
        conv_w, conv_b = lp["conv1d"]["weight"], lp["conv1d"]["bias"]
        if S == 1:
            xBC_t, conv_state = causal_conv1d_step(xBC[:, 0], conv_w, conv_b, cache["conv"][m])
            cache["conv"][m] = conv_state
            xs, Bm, Cm = F.silu(xBC_t).split([s.d_inner, s.d_state, s.d_state], dim=-1)
            dt0 = dt[:, 0]
            args = (cache["ssm"], m, xs.contiguous(), dt0, torch.exp(dt0 * A[None, :]),
                    Bm.float().contiguous(), Cm.float().contiguous(), z[:, 0].contiguous(),
                    lp["D"], lp["ssm_norm"]["weight"])
            if self.reduce is not None:  # the kernel's partial-norm mode
                gw, ss = ssd_gate_step_layered(*args, partial=True)
                return self._norm_fold(gw[:, None], ss[:, None], lp["out_proj"], x.dtype)
            y = ssd_gate_step_layered(*args, eps=self.cfg.norm_epsilon)
            return proj_matmul(y[:, None], lp["out_proj"])
        xBC_c, conv_state = causal_conv1d(xBC, conv_w, conv_b, cache["conv"][m])
        cache["conv"][m] = conv_state
        xs, Bm, Cm = F.silu(xBC_c).split([s.d_inner, s.d_state, s.d_state], dim=-1)
        y, state = ssd_chunked(
            xs.reshape(B, S, s.nheads, s.headdim), dt, A,
            Bm.reshape(B, S, 1, s.d_state), Cm.reshape(B, S, 1, s.d_state), lp["D"],
            chunk=s.chunk, init_state=state_from_lanes(cache["ssm"][m].float(), s.nheads))
        cache["ssm"][m] = state_to_lanes(state).to(cache["ssm"].dtype)
        # Gated RMSNorm: rmsnorm(y * silu(z)) * weight (norm_before_gate=False).
        g = y.reshape(B, S, s.d_inner) * F.silu(z)
        if self.reduce is not None:  # per (row, position): the norm fold
            gf = g.float()
            gw = (gf * lp["ssm_norm"]["weight"].float()).to(g.dtype)
            return self._norm_fold(gw, gf.square().sum(dim=-1), lp["out_proj"], x.dtype)
        y = rms_norm(g, lp["ssm_norm"]["weight"], self.cfg.norm_epsilon)
        return proj_matmul(y, lp["out_proj"])

    def _qkv(self, lp: dict, x: torch.Tensor, rope_pos: torch.Tensor):
        B, S, _ = x.shape
        Hq, Hkv, Dh = self.num_heads, self.num_heads_kv, self.head_dim
        q, k, v = proj_matmul(x, lp["in_proj"]).split([Hq * Dh, Hkv * Dh, Hkv * Dh], dim=-1)
        q = apply_rope_half(q.reshape(B, S, Hq, Dh), rope_pos, self.rotary_dim)
        k = apply_rope_half(k.reshape(B, S, Hkv, Dh), rope_pos, self.rotary_dim)
        return q.contiguous(), k, v.reshape(B, S, Hkv, Dh)

    # -- forward --------------------------------------------------------------

    def forward(self, params: dict, hidden: torch.Tensor, cache: dict,
                offset: int | torch.Tensor, rope=None, stage_base=None, *,
                positions: torch.Tensor | None = None,
                pool_base: torch.Tensor | None = None) -> torch.Tensor:
        """The stack and the final norm; updates ``cache`` in place.

        ``hidden [B, S, D]``. Without ``positions`` the chunk sits at cache
        positions ``[offset, offset + S)`` for every row (prefill for
        ``S > 1``, the solo decode for ``S == 1``; the decode's ``offset``
        may be a one-element int64 device tensor, which the step's column
        write, RoPE and attention bound read on the device, so a CUDA graph
        can capture the step). With ``positions [B]``
        (device, ``S == 1``) every row decodes at its own position: in ring
        mode with ``pool_base [B]``, stage-less otherwise (module
        docstring). ``rope`` and ``stage_base`` are unused: the rotary
        angles are computed per layer, and the solo cache has no stage.
        """
        B, S, _ = hidden.shape
        dev = hidden.device
        pooled = positions is not None
        ring = pool_base is not None
        if (pooled and S != 1) or (ring and not pooled):
            raise ValueError("pooled decode runs one token per row: pass positions (and "
                             "pool_base for ring mode) with S == 1")
        if ring and "k_stage" not in cache:
            raise ValueError("ring mode needs a cache allocated with pool_ring")
        La, W = self.n_attn, self.num_heads_kv * self.head_dim
        if pooled:
            rope_pos = positions.long()[:, None]
            prefix_ends = (pool_base if ring else positions).to(torch.int32).contiguous()
            if ring:
                ring_len = (positions - pool_base).to(torch.int32).contiguous()
        else:
            rope_pos = (offset + torch.arange(S, device=dev))[None, :].expand(B, S)
        if S == 1 and pooled:
            if not ring:
                k_cols = torch.empty((La, B, W), dtype=cache["k"].dtype, device=dev)
                v_cols = torch.empty_like(k_cols)
        elif S == 1:
            seq_end = (torch.as_tensor(offset, device=dev).reshape(1) + 1).to(torch.int32)

        def attention(lp, x, j):
            q, k, v = self._qkv(lp, x, rope_pos)
            if S > 1 or not pooled:
                kc, vc = update_kv_cache(cache["k"][j], cache["v"][j], k, v, offset)
                y = (prefill_attention(q, kc, vc, offset) if S > 1 else
                     decode_attention_unstaged(q, cache["k"], cache["v"], seq_end, j))
            elif ring:  # the kernel stores the columns in ring slot ring_len[b]
                y = decode_attention_pooled_staged(
                    q, cache["k"], cache["v"], cache["k_stage"], cache["v_stage"],
                    k.reshape(B, W), v.reshape(B, W), prefix_ends, ring_len, j)
            else:
                k_cols[j] = k.reshape(B, W)
                v_cols[j] = v.reshape(B, W)
                y = decode_attention_pooled_unstaged(
                    q, cache["k"], cache["v"], k_cols[j], v_cols[j], prefix_ends, j)
            return _row_parallel(y.reshape(B, S, -1), lp["out_proj"], self.reduce)

        rdtype = torch.float32 if self.cfg.residual_in_fp32 else hidden.dtype
        residual = torch.zeros_like(hidden, dtype=rdtype)
        for kind, j in self.plan:
            lp = _layer(params[kind], j)
            residual = hidden.to(rdtype) + residual
            normed = self._norm(lp["norm"], residual.to(hidden.dtype))
            if kind == "attn":
                hidden = attention(lp, normed, j)
            else:
                hidden = self._mamba_mixer(lp, normed, cache, j)
            if "fc1" in lp:
                residual = hidden.to(rdtype) + residual
                normed = self._norm(lp["norm2"], residual.to(hidden.dtype))
                hidden = _row_parallel(swiglu_mid(normed, lp["fc1"]), lp["fc2"], self.reduce)

        if S == 1 and pooled and not ring and La:
            # Each row's columns at its own position (clamped, as JAX's
            # dynamic_update_slice clamps), one indexed copy per K and V.
            rows = torch.arange(B, device=dev)
            idx = positions.long().clamp(0, cache["k"].shape[2] - 1)
            cache["k"][:, rows, idx] = k_cols
            cache["v"][:, rows, idx] = v_cols
        residual = hidden.to(rdtype) + residual
        return self._norm(params["norm_f"], residual.to(hidden.dtype))
