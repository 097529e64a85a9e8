"""Weight-only quantization (int8 and int4) and the int8 KV cache: the port's
own copy of the JAX package's ``ops/quant.py``.

Scheme: symmetric absmax per output column (and, for int4, per group of
contraction rows). In fp32, ``s = absmax / qmax`` (1 for an all-zero column)
and ``q = clip(round(w / s), -qmax, qmax)``, rounding half to even, with
``qmax`` 127 (int8) or 7 (int4), so the values and scales equal the JAX
package's bit for bit. The int4 clip search tries ``s = absmax * c / 7`` for
``c`` in ``CLIPS`` and keeps, per scale column, the first with the least
squared error (ties: the earlier ``c``).

Leaves, at the tree position of the ``weight`` they replace, leading axes
(layers, codebooks) kept:

* int8: ``{"weight_int8": int8 [..., K, N], "scale": fp32 [..., 1, N]}``;
* int4: ``{"weight_int4": uint8 [..., K, N / 2], "scale": fp32 [..., G, 1,
  N]}``. The weight is packed two values to a byte along N (column ``2j``
  in the low nibble of byte ``j``, two's complement in [-7, 7]); the scale
  has one more axis than the weight, always: ``G`` groups of ``K / G``
  contraction rows, ``G = 1`` for an ungrouped leaf. So a grouped and an
  ungrouped leaf tell themselves apart by the scale alone, stacked or not.
  (The JAX package keeps a grouped weight as ``[..., G, K / G, N]`` and an
  ungrouped one as ``[..., K, N]`` with scale ``[..., 1, N]``, which shapes
  alone cannot tell apart; ``utils/checkpoint`` converts both ways.)

Grouping follows JAX: int4 only, and only where ``K % group == 0 and K >
group``. ``fake=True`` returns ``{"weight": dequantized}`` in the weight's
dtype (or ``fake_dtype``), as JAX's quality gate uses it.

The JAX package quantizes on the host in numpy. The port quantizes one slice
of the leading axes at a time on the parameters' device, so the flagship
never holds an fp32 copy of more than one layer's weight. GPTQ
(:func:`_gptq_compensate`) and its Monte-Carlo Hessian
(:func:`fc2_hessian_mc`) run the same recipe in torch on that device (the
Hessian's inputs drawn by numpy, as in JAX); :func:`awq_fold` too.

Two departures from JAX, both refusals where JAX goes on silently: an
``awq_energy`` on the hybrid, or where fc2 is not int4, raises (JAX skips
the fold); and ``models/backbone``'s ``capture_fc2`` raises during decode.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .cuda.qmm import pack_int4, qmm_int4, qmm_int8, unpack_int4

QMAX = 127.0
QMAX4 = 7.0
CLIPS = (1.0, 0.95, 0.9, 0.85, 0.8, 0.75, 0.7, 0.65)
_QUANT_KEYS = ("in_proj", "out_proj", "fc1", "fc2")
_MLP_KEYS = ("fc1", "fc2")


def _absmax_quantize(x: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``x`` -> int8 values and fp32 scales (``dim`` kept, size 1)."""
    absmax = x.abs().amax(dim=dim, keepdim=True)
    scale = torch.where(absmax > 0, absmax / QMAX, torch.ones_like(absmax))
    return torch.clamp(torch.round(x / scale), -QMAX, QMAX).to(torch.int8), scale


def _rtn(w32: torch.Tensor, qmax: float, groups: int,
         clip_search: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """One ``[K, N]`` fp32 weight -> int8 values ``[K, N]`` and fp32 scales
    ``[groups, 1, N]``: round to nearest under per-(group, column) absmax
    scales, with the clip search if asked (JAX's ``_rtn_groupquant``)."""
    K, N = w32.shape
    wg = w32.reshape(groups, K // groups, N)
    absmax = wg.abs().amax(dim=-2, keepdim=True)
    one = torch.ones_like(absmax)

    def candidate(c):
        s = torch.where(absmax > 0, absmax * c / qmax, one)
        return torch.clamp(torch.round(wg / s), -qmax, qmax), s

    q, scale = candidate(1.0)
    if clip_search:
        err = ((q * scale - wg) ** 2).sum(dim=-2, keepdim=True)
        for c in CLIPS[1:]:
            q_c, s_c = candidate(c)
            err_c = ((q_c * s_c - wg) ** 2).sum(dim=-2, keepdim=True)
            better = err_c < err
            q = torch.where(better, q_c, q)
            scale = torch.where(better, s_c, scale)
            err = torch.minimum(err, err_c)
    return q.reshape(K, N).to(torch.int8), scale


def _gptq_compensate(w32: torch.Tensor, H: torch.Tensor, qmax: float, group_size: int,
                     clip_search: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """GPTQ sequential error compensation for one ``[K, N]`` fp32 weight (JAX's
    ``_gptq_compensate``, Frantar et al. 2022): contraction rows are quantized
    in order and each row's rounding error is folded into the rows not yet
    quantized, weighted by the upper Cholesky factor of the damped inverse
    Hessian ``H ~ E[x x^T]``. A group's scales are chosen at its entry from
    the compensated rows, with the same per-column clip search. The inverse
    and the factor are taken in float64, the sweep in fp32, as in JAX.

    Returns ``(q int8 [K, N], scale fp32 [K / group_size, N])``."""
    K, N = w32.shape
    if K % group_size:
        raise ValueError(f"_gptq_compensate: group {group_size} does not divide K = {K}")
    dev = w32.device
    w = w32.float().clone()
    H64 = H.to(torch.float64)
    damp = 0.05 * float(H.float().diagonal().mean()) + 1e-8
    Hinv = torch.linalg.inv(H64 + torch.eye(K, dtype=torch.float64, device=dev) * damp)
    U = torch.linalg.cholesky(Hinv).T.float()  # upper, U^T U = H^-1
    q = torch.zeros((K, N), dtype=torch.int8, device=dev)
    scales = torch.zeros((K // group_size, N), dtype=torch.float32, device=dev)
    for g0 in range(0, K, group_size):
        g1 = g0 + group_size
        _, s = _rtn(w[g0:g1], qmax, 1, clip_search)
        s = s[0, 0]
        scales[g0 // group_size] = s
        errs = torch.zeros((group_size, N), dtype=torch.float32, device=dev)
        for i in range(g0, g1):
            qi = torch.clamp(torch.round(w[i] / s), -qmax, qmax)
            q[i] = qi.to(torch.int8)
            errs[i - g0] = (w[i] - qi * s) / U[i, i]
            if i + 1 < g1:  # in-group compensation, rank 1
                w[i + 1:g1] -= torch.outer(U[i, i + 1:g1], errs[i - g0])
        if g1 < K:  # cross-group compensation, one product per group
            w[g1:] -= U[g0:g1, g1:].T @ errs
    return q, scales


def fc2_hessian_mc(w1: torch.Tensor, n_samples: int = 3072, seed: int = 0) -> torch.Tensor:
    """Monte-Carlo input Hessian ``H = E[h h^T]`` of a gated MLP's fc2 (JAX's
    ``fc2_hessian_mc``): iid standard-normal fc1 inputs (drawn by numpy from
    ``seed``, the same numbers as JAX's), fc1 and the SiLU gate in fp32 on
    ``w1``'s device, ``h^T h`` accumulated in float64. ``w1``: ``[d_model,
    2 * d_ff]``. Returns fp32 ``[d_ff, d_ff]``."""
    w1 = w1.float()
    dev = w1.device
    d_ff = w1.shape[-1] // 2
    H = torch.zeros((d_ff, d_ff), dtype=torch.float64, device=dev)
    rng = np.random.default_rng(seed)
    done = 0
    while done < n_samples:
        m = min(512, n_samples - done)
        x = torch.from_numpy(rng.standard_normal((m, w1.shape[0])).astype(np.float32)).to(dev)
        z = x @ w1
        y, g = z[:, :d_ff], z[:, d_ff:]
        h = y * (g * (0.5 * (1.0 + torch.tanh(0.5 * g))))
        H += (h.T @ h).double()
        done += m
    return (H / n_samples).float()


def _groups(K: int, bits: int, group_size: int | None) -> int:
    """Scale groups of a ``K``-row contraction: JAX's rule (int4 only, and
    only where the group divides K and is shorter)."""
    if bits == 4 and group_size is not None and K % group_size == 0 and K > group_size:
        return K // group_size
    return 1


def quantize_weight(w: torch.Tensor, bits: int = 8, group_size: int | None = None,
                    clip_search: bool = False, fake: bool = False, gptq_h=None,
                    fake_dtype=None) -> dict:
    """``[..., K, N]`` float -> a quantized leaf (module docstring), one slice
    of the leading axes at a time on ``w``'s device.

    ``bits`` 8 or 4; ``group_size`` and ``clip_search`` as JAX's (groups for
    int4 only). ``gptq_h(idx) -> [K, K]`` (int4, grouped) runs GPTQ on slice
    ``idx`` against that Hessian. ``fake`` returns ``{"weight":
    q * scale}`` in ``fake_dtype or w.dtype`` instead."""
    if bits not in (8, 4):
        raise ValueError(f"quantize_weight: bits must be 8 or 4, got {bits}")
    qmax = QMAX if bits == 8 else QMAX4
    lead, (K, N) = w.shape[:-2], w.shape[-2:]
    G = _groups(K, bits, group_size)
    dev = w.device
    if fake:
        deq = torch.empty(w.shape, dtype=fake_dtype or w.dtype, device=dev)
    elif bits == 4:
        if N % 2:
            raise ValueError(f"quantize_weight: int4 packs column pairs, got N = {N}")
        packed = torch.empty((*lead, K, N // 2), dtype=torch.uint8, device=dev)
    else:
        q8 = torch.empty(w.shape, dtype=torch.int8, device=dev)
    scale = torch.empty((*lead, G, 1, N), dtype=torch.float32, device=dev)
    for idx in itertools.product(*map(range, lead)):
        w32 = w[idx].float()
        if gptq_h is not None and bits == 4 and G > 1:
            q, s = _gptq_compensate(w32, gptq_h(idx), qmax, K // G, clip_search)
            s = s[:, None, :]
        else:
            q, s = _rtn(w32, qmax, G, clip_search)
        scale[idx] = s
        if fake:
            deq[idx] = (q.float().reshape(G, K // G, N) * s).reshape(K, N).to(deq.dtype)
        elif bits == 4:
            packed[idx] = pack_int4(q)
        else:
            q8[idx] = q
    if fake:
        return {"weight": deq}
    if bits == 4:
        return {"weight_int4": packed, "scale": scale}
    return {"weight_int8": q8, "scale": scale.squeeze(-3)}


def dequantize_weight(p: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """The ``[..., K, N]`` weight a quantized leaf stands for, in ``dtype``."""
    if "weight_int4" in p:
        q = unpack_int4(p["weight_int4"]).float()
        scale = p["scale"]
        G = scale.shape[-3]
        K, N = q.shape[-2:]
        w = q.reshape(*q.shape[:-2], G, K // G, N) * scale
        return w.reshape(q.shape).to(dtype)
    return (p["weight_int8"].float() * p["scale"]).to(dtype)


def proj_matmul(x: torch.Tensor, p: dict) -> torch.Tensor:
    """``x @ W`` for a float leaf ``{"weight"}``, an int8 leaf (``qmm_int8``:
    fp32 accumulation, the scale on the fp32 result) or an int4 leaf
    (``qmm_int4``: fp32 partials over slices of each group's rows, each
    times its group's scale, summed in fp32); one rounding to ``x.dtype``."""
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if "weight_int4" in p:
        wq = p["weight_int4"]
        if wq.ndim != 2:
            raise ValueError(f"proj_matmul: one layer's int4 weight expected, got "
                             f"{tuple(wq.shape)}")
        return qmm_int4(x2, wq, p["scale"], x.dtype).reshape(*x.shape[:-1], 2 * wq.shape[-1])
    wq = p.get("weight_int8")
    if wq is None:
        return torch.matmul(x, p["weight"])
    if wq.ndim != 2:
        raise ValueError(f"proj_matmul: one layer's int8 weight expected, got {tuple(wq.shape)}")
    y = qmm_int8(x2, wq[None], p["scale"][None], x.dtype)
    return y.reshape(*x.shape[:-1], wq.shape[-1])


def proj_matmul_f32(x: torch.Tensor, p: dict) -> torch.Tensor:
    """``x @ W`` in fp32, not rounded: a row-parallel rank's partial sum
    (``models/backbone._row_parallel``). A float leaf's product sums in
    fp32 (bf16 operands: every product is exact in fp32; on the card
    ``torch.mm`` with an fp32 output), an int8 leaf's runs ``qmm_int8`` with
    an fp32 output, the scale applied to the fp32 product: the slice of the
    contraction a rank holds keeps every output column's whole scale, so the
    scaled partials sum to the scaled total. An int4 leaf runs ``qmm_int4``
    with an fp32 output over the rank's rows and the scales of the groups
    they fall in (``parallel/sharding``): partial sums within a group
    commute with that group's scale."""
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    wq = p.get("weight_int8")
    if "weight_int4" in p:
        y = qmm_int4(x2, p["weight_int4"], p["scale"], torch.float32)
    elif wq is not None:
        y = qmm_int8(x2, wq[None], p["scale"][None], torch.float32)[:, 0]
    elif x2.dtype == torch.float32 and p["weight"].dtype == torch.float32:
        y = x2 @ p["weight"]
    elif x2.is_cuda:
        y = torch.mm(x2, p["weight"], out_dtype=torch.float32)
    else:
        y = x2.float() @ p["weight"].float()
    return y.reshape(*x.shape[:-1], y.shape[-1])


def awq_fold(layers: dict, fc2_energy, group_size: int = 128,
             alphas=(0.0, 0.25, 0.5, 0.75, 1.0)) -> dict:
    """Activation-aware rescale of the gated MLP ahead of int4 fc2 (JAX's
    ``awq_fold``, Lin et al. 2023): fc2's contraction row ``c`` times
    ``s_c`` and fc1's ``y``-half column ``c`` divided by it, an identity on
    the block's output. Per layer ``s = clip((rms / geomean(rms)) ** alpha,
    1e-3, 1e3)`` with ``rms`` from the captured ``fc2_energy`` ``[L, F]``
    (``models/backbone``'s ``capture_fc2``) and ``alpha`` the one of
    ``alphas`` with the least energy-weighted error under the grouped int4
    quantizer with the clip search (``alpha = 0`` is no fold). The search
    runs on the weights' device, the error in float64 of fp32 terms, as in
    JAX. Returns a new stacked ``layers`` tree with fp32 fc1/fc2."""
    if "weight" not in layers.get("fc1", {}) or "weight" not in layers.get("fc2", {}):
        raise ValueError("awq_fold: a float fc1/fc2 tree is required")
    w1 = layers["fc1"]["weight"].float().clone()
    w2 = layers["fc2"]["weight"].float().clone()
    dev = w2.device
    e = torch.as_tensor(np.asarray(fc2_energy, dtype=np.float64)
                        if not isinstance(fc2_energy, torch.Tensor) else fc2_energy,
                        dtype=torch.float64).to(dev)
    L, F, _ = w2.shape
    rms = torch.sqrt(torch.clamp(e, min=1e-20))
    rms = rms / torch.exp(torch.log(rms).mean(dim=1, keepdim=True))
    G = _groups(F, 4, group_size)
    for l in range(L):
        best_err, best_s = None, None
        for a in alphas:
            s = torch.clamp(rms[l] ** a, 1e-3, 1e3).float()
            w2s = w2[l] * s[:, None]
            q, sc = _rtn(w2s, QMAX4, G, clip_search=True)
            dq = (q.float().reshape(G, F // G, -1) * sc).reshape(F, -1)
            err = float((((dq - w2s) ** 2).sum(dim=1).double() * (e[l] / s.double() ** 2)).sum())
            if best_err is None or err < best_err:
                best_err, best_s = err, s
        w2[l] *= best_s[:, None]
        w1[l, :, :F] /= best_s[None, :]
    return {**layers, "fc1": {**layers["fc1"], "weight": w1},
            "fc2": {**layers["fc2"], "weight": w2}}


def quantize_backbone_params(backbone_params: dict, bits: int = 8,
                             mlp_bits: int | None = None, int4_group: int | None = 128,
                             fake: bool = False, fc2_bits: int | None = None,
                             gptq: bool = False, awq_energy=None) -> dict:
    """The backbone's projections quantized (a new tree; norms and the SSM's
    other tensors untouched), with JAX's width rules: attention and Mamba
    projections take ``bits``, fc1 ``mlp_bits or bits``, fc2 ``fc2_bits or
    mlp_bits or bits``; int4 projections take ``int4_group``-row groups and
    the clip search. On the transformer's stacked tree and on the hybrid's
    stacked-by-kind tree (``"mamba"``, ``"attn"``), each layer gets the
    values JAX gives it in its per-layer list.

    ``gptq``: int4 fc2 runs GPTQ against a Monte-Carlo Hessian from its
    layer's own fc1 (:func:`fc2_hessian_mc`). ``awq_energy`` ``[L, F]``:
    the transformer's MLP is folded first (:func:`awq_fold`); it raises on
    the hybrid and where fc2 is not int4."""
    w_fc1 = mlp_bits or bits
    w_fc2 = fc2_bits or mlp_bits or bits
    hybrid = "layers" not in backbone_params
    if awq_energy is not None and (hybrid or w_fc2 != 4):
        raise ValueError("awq_energy needs the transformer with int4 fc2: the fold "
                         "would be skipped" + (" (hybrid backbone)" if hybrid else
                                               f" (fc2 at {w_fc2} bits)"))
    act_dtype = None

    def quantize_layer(layer: dict) -> dict:
        out = dict(layer)
        for k in _QUANT_KEYS:
            if k not in layer or "weight" not in layer[k]:
                continue
            b = w_fc2 if k == "fc2" else w_fc1 if k == "fc1" else bits
            h_fn = None
            if gptq and k == "fc2" and b == 4 and "weight" in layer.get("fc1", {}):
                w1 = layer["fc1"]["weight"]
                h_fn = lambda idx, _w1=w1: fc2_hessian_mc(_w1[idx])  # noqa: E731
            out[k] = quantize_weight(layer[k]["weight"], bits=b,
                                     group_size=int4_group if b == 4 else None,
                                     clip_search=b == 4, fake=fake, gptq_h=h_fn,
                                     fake_dtype=act_dtype if k in _MLP_KEYS else None)
        return out

    out = dict(backbone_params)
    if hybrid:
        for kind in ("mamba", "attn"):
            if kind in backbone_params:
                out[kind] = quantize_layer(backbone_params[kind])
        return out
    layers = backbone_params["layers"]
    if awq_energy is not None:
        act_dtype = layers["fc1"]["weight"].dtype
        layers = awq_fold(layers, awq_energy, group_size=int4_group or 128)
    out["layers"] = quantize_layer(layers)
    return out


def quantize_zonos_params(params: dict, heads: bool = True, embeddings: bool = False,
                          bits: int = 8, mlp_bits: int | None = None,
                          int4_group: int | None = 128, fake: bool = False,
                          fc2_bits: int | None = None, gptq: bool = False,
                          awq_energy=None) -> dict:
    """Backbone projections as :func:`quantize_backbone_params`; the 9 heads
    (``heads``, scales on the fp32 logits) and the code embeddings
    (``embeddings``, scale ``[K, 1, D]`` with a 0-d ``act_dtype`` marker of
    the table's dtype) to int8, never lower; the conditioners stay as they
    are."""
    out = dict(params)
    out["backbone"] = quantize_backbone_params(
        params["backbone"], bits=bits, mlp_bits=mlp_bits, int4_group=int4_group, fake=fake,
        fc2_bits=fc2_bits, gptq=gptq, awq_energy=awq_energy)
    if heads and "weight" in params["heads"]:
        out["heads"] = quantize_weight(params["heads"]["weight"], fake=fake)
    if embeddings and "weight" in params["embeddings"]:
        w = params["embeddings"]["weight"]  # [K, V, D]
        q = quantize_weight(w)
        q["act_dtype"] = torch.zeros((), dtype=w.dtype, device=w.device)
        out["embeddings"] = q
    return out


def quantize_kv(x: torch.Tensor, dh_axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(position, head) int8 for KV columns: absmax over the
    head-dim axis. Returns int8 values and fp32 scales with ``dh_axis``
    squeezed."""
    q, scale = _absmax_quantize(x.float(), dim=dh_axis)
    return q, scale.squeeze(dh_axis)


def quantize_rows(x: torch.Tensor, n_heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The port's time-major KV rows ``[..., Hkv*Dh]`` -> int8 rows and fp32
    scales ``[..., Hkv]``, one per (position, head)."""
    q, scale = quantize_kv(x.unflatten(-1, (n_heads, -1)), dh_axis=-1)
    return q.flatten(-2), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 KV rows ``[..., Hkv*Dh]`` with their scales ``[..., Hkv]`` -> fp32."""
    return (q.float().unflatten(-1, (scale.shape[-1], -1)) * scale[..., None]).flatten(-2)
