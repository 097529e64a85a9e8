"""The yardstick's arithmetic: the work a decode step, a prefill and each
kernel's calls need, counted from the configuration's shapes and the steps
the run took (never from launches), and the chip's published peaks.

Bytes count each input byte read once and each output byte written once;
a kernel's least time is ``max(bytes / HBM_BPS, flops / BF16_FLOPS)``.
Rows are CFG rows: a request holds two (conditioned and not).
"""

from __future__ import annotations

from .weights import attention_geometry, head_width, mamba_geometry

# NVIDIA H100 SXM5 (data sheet; dense, 700 W).
BF16_FLOPS = 989e12
HBM_BPS = 3.35e12


def projections(cfg: dict) -> list[tuple[int, int, int]]:
    """``(count, K, N)`` of every backbone projection and the heads (the
    useful 1025 columns of each of the 9)."""
    bb = cfg["backbone"]
    D = bb["d_model"]
    hq, hkv, dh, _ = attention_geometry(bb)
    F = bb["attn_mlp_d_intermediate"]
    heads = (cfg["num_codebooks"], D, cfg["codebook_size"] + 1)
    if not bb.get("ssm_cfg"):
        L = bb["n_layer"]
        return [(L, D, (hq + 2 * hkv) * dh), (L, hq * dh, D), (L, D, 2 * F), (L, F, D), heads]
    La = len(bb["attn_layer_idx"])
    M = bb["n_layer"] - La
    g = mamba_geometry(bb)
    return [(M, D, g["d_in_proj"]), (M, g["d_inner"], D), (La, D, (hq + 2 * hkv) * dh),
            (La, hq * dh, D), (La, D, 2 * F), (La, F, D), heads]


def step_flops(cfg: dict, rows: int) -> float:
    """Matrix-multiply FLOPs of one decode step over ``rows`` rows
    (attention's and the SSM's few FLOPs left out: an under-count)."""
    return 2.0 * rows * sum(n * k * m for n, k, m in projections(cfg))


def qmm_int8_least_s(cfg: dict, m: int) -> float:
    """Least time of one forward's int8 projections at ``m`` rows (int8
    weights and fp32 column scales read once, bf16 activations in and
    out; the heads' fp32 logits out)."""
    total = 0.0
    projs = projections(cfg)
    for i, (n, k, cols) in enumerate(projs):
        out_bytes = 4 if i == len(projs) - 1 else 2
        width = head_width(cfg) if i == len(projs) - 1 else cols
        b = k * width + 4 * width + 2 * m * k + out_bytes * m * width
        f = 2.0 * m * k * width
        total += n * max(b / HBM_BPS, f / BF16_FLOPS)
    return total


def attention_decode_least_s(cfg: dict, rows: list[tuple[int, int]], int8_prefix: bool) -> float:
    """Least time of one decode step's attention over every attention
    layer, for requests whose caches stand at ``(position, ring length)``
    (two CFG rows each): the prefix's K and V (int8 with fp32 per-(position,
    kv head) scales, or bf16), the ring's bf16 K and V, the new column's
    write, the query in and the output out."""
    bb = cfg["backbone"]
    hq, hkv, dh, _ = attention_geometry(bb)
    W = hkv * dh
    layers = len(bb["attn_layer_idx"]) if bb.get("ssm_cfg") else bb["n_layer"]
    b = 0.0
    for pos, ring in rows:
        prefix = pos - ring
        per = (2 * prefix * W + 2 * prefix * hkv * 4) if int8_prefix else 2 * prefix * W * 2
        per += 2 * ring * W * 2 + 2 * W * 2 + 2 * hq * dh * 2
        b += 2 * per
    return layers * b / HBM_BPS


def ssd_step_least_s(cfg: dict, requests: int, state_bytes: int = 4) -> float:
    """Least time of one decode step's fused Mamba-2 steps: each row's
    state read and written, its x, z and output (bf16), B, C (fp32) and dt,
    over every Mamba layer."""
    bb = cfg["backbone"]
    g = mamba_geometry(bb)
    M = bb["n_layer"] - len(bb["attn_layer_idx"])
    per_row = (2 * g["d_state"] * g["d_inner"] * state_bytes + 3 * g["d_inner"] * 2
               + 2 * g["d_state"] * 4 + g["nheads"] * 4 * 2)
    return M * 2 * requests * per_row / HBM_BPS
