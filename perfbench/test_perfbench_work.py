"""The yardstick's counts equal hand counts of both configurations."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from perfbench.lib import work

CONFIGS = Path(__file__).resolve().parent / "configs"


def model(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["model"]


T, H = "zonos-v0.1-transformer.int8", "zonos-v0.1-hybrid.bf16"


def test_transformer_projection_counts():
    # Per layer: qkv 2048 x (32 + 2 * 8) * 64, out 2048 x 2048, fc1 2048 x
    # 2 * 8192, fc2 8192 x 2048; 26 layers; 9 heads of 2048 x 1025.
    per_layer = 2048 * 3072 + 2048 * 2048 + 2048 * 16384 + 8192 * 2048
    params = 26 * per_layer + 9 * 2048 * 1025
    assert work.step_flops(model(T), 16) == pytest.approx(2 * 16 * params)
    assert params == 1_600_145_408  # 1.60 G parameters in matrix products


def test_hybrid_projection_counts():
    # 42 Mamba-2 layers: in_proj 2048 x (2 * 4096 + 2 * 128 + 64), out 4096 x
    # 2048; 6 attention layers: qkv 2048 x (16 + 2 * 4) * 128, out 2048 x
    # 2048, fc1 2048 x 16384, fc2 8192 x 2048; 9 heads.
    mamba = 2048 * 8512 + 4096 * 2048
    attn = 2048 * 3072 + 2048 * 2048 + 2048 * 16384 + 8192 * 2048
    params = 42 * mamba + 6 * attn + 9 * 2048 * 1025
    assert work.step_flops(model(H), 2) == pytest.approx(2 * 2 * params)


def test_qmm_int8_bytes_of_a_pooled_step():
    m = 16
    per_layer = 0.0
    for k, n in ((2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048)):
        per_layer += k * n + 4 * n + 2 * m * k + 2 * m * n
    heads = 9 * (2048 * 1152 + 4 * 1152 + 2 * m * 2048 + 4 * m * 1152)
    assert work.qmm_int8_least_s(model(T), m) == pytest.approx(
        (26 * per_layer + heads) / work.HBM_BPS)
    # ~1.6 GB of int8 weights a step: about 0.48 ms at 3.35 TB/s.
    assert 0.47e-3 < work.qmm_int8_least_s(model(T), m) < 0.50e-3
    # A prefill of 2 x 100 rows: the heads' bytes still bound it, the
    # backbone's FLOPs bound its projections.
    assert work.qmm_int8_least_s(model(T), 200) > work.qmm_int8_least_s(model(T), 16)


def test_attention_bytes():
    # One request at position 500 with a 20-position ring, int8 prefix:
    # 26 layers x 2 rows x (2 x 480 x 512 + 2 x 480 x 8 x 4 + 2 x 20 x 512 x 2
    # + 2 x 512 x 2 + 2 x 2048 x 2) bytes.
    per = 2 * 480 * 512 + 2 * 480 * 8 * 4 + 2 * 20 * 512 * 2 + 2 * 512 * 2 + 2 * 2048 * 2
    assert work.attention_decode_least_s(model(T), [(500, 20)], True) == pytest.approx(
        26 * 2 * per / work.HBM_BPS)
    # The hybrid's 6 attention layers, bf16 prefix, 4 kv heads of 128.
    per = 2 * 480 * 512 * 2 + 2 * 20 * 512 * 2 + 2 * 512 * 2 + 2 * 2048 * 2
    assert work.attention_decode_least_s(model(H), [(500, 20)], False) == pytest.approx(
        6 * 2 * per / work.HBM_BPS)


def test_ssd_state_bytes():
    # 42 layers x 2 rows x (fp32 state read and written + x, z, y bf16 + B, C
    # fp32 + dt and its decay fp32) per request.
    per_row = 2 * 128 * 4096 * 4 + 3 * 4096 * 2 + 2 * 128 * 4 + 64 * 4 * 2
    assert work.ssd_step_least_s(model(H), 8) == pytest.approx(42 * 2 * 8 * per_row / work.HBM_BPS)
