"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Flagship shapes (26 layers, CFG batch 2, 32 query heads, 8 KV heads, head
dim 64), bf16; the pool's kernels at the 8-slot pool's (16 CFG rows, cache
length 3584); the hybrid's (6 attention layers, 16 query and 4 KV heads,
head dim 128; 42 Mamba-2 layers with a [B, 128, 4096] state). Run on a
machine with an NVIDIA GPU:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

(``--noconftest``: the repository's conftest sets up JAX, which that machine
does not need.) Without a card every test here skips.
"""

import pytest
import torch

from zonos_vibes_tpu_torch.ops import quant
from zonos_vibes_tpu_torch.ops.cuda import build
from zonos_vibes_tpu_torch.ops.cuda.decode_attention import (
    decode_attention_layered,
    decode_attention_layered_plain,
    decode_attention_layered_q,
    decode_attention_layered_q_plain,
    decode_attention_pooled_staged,
    decode_attention_pooled_staged_plain,
    decode_attention_pooled_staged_q,
    decode_attention_pooled_staged_q_plain,
    decode_attention_pooled_unstaged,
    decode_attention_pooled_unstaged_plain,
    decode_attention_unstaged,
    decode_attention_unstaged_plain,
)
from zonos_vibes_tpu_torch.ops.cuda.mamba_step import (
    ssd_gate_step,
    ssd_gate_step_layered,
    ssd_gate_step_layered_plain,
)
from zonos_vibes_tpu_torch.ops.cuda.prefill_attention import (
    prefill_attention,
    prefill_attention_plain,
)
from zonos_vibes_tpu_torch.ops.cuda.qmm import qmm_int8, qmm_int8_plain
from zonos_vibes_tpu_torch.ops.cuda.stage_write import (
    stage_splice,
    stage_splice_plain,
    stage_splice_rows,
    stage_splice_rows_plain,
)

pytestmark = pytest.mark.gpu

L, B, HQ, HKV, D, STAGE = 26, 2, 32, 8, 64, 128
W = HKV * D
# bf16 output rounding (2^-8 relative) plus the kernel keeping p in fp32
# where the plain version rounds it to bf16 before the value product.
TOL = dict(rtol=2e-2, atol=2e-2)
# The int8 kernels run their plain versions' fp32 arithmetic in another
# summation order; the output rounds once, possibly to the neighbouring
# bf16 step.
QMM_TOL = {torch.bfloat16: dict(rtol=8e-3, atol=1e-2), torch.float32: dict(rtol=1e-5, atol=1e-4)}
Q_TOL = dict(rtol=1e-2, atol=1e-2)
# The pooled attention kernels are also held row by row, each row's largest
# |error| against its own largest |output|: a deep row's outputs are ~0.06 at
# most, so an absolute limit set by the shallow rows (outputs up to ~4)
# would pass a deep row that lost a 256-position split (~25% of its largest
# output). The legitimate error is under 1%.
POOL_ROW_TOL = {"bf16": 2e-2, "int8": 1e-2}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, dev):
    return torch.randn(*shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)


@pytest.fixture(scope="module")
def decode_inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    T = 3072
    return dict(
        q=_randn(gen, B, 1, HQ, D, dev=dev),
        k_cache=_randn(gen, L, B, T, W, dev=dev),
        v_cache=_randn(gen, L, B, T, W, dev=dev),
        k_stage=_randn(gen, L, B, STAGE, W, dev=dev),
        v_stage=_randn(gen, L, B, STAGE, W, dev=dev),
        k_cur=_randn(gen, B, W, dev=dev),
        v_cur=_randn(gen, B, W, dev=dev),
    )


@pytest.mark.parametrize("flushed_end", [0, 1, 500, 2944])
@pytest.mark.parametrize("stage_len", [0, 5, 127])
@pytest.mark.parametrize("layer", [0, 25])
def test_decode_attention_kernel(dev, decode_inputs, flushed_end, stage_len, layer):
    scalars = torch.tensor([flushed_end, stage_len, layer], dtype=torch.int32, device=dev)
    before = build.LAUNCHES["decode_attention"]
    got = decode_attention_layered(**decode_inputs, scalars=scalars)
    torch.cuda.synchronize()
    assert build.LAUNCHES["decode_attention"] == before + 1
    want = decode_attention_layered_plain(**decode_inputs, scalars=scalars)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


@pytest.mark.parametrize("flushed_end,stage_len", [(1000, 0), (744, 127), (255, 3)])
def test_decode_attention_kernel_ragged_cache(dev, flushed_end, stage_len):
    """A cache length (1000) that is not a multiple of the 256-position split."""
    gen = torch.Generator(device=dev).manual_seed(flushed_end)
    T = 1000
    x = dict(q=_randn(gen, B, 1, HQ, D, dev=dev), k_cache=_randn(gen, L, B, T, W, dev=dev),
             v_cache=_randn(gen, L, B, T, W, dev=dev),
             k_stage=_randn(gen, L, B, STAGE, W, dev=dev),
             v_stage=_randn(gen, L, B, STAGE, W, dev=dev),
             k_cur=_randn(gen, B, W, dev=dev), v_cur=_randn(gen, B, W, dev=dev))
    scalars = torch.tensor([flushed_end, stage_len, 7], dtype=torch.int32, device=dev)
    got = decode_attention_layered(**x, scalars=scalars)
    torch.cuda.synchronize()
    want = decode_attention_layered_plain(**x, scalars=scalars)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


def test_decode_attention_ignores_padded_tail(dev, decode_inputs):
    """Positions at or past flushed_end must not change the result."""
    scalars = torch.tensor([500, 5, 3], dtype=torch.int32, device=dev)
    a = decode_attention_layered(**decode_inputs, scalars=scalars)
    poisoned = dict(decode_inputs)
    poisoned["k_cache"] = decode_inputs["k_cache"].clone()
    poisoned["k_cache"][3, :, 500:] = float("nan")
    poisoned["k_stage"] = decode_inputs["k_stage"].clone()
    poisoned["k_stage"][3, :, 5:] = float("nan")
    b = decode_attention_layered(**poisoned, scalars=scalars)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("slot", [0, 1, 63, 127])
def test_stage_splice_kernel(dev, slot):
    gen = torch.Generator(device=dev).manual_seed(slot)
    stage = _randn(gen, L, B, STAGE, W, dev=dev)
    cols = _randn(gen, L, B, W, dev=dev)
    want = stage_splice_plain(stage.clone(), cols, torch.tensor([slot]))
    got = stage_splice(stage, cols, torch.tensor([slot], dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    assert got.data_ptr() == stage.data_ptr()
    assert torch.equal(got, want)


@pytest.mark.parametrize("S", [7, 97, 600])
@pytest.mark.parametrize("offset", [0, 64])
def test_prefill_attention_kernel(dev, S, offset):
    gen = torch.Generator(device=dev).manual_seed(S + offset)
    T = 768
    q = _randn(gen, B, S, HQ, D, dev=dev)
    k = _randn(gen, B, T, W, dev=dev)
    v = _randn(gen, B, T, W, dev=dev)
    got = prefill_attention(q, k, v, offset)
    torch.cuda.synchronize()
    want = prefill_attention_plain(q, k, v, offset)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


# (Hq, Hkv, D): the transformer (G = 4), the hybrid (G = 4 at head dim 128),
# and one query head per KV head (G = 1).
PREFILL_HEADS = [(HQ, HKV, D), (16, 4, 128), (8, 8, 64)]


@pytest.mark.parametrize("heads", PREFILL_HEADS, ids=["d64g4", "d128g4", "d64g1"])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 32, 33, 63, 64, 65, 88, 600, 2048])
@pytest.mark.parametrize("offset", [0, 64, 1000])
@pytest.mark.parametrize("wide", [False, True], ids=["b1", "bwide"])
def test_prefill_attention_kernel_tile_edges(dev, heads, S, offset, wide):
    """Every query-tile and key-tile edge at both tile heights; every cache
    row at or past offset + S is NaN and must never be read.

    The kernel takes 64-row tiles when their grid covers at least half of
    the 132 SMs, else 32-row ones. One batch row keeps every chunk of up to
    88 positions under that (32-row tiles); 17 put each of them over it
    (64-row tiles). Chunks of 600 or more take 64-row tiles at any batch, so
    the wide case runs them at 2 rows."""
    Hq, Hkv, Dh = heads
    Bs = (17 if S <= 128 else 2) if wide else 1
    gen = torch.Generator(device=dev).manual_seed(S + offset + Dh)
    T = offset + S + 40
    q = _randn(gen, Bs, S, Hq, Dh, dev=dev)
    k = _randn(gen, Bs, T, Hkv * Dh, dev=dev)
    v = _randn(gen, Bs, T, Hkv * Dh, dev=dev)
    k[:, offset + S:] = float("nan")
    v[:, offset + S:] = float("nan")
    before = build.LAUNCHES["prefill_attention"]
    got = prefill_attention(q, k, v, offset)
    torch.cuda.synchronize()
    assert build.LAUNCHES["prefill_attention"] == before + 1
    assert torch.isfinite(got).all()
    end = offset + S
    want = prefill_attention_plain(q, k[:, :end].contiguous(), v[:, :end].contiguous(), offset)
    torch.testing.assert_close(got.float(), want.float(), **TOL)


def test_wrappers_raise_on_fp32_cuda(dev):
    q = torch.zeros(1, 4, HQ, D, device=dev)
    kv = torch.zeros(1, 16, W, device=dev)
    before = build.LAUNCHES["prefill_attention"]
    with pytest.raises(ValueError):
        prefill_attention(q, kv, kv, 0)
    assert build.LAUNCHES["prefill_attention"] == before


# Solo step (1, 2), pooled step (16, 8 slots), prefill (176), and the edges of
# the tensor-core path's 16- and 64-row tiles.
QMM_MS = [1, 2, 3, 15, 16, 17, 64, 65, 176]
QMM_SHAPES = [
    (1, 2048, 3072, torch.bfloat16), (1, 2048, 2048, torch.bfloat16),
    (1, 2048, 16384, torch.bfloat16), (1, 8192, 2048, torch.bfloat16),
    (9, 2048, 1152, torch.float32),  # the 9 heads, fp32 logits
    (2, 1000, 144, torch.bfloat16),  # ragged: K not a multiple of 256, N of 128
    (2, 320, 144, torch.bfloat16),   # K not a multiple of the 128-row split
    (1, 330, 32, torch.bfloat16),    # K not a multiple of 8: x staged by plain loads
    (1, 2112, 3072, torch.bfloat16),  # K = 2048 + 64: one block's rows past a stage
    (1, 8256, 2048, torch.bfloat16),  # K = 8192 + 64: the cluster's last rank ragged
    (1, 40000, 64, torch.bfloat16),   # clusters of 8, each block walking 5000 rows
]


@pytest.mark.parametrize("M", QMM_MS)
@pytest.mark.parametrize("G,K,N,out_dtype", QMM_SHAPES)
def test_qmm_int8_kernel(dev, M, G, K, N, out_dtype):
    gen = torch.Generator(device=dev).manual_seed(M + N)
    wq = quant.quantize_weight(_randn(gen, G, K, N, dev=dev) / K ** 0.5)
    x = _randn(gen, M, K, dev=dev)
    before = build.LAUNCHES["qmm_int8"]
    got = qmm_int8(x, wq["weight_int8"], wq["scale"], out_dtype)
    torch.cuda.synchronize()
    assert build.LAUNCHES["qmm_int8"] == before + 1
    assert got.shape == (M, G, N) and got.dtype == out_dtype
    want = qmm_int8_plain(x, wq["weight_int8"], wq["scale"], out_dtype)
    torch.testing.assert_close(got.float(), want.float(), **QMM_TOL[out_dtype])
    # The split rows meet in a fixed order (in the cluster at M <= 2; under
    # tile counters that reset at M > 2): a second launch gives the same bits.
    assert torch.equal(qmm_int8(x, wq["weight_int8"], wq["scale"], out_dtype), got)


@pytest.mark.parametrize("M", [3, 16, 17, 176])
@pytest.mark.parametrize("G,K,N,out_dtype", [QMM_SHAPES[3], QMM_SHAPES[4]])
def test_qmm_int8_rows_are_isolated(dev, M, G, K, N, out_dtype):
    """A row's output does not change when another row of x changes (the
    pool's row isolation), nor when x has fewer rows in the same tile."""
    gen = torch.Generator(device=dev).manual_seed(M)
    wq = quant.quantize_weight(_randn(gen, G, K, N, dev=dev) / K ** 0.5)
    x = _randn(gen, M, K, dev=dev)
    got = qmm_int8(x, wq["weight_int8"], wq["scale"], out_dtype)
    x2 = x.clone()
    x2[M - 1] = _randn(gen, K, dev=dev)
    got2 = qmm_int8(x2, wq["weight_int8"], wq["scale"], out_dtype)
    assert torch.equal(got[:M - 1], got2[:M - 1])
    assert not torch.equal(got[M - 1], got2[M - 1])
    if M <= 16:  # same 16-row tile, same plan: row 0 alone in the tile
        x3 = torch.zeros_like(x)
        x3[0] = x[0]
        assert torch.equal(qmm_int8(x3, wq["weight_int8"], wq["scale"], out_dtype)[0], got[0])


def _qmm_case(gen, M, G, K, N, dev):
    wq = quant.quantize_weight(_randn(gen, G, K, N, dev=dev) / K ** 0.5)
    return _randn(gen, M, K, dev=dev), wq["weight_int8"], wq["scale"]


def test_qmm_int8_keeps_no_state_between_calls(dev):
    """Calls of different shapes and M back to back, 300 in all, give each
    call's bits alone: the M <= 2 launches keep nothing between calls, and
    the M > 2 launches' tile counters are reset."""
    gen = torch.Generator(device=dev).manual_seed(30)
    cases = [(2, *QMM_SHAPES[0][:3], torch.bfloat16), (1, *QMM_SHAPES[3][:3], torch.bfloat16),
             (2, *QMM_SHAPES[4][:3], torch.float32), (16, *QMM_SHAPES[1][:3], torch.bfloat16),
             (2, *QMM_SHAPES[8][:3], torch.bfloat16), (1, *QMM_SHAPES[9][:3], torch.bfloat16),
             (2, *QMM_SHAPES[10][:3], torch.bfloat16)]
    calls = []
    for M, G, K, N, out_dtype in cases:
        x, w, scale = _qmm_case(gen, M, G, K, N, dev)
        calls.append(lambda x=x, w=w, scale=scale, o=out_dtype: qmm_int8(x, w, scale, o))
    alone = []
    for c in calls:
        alone.append(c())
        torch.cuda.synchronize()
    outs = [calls[i % len(calls)]() for i in range(300)]
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        assert torch.equal(got, alone[i % len(calls)]), f"call {i} differs from its call alone"


def test_qmm_int8_reads_x_written_just_before(dev):
    """The decode kernel right after a PyTorch kernel that writes x (no
    synchronisation between) sees the new x."""
    gen = torch.Generator(device=dev).manual_seed(31)
    x, w, scale = _qmm_case(gen, 2, 1, 2048, 3072, dev)
    want = qmm_int8_plain(x * 3, w, scale, torch.bfloat16)
    for _ in range(20):
        y = x.clone()
        y.mul_(3)
        got = qmm_int8(y, w, scale, torch.bfloat16)
        torch.testing.assert_close(got.float(), want.float(), **QMM_TOL[torch.bfloat16])


def test_qmm_int8_chain_reads_the_previous_output(dev):
    """A decode launch whose x is the previous decode launch's output (each
    may start while the one before it finishes) equals the plain chain."""
    gen = torch.Generator(device=dev).manual_seed(35)
    x, w1, s1 = _qmm_case(gen, 2, 1, 2048, 8192, dev)
    _, w2, s2 = _qmm_case(gen, 2, 1, 8192, 2048, dev)
    want = qmm_int8_plain(qmm_int8_plain(x, w1, s1, torch.bfloat16)[:, 0], w2, s2,
                          torch.bfloat16)
    for _ in range(20):
        got = qmm_int8(qmm_int8(x, w1, s1, torch.bfloat16)[:, 0], w2, s2, torch.bfloat16)
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def q_decode_inputs(dev, decode_inputs):
    x = dict(decode_inputs)
    for name in ("k", "v"):
        x[name + "_cache"], x[name + "_scale"] = quant.quantize_rows(x.pop(name + "_cache"), HKV)
    return x


@pytest.mark.parametrize("flushed_end", [0, 1, 500, 2944])
@pytest.mark.parametrize("stage_len", [0, 5, 127])
@pytest.mark.parametrize("layer", [0, 25])
def test_decode_attention_q_kernel(dev, q_decode_inputs, flushed_end, stage_len, layer):
    """Scales at or past flushed_end are poisoned with NaN: never read."""
    x = dict(q_decode_inputs)
    for name in ("k_scale", "v_scale"):
        x[name] = x[name].clone()
        x[name][:, :, flushed_end:] = float("nan")
    scalars = torch.tensor([flushed_end, stage_len, layer], dtype=torch.int32, device=dev)
    before = build.LAUNCHES["decode_attention_q"]
    got = decode_attention_layered_q(**x, scalars=scalars)
    torch.cuda.synchronize()
    assert build.LAUNCHES["decode_attention_q"] == before + 1
    want = decode_attention_layered_q_plain(**x, scalars=scalars)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **Q_TOL)


def test_int8_wrappers_raise_on_wrong_dtypes_on_cuda(dev, q_decode_inputs):
    x = torch.zeros(2, 64, device=dev)  # fp32 activations: the kernel takes bf16
    w = torch.zeros(1, 64, 32, dtype=torch.int8, device=dev)
    s = torch.ones(1, 1, 32, device=dev)
    before = dict(build.LAUNCHES)
    with pytest.raises(ValueError):
        qmm_int8(x, w, s, torch.float32)
    with pytest.raises(ValueError):  # N not a multiple of 16
        qmm_int8(x.bfloat16()[:, :64], w[..., :24].contiguous(), s[..., :24].contiguous())
    sc = torch.tensor([4, 1, 0], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        decode_attention_layered_q(**{**q_decode_inputs, "q": q_decode_inputs["q"].float()},
                                   scalars=sc)
    assert build.LAUNCHES == before


# The 8-slot pool: 16 CFG rows at their own depths over a 3584-position cache.
POOL_B, POOL_T = 16, 3584
POOL_BASES = [0, 1, 255, 256, 500, 1800, 3000, 3456, 0, 1, 255, 256, 500, 1800, 3000, 3456]
POOL_LENS = [0, 1, 5, 127, 1, 5, 127, 0, 127, 0, 1, 5, 5, 127, 0, 1]


def _assert_rows_close(got, want, rtol):
    g, w = got.float().flatten(1), want.float().flatten(1)
    rel = (g - w).abs().amax(1) / w.abs().amax(1)
    assert (rel <= rtol).all(), f"per-row relative error {rel.tolist()}"


@pytest.fixture(scope="module")
def pooled_inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(6)
    x = dict(q=_randn(gen, POOL_B, 1, HQ, D, dev=dev),
             k_cache=_randn(gen, L, POOL_B, POOL_T, W, dev=dev),
             v_cache=_randn(gen, L, POOL_B, POOL_T, W, dev=dev),
             k_stage=_randn(gen, L, POOL_B, STAGE, W, dev=dev),
             v_stage=_randn(gen, L, POOL_B, STAGE, W, dev=dev),
             k_cur=_randn(gen, POOL_B, W, dev=dev), v_cur=_randn(gen, POOL_B, W, dev=dev),
             bases=torch.tensor(POOL_BASES, dtype=torch.int32, device=dev),
             lens=torch.tensor(POOL_LENS, dtype=torch.int32, device=dev))
    for b, base in enumerate(POOL_BASES):  # never read: poison
        x["k_cache"][:, b, base:] = float("nan")
        x["v_cache"][:, b, base:] = float("nan")
    return x


@pytest.mark.parametrize("layer", [0, 25])
def test_decode_attention_pooled_kernel(dev, pooled_inputs, layer):
    before = build.LAUNCHES["decode_attention_pooled"]
    got = decode_attention_pooled_staged(**pooled_inputs, layer=layer)
    torch.cuda.synchronize()
    assert build.LAUNCHES["decode_attention_pooled"] == before + 1
    want = decode_attention_pooled_staged_plain(**pooled_inputs, layer=layer)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    _assert_rows_close(got, want, POOL_ROW_TOL["bf16"])


@pytest.mark.parametrize("layer", [0, 25])
def test_decode_attention_pooled_q_kernel(dev, pooled_inputs, layer):
    """int8 prefix, with NaN scales (and int8 values quantized from NaN) at
    or past each row's base."""
    x = dict(pooled_inputs)
    for name in ("k", "v"):
        x[name + "_cache"], x[name + "_scale"] = quant.quantize_rows(x[name + "_cache"], HKV)
    before = build.LAUNCHES["decode_attention_pooled_q"]
    got = decode_attention_pooled_staged_q(**x, layer=layer)
    torch.cuda.synchronize()
    assert build.LAUNCHES["decode_attention_pooled_q"] == before + 1
    want = decode_attention_pooled_staged_q_plain(**x, layer=layer)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **Q_TOL)
    _assert_rows_close(got, want, POOL_ROW_TOL["int8"])


def test_stage_splice_rows_kernel(dev):
    gen = torch.Generator(device=dev).manual_seed(9)
    stage = _randn(gen, L, POOL_B, STAGE, W, dev=dev)
    cols = _randn(gen, L, POOL_B, W, dev=dev)
    slots = torch.tensor([0, 7, 8, 127] * 4, dtype=torch.int32, device=dev)
    want = stage_splice_rows_plain(stage.clone(), cols, slots)
    before = build.LAUNCHES["stage_splice_rows"]
    got = stage_splice_rows(stage, cols, slots)
    torch.cuda.synchronize()
    assert build.LAUNCHES["stage_splice_rows"] == before + 1
    assert got.data_ptr() == stage.data_ptr()
    assert torch.equal(got, want)


def test_pooled_wrappers_raise_on_wrong_dtypes_on_cuda(dev, pooled_inputs):
    before = dict(build.LAUNCHES)
    with pytest.raises(ValueError):
        decode_attention_pooled_staged(**{**pooled_inputs, "q": pooled_inputs["q"].float()},
                                       layer=0)
    with pytest.raises(ValueError):
        stage_splice_rows(pooled_inputs["k_stage"], pooled_inputs["k_stage"][:, :, 0].contiguous(),
                          pooled_inputs["lens"].long())
    assert build.LAUNCHES == before


# The hybrid: 6 attention layers of 16 query and 4 KV heads at head dim 128
# (W = 512), 42 Mamba-2 layers with d_state 128 and d_inner 4096 (64 heads).
H_L, H_HQ, H_HKV, H_D = 6, 16, 4, 128
H_W = H_HKV * H_D
M_LAYERS, M_N, M_HP, M_H = 42, 128, 4096, 64
# bf16 output of the gated norm (2^-8 relative, outputs up to ~4): the
# kernel and its plain version run the same fp32 chain in another order.
SSM_TOL = dict(rtol=2e-2, atol=2e-2)


def _ssd_inputs(gen, B, dev, state_dtype, planes=M_LAYERS):
    f = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    states = torch.full((planes, B, M_N, M_HP), float("nan"), device=dev, dtype=state_dtype)
    dt = torch.nn.functional.softplus(f(B, M_H))
    return states, dict(xs=f(B, M_HP).bfloat16(), dt=dt, decay=torch.exp(-dt),
                        bm=f(B, M_N) * 0.3, cm=f(B, M_N) * 0.3, z=f(B, M_HP).bfloat16(),
                        d_skip=f(M_H), norm_w=(1.0 + 0.1 * f(M_HP)).bfloat16())


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


@pytest.mark.parametrize("B", [1, 2, 16])
@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layer", [0, 17, M_LAYERS - 1])
def test_ssd_gate_step_layered_kernel(dev, B, state_dtype, layer):
    """Plane ``layer`` updated in place against the plain version; every
    other plane (NaN) bitwise untouched."""
    gen = torch.Generator(device=dev).manual_seed(B + layer)
    states, x = _ssd_inputs(gen, B, dev, state_dtype)
    states[layer] = torch.randn(B, M_N, M_HP, generator=gen, device=dev).to(state_dtype)
    others_before = torch.cat([states[:layer], states[layer + 1:]]).clone()
    want_states = states[layer:layer + 1].clone()
    want = ssd_gate_step_layered_plain(want_states, 0, **x)
    before = build.LAUNCHES["ssd_gate_step"]
    got = ssd_gate_step_layered(states, layer, **x)
    torch.cuda.synchronize()
    assert build.LAUNCHES["ssd_gate_step"] == before + 1
    assert got.shape == (B, M_HP) and got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **SSM_TOL)
    # fp32 state: the same update in another rounding order; bf16: one step.
    stol = dict(rtol=1e-5, atol=1e-5) if state_dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(states[layer].float(), want_states[0].float(), **stol)
    others = torch.cat([states[:layer], states[layer + 1:]])
    assert torch.isnan(others).all()
    assert torch.equal(_bits(others), _bits(others_before))


@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
def test_ssd_gate_step_repeats_its_bits(dev, state_dtype):
    """The same inputs give the same output and state bits over 50 calls,
    with calls of another batch size in between (the workspace and the
    tickets carry nothing from one call to the next)."""
    gen = torch.Generator(device=dev).manual_seed(32)
    cases = []
    for B in (2, 16):
        states, x = _ssd_inputs(gen, B, dev, state_dtype, planes=2)
        states[1] = torch.randn(B, M_N, M_HP, generator=gen, device=dev).to(state_dtype)
        cases.append((states[1:].clone(), x))
    first = []
    for init, x in cases:
        st = init.clone()
        first.append((ssd_gate_step_layered(st, 0, **x), st))
    for i in range(50):
        init, x = cases[i % 2]
        st = init.clone()
        got = ssd_gate_step_layered(st, 0, **x)
        assert torch.equal(got, first[i % 2][0]), f"call {i}: output bits differ"
        assert torch.equal(_bits(st), _bits(first[i % 2][1])), f"call {i}: state bits differ"


def test_ssd_gate_step_reads_inputs_written_just_before(dev):
    """The step right after PyTorch kernels that write its state plane and
    its x (no synchronisation between) sees the new values."""
    gen = torch.Generator(device=dev).manual_seed(36)
    states, x = _ssd_inputs(gen, 2, dev, torch.float32, planes=2)
    init = torch.randn(2, M_N, M_HP, generator=gen, device=dev)
    ref = (init * 2)[None].clone()
    want = ssd_gate_step_layered_plain(ref, 0, **dict(x, xs=x["xs"] * 2))
    for _ in range(20):
        states[1].copy_(init)
        states[1].mul_(2)
        xs = x["xs"].clone()
        xs.mul_(2)
        got = ssd_gate_step_layered(states, 1, **dict(x, xs=xs))
        torch.testing.assert_close(got.float(), want.float(), **SSM_TOL)
        torch.testing.assert_close(states[1], ref[0], rtol=1e-5, atol=1e-5)


def test_ssd_gate_step_single_state_kernel(dev):
    gen = torch.Generator(device=dev).manual_seed(3)
    states, x = _ssd_inputs(gen, 2, dev, torch.float32, planes=1)
    state = torch.randn(2, M_N, M_HP, generator=gen, device=dev)
    ref = state.clone()[None]
    want = ssd_gate_step_layered_plain(ref, 0, **x)
    got = ssd_gate_step(state, **x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **SSM_TOL)
    torch.testing.assert_close(state, ref[0], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def hybrid_cache(dev):
    gen = torch.Generator(device=dev).manual_seed(12)
    T = 3584
    return dict(k_cache=_randn(gen, H_L, POOL_B, T, H_W, dev=dev),
                v_cache=_randn(gen, H_L, POOL_B, T, H_W, dev=dev),
                q=_randn(gen, POOL_B, 1, H_HQ, H_D, dev=dev),
                k_cur=_randn(gen, POOL_B, H_W, dev=dev), v_cur=_randn(gen, POOL_B, H_W, dev=dev))


@pytest.mark.parametrize("seq_end", [1, 255, 256, 536, 3584])
@pytest.mark.parametrize("layer", [0, H_L - 1])
def test_decode_attention_unstaged_kernel(dev, hybrid_cache, seq_end, layer):
    """Row 11 at the solo hybrid's shapes (2 rows), NaN past seq_end."""
    x = hybrid_cache
    k = x["k_cache"][:, :2].clone()
    v = x["v_cache"][:, :2].clone()
    k[:, :, seq_end:] = float("nan")
    v[:, :, seq_end:] = float("nan")
    q = x["q"][:2].contiguous()
    sc = torch.tensor([seq_end], dtype=torch.int32, device=dev)
    before = build.LAUNCHES["decode_attention_unstaged"]
    got = decode_attention_unstaged(q, k, v, sc, layer)
    torch.cuda.synchronize()
    assert build.LAUNCHES["decode_attention_unstaged"] == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(),
                               decode_attention_unstaged_plain(q, k, v, sc, layer).float(), **TOL)


@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("layer", [0, 5])
def test_decode_attention_pooled_unstaged_kernel(dev, hybrid_cache, head_dim, layer):
    """Row 12: 16 rows at their own prefix ends, NaN at and past each; head
    dim 128 (the hybrid's 4 KV heads) and 64 (8 KV heads, the transformer)."""
    x = {k: v.clone() for k, v in hybrid_cache.items()}
    if head_dim == 64:
        x["q"] = x["q"].reshape(POOL_B, 1, 2 * H_HQ, 64)
    ends = POOL_BASES
    for b, e in enumerate(ends):
        x["k_cache"][:, b, e:] = float("nan")
        x["v_cache"][:, b, e:] = float("nan")
    pe = torch.tensor(ends, dtype=torch.int32, device=dev)
    before = build.LAUNCHES["decode_attention_pooled_unstaged"]
    got = decode_attention_pooled_unstaged(**x, prefix_ends=pe, layer=layer)
    torch.cuda.synchronize()
    assert build.LAUNCHES["decode_attention_pooled_unstaged"] == before + 1
    want = decode_attention_pooled_unstaged_plain(**x, prefix_ends=pe, layer=layer)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    _assert_rows_close(got, want, POOL_ROW_TOL["bf16"])


@pytest.mark.parametrize("layer", [0, H_L - 1])
def test_decode_attention_pooled_kernel_head_dim_128(dev, hybrid_cache, layer):
    """Row 6 at the hybrid pool's shapes."""
    gen = torch.Generator(device=dev).manual_seed(layer)
    x = {k: v.clone() for k, v in hybrid_cache.items()}
    x["k_stage"] = _randn(gen, H_L, POOL_B, STAGE, H_W, dev=dev)
    x["v_stage"] = _randn(gen, H_L, POOL_B, STAGE, H_W, dev=dev)
    for b, base in enumerate(POOL_BASES):
        x["k_cache"][:, b, base:] = float("nan")
        x["v_cache"][:, b, base:] = float("nan")
    bases = torch.tensor(POOL_BASES, dtype=torch.int32, device=dev)
    lens = torch.tensor(POOL_LENS, dtype=torch.int32, device=dev)
    got = decode_attention_pooled_staged(**x, bases=bases, lens=lens, layer=layer)
    torch.cuda.synchronize()
    want = decode_attention_pooled_staged_plain(**x, bases=bases, lens=lens, layer=layer)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    _assert_rows_close(got, want, POOL_ROW_TOL["bf16"])


@pytest.mark.parametrize("S,offset", [(7, 0), (97, 64), (88, 0), (600, 0)])
def test_prefill_attention_kernel_head_dim_128(dev, S, offset):
    gen = torch.Generator(device=dev).manual_seed(S)
    q = _randn(gen, B, S, H_HQ, H_D, dev=dev)
    k = _randn(gen, B, 768, H_W, dev=dev)
    v = _randn(gen, B, 768, H_W, dev=dev)
    got = prefill_attention(q, k, v, offset)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), prefill_attention_plain(q, k, v, offset).float(), **TOL)


def test_hybrid_wrappers_raise_on_wrong_dtypes_on_cuda(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    states, x = _ssd_inputs(gen, 2, dev, torch.float32, planes=2)
    before = dict(build.LAUNCHES)
    with pytest.raises(ValueError):  # fp32 activations
        ssd_gate_step_layered(states, 0, **{**x, "xs": x["xs"].float()})
    with pytest.raises(ValueError):  # plane out of range
        ssd_gate_step_layered(states, 2, **x)
    with pytest.raises(ValueError):  # an fp16 state
        ssd_gate_step_layered(states.half(), 0, **x)
    assert build.LAUNCHES == before


# The one-launch design: split partials meet in a per-device workspace under
# one ticket per (row, kv head), which the last block resets.

def _solo_inputs(gen, T, dev, layers=2):
    return dict(q=_randn(gen, B, 1, HQ, D, dev=dev), k_cache=_randn(gen, layers, B, T, W, dev=dev),
                v_cache=_randn(gen, layers, B, T, W, dev=dev),
                k_stage=_randn(gen, layers, B, STAGE, W, dev=dev),
                v_stage=_randn(gen, layers, B, STAGE, W, dev=dev),
                k_cur=_randn(gen, B, W, dev=dev), v_cur=_randn(gen, B, W, dev=dev))


def test_decode_attention_reuses_its_workspace_across_shapes(dev):
    """1000 back-to-back calls alternating the solo step at T = 528 and 3072
    (CFG batch 2) and the pool at B = 16, T = 3584 give the first call's bits
    every time: every ticket was reset and no partial leaked between calls."""
    gen = torch.Generator(device=dev).manual_seed(21)
    calls = []
    for T, fe, sl in ((528, 513, 14), (3072, 2944, 127)):
        x = _solo_inputs(gen, T, dev)
        sc = torch.tensor([fe, sl, 1], dtype=torch.int32, device=dev)
        calls.append(lambda x=x, sc=sc: decode_attention_layered(**x, scalars=sc))
    xp = dict(q=_randn(gen, POOL_B, 1, HQ, D, dev=dev),
              k_cache=_randn(gen, 2, POOL_B, POOL_T, W, dev=dev),
              v_cache=_randn(gen, 2, POOL_B, POOL_T, W, dev=dev),
              k_stage=_randn(gen, 2, POOL_B, STAGE, W, dev=dev),
              v_stage=_randn(gen, 2, POOL_B, STAGE, W, dev=dev),
              k_cur=_randn(gen, POOL_B, W, dev=dev), v_cur=_randn(gen, POOL_B, W, dev=dev),
              bases=torch.tensor(POOL_BASES, dtype=torch.int32, device=dev),
              lens=torch.tensor(POOL_LENS, dtype=torch.int32, device=dev))
    calls.append(lambda: decode_attention_pooled_staged(**xp, layer=1))
    first = [c() for c in calls]
    outs = [calls[i % 3]() for i in range(1000)]
    torch.cuda.synchronize()
    for i, got in enumerate(outs):
        assert torch.equal(got, first[i % 3]), f"call {i} differs from the first"


@pytest.mark.parametrize("variant", ["bf16", "int8", "stageless"])
def test_pooled_rows_are_bit_isolated(dev, pooled_inputs, variant):
    """Row 0's output keeps its bits when every other row's base, ring
    length, cache, stage, column and query change."""
    gen = torch.Generator(device=dev).manual_seed(22)
    x = dict(pooled_inputs)
    y = dict(x, bases=torch.tensor([POOL_BASES[0]] + POOL_BASES[:0:-1], dtype=torch.int32,
                                   device=dev),
             lens=torch.tensor([POOL_LENS[0]] + [STAGE - 1] * (POOL_B - 1), dtype=torch.int32,
                               device=dev))
    for name in ("q", "k_cur", "v_cur"):
        y[name] = x[name].clone()
        y[name][1:] = _randn(gen, *x[name][1:].shape, dev=dev)
    for name in ("k_cache", "v_cache", "k_stage", "v_stage"):
        y[name] = x[name].clone()
        y[name][:, 1:] = _randn(gen, *x[name][:, 1:].shape, dev=dev)

    def run(a):
        if variant == "stageless":
            return decode_attention_pooled_unstaged(a["q"], a["k_cache"], a["v_cache"], a["k_cur"],
                                                    a["v_cur"], a["bases"], 3)
        if variant == "int8":
            a = dict(a)
            for name in ("k", "v"):
                a[name + "_cache"], a[name + "_scale"] = quant.quantize_rows(a[name + "_cache"], HKV)
            return decode_attention_pooled_staged_q(**a, layer=3)
        return decode_attention_pooled_staged(**a, layer=3)

    got_x, got_y = run(x), run(y)
    torch.cuda.synchronize()
    assert torch.isfinite(got_x[0]).all()
    assert torch.equal(got_x[0], got_y[0])
    assert not torch.equal(got_x[1:], got_y[1:])


def _one_call_per_variant(dev):
    """One call of each of the kernel's six variants at small shapes, the
    device scalars made beforehand: {name: call}."""
    gen = torch.Generator(device=dev).manual_seed(23)
    x = _solo_inputs(gen, 528, dev)
    kq, ks = quant.quantize_rows(x["k_cache"], HKV)
    vq, vs = quant.quantize_rows(x["v_cache"], HKV)
    xq = dict(x, k_cache=kq, v_cache=vq, k_scale=ks, v_scale=vs)
    sc = torch.tensor([513, 14, 1], dtype=torch.int32, device=dev)
    bases = torch.tensor([500, 17], dtype=torch.int32, device=dev)
    lens = torch.tensor([3, 100], dtype=torch.int32, device=dev)
    seq_end = torch.tensor([300], dtype=torch.int32, device=dev)
    unstaged = {k: x[k] for k in ("q", "k_cache", "v_cache")}
    return {
        "layered": lambda: decode_attention_layered(**x, scalars=sc),
        "layered_q": lambda: decode_attention_layered_q(**xq, scalars=sc),
        "pooled": lambda: decode_attention_pooled_staged(**x, bases=bases, lens=lens, layer=1),
        "pooled_q": lambda: decode_attention_pooled_staged_q(**xq, bases=bases, lens=lens,
                                                             layer=1),
        "unstaged": lambda: decode_attention_unstaged(**unstaged, seq_end=seq_end, layer=1),
        "pooled_unstaged": lambda: decode_attention_pooled_unstaged(
            **unstaged, k_cur=x["k_cur"], v_cur=x["v_cur"], prefix_ends=bases, layer=1),
    }


@pytest.mark.parametrize("variant", ["layered", "layered_q", "pooled", "pooled_q", "unstaged",
                                     "pooled_unstaged"])
def test_decode_attention_call_is_one_device_kernel(dev, variant):
    from torch.profiler import ProfilerActivity, profile

    call = _one_call_per_variant(dev)[variant]
    call()  # the workspace exists before the traced call
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1, [e.name for e in kernels]
    assert "decode_kernel" in kernels[0].name


def _one_device_kernel(call, name_part):
    from torch.profiler import ProfilerActivity, profile

    call()  # any workspace exists before the traced call
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1, [e.name for e in kernels]
    assert name_part in kernels[0].name


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("shape", [0, 1, 2, 3, 4])
def test_qmm_int8_decode_call_is_one_device_kernel(dev, M, shape):
    G, K, N, out_dtype = QMM_SHAPES[shape]
    x, w, scale = _qmm_case(torch.Generator(device=dev).manual_seed(33), M, G, K, N, dev)
    _one_device_kernel(lambda: qmm_int8(x, w, scale, out_dtype), "qmm_int8_decode_kernel")


@pytest.mark.parametrize("B", [2, 16])
@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
def test_ssd_gate_step_call_is_one_device_kernel(dev, B, state_dtype):
    gen = torch.Generator(device=dev).manual_seed(34)
    states, x = _ssd_inputs(gen, B, dev, state_dtype, planes=3)
    states.zero_()
    _one_device_kernel(lambda: ssd_gate_step_layered(states, 1, **x), "ssd_step_kernel")


def _padded(gen, shape, dev):
    """A [L, ...] tensor inside a NaN buffer with one NaN plane on each side:
    a read past the view's first or last plane would make NaN."""
    full = torch.full((shape[0] + 2, *shape[1:]), float("nan"), dtype=torch.bfloat16, device=dev)
    full[1:-1] = _randn(gen, *shape, dev=dev)
    return full[1:-1]


@pytest.mark.parametrize("quant_prefix", [False, True], ids=["row1", "row5"])
def test_layered_kernels_clamp_device_scalars(dev, quant_prefix):
    """Rows 1 and 5 with flushed_end > T or < 0 and stage_len > STAGE or < 0
    equal the plain version on the clamped scalars, reading nothing outside
    the buffers (NaN planes around the cache and the stage); a layer outside
    [0, L) gives an all-NaN output, and the plain versions raise for it."""
    gen = torch.Generator(device=dev).manual_seed(24)
    Lc, T = 3, 1000
    x = dict(q=_randn(gen, B, 1, HQ, D, dev=dev), k_cache=_padded(gen, (Lc, B, T, W), dev),
             v_cache=_padded(gen, (Lc, B, T, W), dev),
             k_stage=_padded(gen, (Lc, B, STAGE, W), dev),
             v_stage=_padded(gen, (Lc, B, STAGE, W), dev),
             k_cur=_randn(gen, B, W, dev=dev), v_cur=_randn(gen, B, W, dev=dev))
    kernel, plain, tol = decode_attention_layered, decode_attention_layered_plain, TOL
    if quant_prefix:
        for name in ("k", "v"):
            q8, s = quant.quantize_rows(x[name + "_cache"], HKV)
            q8_full = torch.zeros((Lc + 2, *q8.shape[1:]), dtype=torch.int8, device=dev)
            s_full = torch.full((Lc + 2, *s.shape[1:]), float("nan"), device=dev)
            q8_full[1:-1], s_full[1:-1] = q8, s
            x[name + "_cache"], x[name + "_scale"] = q8_full[1:-1], s_full[1:-1]
        kernel, plain, tol = decode_attention_layered_q, decode_attention_layered_q_plain, Q_TOL
    for fe, sl, layer in ((T + 7, 5, Lc - 1), (2 * T, STAGE + 50, Lc - 1), (-3, 4, 0),
                          (400, -9, 1), (-1, STAGE + 1, Lc - 1), (T, STAGE, Lc - 1)):
        sc = torch.tensor([fe, sl, layer], dtype=torch.int32, device=dev)
        got = kernel(**x, scalars=sc)
        clamped = torch.tensor([min(max(fe, 0), T), min(max(sl, 0), STAGE), layer],
                               dtype=torch.int32, device=dev)
        want = plain(**x, scalars=clamped)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), (fe, sl, layer)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        torch.testing.assert_close(plain(**x, scalars=sc).float(), want.float(), rtol=0, atol=0)
    for layer in (-1, Lc, 1 << 20):
        sc = torch.tensor([500, 5, layer], dtype=torch.int32, device=dev)
        got = kernel(**x, scalars=sc)
        torch.cuda.synchronize()
        assert torch.isnan(got).all(), layer
        with pytest.raises(ValueError, match="outside"):
            plain(**x, scalars=sc)


# The stage write of the staged calls: the block that holds a
# (row, kv head)'s column stores it into the stage slot. Against the plain
# versions (attention, then stage_splice_plain / stage_splice_rows_plain on
# the layer's plane): output within the tolerance, the stage bit for bit,
# NaN planes on both sides of the stage, V a strided row view.
WRITE_VARIANTS = ["layered", "layered_q", "pooled", "pooled_q", "pooled_d128"]
WRITE_LAYERS = 3


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int16), b.view(torch.int16))


def _write_case(gen, variant, dev):
    """One writing call's inputs at the main path's per-layer shapes
    (``WRITE_LAYERS`` layers): ``(x, guarded stages, call(x, **kw), plain(x,
    **kw))``; ``x["k_stage"]``/``x["v_stage"]`` are views inside NaN
    planes."""
    pooled = variant.startswith("pooled")
    hq, hkv, d = (H_HQ, H_HKV, H_D) if variant.endswith("d128") else (HQ, HKV, D)
    bx, T = (POOL_B, 1024) if pooled else (B, 528)
    w = hkv * d
    x = dict(q=_randn(gen, bx, 1, hq, d, dev=dev),
             k_cache=_randn(gen, WRITE_LAYERS, bx, T, w, dev=dev),
             v_cache=_randn(gen, WRITE_LAYERS, bx, T, w, dev=dev),
             k_cur=_randn(gen, bx, w, dev=dev),
             v_cur=_randn(gen, bx, 3 * w, dev=dev)[:, w:2 * w])
    full = {}
    for n in ("k_stage", "v_stage"):
        full[n] = torch.full((WRITE_LAYERS + 2, bx, STAGE, w), float("nan"),
                             dtype=torch.bfloat16, device=dev)
        full[n][1:-1] = _randn(gen, WRITE_LAYERS, bx, STAGE, w, dev=dev)
        x[n] = full[n][1:-1]
    if variant.endswith("_q"):
        for n in ("k", "v"):
            x[n + "_cache"], x[n + "_scale"] = quant.quantize_rows(x[n + "_cache"], hkv)
    kernel, plain = {
        "layered": (decode_attention_layered, decode_attention_layered_plain),
        "layered_q": (decode_attention_layered_q, decode_attention_layered_q_plain),
        "pooled": (decode_attention_pooled_staged, decode_attention_pooled_staged_plain),
        "pooled_q": (decode_attention_pooled_staged_q, decode_attention_pooled_staged_q_plain),
        "pooled_d128": (decode_attention_pooled_staged, decode_attention_pooled_staged_plain),
    }[variant]
    if pooled:
        x["bases"] = torch.randint(0, T + 1, (bx,), generator=gen, device=dev,
                                   dtype=torch.int32)
    return x, full, kernel, plain


def _with_stages(x, full):
    """``x`` on copies of the guarded stages: ``(x', guarded copies)``."""
    copies = {n: t.clone() for n, t in full.items()}
    return dict(x, k_stage=copies["k_stage"][1:-1], v_stage=copies["v_stage"][1:-1]), copies


def _write_slots(variant, bx):
    """Per call: the scalars' keyword arguments (stage_len or ring lengths;
    slots -1 and STAGE lie outside the stage) and the slot per row."""
    if not variant.startswith("pooled"):
        return [(s, [s] * bx) for s in (0, 5, STAGE - 1, -1, STAGE)]
    lens = [(23 * b) % STAGE for b in range(bx)]
    lens[:4] = [-1, STAGE, STAGE - 1, 0]
    return [(None, lens), (None, lens[::-1])]


@pytest.mark.parametrize("variant", WRITE_VARIANTS)
def test_stage_write_kernel(dev, variant):
    gen = torch.Generator(device=dev).manual_seed(40 + WRITE_VARIANTS.index(variant))
    x, full, kernel, plain = _write_case(gen, variant, dev)
    tol = Q_TOL if variant.endswith("_q") else TOL
    bx = x["q"].shape[0]
    for layer in (0, WRITE_LAYERS - 1):
        for stage_len, slots in _write_slots(variant, bx):
            if stage_len is None:
                kw = dict(lens=torch.tensor(slots, dtype=torch.int32, device=dev), layer=layer)
            else:
                kw = dict(scalars=torch.tensor([400, stage_len, layer], dtype=torch.int32,
                                               device=dev))
            xk, got_full = _with_stages(x, full)
            xp, want_full = _with_stages(x, full)
            got = kernel(**xk, **kw)
            want = plain(**xp, **kw)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all()
            torch.testing.assert_close(got.float(), want.float(), **tol)
            for n in ("k_stage", "v_stage"):
                assert _bits_equal(got_full[n], want_full[n]), (layer, slots, n)
                changed = (got_full[n].view(torch.int16) != full[n].view(torch.int16)).any(-1)
                where = torch.zeros_like(changed)
                for b, s in enumerate(slots):
                    if 0 <= s < STAGE:
                        where[1 + layer, b, s] = True
                assert torch.equal(changed, where), (layer, slots, n)


@pytest.mark.parametrize("variant", ["layered", "layered_q"], ids=["row1", "row5"])
def test_stage_write_skips_a_bad_layer(dev, variant):
    """A layer outside [0, L) gives NaN and writes nothing."""
    gen = torch.Generator(device=dev).manual_seed(46)
    x, full, kernel, _ = _write_case(gen, variant, dev)
    for layer in (-1, WRITE_LAYERS, 1 << 20):
        xk, got_full = _with_stages(x, full)
        got = kernel(**xk, scalars=torch.tensor([400, 5, layer], dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        assert torch.isnan(got).all(), layer
        assert all(_bits_equal(got_full[n], full[n]) for n in full), layer


def test_stage_write_repeats_its_bits(dev):
    """300 calls alternating the five writing variants, each from its
    initial stage, give each variant's first output and stage bits."""
    gen = torch.Generator(device=dev).manual_seed(47)
    calls = []
    for variant in WRITE_VARIANTS:
        x, full, kernel, _ = _write_case(gen, variant, dev)
        kw = (dict(lens=torch.tensor(_write_slots(variant, x["q"].shape[0])[0][1],
                                     dtype=torch.int32, device=dev), layer=1)
              if variant.startswith("pooled") else
              dict(scalars=torch.tensor([400, 54, 1], dtype=torch.int32, device=dev)))
        work = {n: t.clone() for n, t in full.items()}
        xw = dict(x, k_stage=work["k_stage"][1:-1], v_stage=work["v_stage"][1:-1])

        def call(xw=xw, kw=kw, work=work, full=full, kernel=kernel):
            for n in work:
                work[n].copy_(full[n])
            out = kernel(**xw, **kw)
            return [out] + [work[n].clone() for n in work]
        calls.append(call)
    first = [c() for c in calls]
    for i in range(300):
        got = calls[i % len(calls)]()
        assert all(_bits_equal(g, w) for g, w in zip(got, first[i % len(calls)])), i
    torch.cuda.synchronize()
