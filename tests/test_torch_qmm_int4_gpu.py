"""The packed-int4 matmul (``csrc/qmm_int4.cu``) against its plain version,
and the int8 matmul at the hybrid's projection shapes, on the card.

Shapes: every packed-int4 projection of the flagship transformer and the
hybrid (``quantize_int4``: fc1 2048 x 16384, fc2 8192 x 2048; int4full adds
the attention and Mamba projections) in 128-row groups, 64- and 32-row
groups and ungrouped, at the M of every path (1 and 2 solo, 4 and 8 server
batches and 4-slot pools, 16 the 8-slot pool, 176 and 320 prefills and the
quality gate's teacher-forced pass), and ragged edges. Run on a machine with
an NVIDIA GPU:

    python -m pytest --noconftest tests/test_torch_qmm_int4_gpu.py -q

Without a card every test here skips.
"""

import pytest
import torch

from zonos_vibes_tpu_torch.ops import quant
from zonos_vibes_tpu_torch.ops.cuda import build
from zonos_vibes_tpu_torch.ops.cuda import qmm as qmm_mod
from zonos_vibes_tpu_torch.ops.cuda.qmm import (
    int4_plan,
    pack_int4,
    qmm_int4,
    qmm_int4_plain,
    qmm_int8,
    qmm_int8_plain,
)

pytestmark = pytest.mark.gpu

# The kernel runs its plain version's fp32 arithmetic in another summation
# order (and adds each group's scaled sum with one fma); the output rounds
# once, possibly to the neighbouring bf16 step.
QMM_TOL = {torch.bfloat16: dict(rtol=8e-3, atol=1e-2), torch.float32: dict(rtol=1e-5, atol=1e-4)}
# (K, N, groups): fc1, fc2, the transformer's in_proj and out_proj, the
# hybrid's Mamba in_proj and out_proj, and ragged cases (N = 32 and 96 at
# a tile's edge; K = 300: x's rows not 16-byte aligned, groups of 100).
INT4_SHAPES = [(2048, 16384, 16), (8192, 2048, 64), (2048, 3072, 16), (2048, 2048, 16),
               (2048, 8512, 16), (4096, 2048, 32), (2048, 16384, 32), (8192, 2048, 128),
               (2048, 2048, 1), (8192, 2048, 1), (200, 96, 2), (96, 32, 1), (512, 96, 4),
               (1024, 32, 8), (300, 64, 3)]
MS = [1, 2, 3, 4, 8, 16, 17, 176, 320]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    build.load()
    return torch.device("cuda")


def _case(gen, M, K, N, NG, dev):
    q = torch.randint(-7, 8, (K, N), generator=gen, device=dev, dtype=torch.int8)
    scale = torch.rand((NG, 1, N), generator=gen, device=dev) * 0.02 + 1e-3
    x = torch.randn((M, K), generator=gen, device=dev).bfloat16()
    return x, pack_int4(q), scale


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("K,N,NG", INT4_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_qmm_int4_kernel(dev, M, K, N, NG, out_dtype):
    gen = torch.Generator(device=dev).manual_seed(M * 7 + N + NG)
    x, w, scale = _case(gen, M, K, N, NG, dev)
    before = build.LAUNCHES["qmm_int4"]
    got = qmm_int4(x, w, scale, out_dtype)
    torch.cuda.synchronize()
    assert build.LAUNCHES["qmm_int4"] == before + 1
    assert got.shape == (M, N) and got.dtype == out_dtype and torch.isfinite(got).all()
    want = qmm_int4_plain(x, w, scale, out_dtype)
    torch.testing.assert_close(got.float(), want.float(), **QMM_TOL[out_dtype])
    # The slices and the cluster meet in a fixed order: the same bits again.
    assert torch.equal(qmm_int4(x, w, scale, out_dtype), got)


@pytest.mark.parametrize("M", [2, 16, 17, 176])
def test_qmm_int4_rows_are_isolated(dev, M):
    """A row's output does not change when another row of x changes (the
    pool's row isolation)."""
    gen = torch.Generator(device=dev).manual_seed(M)
    x, w, scale = _case(gen, M, 8192, 2048, 64, dev)
    got = qmm_int4(x, w, scale)
    x2 = x.clone()
    x2[M - 1] = torch.randn((8192,), generator=gen, device=dev).bfloat16()
    got2 = qmm_int4(x2, w, scale)
    assert torch.equal(got[:M - 1], got2[:M - 1])
    assert not torch.equal(got[M - 1], got2[M - 1])


def test_qmm_int4_quantized_projection(dev):
    """``proj_matmul`` on a leaf from ``quantize_weight(bits=4)`` launches the
    kernel and equals the dequantized weight's fp32 product."""
    gen = torch.Generator(device=dev).manual_seed(5)
    w = (torch.randn((2048, 16384), generator=gen, device=dev) / 2048 ** 0.5).bfloat16()
    leaf = quant.quantize_weight(w, bits=4, group_size=128, clip_search=True)
    x = torch.randn((2, 3, 2048), generator=gen, device=dev).bfloat16()
    before = build.LAUNCHES["qmm_int4"]
    got = quant.proj_matmul(x, leaf)
    assert build.LAUNCHES["qmm_int4"] == before + 1 and got.shape == (2, 3, 16384)
    want = x.float() @ quant.dequantize_weight(leaf, torch.float32)
    torch.testing.assert_close(got.float(), want, **QMM_TOL[torch.bfloat16])


def test_qmm_int4_in_a_cuda_graph(dev):
    gen = torch.Generator(device=dev).manual_seed(9)
    x, w, scale = _case(gen, 2, 2048, 16384, 16, dev)
    want = qmm_int4(x, w, scale)
    out = torch.empty_like(want)
    s = torch.cuda.Stream(dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(s):
        with torch.cuda.graph(graph, stream=s):
            out.copy_(qmm_int4(x, w, scale))
    torch.cuda.current_stream(dev).wait_stream(s)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_qmm_int4_misuse_raises(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    x, w, scale = _case(gen, 2, 2048, 2048, 16, dev)
    with pytest.raises(ValueError):
        qmm_int4(x.float(), w, scale)  # the kernel takes bf16 x
    with pytest.raises(ValueError):
        qmm_int4(x, w.view(torch.int8), scale)
    with pytest.raises(ValueError):
        qmm_int4(x, w, scale[:, :, :100])
    with pytest.raises(ValueError):
        qmm_int4(x[:, :1000], w[:1000], scale)  # 16 groups do not divide 1000 rows
    with pytest.raises(ValueError):
        qmm_int4(x.cpu(), w, scale)
    x48, w48, s48 = _case(gen, 2, 64, 48, 1, dev)
    with pytest.raises(ValueError):  # N = 48 is not a multiple of 32
        qmm_int4(x48, w48, s48)


def test_int4_plan_fits_the_card(dev):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for K, N, _ in INT4_SHAPES:
        for M in MS:
            bm, tn, cs, rows = int4_plan(M, K, N, sms)
            assert cs * rows >= K and (cs - 1) * rows < K and rows % 64 == 0 and cs <= 8


# (K, NG): group sizes of 96 and 384 (a group crosses a 64-row stage and a
# split of K), 40 and 24 (a group ends inside a k16 step), 8 (two groups end
# inside one step), 32 and 64 (splits are whole 64-row stages, so these
# groups end at a stage's edge or inside one).
GROUPED = [(3072, 32), (1152, 3), (2560, 64), (2400, 100), (512, 64), (2048, 64), (2048, 32)]


@pytest.mark.parametrize("cs", [1, 3, 8])
@pytest.mark.parametrize("M", [2, 8, 16, 176])
@pytest.mark.parametrize("K,NG", GROUPED)
def test_qmm_int4_groups_across_splits(dev, monkeypatch, K, NG, M, cs):
    """Group boundaries inside k16 steps, stages and splits of K: the
    planned row tile and tile width with K forced into ``cs`` splits."""
    N = 256
    bm, tn, _, _ = int4_plan(M, K, N)
    rows = -(-K // (cs * 64)) * 64
    if (cs - 1) * rows >= K:
        pytest.skip(f"{cs} splits of {rows} rows leave a rank without rows at K = {K}")
    monkeypatch.setattr(qmm_mod, "int4_plan", lambda *_: (bm, tn, cs, rows))
    gen = torch.Generator(device=dev).manual_seed(K + NG + M + cs)
    x, w, scale = _case(gen, M, K, N, NG, dev)
    for out_dtype in (torch.bfloat16, torch.float32):
        got = qmm_int4(x, w, scale, out_dtype)
        want = qmm_int4_plain(x, w, scale, out_dtype)
        torch.testing.assert_close(got.float(), want.float(), **QMM_TOL[out_dtype])
        assert torch.equal(qmm_int4(x, w, scale, out_dtype), got)


@pytest.mark.parametrize("cs", [1, 3, 8])
@pytest.mark.parametrize("M", [17, 64, 176, 320])
@pytest.mark.parametrize("K,N,NG", [(2048, 16384, 16), (2048, 256, 32), (1152, 96, 3),
                                    (2048, 384, 1)])
def test_qmm_int4_prefill_tiles(dev, monkeypatch, K, N, NG, M, cs):
    """The prefill's row tile of 64 at 128 columns (the warp pair splitting
    the n8 tiles) in 128-, 64- and 384-row groups and ungrouped, with K
    forced into ``cs`` splits; N = 96 and 384 leave a tile's columns past N."""
    rows = -(-K // (cs * 64)) * 64
    monkeypatch.setattr(qmm_mod, "int4_plan", lambda *_: (64, 128, cs, rows))
    gen = torch.Generator(device=dev).manual_seed(K + N + M + cs)
    x, w, scale = _case(gen, M, K, N, NG, dev)
    for out_dtype in (torch.bfloat16, torch.float32):
        got = qmm_int4(x, w, scale, out_dtype)
        want = qmm_int4_plain(x, w, scale, out_dtype)
        torch.testing.assert_close(got.float(), want.float(), **QMM_TOL[out_dtype])
        assert torch.equal(qmm_int4(x, w, scale, out_dtype), got)


@pytest.mark.parametrize("M", [1, 2, 4, 8])
@pytest.mark.parametrize("K,N,NG", [(2048, 16384, 16), (8192, 2048, 64)])
def test_qmm_int4_small_m_dispatch(dev, monkeypatch, M, K, N, NG):
    """fc1 and fc2 at the solo step's and small batches' M through both row
    tiles the plan can take there (x as the n8 operand, or one m16 tile),
    each within the tolerance of the plain version."""
    gen = torch.Generator(device=dev).manual_seed(M + N)
    x, w, scale = _case(gen, M, K, N, NG, dev)
    want = qmm_int4_plain(x, w, scale, torch.float32)
    planned = qmm_int4(x, w, scale, torch.float32)
    torch.testing.assert_close(planned, want, **QMM_TOL[torch.float32])
    for plan in [(8, 128, 4, -(-K // 256) * 64), (16, 128, 4, -(-K // 256) * 64)]:
        monkeypatch.setattr(qmm_mod, "int4_plan", lambda *_, p=plan: p)
        got = qmm_int4(x, w, scale, torch.float32)
        torch.testing.assert_close(got, want, **QMM_TOL[torch.float32])


# -- qmm_int8 at the hybrid's projection shapes -------------------------------

@pytest.mark.parametrize("M", [2, 16, 176])
@pytest.mark.parametrize("K,N", [(2048, 8512), (4096, 2048), (2048, 3072), (2048, 16384),
                                 (8192, 2048)])
def test_qmm_int8_hybrid_shapes(dev, M, K, N):
    gen = torch.Generator(device=dev).manual_seed(M + K + N)
    w = (torch.randn((1, K, N), generator=gen, device=dev) / K ** 0.5).bfloat16()
    wq = quant.quantize_weight(w)
    x = torch.randn((M, K), generator=gen, device=dev).bfloat16()
    got = qmm_int8(x, wq["weight_int8"], wq["scale"])
    want = qmm_int8_plain(x, wq["weight_int8"], wq["scale"], torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), **QMM_TOL[torch.bfloat16])
