"""The packed-int4 matmul's launch plan and the arithmetic its tensor-core
kernel (``csrc/qmm_int4.cu``) relies on, on the CPU.

- ``int4_plan``: every row of K covered by exactly one block of a cluster,
  splits on whole 64-row stages, a pure function of ``(M, K, N, sms)``, and
  a grid within the card's cluster, block and shared-memory limits for every
  shape and M the paths use.
- The widening: for every nibble, the bf16 bits ``0x4300 | (n ^ 8)`` less
  136 are the two's-complement value, and the kernel's form on a packed
  32-bit word (shift by 4j, mask ``0x000F000F``, xor ``0x43084308``) widens
  both halves of every word exactly.
- The fragment mapping: one warp's k32 x 32-column step emulated in numpy
  from PTX's ``ldmatrix`` (plain and ``.trans``) and ``mma.m16n8k16``
  fragment layouts, with the kernel's widening and its epilogue's placement
  of each thread's columns, equals ``x @ q`` (x as mma's n8 operand and as
  its m16 operand).

The kernel itself runs only on the card (``tests/test_torch_qmm_int4_gpu.py``).
"""

import numpy as np
import pytest
import torch

from zonos_vibes_tpu_torch.ops.cuda import qmm
from zonos_vibes_tpu_torch.ops.cuda.qmm import int4_plan, pack_int4

# (K, N): the flagship's int4 projections (fc1, fc2, attention in_proj and
# out_proj; the hybrid's Mamba in_proj and out_proj) and ragged shapes.
SHAPES = [(2048, 16384), (8192, 2048), (2048, 3072), (2048, 2048), (2048, 8512), (4096, 2048),
          (200, 96), (96, 32), (512, 96), (1024, 32)]
MS = [1, 2, 3, 4, 8, 16, 17, 176, 320]
SMS = [132, 114, 16]  # H100 SXM, H100 PCIe, a small card

# The kernel's limits on the card (H100): threads a block (two warps per 32
# columns, at most 512: `__launch_bounds__`), portable cluster size, dynamic
# shared memory a block, grid y and z.
MAX_THREADS, MAX_CLUSTER, MAX_SMEM, MAX_GRID_YZ = 512, 8, 232448, 65535


def _smem(bm: int, tn: int) -> int:
    """The dynamic shared memory of a launch, as ``csrc/qmm_int4.cu`` sizes it."""
    ring = 4 * (qmm.INT4_BK * (tn // 2 + 16) + bm * (qmm.INT4_BK + 8) * 2)
    return max(ring, (2 if bm <= 16 else 1) * bm * tn * 4)  # and the warps' partials


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("K,N", SHAPES)
def test_int4_plan_covers_k_once_and_fits_the_card(K, N, sms):
    for M in MS:
        bm, tn, cs, rows = int4_plan(M, K, N, sms)
        starts = [r * rows for r in range(cs)]
        assert all(s % qmm.INT4_BK == 0 for s in starts)
        covered = np.zeros(K, dtype=np.int64)
        for s in starts:
            assert s < K  # no rank of a cluster without rows
            covered[s:min(K, s + rows)] += 1
        assert (covered == 1).all()
        assert 1 <= cs <= MAX_CLUSTER and 2 * tn <= MAX_THREADS
        assert _smem(bm, tn) <= MAX_SMEM
        assert -(-N // tn) <= MAX_GRID_YZ and -(-M // bm) <= MAX_GRID_YZ


def test_int4_plan_is_a_pure_function_of_the_shapes():
    before = [int4_plan(M, K, N, sms) for K, N in SHAPES for M in MS for sms in SMS]
    torch.manual_seed(0)  # no hidden state: other calls and seeds change nothing
    int4_plan(7, 4096, 4096, 3)
    assert [int4_plan(M, K, N, sms) for K, N in SHAPES for M in MS for sms in SMS] == before
    # The row tile follows M: x as the n8 operand up to 8 rows, then one or
    # four m16 tiles.
    assert [int4_plan(M, 2048, 16384)[0] for M in (1, 2, 4, 8, 16, 17, 176)] == [
        8, 8, 8, 8, 16, 64, 64]


def _bf16_bits_to_float(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _widen(v: np.ndarray, j: int) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's ``widen(v, j)``: nibble j of both 16-bit halves of a
    32-bit word as floats (low half, high half)."""
    biased = ((v >> np.uint32(4 * j)) & np.uint32(0x000F000F)) ^ np.uint32(0x43084308)
    return (_bf16_bits_to_float(biased & np.uint32(0xFFFF)) - 136.0,
            _bf16_bits_to_float(biased >> np.uint32(16)) - 136.0)


def test_nibble_to_bf16_identity():
    n = np.arange(16, dtype=np.uint32)
    twos = np.where(n >= 8, n.astype(np.int64) - 16, n.astype(np.int64))
    # 128 + (n ^ 8) in bf16, exact, then - 136: the two's-complement value.
    biased = torch.from_numpy((0x4300 | (n ^ 8)).astype(np.int16)).view(torch.bfloat16)
    got = biased - torch.tensor(136.0, dtype=torch.bfloat16)
    assert torch.equal(got.float(), torch.from_numpy(twos.astype(np.float32)))
    assert torch.equal(biased.float(), torch.from_numpy((128 + (n ^ 8)).astype(np.float32)))
    # The same on packed words: every (low, high) pair of nibbles at every j.
    lo, hi = np.meshgrid(n, n, indexing="ij")
    for j in range(4):
        word = (lo.ravel() << np.uint32(4 * j)) | (hi.ravel() << np.uint32(16 + 4 * j))
        word |= np.uint32(0x5A5A5A5A) & ~((np.uint32(0xF) << np.uint32(4 * j)) * np.uint32(0x10001))
        a, b = _widen(word, j)
        np.testing.assert_array_equal(a, twos[lo.ravel()])
        np.testing.assert_array_equal(b, twos[hi.ravel()])


def _tile_as_u16(q: np.ndarray) -> np.ndarray:
    """int4 values [k, 32] -> their packed rows read as 8 little-endian 16-bit
    elements each (element g: columns 4g..4g+3)."""
    packed = pack_int4(torch.from_numpy(q.astype(np.int8))).numpy().astype(np.uint32)
    return packed[:, 0::2] | (packed[:, 1::2] << 8)


def _ldmatrix_trans_weights(u16: np.ndarray) -> np.ndarray:
    """``ldmatrix.x4.trans`` with lane l addressing row l of a [32 k, 8]
    tile of 16-bit elements: lane (g, t) gets in register i the element g
    of rows 8i + 2t (low half) and 8i + 2t + 1 (high half). -> [32, 4]."""
    r = np.zeros((32, 4), dtype=np.uint32)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i in range(4):
            r[lane, i] = u16[8 * i + 2 * t, g] | (u16[8 * i + 2 * t + 1, g] << 16)
    return r


def _mma(a_regs, b_regs):
    """``mma.m16n8k16`` on per-lane fragments (values, not bits): a_regs
    [32][4] pairs (row-major A), b_regs [32][2] pairs (column-major B) ->
    per-lane C [32][4], from PTX's fragment layouts."""
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for q, (row, col) in enumerate(((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8),
                                        (g + 8, 2 * t + 8))):
            A[row, col], A[row, col + 1] = a_regs[lane][q]
        for q in range(2):
            B[2 * t + 8 * q, g], B[2 * t + 8 * q + 1, g] = b_regs[lane][q]
    C = A @ B
    return [[C[lane // 4, 2 * (lane % 4)], C[lane // 4, 2 * (lane % 4) + 1],
             C[lane // 4 + 8, 2 * (lane % 4)], C[lane // 4 + 8, 2 * (lane % 4) + 1]]
            for lane in range(32)]


def _x_pairs(x: np.ndarray, row: int, k: int):
    return (x[row, k], x[row, k + 1])


@pytest.mark.parametrize("bm", [8, 16, 64])
def test_fragment_mapping_emulated(bm):
    """One warp's k32 x 32-column step of the kernel, lane by lane: the packed
    tile through ``ldmatrix.trans`` and ``widen``, x through ``ldmatrix``,
    two k16 ``mma``s, and the epilogue's placement of each thread's columns
    (bm 8: rows 2t, 2t + 1, columns 4g..4g+3; bm 16: rows g, g + 8, columns
    8t..8t+7; bm 64: the warp pair's warp wz takes n8 tiles 2wz and 2wz + 1,
    columns 8t + 2wz, + 1, + 4, + 5), against ``x @ q``; bm 64 on one of its
    four row tiles."""
    rows = min(bm, 16)
    rng = np.random.default_rng(bm)
    q = rng.integers(-7, 8, size=(32, 32))
    x = rng.integers(-64, 64, size=(rows, 32)).astype(np.float64) / 16  # exact in bf16
    wr = _ldmatrix_trans_weights(_tile_as_u16(q))
    out = np.full((rows, 32), np.nan)
    if bm == 8:
        acc = [[[0.0] * 4 for _ in range(2)] for _ in range(32)]
        for h in range(2):
            # ldmatrix.x4 of x rows 0-7 at k 0-7, 8-15, ...: B fragments.
            b = [[_x_pairs(x, lane // 4, 16 * h + 2 * (lane % 4) + 8 * s) for s in range(2)]
                 for lane in range(32)]
            for p in range(2):
                a = []
                for lane in range(32):
                    w0, w1 = wr[lane, 2 * h], wr[lane, 2 * h + 1]
                    a.append([_widen(w0, 2 * p), _widen(w0, 2 * p + 1), _widen(w1, 2 * p),
                              _widen(w1, 2 * p + 1)])
                c = _mma(a, b)
                for lane in range(32):
                    acc[lane][p] = [u + v for u, v in zip(acc[lane][p], c[lane])]
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for e in range(2):
                out[2 * t + e, 4 * g:4 * g + 4] = [acc[lane][0][e], acc[lane][0][2 + e],
                                                    acc[lane][1][e], acc[lane][1][2 + e]]
    else:
        acc = [[[0.0] * 4 for _ in range(4)] for _ in range(32)]
        for h in range(2):
            a = [[_x_pairs(x, row, 16 * h + col) for row, col in
                  ((lane // 4, 2 * (lane % 4)), (lane // 4 + 8, 2 * (lane % 4)),
                   (lane // 4, 2 * (lane % 4) + 8), (lane // 4 + 8, 2 * (lane % 4) + 8))]
                 for lane in range(32)]
            for j in range(4):
                b = [[_widen(wr[lane, 2 * h], j), _widen(wr[lane, 2 * h + 1], j)]
                     for lane in range(32)]
                c = _mma(a, b)
                for lane in range(32):
                    acc[lane][j] = [u + v for u, v in zip(acc[lane][j], c[lane])]
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for hf in range(2):
                if bm == 16:
                    out[g + 8 * hf, 8 * t:8 * t + 8] = (
                        [acc[lane][j][2 * hf] for j in range(4)]
                        + [acc[lane][j][2 * hf + 1] for j in range(4)])
                    continue
                for wz in range(2):  # the pair's warps: tiles 2wz + jj as their jj
                    c = 8 * t + 2 * wz
                    out[g + 8 * hf, c:c + 2] = [acc[lane][2 * wz + jj][2 * hf] for jj in range(2)]
                    out[g + 8 * hf, c + 4:c + 6] = [acc[lane][2 * wz + jj][2 * hf + 1]
                                                    for jj in range(2)]
    np.testing.assert_array_equal(out, x @ q)
