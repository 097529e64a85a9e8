"""The port's kernel wrappers on CPU tensors (their plain versions) against
the JAX package's Pallas kernels run with ``interpret=True``.

Same inputs, made with numpy from a seed, in each side's layout: the JAX
caches are time-minor ``[L, B, Hkv, D, T]``, the port's time-major
``[L, B, T, Hkv*D]``. The edge cases are the chip phase's, at a smaller
cache: an empty and a one-position flushed prefix, an empty and a full
stage, the first and last layer, a cache length that is not a multiple of
the kernel's 256-position chunk, chunks of 7, 97 and 600 queries, offsets 0
and 64. Everything runs in fp32; tolerance 2e-4 (summation order only).

The pool's kernels (pooled decode attention, bf16 and int8 prefix, and the
per-row ring splice) are held to 1e-5 and bit-exactness, at the inputs of
the JAX package's own tests (``tests/test_pallas_decode.py``,
``tests/test_stage_write.py``) plus a row with a full-but-one ring; the
port's prefix positions at or past each row's base are poisoned with NaN.

The stage-less kernels (``decode_attention_pallas``, one position for every
row, and ``decode_attention_pallas_pooled``, per-row prefix ends with the
current column folded in) are held to 1e-5 at head dims 16 and 128 (the
hybrid's), NaN past each bound; rows 3 and 6 at head dim 128 too.

The staged wrappers' stage write (the decode step's
``stage_splice_pallas`` / ``stage_splice_rows_pallas``, done by the
decode-attention call) is held bit for bit against those Pallas kernels on
the same columns, slots in and out of the stage, V a strided row view; and
each backbone's stage after a decode step against gathering the columns and
splicing them after the layer loop.
"""

import inspect
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_vibes_tpu.ops.pallas.decode_attention import (
    decode_attention_pallas,
    decode_attention_pallas_layered,
    decode_attention_pallas_layered_q,
    decode_attention_pallas_pooled,
    decode_attention_pallas_pooled_staged,
    decode_attention_pallas_pooled_staged_q,
)
from zonos_vibes_tpu.ops.pallas.prefill_attention import prefill_attention_pallas
from zonos_vibes_tpu.ops.pallas.stage_write import stage_splice_pallas, stage_splice_rows_pallas
from zonos_vibes_tpu.ops.quant import quantize_kv
from zonos_vibes_tpu_torch.config import BackboneConfig, _freeze
from zonos_vibes_tpu_torch.models import backbone as tbb
from zonos_vibes_tpu_torch.models import mamba_backbone as tmb
from zonos_vibes_tpu_torch.ops.cuda import build
from zonos_vibes_tpu_torch.ops.cuda import decode_attention as dam
from zonos_vibes_tpu_torch.ops.cuda.decode_attention import (
    decode_attention_layered,
    decode_attention_layered_q,
    decode_attention_pooled_staged,
    decode_attention_pooled_staged_q,
    decode_attention_pooled_unstaged,
    decode_attention_unstaged,
    decode_plan,
)
from zonos_vibes_tpu_torch.ops.cuda import mamba_step as msm
from zonos_vibes_tpu_torch.ops.cuda import qmm as qmm_mod
from zonos_vibes_tpu_torch.ops.cuda.prefill_attention import prefill_attention
from zonos_vibes_tpu_torch.ops.cuda.stage_write import stage_splice, stage_splice_rows
from zonos_vibes_tpu_torch.ops.quant import quantize_rows
from zonos_vibes_tpu_torch.ops.rope import rope_table

TOL = dict(rtol=2e-4, atol=2e-4)
L, B, HQ, HKV, D, STAGE, T = 2, 2, 8, 2, 64, 128, 640
W = HKV * D


def _time_minor(x):
    """Port ``[..., T, Hkv*D]`` -> JAX ``[..., Hkv, D, T]``."""
    *lead, t, _ = x.shape
    return np.moveaxis(x.reshape(*lead, t, HKV, D), -3, -1)


@pytest.fixture(scope="module")
def decode_inputs():
    rng = np.random.default_rng(0)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return dict(q=f(B, 1, HQ, D), k_cache=f(L, B, T, W), v_cache=f(L, B, T, W),
                k_stage=f(L, B, STAGE, W), v_stage=f(L, B, STAGE, W),
                k_cur=f(B, W), v_cur=f(B, W))


@pytest.mark.parametrize("flushed_end", [0, 1, 300, 512])
@pytest.mark.parametrize("stage_len", [0, 5, 127])
@pytest.mark.parametrize("layer", [0, L - 1])
def test_decode_attention_plain_matches_pallas(decode_inputs, flushed_end, stage_len, layer):
    x = decode_inputs
    want = decode_attention_pallas_layered(
        jnp.asarray(x["q"]), jnp.asarray(_time_minor(x["k_cache"])),
        jnp.asarray(_time_minor(x["v_cache"])), jnp.asarray(x["k_stage"]),
        jnp.asarray(x["v_stage"]), jnp.asarray(x["k_cur"].reshape(B, HKV, D, 1)),
        jnp.asarray(x["v_cur"].reshape(B, HKV, D, 1)), jnp.int32(flushed_end),
        jnp.int32(stage_len), jnp.int32(layer), block=128, interpret=True,
    )
    scalars = torch.tensor([flushed_end, stage_len, layer], dtype=torch.int32)
    before = dict(build.LAUNCHES)
    got = decode_attention_layered(**{k: torch.from_numpy(v) for k, v in x.items()},
                                   scalars=scalars)
    assert build.LAUNCHES == before  # the CPU path launches nothing
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("slot", [0, 1, 7, 8, 127])
def test_stage_splice_plain_matches_pallas(slot):
    rng = np.random.default_rng(slot)
    stage = rng.standard_normal((L, B, STAGE, W)).astype(np.float32)
    cols = rng.standard_normal((L, B, W)).astype(np.float32)
    want = np.asarray(stage_splice_pallas(jnp.asarray(stage), jnp.asarray(cols[:, :, None]),
                                          jnp.int32(slot), interpret=True))
    st = torch.from_numpy(stage.copy())
    got = stage_splice(st, torch.from_numpy(cols), torch.tensor([slot], dtype=torch.int32))
    assert got.data_ptr() == st.data_ptr()  # in place
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("S", [7, 97, 600])
@pytest.mark.parametrize("offset", [0, 64])
def test_prefill_attention_plain_matches_pallas(S, offset):
    rng = np.random.default_rng(S + offset)
    Tp = 768
    q = rng.standard_normal((B, S, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, Tp, W)).astype(np.float32)
    v = rng.standard_normal((B, Tp, W)).astype(np.float32)
    want = prefill_attention_pallas(
        jnp.asarray(q), jnp.asarray(_time_minor(k)), jnp.asarray(_time_minor(v)),
        jnp.int32(offset), block_q=64, block_k=128, interpret=True)
    got = prefill_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S", [1, 16, 17, 64, 65, 88])
@pytest.mark.parametrize("heads", [(2, 2, 128), (8, 2, 128), (2, 2, 64)],
                         ids=["d128g1", "d128g4", "d64g1"])
def test_prefill_attention_plain_matches_pallas_at_tile_edges(S, heads):
    """The kernel's query- and key-tile edges (16-row warp tiles, 32-key
    tiles) with a chunk at offset > 0, at head dim 128 and one query head
    per KV head."""
    Hq, Hkv, Dh = heads
    offset, Tp = 64, 256
    rng = np.random.default_rng(S * 10 + Hq + Dh)
    q = rng.standard_normal((1, S, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((1, Tp, Hkv * Dh)).astype(np.float32)
    v = rng.standard_normal((1, Tp, Hkv * Dh)).astype(np.float32)
    want = prefill_attention_pallas(
        jnp.asarray(q), jnp.asarray(_to_time_minor(k, Hkv)), jnp.asarray(_to_time_minor(v, Hkv)),
        jnp.int32(offset), block_q=64, block_k=128, interpret=True)
    got = prefill_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrappers_reject_inconsistent_shapes():
    q = torch.zeros(B, 4, HQ, D)
    kv = torch.zeros(B, 16, W)
    with pytest.raises(ValueError):
        prefill_attention(q, kv, kv, 14)  # offset + S past the cache
    with pytest.raises(ValueError):
        stage_splice(torch.zeros(L, B, STAGE, W), torch.zeros(L, B, 1, W),
                     torch.tensor([0], dtype=torch.int32))


@pytest.mark.parametrize("ordinal,sms", [(0, 132), (1, 114)])
def test_prefill_wrapper_passes_its_cards_sm_count(monkeypatch, ordinal, sms):
    """The prefill launch plans its row tiles for the SM count of the card
    its tensors are on (``_sm_count`` of that device, as the decode plan
    reads it), made current for the launch, not a count fixed in the
    source. Meta tensors stand in for a card's, the library for a recorder."""
    import contextlib

    from zonos_vibes_tpu_torch.ops.cuda import prefill_attention as pam

    dev = torch.device("cuda", ordinal)
    calls, current = [], []

    class Lib:
        def zvt_prefill_attention(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(build, "require_cuda", lambda name, *t: dev)
    monkeypatch.setattr(build, "load", lambda: Lib())
    monkeypatch.setattr(build, "stream_handle", lambda d: 0)
    monkeypatch.setattr(pam, "_sm_count", lambda d: {0: 132, 1: 114}[d.index])
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: current.append(d) or contextlib.nullcontext())
    q = torch.empty(B, 9, HQ, D, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(B, 32, W, dtype=torch.bfloat16, device="meta")
    before = build.LAUNCHES["prefill_attention"]
    pam.prefill_attention(q, kv, kv, 3)
    (args,) = calls
    # q, k, v, out, B, S, Hq, Hkv, T, head dim, offset, SM count, stream
    assert args[4:12] == (B, 9, HQ, HKV, 32, D, 3, sms)
    assert current == [dev]
    assert build.LAUNCHES["prefill_attention"] == before + 1
    build.LAUNCHES["prefill_attention"] = before


# The pool's kernels at tests/test_pallas_decode.py's pooled shapes, plus a
# fourth row whose ring holds STAGE - 1 rows.
P_B, P_T, P_STAGE = 4, 256, 16
P_BASES = np.array([40, 0, 201, 100], np.int32)
P_LENS = np.array([5, 0, 14, P_STAGE - 1], np.int32)
P_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pooled_inputs():
    rng = np.random.default_rng(13)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return dict(q=f(P_B, 1, HQ, D), k_cache=f(L, P_B, P_T, W), v_cache=f(L, P_B, P_T, W),
                k_stage=f(L, P_B, P_STAGE, W), v_stage=f(L, P_B, P_STAGE, W),
                k_cur=f(P_B, W), v_cur=f(P_B, W))


def _poison_past_bases(x):
    """A copy with every prefix position at or past its row's base NaN."""
    x = x.copy()
    for b, base in enumerate(P_BASES):
        x[:, b, base:] = np.nan
    return x


def _jax_pooled_args(x):
    return (jnp.asarray(x["q"]), jnp.asarray(x["k_stage"]), jnp.asarray(x["v_stage"]),
            jnp.asarray(x["k_cur"].reshape(P_B, HKV, D, 1)),
            jnp.asarray(x["v_cur"].reshape(P_B, HKV, D, 1)),
            jnp.asarray(P_BASES), jnp.asarray(P_LENS))


@pytest.mark.parametrize("layer", [0, L - 1])
def test_decode_attention_pooled_plain_matches_pallas(pooled_inputs, layer):
    x = pooled_inputs
    q, ks, vs, kc, vc, bases, lens = _jax_pooled_args(x)
    want = decode_attention_pallas_pooled_staged(
        q, jnp.asarray(_time_minor(x["k_cache"])), jnp.asarray(_time_minor(x["v_cache"])),
        ks, vs, kc, vc, bases, lens, jnp.int32(layer), block=128, interpret=True)
    args = {k: torch.from_numpy(v) for k, v in x.items()}
    for name in ("k_cache", "v_cache"):
        args[name] = torch.from_numpy(_poison_past_bases(x[name]))
    before = dict(build.LAUNCHES)
    got = decode_attention_pooled_staged(**args, bases=torch.from_numpy(P_BASES),
                                         lens=torch.from_numpy(P_LENS), layer=layer)
    assert build.LAUNCHES == before  # the CPU path launches nothing
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **P_TOL)


@pytest.mark.parametrize("layer", [0, L - 1])
def test_decode_attention_pooled_q_plain_matches_pallas(pooled_inputs, layer):
    """int8 prefix: the port's int8 values and scales come from the same
    fp32 cache (bit-equal to JAX's ``quantize_kv``); its scales past each
    row's base are NaN."""
    x = pooled_inputs
    q, ks, vs, kc, vc, bases, lens = _jax_pooled_args(x)
    jq = {n: quantize_kv(jnp.asarray(_time_minor(x[n + "_cache"])), dh_axis=3) for n in "kv"}
    want = decode_attention_pallas_pooled_staged_q(
        q, jq["k"][0], jq["v"][0], jq["k"][1], jq["v"][1], ks, vs, kc, vc, bases, lens,
        jnp.int32(layer), block=128, interpret=True)
    args = {k: torch.from_numpy(v) for k, v in x.items() if "cache" not in k}
    for n in "kv":
        qrows, scale = quantize_rows(torch.from_numpy(x[n + "_cache"]), HKV)
        np.testing.assert_array_equal(qrows.numpy(), _port_layout(np.asarray(jq[n][0])))
        args[n + "_cache"] = qrows
        args[n + "_scale"] = torch.from_numpy(_poison_past_bases(scale.numpy()))
    got = decode_attention_pooled_staged_q(**args, bases=torch.from_numpy(P_BASES),
                                           lens=torch.from_numpy(P_LENS), layer=layer)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **P_TOL)


def _port_layout(x):
    """JAX ``[L, B, Hkv, D, T]`` -> the port's ``[L, B, T, Hkv*D]``."""
    Lx, Bx, H, Dx, T = x.shape
    return np.moveaxis(x, -1, 2).reshape(Lx, Bx, T, H * Dx)


def test_stage_splice_rows_plain_matches_pallas():
    rng = np.random.default_rng(3)
    Br = 3
    stage = rng.standard_normal((L, Br, STAGE, W)).astype(np.float32)
    cols = rng.standard_normal((L, Br, W)).astype(np.float32)
    slots = np.array([0, 127, 8], np.int32)
    want = np.asarray(stage_splice_rows_pallas(jnp.asarray(stage), jnp.asarray(cols[:, :, None]),
                                               jnp.asarray(slots), interpret=True))
    st = torch.from_numpy(stage.copy())
    before = dict(build.LAUNCHES)
    got = stage_splice_rows(st, torch.from_numpy(cols), torch.from_numpy(slots))
    assert build.LAUNCHES == before
    assert got.data_ptr() == st.data_ptr()  # in place
    np.testing.assert_array_equal(got.numpy(), want)
    # A slot outside the stage writes nothing.
    st2 = torch.from_numpy(stage.copy())
    stage_splice_rows(st2, torch.from_numpy(cols), torch.tensor([-1, 128, 8], dtype=torch.int32))
    np.testing.assert_array_equal(st2[:, :2].numpy(), stage[:, :2])
    np.testing.assert_array_equal(st2[:, 2, 8].numpy(), cols[:, 2])


def test_pooled_wrappers_reject_wrong_inputs(pooled_inputs):
    x = {k: torch.from_numpy(v) for k, v in pooled_inputs.items()}
    bases, lens = torch.from_numpy(P_BASES), torch.from_numpy(P_LENS)
    with pytest.raises(ValueError):  # int64 bases
        decode_attention_pooled_staged(**x, bases=bases.long(), lens=lens, layer=0)
    with pytest.raises(ValueError):  # one length too few
        decode_attention_pooled_staged(**x, bases=bases, lens=lens[:3], layer=0)
    with pytest.raises(ValueError):  # layer out of range
        decode_attention_pooled_staged(**x, bases=bases, lens=lens, layer=L)
    with pytest.raises(ValueError):  # a bf16 cache where int8 is expected
        decode_attention_pooled_staged_q(
            **x, k_scale=torch.ones(L, P_B, P_T, HKV), v_scale=torch.ones(L, P_B, P_T, HKV),
            bases=bases, lens=lens, layer=0)
    stage = torch.zeros(L, P_B, P_STAGE, W)
    with pytest.raises(ValueError):  # cols with a slot axis
        stage_splice_rows(stage, torch.zeros(L, P_B, 1, W), lens)
    with pytest.raises(ValueError):  # cols of another dtype
        stage_splice_rows(stage, torch.zeros(L, P_B, W, dtype=torch.float64), lens)
    with pytest.raises(ValueError):  # int64 slots
        stage_splice_rows(stage, torch.zeros(L, P_B, W), lens.long())


def _to_time_minor(x, hkv):
    """Port ``[..., T, Hkv*D]`` -> JAX ``[..., Hkv, D, T]`` at any head dim."""
    *lead, t, w = x.shape
    return np.moveaxis(x.reshape(*lead, t, hkv, w // hkv), -3, -1)


@pytest.mark.parametrize("head_dim", [16, 128])
@pytest.mark.parametrize("seq_end,layer", [(1, 0), (100, 1), (129, 0), (256, 1)])
def test_decode_attention_unstaged_plain_matches_pallas(head_dim, seq_end, layer):
    """Row 11: every row attends ``[0, seq_end)`` of one layer."""
    rng = np.random.default_rng(seq_end + head_dim)
    Hq, Hkv, T, Bq = 4, 2, 256, 2
    q = rng.standard_normal((Bq, 1, Hq, head_dim)).astype(np.float32)
    kc = rng.standard_normal((L, Bq, T, Hkv * head_dim)).astype(np.float32)
    vc = rng.standard_normal((L, Bq, T, Hkv * head_dim)).astype(np.float32)
    want = decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(_to_time_minor(kc[layer], Hkv)),
        jnp.asarray(_to_time_minor(vc[layer], Hkv)), jnp.int32(seq_end), block=128,
        interpret=True)
    kp, vp = kc.copy(), vc.copy()
    kp[:, :, seq_end:] = np.nan
    vp[:, :, seq_end:] = np.nan
    before = dict(build.LAUNCHES)
    got = decode_attention_unstaged(torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
                                    torch.tensor([seq_end], dtype=torch.int32), layer)
    assert build.LAUNCHES == before
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **P_TOL)


@pytest.mark.parametrize("head_dim", [16, 128])
@pytest.mark.parametrize("layer", [0, L - 1])
def test_decode_attention_pooled_unstaged_plain_matches_pallas(head_dim, layer):
    """Row 12: row ``b`` attends ``[0, prefix_ends[b])`` and its column."""
    rng = np.random.default_rng(head_dim + layer)
    Hq, Hkv, T = 4, 2, 256
    ends = np.array([40, 0, 201, 255], np.int32)
    Bp, W2 = len(ends), Hkv * head_dim
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, kc, vc, kcur, vcur = f(Bp, 1, Hq, head_dim), f(L, Bp, T, W2), f(L, Bp, T, W2), f(Bp, W2), f(Bp, W2)
    want = decode_attention_pallas_pooled(
        jnp.asarray(q), jnp.asarray(_to_time_minor(kc, Hkv)), jnp.asarray(_to_time_minor(vc, Hkv)),
        jnp.asarray(kcur.reshape(Bp, Hkv, head_dim, 1)), jnp.asarray(vcur.reshape(Bp, Hkv, head_dim, 1)),
        jnp.asarray(ends), jnp.int32(layer), block=128, interpret=True)
    kp, vp = kc.copy(), vc.copy()
    for b, e in enumerate(ends):
        kp[:, b, e:] = np.nan
        vp[:, b, e:] = np.nan
    before = dict(build.LAUNCHES)
    got = decode_attention_pooled_unstaged(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(kcur),
        torch.from_numpy(vcur), torch.from_numpy(ends), layer)
    assert build.LAUNCHES == before
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **P_TOL)


def test_head_dim_128_pooled_staged_and_prefill_plain_match_pallas():
    """Rows 6 and 3 at the hybrid's head dim (128, 4 query and 2 KV heads)."""
    rng = np.random.default_rng(21)
    Hq, Hkv, Dh = 4, 2, 128
    W2 = Hkv * Dh
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, kc, vc = f(P_B, 1, Hq, Dh), f(L, P_B, P_T, W2), f(L, P_B, P_T, W2)
    ks, vs, kcur, vcur = f(L, P_B, P_STAGE, W2), f(L, P_B, P_STAGE, W2), f(P_B, W2), f(P_B, W2)
    want = decode_attention_pallas_pooled_staged(
        jnp.asarray(q), jnp.asarray(_to_time_minor(kc, Hkv)), jnp.asarray(_to_time_minor(vc, Hkv)),
        jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(kcur.reshape(P_B, Hkv, Dh, 1)),
        jnp.asarray(vcur.reshape(P_B, Hkv, Dh, 1)), jnp.asarray(P_BASES), jnp.asarray(P_LENS),
        jnp.int32(1), block=128, interpret=True)
    got = decode_attention_pooled_staged(
        *(torch.from_numpy(a) for a in (q, kc, vc, ks, vs, kcur, vcur)),
        bases=torch.from_numpy(P_BASES), lens=torch.from_numpy(P_LENS), layer=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **P_TOL)

    S, offset, Tp = 37, 64, 256
    q, k, v = f(2, S, Hq, Dh), f(2, Tp, W2), f(2, Tp, W2)
    want = prefill_attention_pallas(
        jnp.asarray(q), jnp.asarray(_to_time_minor(k, Hkv)), jnp.asarray(_to_time_minor(v, Hkv)),
        jnp.int32(offset), block_q=64, block_k=128, interpret=True)
    got = prefill_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_unstaged_wrappers_reject_wrong_inputs():
    q = torch.zeros(2, 1, 4, 16)
    kv = torch.zeros(2, 2, 64, 32)
    with pytest.raises(ValueError):  # two scalars where (seq_end,) is expected
        decode_attention_unstaged(q, kv, kv, torch.tensor([4, 1], dtype=torch.int32), 0)
    with pytest.raises(ValueError):  # layer out of range
        decode_attention_unstaged(q, kv, kv, torch.tensor([4], dtype=torch.int32), 2)
    with pytest.raises(ValueError):  # int64 prefix ends
        decode_attention_pooled_unstaged(q, kv, kv, torch.zeros(2, 32), torch.zeros(2, 32),
                                         torch.tensor([3, 4]), 0)
    with pytest.raises(ValueError):  # layer out of range
        decode_attention_pooled_unstaged(q, kv, kv, torch.zeros(2, 32), torch.zeros(2, 32),
                                         torch.tensor([3, 4], dtype=torch.int32), 2)


# The decode-attention kernel's split plan: a host function of the shapes.
PLAN_T = (1, 8, 255, 256, 528, 3072, 3584)


@pytest.mark.parametrize("T", PLAN_T + (16384, 40000))
@pytest.mark.parametrize("Bp", [2, 16])
@pytest.mark.parametrize("stage", [1, 128])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_decode_plan_covers_every_position_once(T, Bp, stage, head_dim):
    chunk, n_prefix, n_stage = decode_plan(T, stage, Bp, HKV, head_dim)
    assert chunk % 32 == 0 and n_prefix + n_stage <= dam.MAX_SPLITS
    for rows, n in ((T, n_prefix), (stage, n_stage)):
        hits = np.zeros(rows, np.int64)
        for s in range(n):
            lo, hi = s * chunk, min((s + 1) * chunk, rows)
            assert lo < hi  # no split lies wholly past the buffer
            hits[lo:hi] += 1
        assert (hits == 1).all()


def test_decode_plan_depends_on_shapes_only_and_fills_the_card():
    target = dam.BLOCKS_PER_SM * dam.SMS

    def blocks(c, T, stage, Bp, hkv):
        return (-(-T // c) + -(-stage // c)) * Bp * hkv

    for T, Bp, hkv, d, stage in itertools.product(PLAN_T, (2, 16), (8, 4), (64, 128),
                                                  (0, 1, 128)):
        plan = decode_plan(T, stage, Bp, hkv, d)
        assert plan == decode_plan(T, stage, Bp, hkv, d)
        chunk = plan[0]
        fitting = [c for c in dam.CHUNKS if c * d <= dam.SPLIT_DIMS
                   and -(-T // c) + -(-stage // c) <= dam.MAX_SPLITS]
        assert chunk in fitting
        # Two blocks per SM wherever the shortest fitting split allows it; a
        # longer split only when it still gets there.
        assert blocks(chunk, T, stage, Bp, hkv) >= target or chunk == fitting[-1]
        if chunk != fitting[0]:
            assert blocks(2 * chunk, T, stage, Bp, hkv) < target
    # The main path's shapes: 9 prefix + 2 stage splits of 64 would be 176
    # blocks, so the solo step takes 32-position splits; the pool takes 128.
    assert decode_plan(528, 128, 2, 8, 64) == (32, 17, 4)
    assert decode_plan(3072, 128, 2, 8, 64) == (128, 24, 1)
    assert decode_plan(3584, 128, 16, 8, 64) == (128, 28, 1)
    # The hybrid's pool (head dim 128) stops at 64 positions; its solo step
    # (T = 536, no stage) takes 32.
    assert decode_plan(3584, 128, 16, 4, 128) == (64, 56, 2)
    assert decode_plan(536, 0, 2, 4, 128) == (32, 17, 0)
    # Past 64 splits of 128 positions the splits grow by 32 until the row
    # fits the merge's MAX_SPLITS.
    assert decode_plan(16384, 128, 1, 1, 64) == (288, 57, 1)
    assert decode_plan(3072, 128, 1, 1, 64) == (64, 48, 2)


def test_layered_plain_versions_clamp_and_raise_on_a_bad_layer():
    """The one-position staged plain versions clamp flushed_end to [0, T] and
    stage_len to [0, STAGE], as the kernel does, and raise for a layer
    outside [0, L) (the kernel writes NaN)."""
    rng = np.random.default_rng(11)
    Tc, St = 40, 8

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    x = dict(q=f(B, 1, HQ, D), k_cache=f(L, B, Tc, W), v_cache=f(L, B, Tc, W),
             k_stage=f(L, B, St, W), v_stage=f(L, B, St, W), k_cur=f(B, W), v_cur=f(B, W))
    kq, ks = quantize_rows(x["k_cache"], HKV)
    vq, vs = quantize_rows(x["v_cache"], HKV)
    xq = dict(x, k_cache=kq, v_cache=vq, k_scale=ks, v_scale=vs)

    def sc(*v):
        return torch.tensor(v, dtype=torch.int32)

    for fn, args in ((decode_attention_layered, x), (decode_attention_layered_q, xq)):
        torch.testing.assert_close(fn(**args, scalars=sc(Tc + 9, St + 3, 1)),
                                   fn(**args, scalars=sc(Tc, St, 1)), rtol=0, atol=0)
        torch.testing.assert_close(fn(**args, scalars=sc(-4, -2, 0)),
                                   fn(**args, scalars=sc(0, 0, 0)), rtol=0, atol=0)
        for layer in (-1, L, L + 5):
            with pytest.raises(ValueError, match="outside"):
                fn(**args, scalars=sc(5, 2, layer))


# The stage write folded into the staged decode-attention calls. Each case:
# (one position for every row or per-row ring slots, int8 prefix, head dim).
W_STAGE, W_T, W_LAYER = 16, 256, 1
WRITE_CASES = {"solo": (False, False, 64), "solo_int8": (False, True, 64),
               "ring": (True, False, 64), "ring_int8": (True, True, 64),
               "ring_d128": (True, False, 128)}


def _write_inputs(rng, pooled, head_dim):
    Hq, Hkv = (HQ, HKV) if head_dim == 64 else (4, 2)
    Bw = P_B if pooled else B
    w = Hkv * head_dim

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x = dict(q=f(Bw, 1, Hq, head_dim), k_cache=f(L, Bw, W_T, w), v_cache=f(L, Bw, W_T, w),
             k_stage=f(L, Bw, W_STAGE, w), v_stage=f(L, Bw, W_STAGE, w), k_cur=f(Bw, w))
    v_rows = f(Bw, 3 * w)  # the column V as a row view of a wider projection output
    return x, Hkv, v_rows


@pytest.mark.parametrize("slot", [0, W_STAGE - 1, -1, W_STAGE])
@pytest.mark.parametrize("case", list(WRITE_CASES))
def test_stage_write_plain_matches_pallas(case, slot):
    """The writing call of each staged wrapper on the CPU: its output
    against the Pallas decode-attention kernel it stands for (at the clamped
    stage length), and the stage against ``stage_splice_pallas`` /
    ``stage_splice_rows_pallas`` on the same columns on layer ``W_LAYER``'s
    plane, bit for bit; a slot outside the stage writes nothing, and no
    other plane or slot changes. V is a strided row view. Pooled cases put
    ``slot`` on row 0 and in-range slots on the others."""
    pooled, int8, head_dim = WRITE_CASES[case]
    rng = np.random.default_rng(100 + 7 * abs(slot) + len(case))
    x, Hkv, v_rows = _write_inputs(rng, pooled, head_dim)
    w = x["k_cur"].shape[1]
    v_cur = v_rows[:, w:2 * w]
    clamp = int(np.clip(slot, 0, W_STAGE))

    def tm(a):
        return jnp.asarray(_to_time_minor(a, Hkv))

    jcur = [jnp.asarray(c.reshape(c.shape[0], Hkv, head_dim, 1)) for c in (x["k_cur"], v_cur)]
    jstage = (jnp.asarray(x["k_stage"]), jnp.asarray(x["v_stage"]))
    args = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    args["v_cur"] = torch.from_numpy(v_rows)[:, w:2 * w]
    assert not args["v_cur"].is_contiguous()
    if int8:
        jq = {n: quantize_kv(tm(x[n + "_cache"]), dh_axis=3) for n in "kv"}
        jprefix = (jq["k"][0], jq["v"][0], jq["k"][1], jq["v"][1])
        for n in "kv":
            args[n + "_cache"], args[n + "_scale"] = quantize_rows(args[n + "_cache"], Hkv)
    else:
        jprefix = (tm(x["k_cache"]), tm(x["v_cache"]))
    before = dict(build.LAUNCHES)
    if pooled:
        bases = np.array([40, 0, 201, 100], np.int32)
        lens = np.array([slot, 5, W_STAGE - 1, 0], np.int32)
        jax_fn = decode_attention_pallas_pooled_staged_q if int8 else (
            decode_attention_pallas_pooled_staged)
        want = jax_fn(jnp.asarray(x["q"]), *jprefix, *jstage, *jcur, jnp.asarray(bases),
                      jnp.asarray(np.clip(lens, 0, W_STAGE)), jnp.int32(W_LAYER), block=128,
                      interpret=True)
        fn = decode_attention_pooled_staged_q if int8 else decode_attention_pooled_staged
        got = fn(**args, bases=torch.from_numpy(bases), lens=torch.from_numpy(lens),
                 layer=W_LAYER)
        valid = (lens >= 0) & (lens < W_STAGE)
        plane = {n: np.array(stage_splice_rows_pallas(
            jstage[i][W_LAYER:W_LAYER + 1], jcur[i].reshape(1, -1, 1, w),
            jnp.asarray(np.where(valid, lens, 0)), interpret=True))[0]
            for i, n in enumerate("kv")}
        for n in "kv":  # a row whose slot is outside the stage keeps its plane
            plane[n][~valid] = x[n + "_stage"][W_LAYER][~valid]
        tol = P_TOL
    else:
        jax_fn = decode_attention_pallas_layered_q if int8 else decode_attention_pallas_layered
        want = jax_fn(jnp.asarray(x["q"]), *jprefix, *jstage, *jcur, jnp.int32(100),
                      jnp.int32(clamp), jnp.int32(W_LAYER), block=128, interpret=True)
        fn = decode_attention_layered_q if int8 else decode_attention_layered
        got = fn(**args, scalars=torch.tensor([100, slot, W_LAYER], dtype=torch.int32))
        plane = {n: x[n + "_stage"][W_LAYER] for n in "kv"}
        if slot == clamp < W_STAGE:
            plane = {n: np.asarray(stage_splice_pallas(
                jstage[i][W_LAYER:W_LAYER + 1], jcur[i].reshape(1, -1, 1, w), jnp.int32(slot),
                interpret=True))[0] for i, n in enumerate("kv")}
        tol = TOL
    assert build.LAUNCHES == before  # the CPU path launches nothing
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    for n in "kv":
        stage = args[n + "_stage"].numpy()
        np.testing.assert_array_equal(stage[W_LAYER], plane[n])
        np.testing.assert_array_equal(np.delete(stage, W_LAYER, axis=0),
                                      np.delete(x[n + "_stage"], W_LAYER, axis=0))


def test_column_row_stride_accepts_row_views_only():
    """The launch wrapper's check of a column ``[B, W]`` (host code, run
    before any launch): row views of a wider buffer pass with their row
    stride; a stride that is not a multiple of 8 elements, a row start off
    16 bytes, a strided last dimension, overlapping rows or another device
    raise."""
    cpu = torch.device("cpu")
    wide = torch.zeros(4, 3 * 64, dtype=torch.bfloat16)
    assert dam._row_stride("t", wide[:, 128:192], cpu) == 192
    assert dam._row_stride("t", wide[:1, 64:128], cpu) == 64
    assert dam._row_stride("t", wide[:, :64].contiguous(), cpu) == 64
    assert dam._row_stride("t", None, cpu) == 0
    for bad in (wide[:, 4:68], torch.zeros(4, 100, dtype=torch.bfloat16)[:, :64],
                wide[:, 64:192:2], wide.view(-1).as_strided((4, 64), (8, 1))):
        with pytest.raises(ValueError):
            dam._row_stride("t", bad, cpu)
    with pytest.raises(ValueError):
        dam._row_stride("t", wide[:, :64], torch.device("cuda"))


def _recorded(fn, cols):
    """``fn`` with its stage write sent to a copy of the stage, recording
    each call's columns: the backbones' decode before the write moved into
    the attention call."""
    sig = inspect.signature(fn)

    def call(*args, **kwargs):
        bound = sig.bind(*args, **kwargs).arguments
        cols.append((bound["k_cur"].clone(), bound["v_cur"].clone()))
        for n in ("k_stage", "v_stage"):
            bound[n] = bound[n].clone()
        return fn(**bound)
    return call


BACKBONE_CASES = ["transformer_solo", "transformer_solo_int8", "transformer_ring",
                  "transformer_ring_int8", "hybrid_ring"]


@pytest.mark.parametrize("case", BACKBONE_CASES)
def test_backbone_stage_after_a_step_equals_gather_then_splice(case, monkeypatch):
    """A decode step's stage planes (and output and cache) bit-equal to the
    same step with the columns gathered per layer and spliced into the stage
    after the layer loop (``stage_splice`` / ``stage_splice_rows``): 2-4
    layers at narrow widths, fp32 on the CPU, a random stage and prefix."""
    gen = torch.Generator().manual_seed(len(case))
    ring = "ring" in case
    if case.startswith("hybrid"):
        cfg = BackboneConfig(
            d_model=128, n_layer=4, d_intermediate=0, attn_mlp_d_intermediate=256,
            attn_layer_idx=(1, 3), rms_norm=True, residual_in_fp32=True,
            ssm_cfg=_freeze({"layer": "Mamba2", "d_state": 16, "headdim": 32, "chunk_size": 8}),
            attn_cfg=_freeze({"num_heads": 2, "num_heads_kv": 1, "head_dim": 128,
                              "rotary_emb_dim": 64}))
        model = tmb.HybridBackbone(cfg)
        params = model.init(gen, torch.float32, "cpu")
        cache = model.allocate_cache(4, 64, torch.float32, "cpu", pool_ring=True)
        names, module, rope, d_model = ("decode_attention_pooled_staged",), tmb, None, 128
    else:
        cfg = BackboneConfig(d_model=64, n_layer=3, attn_mlp_d_intermediate=128,
                             attn_cfg=_freeze({"num_heads": 4, "num_heads_kv": 2}))
        model = tbb.TransformerBackbone(cfg)
        params = model.init(gen, torch.float32, "cpu")
        cache = model.allocate_cache(4 if ring else 2, 64, torch.float32, "cpu",
                                     kv_int8="int8" in case)
        names = (("decode_attention_pooled_staged", "decode_attention_pooled_staged_q") if ring
                 else ("decode_attention_layered", "decode_attention_layered_q"))
        module, rope, d_model = tbb, rope_table(cfg.head_dim), 64
    for name, t in cache.items():
        if t.is_floating_point() and "scale" not in name:
            t.copy_(torch.randn(t.shape, generator=gen))
    Bx = cache["k_stage"].shape[1]
    hidden = torch.randn(Bx, 1, d_model, generator=gen)
    if ring:
        pos, base = torch.tensor([25, 12, 40, 9]), torch.tensor([20, 12, 30, 2])
        kw = dict(positions=pos, pool_base=base)
        args, slots = (0, rope), (pos - base).to(torch.int32)
    else:
        args, slots = (25, rope, 20), torch.tensor([5], dtype=torch.int32)
        kw = {}
    start = {k: v.clone() for k, v in cache.items()}
    want_out = model.forward(params, hidden, cache, *args, **kw)

    ref = {k: v.clone() for k, v in start.items()}
    cols = []
    for name in names:
        monkeypatch.setattr(module, name, _recorded(getattr(module, name), cols))
    out = model.forward(params, hidden, ref, *args, **kw)
    splice = stage_splice_rows if ring else stage_splice
    for i, n in enumerate(("k_stage", "v_stage")):
        assert torch.equal(ref[n], start[n])  # the calls wrote only to copies
        splice(ref[n], torch.stack([c[i] for c in cols]), slots)
    assert len(cols) == cache["k_stage"].shape[0]
    assert torch.equal(out, want_out)
    for name, t in cache.items():
        assert torch.equal(t, ref[name]), name
    assert not torch.equal(cache["k_stage"], start["k_stage"])


# The M <= 2 qmm_int8 kernel's plan: (tile width, cluster size, rows per
# block), a host function of (M, K, N, G). The flagship projections (in_proj,
# out_proj, fc1, fc2) and the nine heads, then small and odd shapes.
QMM_FLAGSHIP = [(2048, 3072, 1), (2048, 2048, 1), (2048, 16384, 1), (8192, 2048, 1),
                (2048, 1152, 9)]
QMM_ODD = [(1000, 144, 2), (320, 144, 2), (330, 32, 1), (2112, 3072, 1), (8256, 2048, 1),
           (16, 16, 1), (129, 48, 3), (40000, 64, 1)]


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("K,N,G", QMM_FLAGSHIP + QMM_ODD)
def test_qmm_decode_plan_covers_every_row_and_column_once(M, K, N, G):
    tn, cs, rows = qmm_mod.decode_plan(M, K, N, G)
    assert tn in qmm_mod.TILES and N % 16 == 0
    assert 1 <= cs <= qmm_mod.MAX_CLUSTER <= 16 and cs & (cs - 1) == 0
    stage_rows = qmm_mod.STAGE_BYTES // tn
    assert rows % stage_rows == 0
    k_hits = np.zeros(K, np.int64)
    for rank in range(cs):
        k_hits[rank * rows:(rank + 1) * rows] += 1
    assert (k_hits == 1).all()
    # Every output column of every weight lies in exactly one tile; a thread
    # owns 16 columns, all inside or all past N.
    n_hits = np.zeros(N, np.int64)
    for t in range(-(-N // tn)):
        n_hits[t * tn:min((t + 1) * tn, N)] += 1
    assert (n_hits == 1).all()
    assert qmm_mod.decode_plan(M, K, N, G) == (tn, cs, rows)  # shapes alone


def test_qmm_decode_plan_sizes_blocks_and_clusters_at_the_flagship_shapes():
    """The narrowest tile whose grid stays within MAX_PER_SM blocks per SM;
    clusters only while a block would walk more than BLOCK_BYTES; at least
    64 blocks (about half the SMs) at every flagship shape."""
    for K, N, G in QMM_FLAGSHIP:
        tn, cs, rows = qmm_mod.decode_plan(2, K, N, G)
        assert qmm_mod.decode_plan(1, K, N, G) == (tn, cs, rows)
        blocks = cs * -(-N // tn) * G
        assert 64 <= blocks <= qmm_mod.MAX_PER_SM * qmm_mod.SMS, (K, N, G)
        narrower = [t for t in qmm_mod.TILES if t < tn]
        assert all(-(-N // t) * G > qmm_mod.MAX_PER_SM * qmm_mod.SMS for t in narrower)
        assert tn * -(-K // cs) <= qmm_mod.BLOCK_BYTES
        if cs > 1:  # one cluster fewer would leave a block more than BLOCK_BYTES
            assert tn * -(-K // (cs // 2)) > qmm_mod.BLOCK_BYTES
    # in_proj, out_proj, fc1, fc2 (the one that splits K), the heads.
    assert qmm_mod.decode_plan(2, 2048, 3072, 1) == (32, 1, 2048)
    assert qmm_mod.decode_plan(2, 2048, 2048, 1) == (32, 1, 2048)
    assert qmm_mod.decode_plan(2, 2048, 16384, 1) == (64, 1, 2048)
    assert qmm_mod.decode_plan(2, 8192, 2048, 1) == (32, 2, 4096)
    assert qmm_mod.decode_plan(2, 2048, 1152, 9) == (32, 1, 2048)
    # A K too long for eight blocks: each block walks more rows.
    assert qmm_mod.decode_plan(2, 40000, 64, 1) == (32, 8, 5120)
    with pytest.raises(ValueError):
        qmm_mod.decode_plan(3, 2048, 2048, 1)


# The Mamba step's plan: the column tile, a host function of (B, N, HP,
# state bytes).
@pytest.mark.parametrize("B", [1, 2, 3, 16])
@pytest.mark.parametrize("N,HP", [(128, 4096), (64, 128), (64, 256), (256, 1024)])
@pytest.mark.parametrize("state_bytes", [4, 2])
def test_step_plan_covers_every_state_row_and_column_once(B, N, HP, state_bytes):
    tile = msm.step_plan(B, N, HP, state_bytes)
    assert tile in msm.TILES and HP % tile == 0
    # Every (state row, column) of a batch row is one thread's chunk in
    # exactly one pass of exactly one block.
    per_chunk = 16 // state_bytes
    threads_per_row = tile // per_chunk
    pass_rows = 256 // threads_per_row
    assert N % pass_rows == 0
    hits = np.zeros((N, HP), np.int64)
    for t in range(HP // tile):
        for tid in range(256):
            for j in range(N // pass_rows):
                r = tid // threads_per_row + j * pass_rows
                c = t * tile + (tid % threads_per_row) * per_chunk
                hits[r, c:c + per_chunk] += 1
    assert (hits == 1).all()
    assert msm.step_plan(B, N, HP, state_bytes) == tile  # shapes alone


def test_step_plan_fills_the_card_at_the_hybrid_shapes():
    for B, state_bytes in itertools.product((1, 2, 16), (4, 2)):
        tile = msm.step_plan(B, 128, 4096, state_bytes)
        assert B * 4096 // tile >= msm.SMS or tile == msm.TILES[-1]
        wider = [t for t in msm.TILES if t > tile]
        assert all(B * 4096 // t < msm.SMS for t in wider)
    assert msm.step_plan(2, 128, 4096, 4) == 32    # the solo step: 256 blocks
    assert msm.step_plan(2, 128, 4096, 2) == 32
    assert msm.step_plan(16, 128, 4096, 4) == 128  # the pool: 512 blocks
    assert msm.step_plan(16, 128, 4096, 2) == 128
    for bad in ((2, 12, 4096, 4), (2, 128, 4000, 4), (2, 512, 4096, 4)):
        with pytest.raises(ValueError):
            msm.step_plan(*bad)


@pytest.mark.parametrize("ordinal,sms,tile", [(0, 132, 32), (1, 114, 64)])
@pytest.mark.parametrize("partial", [False, True], ids=["norm", "partial"])
def test_step_wrapper_passes_its_cards_sm_count(monkeypatch, ordinal, sms, tile, partial):
    """The fused Mamba step plans its column tile for the SM count of the
    card its tensors are on (``_sm_count`` of that device, as the decode and
    int8 plans read it), not a count fixed in the source: the solo step's
    2 x 4096 columns take 32-column tiles on 132 SMs and 64-column ones on
    114. The partial-norm mode passes its sums' buffer and counts under
    its own name. Meta tensors stand in for a card's, the library for a
    recorder."""
    dev = torch.device("cuda", ordinal)
    calls = []

    class Lib:
        def zvt_ssd_gate_step(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(build, "require_cuda", lambda name, *t: dev)
    monkeypatch.setattr(build, "load", lambda: Lib())
    monkeypatch.setattr(build, "stream_handle", lambda d: 0)
    monkeypatch.setattr(msm, "_sm_count", lambda d: {0: 132, 1: 114}[d.index])
    meta = torch.empty(1 << 16, device="meta")
    monkeypatch.setattr(msm, "_workspace", lambda d, floats, rows: (meta, meta.int()))
    Bx, N, HP, H = 2, 128, 4096, 64

    def t(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    bf = torch.bfloat16
    name = "ssd_gate_step_partial" if partial else "ssd_gate_step"
    before = build.LAUNCHES[name]
    out = msm.ssd_gate_step_layered(
        t(3, Bx, N, HP), 1, t(Bx, HP, dtype=bf), t(Bx, H), t(Bx, H), t(Bx, N), t(Bx, N),
        t(Bx, HP, dtype=bf), t(H), t(HP, dtype=bf), partial=partial)
    (args,) = calls
    # ..., R, B, N, HP, H, tile, eps, stream
    assert args[15:21] == (3, Bx, N, HP, H, tile)
    assert (args[12] is not None) == partial  # the sums' buffer, or null
    if partial:
        assert out[0].shape == (Bx, HP) and out[1].shape == (Bx,)
        assert out[1].dtype == torch.float32
    assert build.LAUNCHES[name] == before + 1
    build.LAUNCHES[name] = before
