"""The port's kernel wrappers on CPU tensors (their plain versions) against
the JAX package's Pallas kernels run with ``interpret=True``.

Same inputs, made with numpy from a seed, in each side's layout: the JAX
caches are time-minor ``[L, B, Hkv, D, T]``, the port's time-major
``[L, B, T, Hkv*D]``. The edge cases are the chip phase's, at a smaller
cache: an empty and a one-position flushed prefix, an empty and a full
stage, the first and last layer, a cache length that is not a multiple of
the kernel's 256-position chunk, chunks of 7, 97 and 600 queries, offsets 0
and 64. Everything runs in fp32; tolerance 2e-4 (summation order only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_vibes_tpu.ops.pallas.decode_attention import decode_attention_pallas_layered
from zonos_vibes_tpu.ops.pallas.prefill_attention import prefill_attention_pallas
from zonos_vibes_tpu.ops.pallas.stage_write import stage_splice_pallas
from zonos_vibes_tpu_torch.ops.cuda import build
from zonos_vibes_tpu_torch.ops.cuda.decode_attention import decode_attention_layered
from zonos_vibes_tpu_torch.ops.cuda.prefill_attention import prefill_attention
from zonos_vibes_tpu_torch.ops.cuda.stage_write import stage_splice

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


def test_wrappers_reject_inconsistent_shapes():
    q = torch.zeros(B, 4, HQ, D)
    kv = torch.zeros(B, 16, W)
    with pytest.raises(ValueError):
        prefill_attention(q, kv, kv, 14)  # offset + S past the cache
    with pytest.raises(ValueError):
        stage_splice(torch.zeros(L, B, STAGE, W), torch.zeros(L, B, 1, W),
                     torch.tensor([0], dtype=torch.int32))
