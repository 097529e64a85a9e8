"""The port's plain ops against the JAX package's, on the same numpy inputs.

fp32 on the CPU, JAX at ``highest`` matmul precision (tests/conftest.py).
Tolerances: 1e-6 for elementwise math (the same fp32 operations), 1e-5 where
a reduction or a matmul sums in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_vibes_tpu.ops import delay_pattern as jdp
from zonos_vibes_tpu.ops import mlp as jmlp
from zonos_vibes_tpu.ops import norms as jnorms
from zonos_vibes_tpu.ops import rope as jrope
from zonos_vibes_tpu.ops import sampling as jsamp
from tests.rope_oracle import rope_table_fp64
from zonos_vibes_tpu.ops.attention import NEG_INF as JAX_NEG_INF
from zonos_vibes_tpu_torch.ops import delay_pattern, mlp, norms, rope, sampling
from zonos_vibes_tpu_torch.ops.attention import NEG_INF


def test_neg_inf_is_bit_identical():
    assert NEG_INF == JAX_NEG_INF


@pytest.mark.parametrize("head_dim", [16, 64, 128])
def test_rope_table_and_apply(head_dim):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, head_dim)).astype(np.float32)
    pos = rng.integers(0, 16384, size=(2, 5))
    table = rope.rope_table(head_dim)
    want_table = np.array(jrope.expand_rope_table(jrope.rope_table(head_dim)))
    # The port's table against its definition, evaluated by the same numpy
    # arithmetic (so this holds the layout and signs; the values are held
    # independently by test_rope_table_against_mpmath).
    exact, freq_ulp, angles = rope_table_fp64(head_dim)
    np.testing.assert_allclose(table.numpy(), exact, rtol=0, atol=2e-7)
    # Against JAX's table: XLA's fp32 pow and reciprocal are not correctly
    # rounded, and how they round depends on how XLA compiles them (fused or
    # not, vector width), so a frequency may differ by one ulp from the
    # correctly rounded one. Position p turns that into an angle difference
    # of p ulp(freq) before the angle's own rounding (one ulp each side),
    # up to ~1.5e-4 at p = 16383; the per-element limit is exactly that.
    slack = (np.arange(16384)[:, None] * freq_ulp + 2 * np.spacing(angles)).astype(np.float64)
    limit = np.repeat(slack, 2, -1)[:, None, :] + 2e-7
    assert (np.abs(table.numpy() - want_table) <= limit).all()
    # Same table on both sides: the rotation itself must agree to fp32 rounding.
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(want_table))
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(want_table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _fp32_nearest(x):
    """The fp32 value nearest to the mpmath number ``x``."""
    import mpmath

    c = np.float32(float(x))
    return min((np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf))),
               key=lambda v: abs(mpmath.mpf(float(v)) - x))


@pytest.mark.parametrize("head_dim", [16, 64, 128])
def test_rope_table_against_mpmath(head_dim):
    """The table's values from an evaluation that shares no arithmetic with
    the port's: each frequency ``1 / 10000 ** (2i / D)`` at 40 digits is
    the correctly rounded fp32 one (bit for bit); at 272 positions spread
    over all 16,384 (every 2048-position block), each cos and sin at 40
    digits of the fp32 angle ``fp32(p * freq)`` is within half an fp32 ulp
    of 1 (2**-25, plus the float64 evaluation's own error) of the table."""
    import mpmath

    mpmath.mp.dps = 40
    freqs = rope.rope_freqs(head_dim).numpy()
    want = np.array([_fp32_nearest(1 / mpmath.mpf(10000) ** (mpmath.mpf(i) / head_dim))
                     for i in range(0, head_dim, 2)], np.float32)
    np.testing.assert_array_equal(freqs.view(np.int32), want.view(np.int32))
    rng = np.random.default_rng(0)
    pos = np.unique(np.concatenate([np.arange(8), rng.choice(16384, 256, replace=False),
                                    np.arange(16376, 16384)]))
    assert len(np.unique(pos // 2048)) == 8
    # A product of an integer below 2**24 and an fp32 is exact in float64:
    # one rounding to fp32 gives the correctly rounded fp32 product.
    angles = (pos[:, None].astype(np.float64) * freqs.astype(np.float64)).astype(np.float32)
    cos = np.array([[float(mpmath.cos(mpmath.mpf(float(a)))) for a in row] for row in angles])
    sin = np.array([[float(mpmath.sin(mpmath.mpf(float(a)))) for a in row] for row in angles])
    exact = np.stack([np.repeat(cos, 2, -1), np.stack([-sin, sin], -1).reshape(len(pos), -1)], 1)
    table = rope.rope_table(head_dim).numpy()[pos].astype(np.float64)
    assert np.abs(table - exact).max() <= 2.0 ** -25 + 2e-16


def test_layer_norm():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    got = norms.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    want = jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_swiglu_mid():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 96)) / 6).astype(np.float32)
    got = mlp.swiglu_mid(torch.from_numpy(x), {"weight": torch.from_numpy(w)})
    want = jmlp.swiglu_mid(jnp.asarray(x), {"weight": jnp.asarray(w)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_delay_pattern_apply_and_revert():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 1024, size=(2, 9, 13))
    got = delay_pattern.apply_delay_pattern(torch.from_numpy(codes), 1025)
    want = jdp.apply_delay_pattern(jnp.asarray(codes), 1025)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = delay_pattern.revert_delay_pattern(got)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jdp.revert_delay_pattern(want)))
    np.testing.assert_array_equal(back.numpy(), codes)


def _jax_probs(logits, params, gen):
    """The JAX static pipeline up to (not including) the draw."""
    if params.repetition_penalty != 1.0 and gen is not None:
        logits = jsamp.apply_repetition_penalty(logits, gen, params.repetition_penalty,
                                                params.repetition_penalty_window)
    logits = logits.astype(jnp.float32)
    if params.temperature <= 0:
        return logits
    probs = jax.nn.softmax(logits / params.temperature, axis=-1)
    if params.linear > 0.0:
        probs = jsamp.apply_unified(probs, params.linear, params.conf, params.quad)
    if params.top_p > 0:
        probs = jsamp.apply_top_p(probs, params.top_p)
    if params.top_k > 0:
        probs = jsamp.apply_top_k(probs, params.top_k)
    if params.min_p > 0:
        probs = jsamp.apply_min_p(probs, params.min_p)
    return probs


@pytest.mark.parametrize("knobs", [
    dict(min_p=0.1),
    dict(temperature=0.7, top_p=0.9),
    dict(top_k=20),
    dict(linear=0.5, conf=0.2, quad=0.1),
    dict(temperature=1.3, top_p=0.8, top_k=50, min_p=0.05, repetition_penalty_window=4),
    dict(temperature=0.0),
])
def test_sampling_probs_match(knobs):
    rng = np.random.default_rng(4)
    V = 1152
    logits = (rng.standard_normal((2, 9, V)) * 3).astype(np.float32)
    logits[..., 1025:] = NEG_INF
    gen = rng.integers(0, V, size=(2, 9, 6))
    gen[0, 0, -1] = 1025  # MASK lands on the clamped top slot
    gen[1, 2, -2] = -1  # not yet generated: counts for nothing
    params_j = jsamp.SamplingParams(**knobs)
    params_t = sampling.SamplingParams(**knobs)
    want = np.asarray(_jax_probs(jnp.asarray(logits), params_j, jnp.asarray(gen)))
    got = sampling.sampling_probs(torch.from_numpy(logits), params_t, torch.from_numpy(gen)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    if params_t.temperature <= 0:
        toks = sampling.sample_from_logits(None, torch.from_numpy(logits), params_t,
                                           torch.from_numpy(gen))
        jtoks = jsamp.sample_from_logits(jax.random.key(0), jnp.asarray(logits), params_j,
                                         jnp.asarray(gen))
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))


def test_exponential_race_samples_the_distribution():
    """The draw (a torch.Generator's stream, unlike JAX's) follows the
    probabilities: 20,000 draws from a 4-token distribution land within 3%
    of each probability."""
    probs = torch.tensor([[[0.5, 0.3, 0.2, 0.0]]]).expand(20000, 1, 4)
    logits = torch.log(probs.clamp(min=1e-30))
    g = torch.Generator().manual_seed(0)
    toks = sampling.sample_from_logits(
        g, logits, sampling.SamplingParams(repetition_penalty=1.0))
    freq = torch.bincount(toks.flatten(), minlength=4).float() / toks.numel()
    np.testing.assert_allclose(freq.numpy(), [0.5, 0.3, 0.2, 0.0], atol=0.03)


# Rows of one batch with different knobs, as the pool runs them.
DYN_ROWS = [
    dict(temperature=0.0),
    dict(min_p=0.1),
    dict(temperature=0.7, top_p=0.9, repetition_penalty_window=1),
    dict(top_k=20, repetition_penalty_window=8),
    dict(linear=0.5, conf=0.2, quad=0.1, repetition_penalty_window=5),
    dict(temperature=1.3, top_p=0.8, top_k=50, min_p=0.05, repetition_penalty_window=4),
    dict(repetition_penalty=1.0, top_k=3, repetition_penalty_window=3),
    dict(temperature=0.0, repetition_penalty=2.0, repetition_penalty_window=6),
]
WMAX = 8


def _dyn_inputs(seed):
    rng = np.random.default_rng(seed)
    V = 1152
    logits = (rng.standard_normal((len(DYN_ROWS), 9, V)) * 3).astype(np.float32)
    logits[..., 1025:] = NEG_INF
    gen = rng.integers(0, 1026, size=(len(DYN_ROWS), 9, WMAX))
    gen[1, 0, -1] = 1025  # MASK lands on the clamped top slot
    gen[:, 3, -2] = logits[:, 3].argmax(-1)  # a penalised winner
    knobs = {f: torch.stack([sampling.knobs_from_params(sampling.SamplingParams(**r), 2.0)[f]
                             for r in DYN_ROWS]) for f in sampling.KNOB_FIELDS}
    return logits, gen, knobs


def test_dyn_sampler_distribution_matches_jax_and_static(monkeypatch):
    """Per-row knobs, one batch: each row's distribution before the draw
    equals JAX's ``sample_from_logits_dyn`` (captured at its draw) and the
    port's static ``sampling_probs`` for that row's ``SamplingParams`` over
    the row's last ``window`` frames; greedy rows take JAX's argmax."""
    logits, gen, knobs = _dyn_inputs(5)
    probs, lf = sampling.sampling_probs_dyn(torch.from_numpy(logits), knobs,
                                            torch.from_numpy(gen))
    captured = {}

    def capture(key, p):
        captured["probs"] = np.asarray(p)
        return jnp.argmax(p, axis=-1).astype(jnp.int32)

    monkeypatch.setattr(jsamp, "gumbel_multinomial", capture)
    for b, row in enumerate(DYN_ROWS):
        jknobs = jsamp.knobs_from_params(jsamp.SamplingParams(**row), 2.0)
        jtok = jsamp.sample_from_logits_dyn(jax.random.key(0), jnp.asarray(logits[b: b + 1]),
                                            jknobs, jnp.asarray(gen[b: b + 1]))
        np.testing.assert_allclose(probs[b].numpy(), captured["probs"][0], rtol=1e-6, atol=1e-6)
        params = sampling.SamplingParams(**row)
        w = params.repetition_penalty_window
        static = sampling.sampling_probs(torch.from_numpy(logits[b: b + 1]), params,
                                         torch.from_numpy(gen[b: b + 1, :, WMAX - w:]))
        if params.temperature > 0:
            np.testing.assert_allclose(probs[b: b + 1].numpy(), static.numpy(), rtol=1e-6,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(lf[b: b + 1].numpy(), static.numpy())
            tok = sampling.sample_from_logits_dyn(
                torch.from_numpy(logits), knobs, torch.ones(logits.shape),
                torch.from_numpy(gen))[b]
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok)[0])


def test_dyn_sampler_without_sorted_stages_matches_when_top_p_k_are_off():
    logits, gen, knobs = _dyn_inputs(6)
    off = [b for b, r in enumerate(DYN_ROWS) if not r.get("top_p") and not r.get("top_k")]
    full, _ = sampling.sampling_probs_dyn(torch.from_numpy(logits), knobs,
                                          torch.from_numpy(gen))
    short, _ = sampling.sampling_probs_dyn(torch.from_numpy(logits), knobs,
                                           torch.from_numpy(gen), sorted_stages=False)
    np.testing.assert_array_equal(short[off].numpy(), full[off].numpy())


def test_pool_draws_are_composition_invariant():
    """The same (row seed, step) gives the same noise and token whatever the
    other rows hold."""
    logits, gen, knobs = _dyn_inputs(7)
    seeds, steps = torch.tensor([11, 12, 13, 14, 15, 16, 17, 18]), torch.arange(8) + 3
    noise = sampling.pool_noise(42, seeds, steps, 9, logits.shape[-1])
    toks = sampling.sample_from_logits_dyn(torch.from_numpy(logits), knobs, noise,
                                           torch.from_numpy(gen))
    # Row 1 alone (a batch of one), and row 1 beside other rows and seeds.
    alone = sampling.pool_noise(42, seeds[1:2], steps[1:2], 9, logits.shape[-1])
    np.testing.assert_array_equal(alone[0].numpy(), noise[1].numpy())
    k1 = {f: v[1:2] for f, v in knobs.items()}
    tok1 = sampling.sample_from_logits_dyn(torch.from_numpy(logits[1:2]), k1, alone,
                                           torch.from_numpy(gen[1:2]))
    np.testing.assert_array_equal(tok1[0].numpy(), toks[1].numpy())
    # Neighbours with other seeds, steps and logits.
    other_seeds, other_steps = torch.tensor([99, 12, 7, 0, 1, 2, 3, 4]), torch.arange(8) + 50
    other_steps[1] = steps[1]
    moved = sampling.pool_noise(42, other_seeds, other_steps, 9, logits.shape[-1])
    assert not torch.equal(moved[0], noise[0])
    other_logits = torch.from_numpy(logits).roll(1, dims=0)
    other_logits[1] = torch.from_numpy(logits[1])
    toks2 = sampling.sample_from_logits_dyn(other_logits, knobs, moved, torch.from_numpy(gen))
    np.testing.assert_array_equal(toks2[1].numpy(), toks[1].numpy())


def test_pool_noise_is_exp1():
    """10^5 draws have mean 1 within 0.02 and the Exp(1) tail:
    P(e > 3) = e^-3 within 0.005."""
    e = sampling.pool_noise(7, torch.arange(10), torch.full((10,), 3), 10, 1000)
    assert e.shape == (10, 10, 1000) and e.dtype == torch.float32
    assert (e > 0).all() and torch.isfinite(e).all()
    assert abs(e.mean().item() - 1.0) < 0.02
    assert abs((e > 3).float().mean().item() - np.exp(-3.0)) < 0.005
