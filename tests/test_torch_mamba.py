"""The port's Mamba-2 ops (``ops/mamba.py``, ``ops/norms.rms_norm``,
``ops/rope.apply_rope_half``) and the fused decode step's plain version
(``ops/cuda/mamba_step.py``, rows 9 and 10 of the kernel table) against the
JAX package's, on the CPU.

Inputs come from a numpy seed and go to both sides in fp32. The XLA ops
agree to 1e-5 (summation order only). The fused step's plain version is
held against the Pallas kernels run with ``interpret=True``: the output
within 1e-5, an fp32 state within 1e-6, a bf16 state within one bf16 step
(both round the same fp32 update, which may differ in its last bit); the
layered entry leaves every other plane of the stacked state bit-identical.
The partial-norm mode's plain version (a tensor-parallel rank's heads),
folded through the row-parallel out_proj, is held against the Pallas step
followed by out_proj within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zonos_vibes_tpu.models.mamba_backbone import apply_rope_half as japply_rope_half
from zonos_vibes_tpu.ops import mamba as jm
from zonos_vibes_tpu.ops.norms import rms_norm as jrms_norm
from zonos_vibes_tpu.ops.pallas.mamba_step import (
    ssd_gate_step_layered_pallas,
    ssd_gate_step_pallas,
)
from zonos_vibes_tpu_torch.ops import mamba as tm
from zonos_vibes_tpu_torch.ops.cuda import build
from zonos_vibes_tpu_torch.ops.cuda.mamba_step import (
    ssd_gate_step,
    ssd_gate_step_layered,
    ssd_gate_step_partial_plain,
)
from zonos_vibes_tpu_torch.ops.norms import rms_norm
from zonos_vibes_tpu_torch.ops.rope import apply_rope_half

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    rng = np.random.default_rng(seed)
    return lambda *s: rng.standard_normal(s).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_within_one_bf16_step(got, want):
    """Every element within one bf16 step (8 bits of mantissa) of ``want``."""
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= step).all()


def test_rms_norm_matches_jax():
    f = _rng(0)
    x, w = f(3, 5, 48), f(48)
    np.testing.assert_allclose(rms_norm(_t(x), _t(w), 1e-5).numpy(),
                               np.asarray(jrms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)), **TOL)


@pytest.mark.parametrize("rotary_dim", [0, 8, 16])
def test_apply_rope_half_matches_jax(rotary_dim):
    f = _rng(1)
    x = f(2, 5, 4, 16)
    pos = np.array([[0, 1, 2, 3, 4], [100, 7, 3000, 9, 11]], np.int32)
    want = japply_rope_half(jnp.asarray(x), jnp.asarray(pos), rotary_dim)
    got = apply_rope_half(_t(x), _t(pos), rotary_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    f = _rng(2)
    x, w, b = f(2, 7, 24), f(4, 24), f(24)
    state = f(2, 3, 24) if with_state else None
    jy, jst = jm.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               None if state is None else jnp.asarray(state))
    ty, tst = tm.causal_conv1d(_t(x), _t(w), _t(b), None if state is None else _t(state))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


def test_causal_conv1d_step_matches_jax():
    f = _rng(3)
    x, w, b, state = f(2, 24), f(4, 24), f(24), f(2, 3, 24)
    jy, jst = jm.causal_conv1d_step(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                    jnp.asarray(state))
    ty, tst = tm.causal_conv1d_step(_t(x), _t(w), _t(b), _t(state))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


def _ssd_inputs(seed, B=2, L=13, H=4, P=8, G=1, N=16):
    f = _rng(seed)
    x, Bm, Cm = f(B, L, H, P), f(B, L, G, N) * 0.5, f(B, L, G, N) * 0.5
    dt = np.log1p(np.exp(f(B, L, H))).astype(np.float32)
    A = -np.exp(f(H)).astype(np.float32)
    return x, dt, A, Bm, Cm, f(H), f(B, H, P, N) * 0.3


@pytest.mark.parametrize("L,chunk,G", [(13, 4, 1), (8, 8, 1), (9, 4, 2)])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunked_matches_jax(L, chunk, G, init):
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(L, L=L, G=G)
    h0 = h0 if init else None
    jy, jh = jm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm, D)), chunk=chunk,
                            init_state=None if h0 is None else jnp.asarray(h0))
    ty, th = tm.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm, D)), chunk=chunk,
                            init_state=None if h0 is None else _t(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    # The sequential recurrence agrees with the chunked scan.
    ny, nh = tm.ssd_naive(*map(_t, (x, dt, A, Bm, Cm, D)), init_state=None if h0 is None else _t(h0))
    np.testing.assert_allclose(ny.numpy(), ty.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(nh.numpy(), th.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_step_t_and_lanes_match_jax(G):
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(7, L=1, G=G)
    B, H, P = x.shape[0], x.shape[2], x.shape[3]
    st = jm.state_to_lanes(jnp.asarray(h0))
    np.testing.assert_array_equal(tm.state_to_lanes(_t(h0)).numpy(), np.asarray(st))
    np.testing.assert_array_equal(tm.state_from_lanes(tm.state_to_lanes(_t(h0)), H).numpy(), h0)
    xs = x[:, 0].reshape(B, H * P)
    jy, jst = jm.ssd_step_t(st, jnp.asarray(xs), jnp.asarray(dt[:, 0]), jnp.asarray(A),
                            jnp.asarray(Bm[:, 0]), jnp.asarray(Cm[:, 0]), jnp.asarray(D), H)
    ty, tst = tm.ssd_step_t(tm.state_to_lanes(_t(h0)), _t(xs), _t(dt[:, 0]), _t(A),
                            _t(Bm[:, 0]), _t(Cm[:, 0]), _t(D), H)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **TOL)
    # The canonical step is the same step.
    cy, ch = tm.ssd_step(_t(h0), _t(x[:, 0]), _t(dt[:, 0]), _t(A), _t(Bm[:, 0]), _t(Cm[:, 0]),
                         _t(D))
    np.testing.assert_allclose(cy.reshape(B, H * P).numpy(), ty.numpy(), **TOL)
    np.testing.assert_allclose(tm.state_to_lanes(ch).numpy(), tst.numpy(), **TOL)


def _step_inputs(seed, B=3, H=8, P=16, N=16):
    """Per-head inputs for the port and their lane expansions for Pallas."""
    f = _rng(seed)
    HP = H * P
    dt = np.log1p(np.exp(f(B, H))).astype(np.float32)
    A = -np.exp(f(H)).astype(np.float32)
    port = dict(xs=f(B, HP), dt=dt, decay=np.exp(dt * A[None]).astype(np.float32),
                bm=f(B, N) * 0.5, cm=f(B, N) * 0.5, z=f(B, HP), d_skip=f(H),
                norm_w=(f(HP) * 0.1 + 1.0).astype(np.float32))
    lanes = lambda a: np.repeat(a, P, axis=-1)  # noqa: E731
    pallas = (port["xs"][:, None], lanes(port["dt"])[:, None], lanes(port["decay"])[:, None],
              port["bm"][:, :, None], port["cm"][:, :, None], port["z"][:, None],
              lanes(port["d_skip"])[None], port["norm_w"][None])
    return port, [jnp.asarray(a) for a in pallas], f(B, N, HP)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_ssd_gate_step_plain_matches_pallas(state_dtype):
    """Row 9: ``ssd_gate_step`` on one state against ``ssd_gate_step_pallas``."""
    port, pallas, state = _step_inputs(11)
    jstate = jnp.asarray(state).astype(state_dtype)
    jy, jns = ssd_gate_step_pallas(jstate, *pallas, eps=1e-5, interpret=True)
    tstate = _t(jstate.astype(jnp.float32)).to(getattr(torch, state_dtype))
    before = dict(build.LAUNCHES)
    ty = ssd_gate_step(tstate, **{k: _t(v) for k, v in port.items()})
    assert build.LAUNCHES == before  # the CPU path launches nothing
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy)[:, 0], **TOL)
    got = tstate.float().numpy()
    want = np.asarray(jns.astype(jnp.float32))
    if state_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        _assert_within_one_bf16_step(got, want)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", [0, 2])
def test_ssd_gate_step_layered_plain_matches_pallas(state_dtype, layer):
    """Row 10: plane ``layer`` of a stacked ``[3, B, N, HP]`` state updated in
    place against ``ssd_gate_step_layered_pallas``; the other planes stay
    bit-identical."""
    port, pallas, _ = _step_inputs(12 + layer)
    states = _rng(20)(3, 3, 16, 128)
    jstates = jnp.asarray(states).astype(state_dtype)
    jy, jns = ssd_gate_step_layered_pallas(jstates, jnp.int32(layer), *pallas, eps=1e-5,
                                           interpret=True)
    tstates = _t(jstates.astype(jnp.float32)).to(getattr(torch, state_dtype))
    before = tstates.clone()
    ty = ssd_gate_step_layered(tstates, layer, **{k: _t(v) for k, v in port.items()})
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy)[:, 0], **TOL)
    got = tstates.float().numpy()
    want = np.asarray(jns.astype(jnp.float32))
    if state_dtype == "float32":
        np.testing.assert_allclose(got[layer], want[layer], rtol=1e-6, atol=1e-6)
    else:
        _assert_within_one_bf16_step(got[layer], want[layer])
    for other in set(range(3)) - {layer}:
        assert torch.equal(tstates[other], before[other])
        np.testing.assert_array_equal(got[other], want[other])


def test_fused_step_equals_the_unfused_chain_in_fp32():
    """In fp32 the fused step (``y`` kept fp32 through the norm) equals the
    unfused chain ``ssd_step_t`` -> ``y * silu(z)`` -> ``rms_norm``."""
    port, _, state = _step_inputs(13)
    t = {k: _t(v) for k, v in port.items()}
    H = t["dt"].shape[-1]
    A = torch.log(t["decay"][0]) / t["dt"][0]  # per-head A back from decay
    y, ns = tm.ssd_step_t(_t(state), t["xs"], t["dt"], A, t["bm"][:, None], t["cm"][:, None],
                          t["d_skip"], H)
    chain = rms_norm(y * torch.nn.functional.silu(t["z"]), t["norm_w"], 1e-5)
    st = _t(state).clone()
    fused = ssd_gate_step(st, **t)
    np.testing.assert_allclose(fused.numpy(), chain.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st.numpy(), ns.numpy(), rtol=1e-5, atol=1e-5)


def test_ssd_gate_step_rejects_inconsistent_inputs():
    port, _, state = _step_inputs(14)
    t = {k: _t(v) for k, v in port.items()}
    states = _t(state)[None].clone()
    with pytest.raises(ValueError):
        ssd_gate_step_layered(states, 1, **t)  # plane out of range
    with pytest.raises(ValueError):
        ssd_gate_step_layered(states, 0, **{**t, "bm": t["bm"][:, :8]})
    with pytest.raises(ValueError):
        ssd_gate_step_layered(states, 0, **{**t, "d_skip": t["d_skip"][:4]})
    with pytest.raises(ValueError):
        ssd_gate_step(states, **t)  # a stacked state where one plane is expected


def _folded_step(port, state, out_w, n, local_norm=False, eps=1e-5):
    """The step of ``n`` tensor-parallel ranks, each holding ``H / n`` heads
    (their state columns, gate and norm weight, and out_proj rows), through
    the norm fold: every rank's ``out_proj(g * w)`` and sum of ``g^2`` summed,
    then scaled by ``rsqrt(total / HP + eps)``. ``local_norm`` plants the
    trap instead: each rank normalises over its own heads."""
    H = port["dt"].shape[-1]
    HP = state.shape[-1]
    hl, cl = H // n, HP // n
    parts, sums, states = [], [], []
    for r in range(n):
        heads, cols = slice(r * hl, (r + 1) * hl), slice(r * cl, (r + 1) * cl)
        st = _t(state[None, :, :, cols])
        gw, ss = ssd_gate_step_partial_plain(
            st, 0, _t(port["xs"][:, cols]), _t(port["dt"][:, heads]),
            _t(port["decay"][:, heads]), _t(port["bm"]), _t(port["cm"]),
            _t(port["z"][:, cols]), _t(port["d_skip"][heads]), _t(port["norm_w"][cols]))
        part = gw @ _t(out_w[cols])
        if local_norm:
            part = part * torch.rsqrt(ss / cl + eps)[:, None]
        parts.append(part)
        sums.append(ss)
        states.append(st[0])
    out = sum(parts)
    if not local_norm:
        out = out * torch.rsqrt(sum(sums) / HP + eps)[:, None]
    return out.numpy(), torch.cat(states, dim=-1).numpy()


@pytest.mark.parametrize("n", [2, 4])
def test_partial_norm_fold_equals_pallas_step_and_out_proj(n):
    """The partial-norm mode's plain version on n slices of one layer's heads,
    combined by the fold (sum ``out_proj(g * w)`` and ``sum(g^2)``, then
    scale), equals JAX's ``ssd_gate_step_pallas`` (interpret mode) followed
    by out_proj within 1e-5; the rank slices' states are JAX's new state."""
    port, pallas, state = _step_inputs(31)
    out_w = _rng(32)(state.shape[-1], 24) / 8
    jy, jns = ssd_gate_step_pallas(jnp.asarray(state), *pallas, eps=1e-5, interpret=True)
    want = np.asarray(jy)[:, 0] @ out_w
    got, new_state = _folded_step(port, state, out_w, n)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(new_state, np.asarray(jns), rtol=1e-6, atol=1e-6)


def test_local_norm_fault_misses_pallas():
    """The trap the fold avoids: each rank normalising over its own heads
    misses JAX's step by more than 1e-2, so the test above can see it."""
    port, pallas, state = _step_inputs(31)
    out_w = _rng(32)(state.shape[-1], 24) / 8
    jy, _ = ssd_gate_step_pallas(jnp.asarray(state), *pallas, eps=1e-5, interpret=True)
    want = np.asarray(jy)[:, 0] @ out_w
    for n in (2, 4):
        got, _ = _folded_step(port, state, out_w, n, local_norm=True)
        assert np.abs(got - want).max() > 1e-2, n
