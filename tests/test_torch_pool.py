"""The port's continuous-batching pool against the JAX package's
``engine/pool.py``, on the tiny transformer with the same fp32 weights
(``params_from_jax``).

Both sides run the same schedule of joins and segments; segments are 5
steps long, so every one ends in a ring flush that later steps read.
Greedy rows are deterministic on both sides, so their codes must be equal;
the pool state after each join and each segment (cache rows within 1e-5 in
fp32, counters and delayed codes exactly) is compared too. Sampled rows draw
from different random streams (JAX keys against the port's counter-based
noise), so for them the port is held to its own contract: a row's codes do
not depend on its neighbours.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_generate import JTINY, TTINY, _weights
from zonos_vibes_tpu.engine import pool as jpool
from zonos_vibes_tpu.models.dac import DACConfig as JDACConfig
from zonos_vibes_tpu.models.dac import DACModel as JDACModel
from zonos_vibes_tpu.models.zonos import ZonosModel as JModel
from zonos_vibes_tpu.ops.quant import quantize_zonos_params as jquantize
from zonos_vibes_tpu.ops.sampling import SamplingParams as JSampling
from zonos_vibes_tpu_torch import config as tcfg
from zonos_vibes_tpu_torch.engine import pool as tpool
from zonos_vibes_tpu_torch.engine.generate import DecodeEngine
from zonos_vibes_tpu_torch.models.dac import DACConfig, DACModel
from zonos_vibes_tpu_torch.models.zonos import ZonosModel
from zonos_vibes_tpu_torch.ops.quant import quantize_zonos_params
from zonos_vibes_tpu_torch.ops.sampling import SamplingParams
from zonos_vibes_tpu_torch.utils.checkpoint import params_from_jax

PC = dict(slots=2, max_cond_len=16, max_new_tokens=24)
SEGMENT = 5
BASE_SEED = 42
PHONEMES = {"a": [2, 5, 6, 7, 3], "b": [2, 9, 8, 3], "c": [2, 10, 20, 30, 3]}
GREEDY = dict(temperature=0.0)
TOL = dict(rtol=1e-5, atol=1e-5)


@dataclasses.dataclass(frozen=True)
class Join:
    slot: int
    cond: str
    mnt: int
    seed: int
    cfg: float = 2.0
    sampling: tuple = tuple(GREEDY.items())
    prefix: bool = False


def _to_port_cache(x):
    """JAX time-minor ``[L, B, Hkv, Dh, T]`` (or scales ``[L, B, Hkv, T]``)
    -> the port's time-major ``[L, B, T, Hkv*Dh]`` (``[L, B, T, Hkv]``)."""
    x = np.asarray(x)
    if x.ndim == 4:
        return np.moveaxis(x, -1, -2)
    L, B, H, D, T = x.shape
    return np.moveaxis(x, -1, 2).reshape(L, B, T, H * D)


class Side:
    """One package's model, params and pool, driven by a shared schedule."""

    def __init__(self, jax_side: bool, params, kv_int8: bool):
        self.jax_side, self.kv_int8 = jax_side, kv_int8
        if jax_side:
            self.model, self.params = JModel(JTINY), params
            self.pool = jpool.make_pool(self.model, jpool.PoolConfig(**PC), jnp.float32,
                                        kv_int8=kv_int8)
        else:
            self.model, self.params = ZonosModel(TTINY), params
            self.pool = tpool.make_pool(self.model, tpool.PoolConfig(**PC), torch.float32,
                                        kv_int8=kv_int8, device="cpu")

    def cond(self, name):
        tokens = PHONEMES[name]
        if self.jax_side:
            return self.model.prepare_conditioning(self.params, {"espeak": jnp.asarray([tokens])})
        return self.model.prepare_conditioning(self.params, {"espeak": torch.tensor([tokens])})

    def join(self, j: Join):
        cond = self.cond(j.cond)
        K = self.model.config.num_codebooks
        prefix = np.random.default_rng(5).integers(0, 1024, (1, K, 4)) if j.prefix else None
        if self.jax_side:
            req, knobs = jpool.prefill_request(
                self.model, self.params, cond, jax.random.key(j.seed), j.mnt, j.cfg,
                JSampling(**dict(j.sampling)), kv_int8=self.kv_int8,
                audio_prefix_codes=None if prefix is None else jnp.asarray(prefix, jnp.int32))
            self.pool = jpool.join(self.pool, req, j.slot, cond.shape[1], j.seed, knobs)
        else:
            req, knobs = tpool.prefill_request(
                self.model, self.params, cond, torch.Generator().manual_seed(j.seed), j.mnt,
                j.cfg, SamplingParams(**dict(j.sampling)), kv_int8=self.kv_int8,
                audio_prefix_codes=None if prefix is None else torch.from_numpy(prefix))
            tpool.join(self.pool, req, j.slot, cond.shape[1], j.seed, knobs)

    def steps(self, n):
        if self.jax_side:
            self.pool = jpool.pool_steps_jit(self.model, self.params, self.pool,
                                             jax.random.key(BASE_SEED), n)
        else:
            tpool.pool_steps(self.model, self.params, self.pool, BASE_SEED, n)

    def finished(self, slot):
        lib = jpool if self.jax_side else tpool
        return lib.row_finished(self.pool, slot)

    def extract(self, slot):
        lib = jpool if self.jax_side else tpool
        codes, valid = lib.extract_row(self.model, self.pool, slot)
        return np.asarray(codes), valid

    def state(self):
        """Cache in the port's layout and the counters, as numpy."""
        cache = self.pool["cache"]
        names = ("k", "v") + (("k_scale", "v_scale") if self.kv_int8 else ())
        out = {n: (_to_port_cache(cache[n]) if self.jax_side else cache[n].numpy().copy())
               for n in names}
        for n in ("pos", "step", "flush_base", "remaining", "stop_offset", "delayed",
                  "active", "stopping"):
            out[n] = np.array(self.pool[n], dtype=np.int64)  # a copy: the port updates in place
        return out


def _run(side: Side, schedule, slots_to_finish):
    """Apply ``schedule`` (joins and step counts), then 5-step segments
    until every slot in ``slots_to_finish`` is finished. Returns the states
    after each operation and each finished slot's codes."""
    states = []
    for op in schedule:
        side.join(op) if isinstance(op, Join) else side.steps(op)
        states.append(side.state())
    for _ in range(40):
        if all(side.finished(s) for s in slots_to_finish):
            break
        side.steps(SEGMENT)
        states.append(side.state())
    assert all(side.finished(s) for s in slots_to_finish)
    return states, {s: side.extract(s) for s in slots_to_finish}


@pytest.fixture(scope="module")
def weights():
    np_params = _weights(False)
    return {"jax": jax.tree_util.tree_map(jnp.asarray, np_params),
            "port": params_from_jax(np_params), "np": np_params}


@pytest.fixture(scope="module")
def int8_weights(weights):
    return {"jax": jquantize(weights["jax"], heads=True),
            "port": quantize_zonos_params(params_from_jax(weights["np"]))}


STAGGERED = (Join(0, "a", 14, seed=1), 3, Join(1, "b", 14, seed=2, cfg=3.5))


@pytest.fixture(scope="module")
def staggered(weights):
    """Row A (cfg 2) alone for 3 steps, then row B (cfg 3.5) joins."""
    return {name: _run(Side(name == "jax", weights[name], False), STAGGERED, (0, 1))
            for name in ("jax", "port")}


@pytest.fixture(scope="module")
def staggered_int8(int8_weights):
    """The int8 serving configuration: int8 projections and heads, an int8
    KV pool, the staggered schedule."""
    return {name: _run(Side(name == "jax", int8_weights[name], True), STAGGERED, (0, 1))
            for name in ("jax", "port")}


def _solo_codes(params, cond_name, mnt, cfg, kv_int8=False, prefix=None):
    model = ZonosModel(TTINY)
    cond = model.prepare_conditioning(params, {"espeak": torch.tensor([PHONEMES[cond_name]])})
    res = DecodeEngine(model, kv_int8=kv_int8).generate(
        params, cond, prefix, generator=torch.Generator().manual_seed(0), max_new_tokens=mnt,
        cfg_scale=cfg, sampling_params=SamplingParams(**GREEDY))
    return res.codes[0, :, :res.valid_length].numpy(), res.valid_length


def _assert_states_equal(jstates, tstates, int8: bool):
    assert len(jstates) == len(tstates)
    for i, (js, ts) in enumerate(zip(jstates, tstates)):
        for n in ("pos", "step", "flush_base", "remaining", "stop_offset", "delayed", "active",
                  "stopping"):
            np.testing.assert_array_equal(ts[n], js[n], err_msg=f"{n} after op {i}")
        if int8:
            # Scales to 1e-5; int8 values may sit one step apart where the
            # two sides' fp32 columns round on either side of a half.
            for n in ("k_scale", "v_scale"):
                np.testing.assert_allclose(ts[n], js[n], **TOL, err_msg=f"{n} after op {i}")
            for n in ("k", "v"):
                assert np.abs(ts[n].astype(np.int32) - js[n].astype(np.int32)).max() <= 1
        else:
            for n in ("k", "v"):
                np.testing.assert_allclose(ts[n], js[n], **TOL, err_msg=f"{n} after op {i}")


def test_pool_state_matches_jax_after_each_join_and_flush(staggered):
    (jstates, _), (tstates, _) = staggered["jax"], staggered["port"]
    assert len(tstates) >= 5  # two joins, then segments across several flushes
    _assert_states_equal(jstates, tstates, int8=False)


def test_pooled_row_equals_jax_pool_and_solo_engine(staggered, weights):
    """Row A's codes equal JAX's pooled row and the port's solo engine."""
    jcodes, tcodes = staggered["jax"][1], staggered["port"][1]
    np.testing.assert_array_equal(tcodes[0][0], jcodes[0][0])
    assert tcodes[0][1] == jcodes[0][1] == 14
    solo, valid = _solo_codes(weights["port"], "a", 14, 2.0)
    assert valid == tcodes[0][1]
    np.testing.assert_array_equal(tcodes[0][0], solo)


def test_per_row_cfg_rows_equal_their_solo_engines(staggered, weights):
    """Rows at cfg 2.0 and 3.5 share each step; each equals its own solo
    engine and JAX's pool."""
    tcodes, jcodes = staggered["port"][1], staggered["jax"][1]
    np.testing.assert_array_equal(tcodes[1][0], jcodes[1][0])
    solo, valid = _solo_codes(weights["port"], "b", 14, 3.5)
    assert valid == tcodes[1][1]
    np.testing.assert_array_equal(tcodes[1][0], solo)


def test_top_k_row_runs_the_sort_stages(staggered, weights):
    """``pool_steps`` runs the sort-bearing stages while an active row sets
    ``top_k``, read from the rows' own knobs: a ``top_k = 1`` row at
    temperature 1 draws its argmax, so both rows of the staggered schedule
    equal its greedy run (without the top-k stage row A would sample)."""
    top1 = (("temperature", 1.0), ("top_k", 1))
    sched = (Join(0, "a", 14, seed=1, sampling=top1), 3, Join(1, "b", 14, seed=2, cfg=3.5))
    _, codes = _run(Side(False, weights["port"], False), sched, (0, 1))
    greedy = staggered["port"][1]
    for s in (0, 1):
        assert codes[s][1] == greedy[s][1] > 0
        np.testing.assert_array_equal(codes[s][0], greedy[s][0])


@pytest.mark.parametrize("sampling", [GREEDY, dict(min_p=0.1)])
def test_row_isolation_under_a_staggered_join(weights, sampling):
    """Row A's codes do not depend on what else shares the pool: alone, and
    with row B joining after 3 steps, they are equal (greedy, and sampled
    with the default min-p sampler, whose draws depend only on the row)."""
    samp = tuple(sampling.items())
    a = Join(0, "a", 14, seed=1, sampling=samp)
    b = Join(1, "b", 14, seed=2, cfg=3.5, sampling=samp)
    _, alone = _run(Side(False, weights["port"], False), (a, 3), (0,))
    _, shared = _run(Side(False, weights["port"], False), (a, 3, b), (0, 1))
    np.testing.assert_array_equal(alone[0][0], shared[0][0])
    assert alone[0][1] == shared[0][1] > 0 and shared[1][1] > 0


def test_slot_reuse(weights):
    """A finished slot, released and joined again with the same request,
    gives the same codes."""
    side = Side(False, weights["port"], False)
    out = []
    for _ in range(2):
        side.join(Join(0, "c", 8, seed=3))
        while not side.finished(0):
            side.steps(4)
        out.append(side.extract(0))
        tpool.release_row(side.pool, 0)
        assert not bool(side.pool["active"][0])
    assert out[0][1] == out[1][1] > 0
    np.testing.assert_array_equal(out[0][0], out[1][0])


def test_full_budget_row_across_flushes_equals_jax_and_solo(weights):
    """A row with the pool's whole budget (24 frames): its last step writes
    past the delayed buffer (nothing is written, as in JAX), and its 32
    steps cross six ring flushes."""
    sched = (Join(0, "c", 24, seed=7),)
    (jstates, jcodes) = _run(Side(True, weights["jax"], False), sched, (0,))
    (tstates, tcodes) = _run(Side(False, weights["port"], False), sched, (0,))
    _assert_states_equal(jstates, tstates, int8=False)
    np.testing.assert_array_equal(tcodes[0][0], jcodes[0][0])
    solo, valid = _solo_codes(weights["port"], "c", 24, 2.0)
    assert tcodes[0][1] == jcodes[0][1] == valid == 24
    np.testing.assert_array_equal(tcodes[0][0], solo)


def test_kv_int8_codes_equal_jax_across_flushes(staggered_int8):
    """int8 weights and heads with an int8 KV pool: greedy codes equal JAX's
    ``kv_int8`` pool for both staggered rows, across quantized flushes."""
    (jstates, jcodes), (tstates, tcodes) = staggered_int8["jax"], staggered_int8["port"]
    for s in (0, 1):
        assert tcodes[s][1] == jcodes[s][1] > 0
        np.testing.assert_array_equal(tcodes[s][0], jcodes[s][0])
    _assert_states_equal(jstates, tstates, int8=True)


def test_kv_int8_single_segment_row_equals_solo_kv_int8_engine(int8_weights):
    """A kv_int8 row that finishes inside one ring segment reads only the
    prefill's quantized prefix, as the solo kv_int8 engine does: equal
    codes."""
    side = Side(False, int8_weights["port"], True)
    side.join(Join(0, "c", 16, seed=7))
    side.steps(32)
    assert side.finished(0)
    codes, valid = side.extract(0)
    solo, solo_valid = _solo_codes(int8_weights["port"], "c", 16, 2.0, kv_int8=True)
    assert valid == solo_valid
    np.testing.assert_array_equal(codes, solo)


def test_audio_prefix_row_equals_jax_and_solo_engine(weights):
    sched = (Join(0, "c", 12, seed=7, prefix=True),)
    _, jcodes = _run(Side(True, weights["jax"], False), sched, (0,))
    _, tcodes = _run(Side(False, weights["port"], False), sched, (0,))
    np.testing.assert_array_equal(tcodes[0][0], jcodes[0][0])
    prefix = torch.from_numpy(np.random.default_rng(5).integers(0, 1024, (1, 9, 4)))
    solo, valid = _solo_codes(weights["port"], "c", 12, 2.0, prefix=prefix)
    assert tcodes[0][1] == jcodes[0][1] == valid
    np.testing.assert_array_equal(tcodes[0][0], solo)


def test_eos_cascade_bookkeeping_matches_jax():
    """Codebook 0 forced to EOS: both rows run the 9-step cascade and stop
    with JAX's stop offsets, remaining counts and valid lengths."""
    np_params = _weights(True)
    sched = (Join(0, "a", 20, seed=1), 2, Join(1, "b", 20, seed=2))
    jstates, jcodes = _run(Side(True, jax.tree_util.tree_map(jnp.asarray, np_params), False),
                           sched, (0, 1))
    tstates, tcodes = _run(Side(False, params_from_jax(np_params), False), sched, (0, 1))
    _assert_states_equal(jstates, tstates, int8=False)
    assert (tstates[-1]["stop_offset"] >= 0).all()
    for s in (0, 1):
        assert tcodes[s][1] == jcodes[s][1] < 20
        np.testing.assert_array_equal(tcodes[s][0], jcodes[s][0])


def test_pool_emit_matches_jax(staggered, weights):
    """``make_pool_emit`` on the tiny DAC: PCM and counters equal JAX's for
    the pool mid-flight (after B's join and one segment) and after the rows
    finish."""
    dac = dict(encoder_hidden_size=16, downsampling_ratios=(2, 4), decoder_hidden_size=64,
               n_codebooks=9, codebook_size=1024, codebook_dim=4)
    jdac = JDACModel(JDACConfig(**dac))
    dparams = jax.device_get(jdac.init(jax.random.key(0)))
    margin, win = 2, 16
    jemit = jax.jit(jpool.make_pool_emit(JModel(JTINY), jdac, margin, win))
    temit = tpool.make_pool_emit(ZonosModel(TTINY), DACModel(DACConfig(**dac)), margin, win)
    emitted = np.array([3, 0], np.int32)
    mnt_cap = np.array([14, 12], np.int32)
    for n_segments in (1, None):
        sides = [Side(True, weights["jax"], False), Side(False, weights["port"], False)]
        for side in sides:
            for op in STAGGERED:
                side.join(op) if isinstance(op, Join) else side.steps(op)
            for _ in range(n_segments or 40):
                side.steps(SEGMENT)
        want = jax.device_get(jemit(jax.tree_util.tree_map(jnp.asarray, dparams), sides[0].pool,
                                    jnp.asarray(emitted), jnp.asarray(mnt_cap)))
        got = temit(params_from_jax(dparams), sides[1].pool, torch.from_numpy(emitted).long(),
                    torch.from_numpy(mnt_cap).long())
        for key in ("active", "remaining", "valid", "new_emitted"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
        assert got["pcm"].dtype == torch.int16 and got["pcm"].shape == want["pcm"].shape
        # int16 truncation of fp32 samples summed in another order: 1 LSB.
        assert np.abs(got["pcm"].numpy().astype(np.int32)
                      - np.asarray(want["pcm"]).astype(np.int32)).max() <= 1
        assert np.abs(np.asarray(want["pcm"])).max() > 0
    assert bool(want["active"].all()) and (np.asarray(want["remaining"]) <= 0).all()


def test_hybrid_and_state_bf16_raise():
    """``state_bf16`` is hybrid-only (a transformer cache has no SSM state),
    and the hybrid pool refuses int8 KV, as in JAX; the hybrid pool itself
    runs (``tests/test_torch_hybrid_pool.py``)."""
    model = ZonosModel(TTINY)
    with pytest.raises(ValueError):
        tpool.make_pool(model, tpool.PoolConfig(**PC), torch.float32, state_bf16=True,
                        device="cpu")
    hybrid = dataclasses.replace(
        TTINY, backbone=dataclasses.replace(TTINY.backbone, ssm_cfg=tcfg._freeze({"d_state": 16})))
    with pytest.raises(NotImplementedError):
        tpool.make_pool(ZonosModel(hybrid), tpool.PoolConfig(**PC), torch.float32, kv_int8=True,
                        device="cpu")


def test_pool_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpool.make_pool(ZonosModel(TTINY), tpool.PoolConfig(**PC), torch.float32)


def test_segment_longer_than_the_ring_raises(weights):
    side = Side(False, weights["port"], False)
    with pytest.raises(ValueError):
        side.steps(side.pool["cache"]["k_stage"].shape[2] + 1)
