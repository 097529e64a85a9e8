"""The port's continuous-batching pool on the hybrid backbone against the JAX
package's ``engine/pool.py``, on tests/test_pool.py's tiny hybrid (3 layers,
attention at 1) with the same fp32 weights (``params_from_jax``).

Both sides run the same schedule of joins and 5-step segments, each ending
in a ring flush that later steps read. Greedy rows are deterministic, so
their codes must be equal; after every join and every segment the pool
state is compared too: the attention layer's cache rows and the Mamba
layers' conv and SSM states within 1e-5 (fp32), counters and delayed codes
exactly. The port's own contracts: a row's codes do not depend on its
neighbours, and a bf16-state pool row equals the bf16-state solo engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_parallel import TINY_HYBRID as JTINY_HYBRID
from tests.test_torch_hybrid import BB3, PC, _configs
from zonos_vibes_tpu.engine import pool as jpool
from zonos_vibes_tpu.models.zonos import ZonosModel as JModel
from zonos_vibes_tpu.ops.sampling import SamplingParams as JSampling
from zonos_vibes_tpu_torch import config as tcfg
from zonos_vibes_tpu_torch.engine import pool as tpool
from zonos_vibes_tpu_torch.engine.generate import DecodeEngine
from zonos_vibes_tpu_torch.models.zonos import ZonosModel
from zonos_vibes_tpu_torch.ops.sampling import SamplingParams
from zonos_vibes_tpu_torch.utils.checkpoint import params_from_jax

TTINY_HYBRID = tcfg.ZonosConfig(backbone=_configs(BB3)[1],
                                prefix_conditioner=tcfg.PrefixConditionerConfig.from_dict(PC))
PC_H = dict(slots=2, max_cond_len=16, max_new_tokens=24)
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


def _jax_state(pool) -> dict:
    """JAX's hybrid pool cache in the port's stacked layout, and the counters."""
    cache = pool["cache"]
    kv = cache["attn"]["1"]
    out = {n: np.moveaxis(np.asarray(kv[n]), -1, 1).reshape(4, -1, 32)[None]
           for n in ("k", "v")}
    out.update({n: np.stack([np.asarray(cache["solo"][i][n], np.float32) for i in ("0", "2")])
                for n in ("conv", "ssm")})
    return out


class Side:
    """One package's tiny hybrid and pool, driven by a shared schedule."""

    def __init__(self, jax_side: bool, params, state_bf16: bool = False):
        self.jax_side, self.state_bf16 = jax_side, state_bf16
        if jax_side:
            self.model, self.params = JModel(JTINY_HYBRID), params
            self.pool = jpool.make_pool(self.model, jpool.PoolConfig(**PC_H), jnp.float32,
                                        state_bf16=state_bf16)
        else:
            self.model, self.params = ZonosModel(TTINY_HYBRID), params
            self.pool = tpool.make_pool(self.model, tpool.PoolConfig(**PC_H), torch.float32,
                                        state_bf16=state_bf16, device="cpu")

    def join(self, j: Join):
        tokens = PHONEMES[j.cond]
        if self.jax_side:
            cond = self.model.prepare_conditioning(self.params, {"espeak": jnp.asarray([tokens])})
            req, knobs = jpool.prefill_request(self.model, self.params, cond,
                                               jax.random.key(j.seed), j.mnt, j.cfg,
                                               JSampling(**GREEDY), state_bf16=self.state_bf16)
            self.pool = jpool.join(self.pool, req, j.slot, cond.shape[1], j.seed, knobs)
        else:
            cond = self.model.prepare_conditioning(self.params, {"espeak": torch.tensor([tokens])})
            req, knobs = tpool.prefill_request(self.model, self.params, cond,
                                               torch.Generator().manual_seed(j.seed), j.mnt,
                                               j.cfg, SamplingParams(**GREEDY),
                                               state_bf16=self.state_bf16)
            tpool.join(self.pool, req, j.slot, cond.shape[1], j.seed, knobs)

    def steps(self, n):
        if self.jax_side:
            self.pool = jpool.pool_steps_jit(self.model, self.params, self.pool,
                                             jax.random.key(BASE_SEED), n)
        else:
            tpool.pool_steps(self.model, self.params, self.pool, BASE_SEED, n)

    def finished(self, slot):
        return (jpool if self.jax_side else tpool).row_finished(self.pool, slot)

    def extract(self, slot):
        codes, valid = (jpool if self.jax_side else tpool).extract_row(self.model, self.pool, slot)
        return np.asarray(codes), valid

    def state(self):
        if self.jax_side:
            out = _jax_state(self.pool)
        else:
            c = self.pool["cache"]
            out = {n: c[n].float().numpy().copy() for n in ("k", "v", "conv", "ssm")}
        for n in ("pos", "step", "flush_base", "remaining", "stop_offset", "delayed", "active",
                  "stopping"):
            out[n] = np.array(self.pool[n], dtype=np.int64)
        return out


def _run(side: Side, schedule, slots_to_finish):
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
    np_params = jax.device_get(JModel(JTINY_HYBRID).init(jax.random.key(3), jnp.float32))
    return {"jax": jax.tree_util.tree_map(jnp.asarray, np_params),
            "port": params_from_jax(np_params)}


STAGGERED = (Join(0, "a", 14, seed=1), 3, Join(1, "b", 14, seed=2, cfg=3.5))


@pytest.fixture(scope="module")
def staggered(weights):
    """Row A (cfg 2) alone for 3 steps, then row B (cfg 3.5) joins; both run
    to the end on each side."""
    return {name: _run(Side(name == "jax", weights[name]), STAGGERED, (0, 1))
            for name in ("jax", "port")}


def _solo_codes(params, cond_name, mnt, cfg, state_bf16=False):
    model = ZonosModel(TTINY_HYBRID)
    cond = model.prepare_conditioning(params, {"espeak": torch.tensor([PHONEMES[cond_name]])})
    res = DecodeEngine(model, state_bf16=state_bf16).generate(
        params, cond, generator=torch.Generator().manual_seed(0), max_new_tokens=mnt,
        cfg_scale=cfg, sampling_params=SamplingParams(**GREEDY))
    return res.codes[0, :, :res.valid_length].numpy(), res.valid_length


def test_pool_state_matches_jax_after_each_join_and_flush(staggered):
    (jstates, _), (tstates, _) = staggered["jax"], staggered["port"]
    assert len(tstates) == len(jstates) >= 5
    for i, (js, ts) in enumerate(zip(jstates, tstates)):
        for n in ("pos", "step", "flush_base", "remaining", "stop_offset", "delayed", "active",
                  "stopping"):
            np.testing.assert_array_equal(ts[n], js[n], err_msg=f"{n} after op {i}")
        for n in ("k", "v", "conv", "ssm"):
            np.testing.assert_allclose(ts[n], js[n], **TOL, err_msg=f"{n} after op {i}")


@pytest.mark.parametrize("slot,cond,cfg", [(0, "a", 2.0), (1, "b", 3.5)])
def test_pooled_rows_equal_jax_pool_and_solo_engine(staggered, weights, slot, cond, cfg):
    jcodes, tcodes = staggered["jax"][1], staggered["port"][1]
    np.testing.assert_array_equal(tcodes[slot][0], jcodes[slot][0])
    solo, valid = _solo_codes(weights["port"], cond, 14, cfg)
    assert tcodes[slot][1] == jcodes[slot][1] == valid > 0
    np.testing.assert_array_equal(tcodes[slot][0], solo)


def test_row_isolation_under_a_staggered_join(weights):
    """Row A alone and with row B joining after 3 steps: equal codes."""
    a, b = Join(0, "a", 14, seed=1), Join(1, "c", 14, seed=2, cfg=3.5)
    _, alone = _run(Side(False, weights["port"]), (a, 3), (0,))
    _, shared = _run(Side(False, weights["port"]), (a, 3, b), (0, 1))
    np.testing.assert_array_equal(alone[0][0], shared[0][0])
    assert alone[0][1] == shared[0][1] > 0 and shared[1][1] > 0


def test_state_bf16_pool_equals_solo_state_bf16_engine(weights):
    """bf16 SSM-state storage: the pool's state really is bf16, and a pooled
    row's greedy codes equal the bf16-state solo engine's (both round the
    state at the same points)."""
    side = Side(False, weights["port"], state_bf16=True)
    assert side.pool["cache"]["ssm"].dtype == torch.bfloat16
    _, codes = _run(side, (Join(0, "c", 16, seed=7),), (0,))
    solo, valid = _solo_codes(weights["port"], "c", 16, 2.0, state_bf16=True)
    assert codes[0][1] == valid > 0
    np.testing.assert_array_equal(codes[0][0], solo)


def test_join_rejects_a_mismatched_state_dtype(weights):
    side = Side(False, weights["port"])
    model = side.model
    cond = model.prepare_conditioning(weights["port"], {"espeak": torch.tensor([PHONEMES["a"]])})
    req, knobs = tpool.prefill_request(model, weights["port"], cond, torch.Generator(), 8, 2.0,
                                       SamplingParams(**GREEDY), state_bf16=True)
    with pytest.raises(ValueError):
        tpool.join(side.pool, req, 0, cond.shape[1], 1, knobs)
    with pytest.raises(NotImplementedError):  # int8 KV on the hybrid, as in JAX
        tpool.make_pool(model, tpool.PoolConfig(**PC_H), torch.float32, kv_int8=True,
                        device="cpu")
