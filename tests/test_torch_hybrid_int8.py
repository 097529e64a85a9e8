"""The quantized hybrid (Mamba-2 + attention) against the JAX package on the
CPU: ``quantize_zonos_params`` on the port's stacked-by-kind tree against
JAX's per-layer list, greedy codes of the int8 and int4-MLP hybrids, and the
int8 hybrid pool with a bf16 SSM state against JAX's pool.

tests/test_pool.py's tiny hybrid (3 layers, attention with an MLP at layer
1; Mamba in_proj 64 -> 296, out_proj 128 -> 64), fp32 weights carried by
``params_from_jax``. Quantized values and scales are bit-identical (module
docstring of tests/test_torch_quant_int4.py); the pool state is held at
tests/test_torch_hybrid_pool.py's limits, where a bf16-stored SSM state
may also round to the neighbouring bf16 step (its fp32 values are summed in
another order on each side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_hybrid_pool import (
    GREEDY,
    PHONEMES,
    STAGGERED,
    TOL,
    TTINY_HYBRID,
    Join,
    Side,
    _run,
)
from tests.test_parallel import TINY_HYBRID as JTINY_HYBRID
from tests.test_torch_quant_int4 import MODES, _assert_trees_equal
from zonos_vibes_tpu.engine import generate as jgen
from zonos_vibes_tpu.models.zonos import ZonosModel as JModel
from zonos_vibes_tpu.ops import quant as jquant
from zonos_vibes_tpu.ops.sampling import SamplingParams as JSampling
from zonos_vibes_tpu_torch.engine.generate import DecodeEngine
from zonos_vibes_tpu_torch.ops import quant
from zonos_vibes_tpu_torch.ops.sampling import SamplingParams
from zonos_vibes_tpu_torch.pipeline import ZonosPipeline
from zonos_vibes_tpu_torch.utils.checkpoint import params_from_jax


@pytest.fixture(scope="module")
def np_params():
    return jax.device_get(JModel(JTINY_HYBRID).init(jax.random.key(3), jnp.float32))


def _jax_quantized(np_params, **kw):
    return jquant.quantize_zonos_params(jax.tree_util.tree_map(jnp.asarray, np_params), **kw)


@pytest.mark.parametrize("mode", list(MODES))
def test_quantize_hybrid_matches_jax(np_params, mode):
    want = params_from_jax(jax.device_get(_jax_quantized(np_params, **MODES[mode])))
    got = quant.quantize_zonos_params(params_from_jax(np_params), **MODES[mode])
    _assert_trees_equal(got, want)
    bb = got["backbone"]
    inner = "weight_int4" if MODES[mode]["bits"] == 4 else "weight_int8"
    assert inner in bb["mamba"]["in_proj"] and inner in bb["attn"]["out_proj"]
    assert bb["mamba"]["A_log"].dtype == torch.float32  # the SSM's own tensors untouched
    if mode == "int4full":  # Mamba out_proj's 128 rows: ungrouped at 128, two groups at 64
        assert bb["mamba"]["out_proj"]["scale"].shape == (2, 1, 1, 64)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_hybrid_greedy_codes_equal_jax(np_params, mode):
    steps = 16
    jparams = _jax_quantized(np_params, **MODES[mode])
    jmodel = JModel(JTINY_HYBRID)
    tokens = [PHONEMES["c"]]
    jcond = jmodel.prepare_conditioning(jparams, {"espeak": jnp.asarray(tokens)})
    jres = jgen.DecodeEngine(jmodel).generate(
        jparams, jcond, key=jax.random.key(1), max_new_tokens=steps,
        sampling_params=JSampling(**GREEDY), disable_eos=True)
    pipe = ZonosPipeline.from_params(TTINY_HYBRID, params_from_jax(np_params), device="cpu")
    assert (pipe.quantize_int8() if mode == "int8" else pipe.quantize_int4()) is pipe
    cond = pipe.prepare_conditioning({"espeak": torch.tensor(tokens)})
    tres = DecodeEngine(pipe.model).generate(
        pipe.params, cond, generator=torch.Generator().manual_seed(1), max_new_tokens=steps,
        sampling_params=SamplingParams(**GREEDY), disable_eos=True)
    np.testing.assert_array_equal(tres.codes.numpy(), np.asarray(jres.codes))


def _assert_bf16_state_close(got, want, msg):
    """The bf16-stored SSM state: within TOL, except where the two sides'
    fp32 values (summed in another order) round to neighbouring bf16 steps.
    Such entries are rare, and at most two bf16 steps apart: a step of one
    rounding, carried by the recurrence into a later step that rounds the
    other way (on this schedule: at most 10 of 16384 entries, 2 steps)."""
    diff = np.abs(got - want)
    off = diff > TOL["atol"] + TOL["rtol"] * np.abs(want)
    top = np.maximum(np.abs(got), np.abs(want))
    step = 2.0 ** (np.floor(np.log2(np.maximum(top, 1e-30))) - 7)
    assert off.mean() <= 1e-3, (msg, int(off.sum()))
    assert (diff[off] <= 2 * step[off] * (1 + 1e-6)).all(), msg


def test_int8_hybrid_pool_with_bf16_state_matches_jax(np_params):
    """The int8 hybrid's pool with a bf16 SSM state, on both sides, through
    tests/test_torch_hybrid_pool.py's staggered schedule: counters and
    codes equal, the cache and conv state within its limits after every op,
    the bf16 SSM state too but for rare entries a bf16 step or two apart."""
    jparams = _jax_quantized(np_params)
    tparams = quant.quantize_zonos_params(params_from_jax(np_params))
    jstates, jcodes = _run(Side(True, jparams, state_bf16=True), STAGGERED, (0, 1))
    side = Side(False, tparams, state_bf16=True)
    assert side.pool["cache"]["ssm"].dtype == torch.bfloat16
    tstates, tcodes = _run(side, STAGGERED, (0, 1))
    assert len(tstates) == len(jstates) >= 5
    for i, (js, ts) in enumerate(zip(jstates, tstates)):
        for n in ("pos", "step", "flush_base", "remaining", "stop_offset", "delayed", "active",
                  "stopping"):
            np.testing.assert_array_equal(ts[n], js[n], err_msg=f"{n} after op {i}")
        for n in ("k", "v", "conv"):
            np.testing.assert_allclose(ts[n], js[n], **TOL, err_msg=f"{n} after op {i}")
        _assert_bf16_state_close(ts["ssm"], js["ssm"], f"ssm after op {i}")
    for slot in (0, 1):
        np.testing.assert_array_equal(tcodes[slot][0], jcodes[slot][0])
        assert tcodes[slot][1] == jcodes[slot][1] > 0


def test_int8_hybrid_pool_row_equals_its_solo_run(np_params):
    """A pooled row of the int8 hybrid equals the int8 solo engine's codes
    (bf16 state on both)."""
    tparams = quant.quantize_zonos_params(params_from_jax(np_params))
    _, codes = _run(Side(False, tparams, state_bf16=True), (Join(0, "c", 16, seed=7),), (0,))
    model = Side(False, tparams).model
    cond = model.prepare_conditioning(tparams, {"espeak": torch.tensor([PHONEMES["c"]])})
    res = DecodeEngine(model, state_bf16=True).generate(
        tparams, cond, generator=torch.Generator().manual_seed(0), max_new_tokens=16,
        sampling_params=SamplingParams(**GREEDY))
    assert codes[0][1] == res.valid_length > 0
    np.testing.assert_array_equal(codes[0][0], res.codes[0, :, :res.valid_length].numpy())
