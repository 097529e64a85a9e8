"""The port's pipeline parallelism and expert dispatch
(``zonos_vibes_tpu_torch/parallel/``) against the JAX package, on the CPU.

Ranks are spawned gloo processes (``torch_parallel_workers``), one spawn per
world size. The real transformer staged over ``pipe`` (2 and 4 stages,
``n_micro`` 1, 2 and 4, composed with ``data``) gives JAX's
``PipelineEngine`` greedy codes and JAX's and the port's ``DecodeEngine``'s,
int8 weights the solo int8 codes, and sampled codes the port's solo engine's
for the same generator. The generic runners, ``pipeline_apply`` and
``expert_dispatch`` (capacity overflow, tokens not divisible by the axis),
match JAX's within 1e-5 (as ``tests/test_pp_ep.py`` holds JAX's to its
sequential references).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_jax import jax_conditioning, jax_config, jax_tree, random_params
from torch_parallel_workers import Ranks, run_tasks, tiny_config
from zonos_vibes_tpu.config import MeshConfig as JMeshConfig
from zonos_vibes_tpu.engine.generate import DecodeEngine as JDecodeEngine
from zonos_vibes_tpu.models.zonos import ZonosModel as JModel
from zonos_vibes_tpu.ops.quant import quantize_zonos_params as jquantize
from zonos_vibes_tpu.ops.sampling import SamplingParams as JSampling
from zonos_vibes_tpu.parallel.engine import PipelineEngine as JPipelineEngine
from zonos_vibes_tpu.parallel.expert_parallel import expert_dispatch as jexpert_dispatch
from zonos_vibes_tpu.parallel.pipeline_parallel import pipeline_apply as jpipeline_apply
from zonos_vibes_tpu.parallel.sharding import make_mesh as jmake_mesh
from zonos_vibes_tpu_torch.engine.generate import DecodeEngine
from zonos_vibes_tpu_torch.models.zonos import ZonosModel
from zonos_vibes_tpu_torch.ops.quant import quantize_zonos_params
from zonos_vibes_tpu_torch.ops.sampling import SamplingParams
from zonos_vibes_tpu_torch.utils.checkpoint import params_from_jax

HEADS, N_LAYER, MAX_NEW = (8, 4), 4, 6
PHONEMES = [[2, 10, 20, 30, 3]] * 4
SAMPLED = {"min_p": 0.1}
# (data, model, pipe, expert), n_micro, int8, sampling: by world size.
RUNS = {2: [((1, 1, 2, 1), 1, False, None), ((1, 1, 2, 1), 2, False, None),
            ((1, 1, 2, 1), 1, True, None), ((1, 1, 2, 1), 2, False, SAMPLED)],
        4: [((1, 1, 4, 1), 1, False, None), ((1, 1, 4, 1), 4, False, None),
            ((2, 1, 2, 1), 2, False, None)]}


def _pipe_case():
    rng = np.random.default_rng(0)
    n_stages, n_micro, B, D = 4, 6, 3, 8
    return {"params": {"w": rng.standard_normal((n_stages, D, D)).astype(np.float32) * 0.5,
                       "b": rng.standard_normal((n_stages, D)).astype(np.float32) * 0.1},
            "x": rng.standard_normal((n_micro, B, D)).astype(np.float32)}


def _expert_cases(n: int) -> list[dict]:
    """As tests/test_pp_ep.py: 4 experts with capacity T and with T = 22
    (uneven over the axis); 2 experts whose one overloaded expert drops half
    the tokens."""
    if n == 2:
        return [{"w": np.zeros((2, 4, 4), np.float32), "tokens": np.ones((8, 4), np.float32),
                 "router": np.tile(np.asarray([[10.0, 0.0]], np.float32), (8, 1)),
                 "capacity": 4}]
    rng = np.random.default_rng(1)
    cases = []
    for T, capacity in ((24, 24), (22, 88)):
        cases.append({"w": rng.standard_normal((4, 8, 8)).astype(np.float32) * 0.5,
                      "tokens": rng.standard_normal((T, 8)).astype(np.float32),
                      "router": rng.standard_normal((T, 4)).astype(np.float32),
                      "capacity": capacity})
    return cases


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = jax_config(N_LAYER, HEADS)
    np_params = random_params(cfg, 1)
    cond = jax_conditioning(cfg, np_params, PHONEMES)
    spawned = {}
    for world, runs in RUNS.items():
        gen = [dict(mesh=m, n_micro=k, quant="int8" if q else None, max_new_tokens=MAX_NEW,
                    **({"sampling": s} if s else {})) for m, k, q, s in runs]
        tasks = [("generate_runs", (N_LAYER, HEADS, np_params, cond, gen)),
                 ("pipeline_and_experts", (world, _pipe_case() if world == 4 else None,
                                           _expert_cases(world)))]
        spawned[world] = Ranks(run_tasks, world, (tasks,), tmp_path_factory.mktemp("pg"))
    return cfg, np_params, cond, spawned


@pytest.fixture(scope="module")
def refs(setup):
    """JAX: DecodeEngine (float, int8) and PipelineEngine per greedy run; the
    port's DecodeEngine, greedy and sampled."""
    cfg, np_params, cond, _ = setup
    model = JModel(cfg)
    kw = dict(key=jax.random.key(7), max_new_tokens=MAX_NEW,
              sampling_params=JSampling(temperature=0.0))
    params = jax_tree(np_params)
    out = {"jax_solo": np.asarray(JDecodeEngine(model).generate(params, cond, **kw).codes),
           "jax_int8": np.asarray(JDecodeEngine(model).generate(
               jquantize(params, heads=True), cond, **kw).codes)}
    for m, k, q, s in RUNS[2] + RUNS[4]:
        if not q and s is None:
            eng = JPipelineEngine(model, JMeshConfig(*m), params, n_micro=k)
            out["jax_pp", m, k] = np.asarray(eng.generate(cond, **kw).codes)
    tmodel = ZonosModel(tiny_config(N_LAYER, HEADS))
    tparams = params_from_jax(np_params)
    for key, sampling in (("port_solo", {"temperature": 0.0}), ("port_sampled", SAMPLED)):
        out[key] = DecodeEngine(tmodel).generate(
            tparams, torch.from_numpy(cond.copy()), generator=torch.Generator().manual_seed(7),
            max_new_tokens=MAX_NEW, sampling_params=SamplingParams(**sampling)).codes.numpy()
    out["port_int8"] = DecodeEngine(tmodel).generate(
        quantize_zonos_params(tparams), torch.from_numpy(cond.copy()),
        generator=torch.Generator().manual_seed(7), max_new_tokens=MAX_NEW,
        sampling_params=SamplingParams(temperature=0.0)).codes.numpy()
    # The generic runners, as tests/test_pp_ep.py runs them.
    case = _pipe_case()
    out["pipeline"] = np.asarray(jpipeline_apply(
        lambda p, x: jnp.tanh(x @ p["w"] + p["b"]), jax_tree(case["params"]),
        jnp.asarray(case["x"]), jmake_mesh(JMeshConfig(data=1, model=1, pipe=4)),
        axis_name="pipe"))
    for n in (2, 4):
        mesh = jmake_mesh(JMeshConfig(data=1, model=1, expert=n))
        out["experts", n] = [np.asarray(jexpert_dispatch(
            lambda p, x: x @ p["w"], {"w": jnp.asarray(c["w"])}, jnp.asarray(c["tokens"]),
            jnp.asarray(c["router"]), mesh, capacity=c["capacity"])) for c in _expert_cases(n)]
    return out


@pytest.fixture(scope="module", params=sorted(RUNS), ids=lambda w: f"world{w}")
def ranks(request, setup, refs):
    return request.param, setup[3][request.param].results()


def test_pp_codes_equal_jax_and_solo(ranks, refs):
    """Greedy: every rank's codes equal JAX's PipelineEngine on the mesh, JAX's
    and the port's DecodeEngine (int8: the solo int8 codes of both); sampled:
    the port's DecodeEngine with the same generator."""
    world, results = ranks
    np.testing.assert_array_equal(refs["port_solo"], refs["jax_solo"])
    np.testing.assert_array_equal(refs["port_int8"], refs["jax_int8"])
    for i, (m, k, q, s) in enumerate(RUNS[world]):
        if s is not None:
            want = refs["port_sampled"]
        elif q:
            want = refs["jax_int8"]
        else:
            want = refs["jax_solo"]
            np.testing.assert_array_equal(refs["jax_pp", m, k], want)
        for rank, res in enumerate(results):
            np.testing.assert_array_equal(res[0]["codes"][i], want,
                                          err_msg=f"mesh {m} n_micro {k} rank {rank}")


def test_generic_runners_match_jax(ranks, refs):
    """``pipeline_apply`` over 4 stages and ``expert_dispatch`` over 2 and 4
    experts give JAX's outputs on every rank within 1e-5; the overloaded
    expert drops the same tokens."""
    world, results = ranks
    for rank, res in enumerate(results):
        runners = res[1]
        if world == 4:
            np.testing.assert_allclose(runners["pipeline"], refs["pipeline"], rtol=1e-5,
                                       atol=1e-5)
        for got, want in zip(runners["experts"], refs["experts", world]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if world == 2:  # capacity 4 over 2 ranks: 2 slots each; 4 of 8 tokens pass through
        out = results[0][1]["experts"][0]
        assert (out.sum(-1) == 0).sum() == 4 and (out.sum(-1) == 4).sum() == 4
