"""The port's data and tensor parallelism (``zonos_vibes_tpu_torch/parallel/``)
against the JAX package, on the CPU.

Ranks are spawned gloo processes (``torch_parallel_workers``), one spawn per
world size running every mesh of that size. The same numpy weights and
conditioning go through JAX's ``DecodeEngine`` (and its ``ParallelEngine``
or ``PipelineEngine`` on the same mesh over the spoofed CPU devices), the
port's ``DecodeEngine`` and the port's ``ParallelEngine`` on every rank: the
greedy codes must be equal, float (fp32 here) and quantized trees alike. The
runs: the tiny transformer float and int8 on every mesh; the tiny hybrid
(Mamba-2 + attention) float, int8 and grouped int4 on every mesh; the
transformer's grouped int4 and mixed (int4 MLP) trees under TP and PP 2.
The shards of float, int8 and int4 trees of both backbones are held leaf by
leaf against the full tree.
"""

import jax
import numpy as np
import pytest
import torch

from torch_parallel_jax import (jax_conditioning, jax_config, jax_hybrid_config, jax_tree,
                                random_params)
from torch_parallel_workers import (HYBRID_BACKBONE, QUANT, Ranks, generate_runs, tiny_config,
                                    tiny_hybrid_config)
from zonos_vibes_tpu.config import MeshConfig as JMeshConfig
from zonos_vibes_tpu.engine.generate import DecodeEngine as JDecodeEngine
from zonos_vibes_tpu.models.zonos import ZonosModel as JModel
from zonos_vibes_tpu.ops.quant import quantize_zonos_params as jquantize
from zonos_vibes_tpu.ops.sampling import SamplingParams as JSampling
from zonos_vibes_tpu.parallel.engine import ParallelEngine as JParallelEngine
from zonos_vibes_tpu.parallel.engine import PipelineEngine as JPipelineEngine
from zonos_vibes_tpu_torch.config import MeshConfig, ZONOS_V01_HYBRID
from zonos_vibes_tpu_torch.engine.generate import DecodeEngine
from zonos_vibes_tpu_torch.models.mamba_backbone import Mamba2Spec
from zonos_vibes_tpu_torch.models.zonos import ZonosModel
from zonos_vibes_tpu_torch.ops.quant import quantize_zonos_params
from zonos_vibes_tpu_torch.ops.sampling import SamplingParams
from zonos_vibes_tpu_torch.parallel import sharding
from zonos_vibes_tpu_torch.parallel.engine import ParallelEngine, PipelineEngine
from zonos_vibes_tpu_torch.utils.checkpoint import params_from_jax

HEADS, N_LAYER, MAX_NEW = (8, 4), 2, 6
PHONEMES = [[2, 10, 20, 30, 3]] * 4  # CFG batch 8: splits over data 2
# (data, model, pipe, expert) by world size; each mesh bf16 and int8 on the
# transformer, float, int8 and int4 on the hybrid.
MESHES = {2: [(2, 1, 1, 1), (1, 2, 1, 1)], 4: [(2, 2, 1, 1), (1, 4, 1, 1)]}
HYBRID_QUANTS = (None, "int8", "int4")
# The transformer's grouped int4 and mixed trees: TP 2 and PP 2 on two ranks,
# TP 4 on four. PP trees keep float heads: JAX's PipelineEngine places the
# heads as a float leaf (pp_zonos_param_specs), so quantized heads would
# leave it no reference.
INT4_MESHES = {2: [(1, 2, 1, 1), (1, 1, 2, 1)], 4: [(1, 4, 1, 1)]}
INT4_QUANTS = ("int4", "mixed")
HYBRID_SSM = HYBRID_BACKBONE["ssm_cfg"]


def _world_runs(world: int) -> list[dict]:
    runs = [dict(mesh=m, quant=q) for m in MESHES[world] for q in (None, "int8")]
    runs += [dict(mesh=m, hybrid=True, quant=q) for m in MESHES[world] for q in HYBRID_QUANTS]
    runs += [dict(mesh=m, quant=q, heads=m[2] == 1) for m in INT4_MESHES[world]
             for q in INT4_QUANTS]
    return [dict(run, max_new_tokens=MAX_NEW) for run in runs]


def _tree_key(run: dict) -> tuple:
    """(hybrid, weight mode, quantized heads): the tree a run decodes."""
    return run.get("hybrid", False), run.get("quant"), run.get("heads", True)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Weights and conditioning of both backbones; then the ranks start, one
    spawn per world size running every run of that size."""
    cfgs = {False: jax_config(N_LAYER, HEADS), True: jax_hybrid_config()}
    np_params = {h: random_params(cfg, 0) for h, cfg in cfgs.items()}
    cond = {h: jax_conditioning(cfgs[h], np_params[h], PHONEMES) for h in cfgs}
    spawned = {}
    for world in MESHES:
        runs = _world_runs(world)
        spawned[world] = runs, Ranks(generate_runs, world,
                                     (N_LAYER, HEADS, np_params[False], cond[False], runs,
                                      (np_params[True], cond[True])),
                                     tmp_path_factory.mktemp("pg"))
    return cfgs, np_params, cond, spawned


@pytest.fixture(scope="module")
def jax_codes(setup):
    """JAX's greedy codes: DecodeEngine on one device for every tree (float,
    ``quantize_zonos_params`` with the runs' arguments), and ParallelEngine
    (PipelineEngine for a pipe axis) on each run's mesh, except the
    transformer's int8 runs, held against the solo engines only."""
    cfgs, np_params, cond, _ = setup
    kw = dict(key=jax.random.key(7), max_new_tokens=MAX_NEW,
              sampling_params=JSampling(temperature=0.0))
    trees, out = {}, {}
    for run in _world_runs(2) + _world_runs(4):
        key = _tree_key(run)
        hybrid, quant, heads = key
        model = JModel(cfgs[hybrid])
        if key not in trees:
            params = jax_tree(np_params[hybrid])
            if quant is not None:
                params = jquantize(params, heads=heads, **QUANT[quant])
            trees[key] = params
            out["solo", key] = np.asarray(JDecodeEngine(model).generate(
                trees[key], cond[hybrid], **kw).codes)
        if hybrid or quant != "int8":
            mesh = JMeshConfig(*run["mesh"])
            eng = (JPipelineEngine(model, mesh, trees[key]) if mesh.pipe > 1
                   else JParallelEngine(model, mesh, trees[key]))
            out[key, run["mesh"]] = np.asarray(eng.generate(cond[hybrid], **kw).codes)
    return out


@pytest.fixture(scope="module")
def port_solo(setup):
    """The port's DecodeEngine on one process, on every run's tree."""
    _, np_params, cond, _ = setup
    models = {False: ZonosModel(tiny_config(N_LAYER, HEADS)),
              True: ZonosModel(tiny_hybrid_config())}
    out = {}
    for run in _world_runs(2) + _world_runs(4):
        key = _tree_key(run)
        if key in out:
            continue
        hybrid, quant, heads = key
        params = params_from_jax(np_params[hybrid])
        if quant is not None:
            params = quantize_zonos_params(params, heads=heads, **QUANT[quant])
        out[key] = DecodeEngine(models[hybrid]).generate(
            params, torch.from_numpy(cond[hybrid].copy()),
            generator=torch.Generator().manual_seed(7), max_new_tokens=MAX_NEW,
            sampling_params=SamplingParams(temperature=0.0)).codes.numpy()
    return out


@pytest.fixture(scope="module", params=sorted(MESHES), ids=lambda w: f"world{w}")
def ranks(request, setup, jax_codes, port_solo):
    runs, spawned = setup[3][request.param]
    return request.param, runs, spawned.results()


def _check_runs(ranks, jax_codes, port_solo, select) -> int:
    """Every selected run's codes on every rank against JAX's DecodeEngine,
    JAX's engine on the same mesh (where it ran) and the port's solo engine;
    returns how many runs were held."""
    world, runs, results = ranks
    held = 0
    for i, run in enumerate(runs):
        if not select(run):
            continue
        key = _tree_key(run)
        want = jax_codes["solo", key]
        if (key, run["mesh"]) in jax_codes:
            np.testing.assert_array_equal(jax_codes[key, run["mesh"]], want,
                                          err_msg=f"JAX's engine on {run['mesh']}, {key}")
        np.testing.assert_array_equal(port_solo[key], want, err_msg=f"port solo {key}")
        for rank, res in enumerate(results):
            np.testing.assert_array_equal(res["codes"][i], want,
                                          err_msg=f"mesh {run['mesh']} {key} rank {rank}")
        held += 1
    return held


def test_parallel_codes_equal_jax_and_solo(ranks, jax_codes, port_solo):
    """The transformer, float and int8 on every mesh: every rank's greedy
    codes equal JAX's DecodeEngine and the port's, and (float) JAX's
    ParallelEngine on the same mesh."""
    held = _check_runs(ranks, jax_codes, port_solo,
                       lambda r: not r.get("hybrid") and r["quant"] in (None, "int8"))
    assert held == 2 * len(MESHES[ranks[0]])


def test_hybrid_parallel_codes_equal_jax_and_solo(ranks, jax_codes, port_solo):
    """The hybrid (Mamba-2 + attention), float, int8 and grouped int4 (group
    32), on every mesh of the world size ((2, 1) and (1, 2); (2, 2) and (1,
    4)): every rank's greedy codes equal JAX's DecodeEngine, JAX's
    ParallelEngine on the same mesh (its tests/test_parallel.py runs the
    hybrid at (4, 2) and (1, 4)) and the port's DecodeEngine. Model 4 takes
    one of the 4 kv heads per rank."""
    held = _check_runs(ranks, jax_codes, port_solo, lambda r: r.get("hybrid", False))
    assert held == len(HYBRID_QUANTS) * len(MESHES[ranks[0]])


def test_int4_parallel_codes_equal_jax_and_solo(ranks, jax_codes, port_solo):
    """The transformer's grouped int4 and mixed (int4 MLP, int8 elsewhere)
    trees at group 32 under TP 2, TP 4 and PP 2: every rank's greedy codes
    equal JAX's DecodeEngine, JAX's ParallelEngine or PipelineEngine on the
    same mesh and the port's DecodeEngine."""
    held = _check_runs(ranks, jax_codes, port_solo,
                       lambda r: not r.get("hybrid") and r["quant"] in INT4_QUANTS)
    assert held == len(INT4_QUANTS) * len(INT4_MESHES[ranks[0]])


def test_mesh_coordinates(ranks):
    """``make_mesh`` places rank r at the row-major coordinates of r in the
    mesh shape, as JAX reshapes its device list."""
    world, runs, results = ranks
    for rank, res in enumerate(results):
        for mesh, coords in res["mesh"].items():
            assert coords == list(np.unravel_index(rank, mesh)), (mesh, rank)


def _tree(int8: bool, quant: str | None = None, hybrid: bool = False, **changes):
    model = ZonosModel(tiny_hybrid_config(**changes) if hybrid else tiny_config(N_LAYER, HEADS))
    params = model.init(torch.Generator().manual_seed(3), torch.bfloat16)
    quant = "int8" if int8 else quant
    return params if quant is None else quantize_zonos_params(params, **QUANT[quant])


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("n", [2, 4])
def test_tp_shards_cover_and_reassemble(int8, n):
    """Every projection and head leaf (an int8 leaf's weight and, for a
    column split, its scale) is sliced n ways; the rest is whole; the slices
    reassemble the tree exactly. Rank r's in_proj holds its q, k and v heads
    and its fc1 its slice of each half."""
    cfg = tiny_config(N_LAYER, HEADS).backbone
    full = _tree(int8)
    shards = [sharding.tp_slices(full, cfg, r, n) for r in range(n)]
    wkey = "weight_int8" if int8 else "weight"
    Hq, Hkv, Dh, F = cfg.num_heads, cfg.num_heads_kv, cfg.head_dim, cfg.attn_mlp_d_intermediate
    for r, s in enumerate(shards):
        lay, flay = s["backbone"]["layers"], full["backbone"]["layers"]
        assert lay["in_proj"][wkey].shape[-1] == (Hq + 2 * Hkv) * Dh // n
        assert lay["out_proj"][wkey].shape[-2] == Hq * Dh // n
        assert lay["fc1"][wkey].shape[-1] == 2 * F // n
        assert lay["fc2"][wkey].shape[-2] == F // n
        assert s["heads"][wkey].shape[-1] == full["heads"][wkey].shape[-1] // n
        if int8:  # a row split keeps the whole per-column scale
            assert torch.equal(lay["out_proj"]["scale"], flay["out_proj"]["scale"])
            assert lay["in_proj"]["scale"].shape[-1] == lay["in_proj"][wkey].shape[-1]
        for name in ("norm1", "norm2"):
            assert all(torch.equal(lay[name][k], flay[name][k]) for k in flay[name])
        assert s["embeddings"] is full["embeddings"]
        # Rank r's heads of each of q, k and v, by head.
        q, k, v = lay["in_proj"][wkey].split([Hq * Dh // n, Hkv * Dh // n, Hkv * Dh // n], -1)
        fq, fk, fv = flay["in_proj"][wkey].split([Hq * Dh, Hkv * Dh, Hkv * Dh], -1)
        for got, whole, h in ((q, fq, Hq // n), (k, fk, Hkv // n), (v, fv, Hkv // n)):
            assert torch.equal(got, whole[..., r * h * Dh: (r + 1) * h * Dh])
        y, g = lay["fc1"][wkey].chunk(2, -1)
        fy, fg = flay["fc1"][wkey].chunk(2, -1)
        f = F // n
        assert torch.equal(y, fy[..., r * f: (r + 1) * f])
        assert torch.equal(g, fg[..., r * f: (r + 1) * f])
    back = sharding.unshard_tp(shards, cfg)
    for path, a, b in _leaves(back, full):
        assert a.shape == b.shape and torch.equal(a, b), path


def _assert_reassembles(shards, full, cfg, group=32):
    back = sharding.unshard_tp(shards, cfg, int4_group=group)
    for path, a, b in _leaves(back, full):
        assert a.shape == b.shape and torch.equal(a, b), path


@pytest.mark.parametrize("quant", [None, "int8", "int4"], ids=["bf16", "int8", "int4"])
@pytest.mark.parametrize("n", [2, 4])
def test_hybrid_tp_shards_cover_and_reassemble(quant, n):
    """The hybrid's stacked-by-kind tree: rank r's Mamba in_proj holds its
    heads' z, x and dt columns and all of B | C (the same on every rank; an
    int4 slice padded with zero columns and scales to a multiple of 32),
    its conv its x channels and all of B | C, its dt_bias, A_log, D and norm
    weight its heads, its out_proj its heads' rows (int4: the scales of the
    groups they fall in: 2 groups of 32 rows at TP 2, 1 at TP 4; attention's
    64-row out_proj at TP 4: one 32-row group's scale for 16 rows); the
    slices reassemble the tree exactly."""
    cfg = tiny_hybrid_config().backbone
    full = _tree(False, quant, hybrid=True)
    shards = [sharding.tp_slices(full, cfg, r, n) for r in range(n)]
    s = Mamba2Spec(cfg.d_model, cfg.ssm_cfg_dict)
    Di, N, dl, hl = s.d_inner, s.d_state, s.d_inner // n, s.nheads // n
    wkey = {None: "weight", "int8": "weight_int8", "int4": "weight_int4"}[quant]
    half = 2 if quant == "int4" else 1
    fm = full["backbone"]["mamba"]
    for r, shard in enumerate(shards):
        m = shard["backbone"]["mamba"]
        width = 2 * dl + 2 * N + hl
        padded = -(-width // 32) * 32 if quant == "int4" else width
        assert m["in_proj"][wkey].shape[-1] == padded // half
        bc = m["in_proj"][wkey][..., 2 * dl // half: (2 * dl + 2 * N) // half]
        assert torch.equal(bc, fm["in_proj"][wkey][..., 2 * Di // half: (2 * Di + 2 * N) // half])
        if quant == "int4":
            assert not m["in_proj"][wkey][..., width // 2:].any()
            assert not m["in_proj"]["scale"][..., width:].any()
        assert torch.equal(m["conv1d"]["weight"][..., dl:], fm["conv1d"]["weight"][..., Di:])
        for k in ("dt_bias", "A_log", "D"):
            assert torch.equal(m[k], fm[k][..., r * hl: (r + 1) * hl])
        assert m["ssm_norm"]["weight"].shape[-1] == dl
        assert m["out_proj"][wkey].shape[-2] == dl
        if quant == "int4":
            assert m["out_proj"]["scale"].shape[-3] == {2: 2, 4: 1}[n]
            a = shard["backbone"]["attn"]["out_proj"]
            assert a["weight_int4"].shape[-2] == 64 // n and a["scale"].shape[-3] == 1
            g = r * (64 // n) // 32
            assert torch.equal(a["scale"], full["backbone"]["attn"]["out_proj"]["scale"]
                               [..., g: g + 1, :, :])
    _assert_reassembles(shards, full, cfg)


@pytest.mark.parametrize("quant", ["int4", "mixed"])
@pytest.mark.parametrize("n", [2, 4])
def test_int4_tp_shards_cover_and_reassemble(quant, n):
    """The transformer's grouped int4 and mixed trees (group 32): column
    slices keep byte pairs, row slices take their groups' scales (out_proj's
    64 rows at TP 4: 16 rows under one group's scale), and the slices
    reassemble the tree exactly."""
    cfg = tiny_config(N_LAYER, HEADS).backbone
    full = _tree(False, quant)
    shards = [sharding.tp_slices(full, cfg, r, n) for r in range(n)]
    for shard in shards:
        lay = shard["backbone"]["layers"]
        assert lay["fc2"]["weight_int4"].shape[-2] == 128 // n
        assert lay["fc2"]["scale"].shape[-3] == 4 // n
        assert lay["fc1"]["weight_int4"].shape[-1] == 256 // n // 2
    _assert_reassembles(shards, full, cfg)


@pytest.mark.parametrize("case", ["group_ratio", "odd_span"])
def test_int4_splits_refuse_what_they_cannot_split(case):
    """A rank's int4 contraction rows that neither divide nor are divided by
    the group (JAX's tiny hybrid's 96-row fc2 at group 32 over TP 2: 48
    rows), and a column span that would split a packed byte pair (a Mamba
    mixer of 4 heads over TP 4: one dt column per rank), raise."""
    if case == "group_ratio":
        changes, n = {"attn_mlp_d_intermediate": 96}, 2
    else:
        changes, n = {"ssm_cfg": {**HYBRID_SSM, "headdim": 32}}, 4
    cfg = tiny_hybrid_config(**changes).backbone
    full = _tree(False, "int4", hybrid=True, **changes)
    with pytest.raises(ValueError, match="neither divides" if case == "group_ratio" else "even"):
        sharding.tp_slices(full, cfg, 0, n)


def _leaves(a, b, path=()):
    if isinstance(b, torch.Tensor):
        yield path, a, b
        return
    assert set(a) == set(b), path
    for k in b:
        yield from _leaves(a[k], b[k], path + (k,))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_pp_shards_cover_and_reassemble(int8):
    full = _tree(int8)
    shards = [sharding.pp_slices(full, r, 2) for r in range(2)]
    for name, leaf in full["backbone"]["layers"].items():
        for k, t in leaf.items():
            parts = [s["backbone"]["layers"][name][k] for s in shards]
            assert all(p.shape[0] == t.shape[0] // 2 for p in parts)
            assert torch.equal(torch.cat(parts), t)
    assert shards[1]["heads"] is full["heads"]


def test_local_cache_shapes():
    cfg = tiny_config(N_LAYER, HEADS).backbone
    cache = sharding.allocate_local_cache(cfg, 4, 40, torch.float32, "cpu", model=4, layers=1)
    assert cache["k"].shape == (1, 4, 40, HEADS[1] // 4 * cfg.head_dim)
    assert cache["k_stage"].shape == (1, 4, 40, HEADS[1] // 4 * cfg.head_dim)


@pytest.mark.parametrize("case", ["kv_int8"])
def test_unported_trees_raise_naming_the_roadmap(case):
    """An int8 KV cache under the parallel layer refuses, naming its reason
    (JAX's parallel engines never pass ``kv_int8``) and the ROADMAP's list
    of what is not ported on purpose; nothing runs on another path."""
    model = ZonosModel(tiny_config(N_LAYER, HEADS))
    params = model.init(torch.Generator().manual_seed(0), torch.float32)
    with pytest.raises(NotImplementedError,
                       match="never pass kv_int8 .*ROADMAP.md queue 1, not ported on purpose"):
        ParallelEngine(model, MeshConfig(), params, kv_int8=True, device="cpu")


@pytest.mark.parametrize("case", ["hybrid_pipe", "sp_hybrid", "sp_int4", "hybrid_model8"])
def test_left_out_cases_raise_naming_their_reason(case):
    """What stays out of the parallel layer raises ``ValueError`` before any
    process group is touched: the hybrid under a pipe axis (JAX asserts it),
    the sequence-parallel prefill on the hybrid or on an int4 tree (JAX
    refuses both), and a model axis that does not divide the flagship
    hybrid's 4 kv heads."""
    if case in ("sp_int4",):
        model = ZonosModel(tiny_config(N_LAYER, HEADS))
        params = quantize_zonos_params(model.init(torch.Generator().manual_seed(0),
                                                  torch.float32), bits=4, int4_group=32)
    else:
        model = ZonosModel(tiny_hybrid_config() if case != "hybrid_model8" else ZONOS_V01_HYBRID)
        params = {"backbone": {}}
    if case == "hybrid_pipe":
        with pytest.raises(ValueError, match="pp_backbone.py:136"):
            PipelineEngine(model, MeshConfig(pipe=2), params, device="cpu")
    elif case == "hybrid_model8":
        with pytest.raises(ValueError, match="4 kv heads do not split over a model axis of 8"):
            ParallelEngine(model, MeshConfig(model=8), params, device="cpu")
    else:
        with pytest.raises(ValueError, match="sp_prefill"):
            ParallelEngine(model, MeshConfig(model=2), params, sp_prefill="ring", device="cpu")
