"""The port's data and tensor parallelism (``zonos_vibes_tpu_torch/parallel/``)
against the JAX package, on the CPU.

Ranks are spawned gloo processes (``torch_parallel_workers``), one spawn per
world size running every mesh of that size. The same numpy weights and
conditioning go through JAX's ``DecodeEngine`` (and, float, its
``ParallelEngine`` on the same mesh over the spoofed CPU devices), the
port's ``DecodeEngine`` and the port's ``ParallelEngine`` on every rank: the
greedy codes must be equal, float (fp32 here) and int8 trees alike. The
shards of a float and an int8 tree are held leaf by leaf against the full
tree.
"""

import jax
import numpy as np
import pytest
import torch

from torch_parallel_jax import jax_conditioning, jax_config, jax_tree, random_params
from torch_parallel_workers import Ranks, generate_runs, tiny_config
from zonos_vibes_tpu.config import MeshConfig as JMeshConfig
from zonos_vibes_tpu.engine.generate import DecodeEngine as JDecodeEngine
from zonos_vibes_tpu.models.zonos import ZonosModel as JModel
from zonos_vibes_tpu.ops.quant import quantize_zonos_params as jquantize
from zonos_vibes_tpu.ops.sampling import SamplingParams as JSampling
from zonos_vibes_tpu.parallel.engine import ParallelEngine as JParallelEngine
from zonos_vibes_tpu_torch.config import MeshConfig, ZONOS_V01_HYBRID
from zonos_vibes_tpu_torch.engine.generate import DecodeEngine
from zonos_vibes_tpu_torch.models.zonos import ZonosModel
from zonos_vibes_tpu_torch.ops.quant import quantize_zonos_params
from zonos_vibes_tpu_torch.ops.sampling import SamplingParams
from zonos_vibes_tpu_torch.parallel import sharding
from zonos_vibes_tpu_torch.parallel.engine import ParallelEngine
from zonos_vibes_tpu_torch.utils.checkpoint import params_from_jax

HEADS, N_LAYER, MAX_NEW = (8, 4), 2, 6
PHONEMES = [[2, 10, 20, 30, 3]] * 4  # CFG batch 8: splits over data 2
# (data, model, pipe, expert) by world size; each mesh bf16 and int8.
MESHES = {2: [(2, 1, 1, 1), (1, 2, 1, 1)], 4: [(2, 2, 1, 1), (1, 4, 1, 1)]}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Weights and conditioning; then the ranks start, one spawn per world
    size running every mesh of that size, float then int8."""
    cfg = jax_config(N_LAYER, HEADS)
    np_params = random_params(cfg, 0)
    cond = jax_conditioning(cfg, np_params, PHONEMES)
    spawned = {}
    for world, meshes in MESHES.items():
        runs = [dict(mesh=m, int8=q, max_new_tokens=MAX_NEW)
                for m in meshes for q in (False, True)]
        spawned[world] = runs, Ranks(generate_runs, world,
                                     (N_LAYER, HEADS, np_params, cond, runs),
                                     tmp_path_factory.mktemp("pg"))
    return cfg, np_params, cond, spawned


@pytest.fixture(scope="module")
def jax_codes(setup):
    """JAX's greedy codes: DecodeEngine on one device, float and int8
    (``quantize_zonos_params(heads=True)``), and ParallelEngine on each mesh."""
    cfg, np_params, cond, _ = setup
    model = JModel(cfg)
    kw = dict(key=jax.random.key(7), max_new_tokens=MAX_NEW,
              sampling_params=JSampling(temperature=0.0))
    params = jax_tree(np_params)
    out = {("solo", False): np.asarray(JDecodeEngine(model).generate(params, cond, **kw).codes),
           ("solo", True): np.asarray(JDecodeEngine(model).generate(
               jquantize(params, heads=True), cond, **kw).codes)}
    for mesh in MESHES[2] + MESHES[4]:
        eng = JParallelEngine(model, JMeshConfig(*mesh), params)
        out[mesh] = np.asarray(eng.generate(cond, **kw).codes)
    return out


@pytest.fixture(scope="module")
def port_solo(setup):
    """The port's DecodeEngine on one process, float and int8."""
    _, np_params, cond, _ = setup
    model = ZonosModel(tiny_config(N_LAYER, HEADS))
    out = {}
    for int8 in (False, True):
        params = params_from_jax(np_params)
        if int8:
            params = quantize_zonos_params(params)
        out[int8] = DecodeEngine(model).generate(
            params, torch.from_numpy(cond.copy()), generator=torch.Generator().manual_seed(7),
            max_new_tokens=MAX_NEW, sampling_params=SamplingParams(temperature=0.0)).codes.numpy()
    return out


@pytest.fixture(scope="module", params=sorted(MESHES), ids=lambda w: f"world{w}")
def ranks(request, setup, jax_codes, port_solo):
    runs, spawned = setup[3][request.param]
    return request.param, runs, spawned.results()


def test_parallel_codes_equal_jax_and_solo(ranks, jax_codes, port_solo):
    """Every rank's greedy codes equal JAX's DecodeEngine and the port's, and
    (float) JAX's ParallelEngine on the same mesh."""
    world, runs, results = ranks
    for i, run in enumerate(runs):
        int8 = run["int8"]
        want = jax_codes["solo", int8]
        if not int8:
            np.testing.assert_array_equal(jax_codes[run["mesh"]], want)
        np.testing.assert_array_equal(port_solo[int8], want)
        for rank, res in enumerate(results):
            np.testing.assert_array_equal(res["codes"][i], want,
                                          err_msg=f"mesh {run['mesh']} int8 {int8} rank {rank}")


def test_mesh_coordinates(ranks):
    """``make_mesh`` places rank r at the row-major coordinates of r in the
    mesh shape, as JAX reshapes its device list."""
    world, runs, results = ranks
    for rank, res in enumerate(results):
        for mesh, coords in res["mesh"].items():
            assert coords == list(np.unravel_index(rank, mesh)), (mesh, rank)


def _tree(int8: bool):
    model = ZonosModel(tiny_config(N_LAYER, HEADS))
    params = model.init(torch.Generator().manual_seed(3), torch.bfloat16)
    return quantize_zonos_params(params) if int8 else params


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


@pytest.mark.parametrize("case", ["hybrid", "int4", "kv_int8"])
def test_unported_trees_raise_naming_the_roadmap(case):
    """The hybrid, grouped int4 trees and an int8 KV cache under the parallel
    layer refuse, naming the ROADMAP item; nothing runs on another path."""
    if case == "hybrid":
        model = ZonosModel(ZONOS_V01_HYBRID)
        params = {"backbone": {"layers": {}}}
    else:
        model = ZonosModel(tiny_config(N_LAYER, HEADS))
        params = model.init(torch.Generator().manual_seed(0), torch.float32)
        if case == "int4":
            params = quantize_zonos_params(params, bits=4)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 7"):
        ParallelEngine(model, MeshConfig(), params, kv_int8=case == "kv_int8", device="cpu")
