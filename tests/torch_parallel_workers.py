"""Rank processes for the parallel layer's CPU tests (``tests/test_torch_parallel.py``,
``test_torch_pp.py``, ``test_torch_sp.py``, ``test_torch_multihost.py``).

This module imports no JAX: a spawned rank re-imports the module its target
comes from, and the ranks run the port alone. :func:`run_ranks` starts
``world`` gloo ranks (one thread each, a ``FileStore`` under the test's
temporary directory, a collective timeout of 60 s), gathers each rank's
result and joins them under a deadline, killing them on expiry. The test
files compute the JAX side in their own process, while the ranks run, and
compare.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import pickle
import queue
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from zonos_vibes_tpu_torch import config as tcfg
from zonos_vibes_tpu_torch.config import MeshConfig

PG_TIMEOUT_S = 60.0
PC = {"projection": "linear",
      "conditioners": [{"type": "EspeakPhonemeConditioner", "name": "espeak"}]}


# JAX's tests/test_parallel.py TINY_HYBRID with two changes. Attention has
# 8/4 heads, not 4/2: JAX's GSPMD runs 2 kv heads at model 4, while the
# port's explicit split needs the model axis to divide the kv heads. The
# MLP is 128 wide, not 96: at group 32 a rank's 48 fc2 rows at TP 2 would
# neither divide nor be divided by the group (a split the port refuses).
HYBRID_BACKBONE = dict(
    d_model=64, n_layer=3, d_intermediate=0, attn_mlp_d_intermediate=128, attn_layer_idx=(1,),
    ssm_cfg={"layer": "Mamba2", "d_state": 16, "headdim": 16, "chunk_size": 8},
    attn_cfg={"num_heads": 8, "num_heads_kv": 4, "rotary_emb_dim": 4},
    rms_norm=True, residual_in_fp32=True)
# ops/quant.quantize_zonos_params arguments by name (JAX's take the same):
# int8; grouped int4 at JAX's test group of 32; and a mixed tree, int4 MLP
# and int8 elsewhere (the server's --int4-mlp, at group 32).
QUANT = {"int8": {}, "int4": {"bits": 4, "int4_group": 32},
         "mixed": {"bits": 8, "mlp_bits": 4, "int4_group": 32}}


def tiny_config(n_layer: int, heads: tuple[int, int]) -> tcfg.ZonosConfig:
    """The port's twin of the JAX tests' tiny fp32 configurations."""
    return tcfg.ZonosConfig(
        backbone=tcfg.BackboneConfig(
            d_model=64, n_layer=n_layer, attn_mlp_d_intermediate=128,
            attn_cfg=tcfg._freeze({"num_heads": heads[0], "num_heads_kv": heads[1]})),
        prefix_conditioner=tcfg.PrefixConditionerConfig.from_dict(PC))


def tiny_hybrid_config(**changes) -> tcfg.ZonosConfig:
    """The port's twin of :data:`HYBRID_BACKBONE` (with ``changes``)."""
    bb = {**HYBRID_BACKBONE, **changes}
    bb = {k: tcfg._freeze(v) if isinstance(v, dict) else v for k, v in bb.items()}
    return tcfg.ZonosConfig(backbone=tcfg.BackboneConfig(**bb),
                            prefix_conditioner=tcfg.PrefixConditionerConfig.from_dict(PC))


def _entry(target, rank: int, world: int, store_path: str, args_path: str, out) -> None:
    torch.set_num_threads(1)
    try:
        with open(args_path, "rb") as f:
            args = pickle.load(f)
        dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
        try:
            out.put((rank, "ok", target(rank, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 (the parent raises with this traceback)
        out.put((rank, "error", traceback.format_exc()))


class Ranks:
    """``target(rank, *args)`` started on ``world`` spawned gloo ranks;
    :meth:`results` collects them. Starting the ranks before the JAX side's
    compiles lets the two overlap."""

    def __init__(self, target, world: int, args: tuple, tmp_path):
        ctx = mp.get_context("spawn")
        self.world = world
        self.out = ctx.Queue()
        stem = tmp_path / f"ranks-{time.monotonic_ns()}"
        store, args_path = f"{stem}.store", f"{stem}.args"
        # The arguments go through a file: a spawned child reads its start-up
        # pipe only after importing the parent's main module, so arguments
        # larger than the pipe's buffer would hold up every start() that long.
        with open(args_path, "wb") as f:
            pickle.dump(args, f)
        self.procs = [ctx.Process(target=_entry,
                                  args=(target, r, world, store, args_path, self.out))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self, timeout_s: float = 240.0) -> list:
        """The ranks' results in rank order. Raises if a rank fails or the
        deadline passes; every rank is joined, and killed past the deadline."""
        results, errors = {}, []
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) + len(errors) < self.world and time.monotonic() < deadline:
                try:
                    rank, status, value = self.out.get(timeout=0.5)
                except queue.Empty:
                    if not any(p.is_alive() for p in self.procs) and self.out.empty():
                        break
                    continue
                if status == "ok":
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
        finally:
            for p in self.procs:
                p.join(timeout=max(0.0, deadline - time.monotonic())
                       if len(results) == self.world else 1.0)
                if p.is_alive():
                    p.kill()
                    p.join()
        if errors:
            raise AssertionError("\n".join(errors))
        if len(results) < self.world:
            raise AssertionError(f"ranks {sorted(set(range(self.world)) - set(results))} gave no "
                                 f"result within {timeout_s} s (exit codes "
                                 f"{[p.exitcode for p in self.procs]})")
        return [results[r] for r in range(self.world)]


def run_ranks(target, world: int, args: tuple, tmp_path, timeout_s: float = 240.0) -> list:
    """``target(rank, *args)`` on ``world`` spawned gloo ranks; their results
    in rank order (:class:`Ranks`)."""
    return Ranks(target, world, args, tmp_path).results(timeout_s)


def run_tasks(rank: int, tasks: list[tuple[str, tuple]]) -> list:
    """Several of this module's functions on one spawn of ranks, in order:
    ``(name, args)`` runs ``name(rank, *args)``; their results in order."""
    return [globals()[name](rank, *args) for name, args in tasks]


# -- generation --------------------------------------------------------------

def generate_runs(rank: int, n_layer: int, heads: tuple[int, int], np_params: dict,
                  np_cond: np.ndarray, runs: list[dict], hybrid: tuple | None = None) -> dict:
    """Each run's codes from ``ParallelEngine`` or ``PipelineEngine`` on this
    rank: ``mesh`` (data, model, pipe, expert), ``hybrid`` (the tiny hybrid
    of :func:`tiny_hybrid_config` on ``hybrid``'s ``(np_params, np_cond)``,
    else the transformer), ``quant`` (a :data:`QUANT` key: the weights
    through ``quantize_zonos_params`` with its arguments; ``heads`` False
    keeps float heads; None or absent, float), ``n_micro``,
    ``sp``/``sp_threshold``, ``prefix`` (audio prefix codes), ``max_new_tokens`` and ``sampling``
    (default greedy; generator seed 7). Returns ``codes`` per run,
    ``sp_calls`` (how often each run took the sequence-parallel prefill)
    and ``mesh``: this rank's coordinates in each mesh shape."""
    from zonos_vibes_tpu_torch.models.zonos import ZonosModel
    from zonos_vibes_tpu_torch.ops.quant import quantize_zonos_params
    from zonos_vibes_tpu_torch.ops.sampling import SamplingParams
    from zonos_vibes_tpu_torch.parallel import engine as peng
    from zonos_vibes_tpu_torch.utils.checkpoint import params_from_jax

    calls = []
    route = peng.sp_prefill_last

    def counted(*args, **kwargs):
        calls.append(1)
        return route(*args, **kwargs)

    peng.sp_prefill_last = counted
    models = {False: (ZonosModel(tiny_config(n_layer, heads)), params_from_jax(np_params),
                      torch.from_numpy(np_cond.copy()))}
    if hybrid is not None:
        models[True] = (ZonosModel(tiny_hybrid_config()), params_from_jax(hybrid[0]),
                        torch.from_numpy(hybrid[1].copy()))
    out = {"codes": [], "sp_calls": [], "mesh": {}}
    for run in runs:
        model, base, cond = models[run.get("hybrid", False)]
        quant = run.get("quant")
        params = base if quant is None else quantize_zonos_params(
            base, heads=run.get("heads", True), **QUANT[quant])
        mesh = MeshConfig(*run["mesh"])
        if mesh.pipe > 1:
            eng = peng.PipelineEngine(model, mesh, params, n_micro=run.get("n_micro", 1),
                                      device="cpu")
        else:
            eng = peng.ParallelEngine(model, mesh, params, sp_prefill=run.get("sp"),
                                      sp_threshold=run.get("sp_threshold", 512), device="cpu")
        out["mesh"][mesh.shape] = [eng.mesh.get_coordinate()[i] for i in range(4)]
        prefix = run.get("prefix")
        del calls[:]
        res = eng.generate(cond, None if prefix is None else torch.from_numpy(prefix.copy()),
                           generator=torch.Generator().manual_seed(7),
                           max_new_tokens=run["max_new_tokens"],
                           sampling_params=SamplingParams(**run.get("sampling",
                                                                    {"temperature": 0.0})))
        out["codes"].append(res.codes.numpy())
        out["sp_calls"].append(len(calls))
    return out


# -- sequence parallelism ----------------------------------------------------

def _mesh_comm(shape: tuple, axis: str):
    from zonos_vibes_tpu_torch.parallel.comm import Comm
    from zonos_vibes_tpu_torch.parallel.sharding import make_mesh

    mesh = make_mesh(MeshConfig(*shape), "cpu")
    return Comm(mesh.get_group(axis))


def sp_attention(rank: int, n: int, q: np.ndarray, k: np.ndarray, v: np.ndarray,
                 k_cache: np.ndarray, v_cache: np.ndarray, seq_end: int) -> dict:
    """Ring and Ulysses prefill attention and the time-sharded decode on the
    model axis of ``n`` ranks; returns this rank's chunks."""
    from zonos_vibes_tpu_torch.parallel.ring_attention import (
        ring_attention_prefill, sp_decode_attention, ulysses_prefill)

    comm = _mesh_comm((1, n, 1, 1), "model")
    S = q.shape[1] // n
    T = k_cache.shape[1] // n
    part = slice(rank * S, (rank + 1) * S)
    qt, kt, vt = (torch.from_numpy(x[:, part]) for x in (q, k, v))
    out = {"ring": ring_attention_prefill(qt, kt, vt, comm).numpy()}
    if k.shape[2] % n == 0:
        out["ulysses"] = ulysses_prefill(qt, kt, vt, comm).numpy()
    tpart = slice(rank * T, (rank + 1) * T)
    out["decode"] = sp_decode_attention(
        torch.from_numpy(q[:, :1]), torch.from_numpy(k_cache[:, tpart]),
        torch.from_numpy(v_cache[:, tpart]), seq_end, comm).numpy()
    return out


def sp_prefill(rank: int, n: int, method: str, n_layer: int, heads: tuple[int, int],
               np_backbone: dict, x: np.ndarray, T: int, tp_weights: bool) -> dict:
    """``sp_prefill_forward`` of this rank's chunk of ``x`` on the model axis of
    ``n`` ranks, over whole weights and a cache of every head, or (with
    ``tp_weights``) over this rank's tensor-parallel slices and a cache of its
    heads; returns the chunk's output and the cache."""
    from zonos_vibes_tpu_torch.models.backbone import allocate_kv_cache
    from zonos_vibes_tpu_torch.parallel.sharding import tp_slices
    from zonos_vibes_tpu_torch.parallel.sp_prefill import sp_prefill_forward
    from zonos_vibes_tpu_torch.utils.checkpoint import params_from_jax

    cfg = tiny_config(n_layer, heads).backbone
    comm = _mesh_comm((1, n, 1, 1), "model")
    params = params_from_jax(np_backbone)
    kv_heads = None
    if tp_weights:
        tree = tp_slices({"backbone": params, "heads": {"weight": torch.zeros(1, 64, 8)}}, cfg,
                         rank, n)
        params = tree["backbone"]
        kv_heads = heads[1] // n
    cache = allocate_kv_cache(cfg, x.shape[0], T, torch.float32, "cpu", kv_heads=kv_heads)
    S = x.shape[1] // n
    out = sp_prefill_forward(params, cfg, torch.from_numpy(x[:, rank * S: (rank + 1) * S]),
                             cache, comm, method, gather_weights=tp_weights)
    return {"out": out.numpy(), "k": cache["k"].numpy(), "v": cache["v"].numpy()}


# -- pipeline and expert runners ----------------------------------------------

def _stage_fn(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def _expert_fn(params, x):
    return x @ params["w"]


def pipeline_and_experts(rank: int, n: int, pipe_case: dict | None,
                         expert_cases: list[dict]) -> dict:
    """``pipeline_apply`` over ``n`` stages and ``expert_dispatch`` over ``n``
    experts; every rank returns the full outputs."""
    from zonos_vibes_tpu_torch.parallel.expert_parallel import expert_dispatch
    from zonos_vibes_tpu_torch.parallel.pipeline_parallel import pipeline_apply

    out = {}
    if pipe_case is not None:
        comm = _mesh_comm((1, 1, n, 1), "pipe")
        params = {k: torch.from_numpy(v[rank]) for k, v in pipe_case["params"].items()}
        out["pipeline"] = pipeline_apply(_stage_fn, params, torch.from_numpy(pipe_case["x"]),
                                         comm).numpy()
    if expert_cases:
        comm = _mesh_comm((1, 1, 1, n), "expert")
        out["experts"] = [
            expert_dispatch(_expert_fn, {"w": torch.from_numpy(c["w"][rank])},
                            torch.from_numpy(c["tokens"]), torch.from_numpy(c["router"]), comm,
                            capacity=c.get("capacity")).numpy()
            for c in expert_cases]
    return out


# -- heartbeat ------------------------------------------------------------------

def heartbeat(rank: int, sleeper: int, timeout_s: float) -> list[bool]:
    """Probes over every rank: one together (True), then one that rank
    ``sleeper`` joins only after twice the deadline (False elsewhere), then
    one together again once the late collective has completed (True)."""
    from zonos_vibes_tpu_torch.parallel.multihost import Heartbeat

    hb = Heartbeat(timeout_s=timeout_s)
    results = [hb.probe()]
    if rank == sleeper:
        time.sleep(2 * timeout_s)
        results.append(hb.probe())
    else:
        results.append(hb.probe())
        time.sleep(3 * timeout_s)  # the sleeper's late probe completes the wedged one
    dist.barrier()
    results.append(hb.probe())
    return results
