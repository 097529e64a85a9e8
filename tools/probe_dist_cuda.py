#!/usr/bin/env python3
"""Probes what ``torch.distributed`` offers the port on one NVIDIA GPU.

    python3 tools/probe_dist_cuda.py [--timeout-s 60]

Two gloo ranks (spawned processes, a ``FileStore`` in a temporary
directory, one pair per collective, all pairs at once) share ``cuda:0`` and
run one collective each on CUDA tensors: whether it completes with the right
values, raises, or kills the process. Its result decides
``parallel/comm.py``'s staging: on the card's torch 2.11 gloo took CUDA
tensors for every collective but ``send``/``recv``, which abort the
process, so ``comm.py`` stages point-to-point transfers, and only those,
through host buffers. Then a 4-axis ``DeviceMesh`` (``init_device_mesh``)
is built over two gloo ranks on the one card, and ``torch.mm(...,
out_dtype=torch.float32)`` on bf16 inputs is checked against the fp32
product (the row-parallel partials). Prints one line per probe and a JSON
line.
"""

from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing as mp
import os
import sys
import tempfile

OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor", "all_to_all_single",
       "send_recv", "barrier")


def _gloo(rank: int, world: int, store_path: str, timeout_s: float):
    import torch.distributed as dist

    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def _collective(op: str, rank: int, store_path: str, timeout_s: float, out) -> None:
    """One gloo rank on cuda:0 running ``op`` on CUDA tensors."""
    try:
        import torch
        import torch.distributed as dist

        torch.cuda.set_device(0)
        _gloo(rank, 2, store_path, timeout_s)
        x = torch.arange(4, dtype=torch.float32, device="cuda") + 10 * rank
        if op == "all_reduce":
            dist.all_reduce(x)
            ok = x.tolist() == [10.0, 12.0, 14.0, 16.0]
        elif op == "broadcast":
            dist.broadcast(x, src=1)
            ok = x.tolist() == [10.0, 11.0, 12.0, 13.0]
        elif op == "all_gather":
            parts = [torch.empty_like(x) for _ in range(2)]
            dist.all_gather(parts, x)
            ok = torch.cat(parts).tolist() == [0, 1, 2, 3, 10, 11, 12, 13]
        elif op == "all_gather_into_tensor":
            y = torch.empty(8, device="cuda")
            dist.all_gather_into_tensor(y, x)
            ok = y.tolist() == [0, 1, 2, 3, 10, 11, 12, 13]
        elif op == "all_to_all_single":
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            want = [0, 1, 10, 11] if rank == 0 else [2, 3, 12, 13]
            ok = y.tolist() == want
        elif op == "send_recv":
            if rank == 0:
                dist.send(x, dst=1)
                ok = True
            else:
                y = torch.empty_like(x)
                dist.recv(y, src=0)
                ok = y.tolist() == [0.0, 1.0, 2.0, 3.0]
        else:
            dist.barrier()
            ok = True
        torch.cuda.synchronize()
        out.put((op, rank, "ok" if ok else "wrong values"))
        dist.destroy_process_group()
    except Exception as e:  # noqa: BLE001 (a probe reports every failure)
        out.put((op, rank, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"))


def _mesh(rank: int, store_path: str, timeout_s: float, out) -> None:
    """A ``(data, model, pipe, expert) = (1, 2, 1, 1)`` mesh over two gloo ranks
    on one card, and an all-reduce over its model group."""
    try:
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        torch.cuda.set_device(0)
        _gloo(rank, 2, store_path, timeout_s)
        mesh = init_device_mesh("cuda", (1, 2, 1, 1),
                                mesh_dim_names=("data", "model", "pipe", "expert"))
        x = torch.ones(2, device="cuda")
        dist.all_reduce(x, group=mesh.get_group("model"))
        ok = x.tolist() == [2.0, 2.0] and mesh.get_local_rank("model") == rank
        out.put(("device_mesh", rank, "ok" if ok else "wrong values"))
        dist.destroy_process_group()
    except Exception as e:  # noqa: BLE001
        out.put(("device_mesh", rank, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeout-s", type=float, default=60.0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_dist_cuda: no CUDA device", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    result = {}
    a = torch.randn(2, 2048, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(2048, 1024, device="cuda", dtype=torch.bfloat16)
    try:
        got = torch.mm(a, w, out_dtype=torch.float32)
        err = (got - a.float() @ w.float()).abs().max().item()
        result["mm_out_dtype"] = f"ok, {got.dtype}, max |err| vs fp32 {err:.3e}"
    except Exception as e:  # noqa: BLE001
        result["mm_out_dtype"] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    print(f"mm out_dtype: {result['mm_out_dtype']}", flush=True)

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for op in OPS:
            for rank in range(2):
                procs.append(ctx.Process(target=_collective,
                                         args=(op, rank, os.path.join(tmp, op), args.timeout_s, q)))
        for rank in range(2):
            procs.append(ctx.Process(target=_mesh,
                                     args=(rank, os.path.join(tmp, "mesh"), args.timeout_s, q)))
        for p in procs:
            p.start()
        want = len(procs)
        got = {}
        import queue as _queue
        import time

        deadline = time.monotonic() + 3 * args.timeout_s
        while len(got) < want and time.monotonic() < deadline:
            try:
                op, rank, status = q.get(timeout=1.0)
                got[(op, rank)] = status
            except _queue.Empty:
                if not any(p.is_alive() for p in procs):
                    break
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        for p, key in zip(procs, [(op, r) for op in OPS for r in range(2)]
                          + [("device_mesh", 0), ("device_mesh", 1)]):
            status = got.get(key, f"no result (exit code {p.exitcode})")
            result[f"{key[0]}[{key[1]}]"] = status
            print(f"{key[0]} rank {key[1]}: {status}", flush=True)
    print(json.dumps({"probe_dist_cuda": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
