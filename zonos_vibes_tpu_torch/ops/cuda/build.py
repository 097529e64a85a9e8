"""Builds the port's CUDA kernels and binds them with ``ctypes``.

The sources under ``zonos_vibes_tpu_torch/csrc/`` have a plain C interface
(pointers, ints and the stream as ``void*``; each entry returns
``cudaGetLastError()``), so ``nvcc`` compiles them in seconds without
PyTorch's headers. :func:`load` compiles every source at first use, one
``nvcc`` per source started together, links them into one shared library
under ``build/zonos_vibes_tpu_torch/`` at the checkout root, and caches it by
a hash of the sources and flags. Nothing is built when the module is
imported: the CPU tests import every module of the package.

Every wrapper counts its launches in :data:`LAUNCHES` (one per call that
launches its kernel, and nowhere else), so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ...utils import tracing

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "zonos_vibes_tpu_torch"
SOURCES = ("decode_attention.cu", "stage_write.cu", "prefill_attention.cu", "qmm_int8.cu",
           "mamba_step.cu", "qmm_int4.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

LAUNCHES = {"decode_attention": 0, "decode_attention_q": 0, "stage_splice": 0,
            "prefill_attention": 0, "qmm_int8": 0, "decode_attention_pooled": 0,
            "decode_attention_pooled_q": 0, "stage_splice_rows": 0,
            "decode_attention_unstaged": 0, "decode_attention_pooled_unstaged": 0,
            "ssd_gate_step": 0, "qmm_int4": 0, "ssd_gate_step_partial": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "zvt_decode_attention": (_I,) * 3 + (_P,) * 14 + (_I,) * 13 + (_P,),
    "zvt_stage_splice": (_P, _P, _P, _I, _I, _I, _P),
    "zvt_stage_splice_rows": (_P, _P, _P, _I, _I, _I, _I, _P),
    "zvt_prefill_attention": (_P,) * 4 + (_I,) * 8 + (_P,),
    "zvt_qmm_int8": (_P,) * 6 + (_I,) * 6 + (_P,),
    "zvt_qmm_int8_decode": (_P,) * 4 + (_I,) * 8 + (_P,),
    "zvt_qmm_int8_tiles": (_I,) * 5,
    "zvt_qmm_int8_workspace": (_I,) * 5,
    "zvt_qmm_int4": (_P,) * 4 + (_I,) * 9 + (_P,),
    "zvt_ssd_gate_step": (_P, _I, _I) + (_P,) * 12 + (_I,) * 6 + (_F, _P),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def build(verbose: bool = False) -> tuple[Path, float]:
    """Compile and link the kernels if the cached library is missing or
    stale. Returns ``(library path, seconds spent building)``."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    lib_path = BUILD_DIR / f"libzvt_kernels-{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path, 0.0
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ("-Xptxas", "-v") if verbose else ()
    jobs = []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}-{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(CSRC / name), "-o", str(obj)]
        jobs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, failed = [], []
    for name, obj, proc in jobs:
        out, _ = proc.communicate()
        if verbose and out:
            print(out)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
        objs.append(str(obj))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib_path)
    return lib_path, time.perf_counter() - t0


@functools.cache
def load() -> ctypes.CDLL:
    """The built kernel library with every entry's argument types set: a
    ``kernel_build`` phase (``nvcc``, where the library is not built yet),
    then a ``kernel_load`` phase."""
    with tracing.phase("kernel_build"):
        path, _ = build()
    with tracing.phase("kernel_load"):
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_status(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Every tensor on one CUDA device, contiguous and 16-byte aligned."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not 16-byte aligned")
    return dev
