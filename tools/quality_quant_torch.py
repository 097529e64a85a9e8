"""Quantization quality gate for the PyTorch port: the counterpart of
``tools/quality_quant.py`` (the JAX package's), with the same modes and
measures, on ``zonos_vibes_tpu_torch`` alone (no JAX).

For each mode against the unquantized model, random-init weights (seed 0;
no checkpoint is in the repository), on one teacher-forced context:

* the reference's greedy codes for ``steps`` frames (``disable_eos``), the
  delay pattern applied, fed as ONE prefill after the conditioning
  (``[2, ...]``: CFG, conditional and unconditional rows alike, as JAX's);
* at every audio position, the next-token distribution: heads, CFG 2.0, the
  masked vocabulary, softmax;
* margin-weighted top-8 overlap (``|top8(ref) & top8(quant)| / 8`` weighted
  by the reference's top-1 minus top-2 probability) and total-variation
  distance (mean, p95, max over codebooks and positions).

Mode grammar, as JAX's: ``int8`` | ``int4`` (MLP int4, the rest int8) |
``int4full`` (every backbone projection int4), with optional suffixes
``fc1`` (fc2 stays int8) / ``fc2`` (fc1 stays int8), ``g64`` / ``g32``
(scale-group rows, default 128), ``gptq`` (fc2 error compensation), ``awq``
(the fc2 fold against energies captured on the same context) and ``real``.
By default a mode quantizes ``fake`` (dequantized weights in the model's
dtype); ``real`` keeps the packed leaves, so the int4 projections run the
``qmm_int4`` kernel on the card (and the int8 ones ``qmm_int8``).

    python tools/quality_quant_torch.py [steps] [modes...] [--hybrid]
        [--device cuda|cpu] [--layers N]

Defaults: 86 steps, modes ``int8 int4``, the flagship transformer
(``--hybrid``: the flagship hybrid) on the card. ``--layers N`` cuts the
depth (for a quick run on the CPU, e.g. ``--device cpu --layers 2 16
int8``). Prints one JSON line per mode.
"""

from __future__ import annotations

import dataclasses
import json
import re
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from zonos_vibes_tpu_torch.config import ZONOS_V01_HYBRID, ZONOS_V01_TRANSFORMER  # noqa: E402
from zonos_vibes_tpu_torch.engine.generate import DecodeEngine  # noqa: E402
from zonos_vibes_tpu_torch.models.zonos import ZonosModel  # noqa: E402
from zonos_vibes_tpu_torch.ops.delay_pattern import apply_delay_pattern  # noqa: E402
from zonos_vibes_tpu_torch.ops.quant import quantize_zonos_params  # noqa: E402
from zonos_vibes_tpu_torch.ops.sampling import SamplingParams  # noqa: E402
from zonos_vibes_tpu_torch.utils.device import resolve_device  # noqa: E402

TOPK = 8
CFG_SCALE = 2.0
PHONEMES = [[2] + [40] * 58 + [3]]


def parse_mode(mode: str) -> tuple[dict, bool]:
    """A mode name -> (``quantize_zonos_params`` keywords without the AWQ
    energies, whether it folds AWQ)."""
    base = mode.removesuffix("real")
    if not re.fullmatch(r"int8|int4(full)?(fc1|fc2)?(g64|g32)?(gptq)?(awq)?", base):
        raise ValueError(f"unknown mode {mode!r}")
    mlp_bits = 4 if base.startswith("int4") else None
    fc2_bits = None
    if "fc1" in base:
        mlp_bits, fc2_bits = 4, 8
    elif "fc2" in base:
        mlp_bits, fc2_bits = 8, 4
    kw = dict(bits=4 if base.startswith("int4full") else 8, mlp_bits=mlp_bits,
              fc2_bits=fc2_bits, int4_group=64 if "g64" in base else 32 if "g32" in base else 128,
              gptq="gptq" in base, fake=not mode.endswith("real"))
    return kw, "awq" in base


def greedy_codes(model: ZonosModel, params: dict, cond: torch.Tensor, steps: int) -> torch.Tensor:
    """The reference's greedy codes ``[1, K, steps]`` (EOS disabled)."""
    res = DecodeEngine(model).generate(
        params, cond, generator=torch.Generator(cond.device).manual_seed(1),
        max_new_tokens=steps, sampling_params=SamplingParams(temperature=0.0),
        disable_eos=True)
    return res.codes


def _teacher_forced(model, params, cond, delayed, capture_fc2=False):
    with torch.inference_mode():
        emb = model.embed_codes(params, delayed)
        emb = torch.cat([emb, emb], dim=0)
        hidden = torch.cat([cond.to(emb.dtype), emb], dim=1)
        T = hidden.shape[1]
        cache = model.allocate_cache(2, (T + 7) // 8 * 8, cond.dtype, cond.device)
        return model.backbone_forward(params, hidden, cache, 0, model.rope_for(cond.device),
                                      capture_fc2=capture_fc2)


def probs_along(model: ZonosModel, params: dict, cond: torch.Tensor,
                delayed: torch.Tensor) -> torch.Tensor:
    """Next-token distributions ``[K, T', V]`` (fp32) at every audio position
    of ONE teacher-forced prefill over ``delayed`` ``[1, K, T']``."""
    out = _teacher_forced(model, params, cond, delayed)
    with torch.inference_mode():
        logits = model.apply_heads(params, out[:, cond.shape[1]:, :])  # [2, K, T', V]
        c, u = logits.chunk(2, dim=0)
        logits = u + (c - u) * CFG_SCALE
        logits[..., model.config.head_vocab_size:] = -1e30
        return torch.softmax(logits[0], dim=-1)


def fc2_energy(model: ZonosModel, params: dict, cond: torch.Tensor,
               delayed: torch.Tensor) -> torch.Tensor:
    """The fc2 inputs' per-channel energies ``[L, F]`` over the same
    teacher-forced context (the AWQ fold's calibration)."""
    return _teacher_forced(model, params, cond, delayed, capture_fc2=True)[1]


def compare(p_ref: torch.Tensor, p_q: torch.Tensor) -> dict:
    """Margin-weighted top-8 overlap and TV distance (mean, p95, max), as
    Python floats (computed in float64)."""
    p_ref, p_q = p_ref.double(), p_q.double()
    tv = 0.5 * (p_ref - p_q).abs().sum(dim=-1)  # [K, T']
    top_ref = torch.argsort(p_ref, dim=-1, descending=True)[..., :TOPK]
    top_q = torch.argsort(p_q, dim=-1, descending=True)[..., :TOPK]
    overlap = (top_ref[..., :, None] == top_q[..., None, :]).any(-1).sum(-1).double() / TOPK
    ordered = torch.sort(p_ref, dim=-1, descending=True).values
    margin = ordered[..., 0] - ordered[..., 1]
    weighted = float((overlap * margin).sum() / max(float(margin.sum()), 1e-9))
    return {"topk_overlap_margin_weighted": weighted,
            "tv_distance_mean": float(tv.mean()),
            "tv_distance_p95": float(torch.quantile(tv.flatten(), 0.95)),
            "tv_distance_max": float(tv.max())}


def run(model: ZonosModel, params: dict, cond: torch.Tensor, modes, steps: int):
    """Yields one result dict per mode (see the module docstring)."""
    codes = greedy_codes(model, params, cond, steps)
    delayed = apply_delay_pattern(codes, model.config.masked_token_id)
    p_ref = probs_along(model, params, cond, delayed)
    energy = None
    for mode in modes:
        kw, awq = parse_mode(mode)
        if awq and energy is None:
            energy = fc2_energy(model, params, cond, delayed)
        t0 = time.perf_counter()
        qp = quantize_zonos_params(params, awq_energy=energy if awq else None, **kw)
        if cond.device.type == "cuda":
            torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        p_q = probs_along(model, qp, cond, delayed)
        del qp
        yield {"mode": mode, "steps": steps, **compare(p_ref, p_q),
               "quantize_seconds": quant_s}


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("args", nargs="*", help="[steps] [modes...]")
    ap.add_argument("--hybrid", action="store_true", help="the flagship hybrid backbone")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth to N layers")
    a = ap.parse_args(argv)
    steps = int(a.args[0]) if a.args and a.args[0].isdigit() else 86
    modes = [m for m in a.args if not m.isdigit()] or ["int8", "int4"]
    for m in modes:
        parse_mode(m)
    dev = resolve_device(a.device)
    config = ZONOS_V01_HYBRID if a.hybrid else ZONOS_V01_TRANSFORMER
    if a.layers:
        bb = config.backbone
        idx = tuple(i for i in bb.attn_layer_idx if i < a.layers) if bb.is_hybrid else ()
        config = dataclasses.replace(config, backbone=dataclasses.replace(
            bb, n_layer=a.layers, **({"attn_layer_idx": idx} if bb.is_hybrid else {})))
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    model = ZonosModel(config)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    params = model.init(torch.Generator(dev).manual_seed(0), dtype, dev)
    cond = model.prepare_conditioning(params, {"espeak": torch.tensor(PHONEMES, device=dev)})
    name = "hybrid" if a.hybrid else "transformer"
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for res in run(model, params, cond, modes, steps):
        print(json.dumps({**res, "backbone": name, "layers": config.backbone.n_layer,
                          "device": kind}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
