"""Development server for the PyTorch port: random weights on a local port,
driving the whole HTTP surface (POST /tts, streaming, /healthz, /metrics,
/model-info, the web UI) without checkpoints. The audio is noise-shaped,
but every stage (phonemize -> conditioning -> decode -> DAC -> WAV) is the
real one.

    python tools/dev_server_torch.py [port] [--device cuda] [--pooled] [--hybrid]
        [--int8] [--pool-kv-int8] [--pool-state-bf16] [--warmup]

On the CPU (the default) the pipelines are tiny fp32 configurations (two
layers of width 64, the tiny DAC and speaker encoder). With ``--device
cuda`` they run on the card in bf16 at the flagship's widths, cut to two
layers (the hybrid to eight, attention at layers 3 and 7), with the
flagship's DAC and speaker encoder, so every kernel runs at its real shapes.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from zonos_vibes_tpu_torch import config as tcfg  # noqa: E402
from zonos_vibes_tpu_torch.models.dac import DACConfig  # noqa: E402
from zonos_vibes_tpu_torch.models.speaker import SpeakerEncoder  # noqa: E402
from zonos_vibes_tpu_torch.pipeline import ZonosPipeline  # noqa: E402
from zonos_vibes_tpu_torch.serve.server import TTSServer  # noqa: E402

TINY_DAC = DACConfig(encoder_hidden_size=8, downsampling_ratios=(2, 4), decoder_hidden_size=32,
                     n_codebooks=9, codebook_size=1024, codebook_dim=4)
TINY_PREFIX = tcfg.PrefixConditionerConfig.from_dict({
    "projection": "linear",
    "conditioners": [
        {"type": "EspeakPhonemeConditioner", "name": "espeak"},
        {"type": "PassthroughConditioner", "name": "speaker", "cond_dim": 16,
         "projection": "linear", "uncond_type": "learned"},
        {"type": "FourierConditioner", "name": "emotion", "input_dim": 8, "min_val": 0,
         "max_val": 1, "uncond_type": "learned"},
        {"type": "FourierConditioner", "name": "speaking_rate", "min_val": 0, "max_val": 40,
         "uncond_type": "learned"},
        {"type": "IntegerConditioner", "name": "language_id", "min_val": -1, "max_val": 126,
         "uncond_type": "learned"},
    ],
})
TINY_CFG = tcfg.ZonosConfig(
    backbone=tcfg.BackboneConfig(d_model=64, n_layer=2, attn_mlp_d_intermediate=128,
                                 attn_cfg=tcfg._freeze({"num_heads": 4, "num_heads_kv": 2})),
    prefix_conditioner=TINY_PREFIX)
TINY_HYBRID_CFG = tcfg.ZonosConfig(
    backbone=tcfg.BackboneConfig(
        d_model=64, n_layer=3, d_intermediate=0, attn_mlp_d_intermediate=96,
        attn_layer_idx=(1,),
        ssm_cfg=tcfg._freeze({"layer": "Mamba2", "d_state": 16, "headdim": 16,
                              "chunk_size": 8}),
        attn_cfg=tcfg._freeze({"num_heads": 4, "num_heads_kv": 2, "rotary_emb_dim": 8}),
        rms_norm=True, residual_in_fp32=True),
    prefix_conditioner=TINY_PREFIX)


def _cut(cfg: tcfg.ZonosConfig, **backbone) -> tcfg.ZonosConfig:
    return dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, **backbone))


def pipelines(device: str, hybrid: bool) -> tuple:
    """``(default pipeline, extra pipelines or None)`` for ``device``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        pipe = ZonosPipeline.from_config(TINY_CFG, device=dev, dtype=torch.float32,
                                         generator=torch.Generator().manual_seed(0),
                                         dac_config=TINY_DAC)
        pipe.speaker_encoder = SpeakerEncoder(in_planes=4, embd_dim=24, lda_dim=16,
                                              depths=(1, 1, 1, 1))
        pipe.speaker_params = pipe.speaker_encoder.init(torch.Generator().manual_seed(1), dev)
        extra = {"hybrid": ZonosPipeline.from_config(
            TINY_HYBRID_CFG, device=dev, dtype=torch.float32,
            generator=torch.Generator().manual_seed(2), dac_config=TINY_DAC)} if hybrid else None
        return pipe, extra
    pipe = ZonosPipeline.from_config(_cut(tcfg.ZONOS_V01_TRANSFORMER, n_layer=2), device=dev,
                                     generator=torch.Generator(dev).manual_seed(0))
    extra = {"hybrid": ZonosPipeline.from_config(
        _cut(tcfg.ZONOS_V01_HYBRID, n_layer=8, attn_layer_idx=(3, 7)), device=dev,
        generator=torch.Generator(dev).manual_seed(2))} if hybrid else None
    return pipe, extra


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("port", nargs="?", type=int, default=5050)
    ap.add_argument("--device", default="cpu", help="cpu (default) or cuda")
    ap.add_argument("--hybrid", action="store_true", help="also serve model=hybrid")
    ap.add_argument("--int8", action="store_true", help="int8 weights (the transformer)")
    ap.add_argument("--pooled", action="store_true")
    ap.add_argument("--pool-kv-int8", action="store_true")
    ap.add_argument("--pool-state-bf16", action="store_true")
    ap.add_argument("--warmup", action="store_true")
    args = ap.parse_args(argv)
    pipe, extra = pipelines(args.device, args.hybrid)
    if args.int8:
        pipe.quantize_int8()
    srv = TTSServer(pipe, host="127.0.0.1", port=args.port, batch_window_s=1.0,
                    request_timeout_s=600, extra_pipelines=extra, pooled=args.pooled,
                    pool_slots=2, pool_kv_int8=args.pool_kv_int8,
                    pool_state_bf16=args.pool_state_bf16)
    if args.warmup:
        srv.warmup([(1, 64, 215, True)])
    print(f"dev server on http://127.0.0.1:{args.port} ({pipe.device})", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
