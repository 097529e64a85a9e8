"""DAC audio codec (the JAX package's ``models/dac.py``).

``encoder_forward`` is Conv1d(1 -> 64, k7), four blocks of three dilated
residual units (dilation 1, 3, 9) -> Snake -> a strided Conv1d (k = 2s,
stride s, padding ceil(s / 2), doubling channels; strides 2, 4, 8, 8), then
Snake -> Conv1d(1024 -> 1024, k3). ``quantize`` is the 9-stage residual
vector quantizer: each stage projects the residual 1024 -> 8 (1x1 conv),
takes the nearest codebook entry in l2-normalised space (first index on a
tie) and subtracts that entry's 8 -> 1024 projection (of the raw codebook
row). ``from_codes`` sums the 9 stages' projections; ``decoder_forward`` is
Conv1d(1024 -> 1536, k7), four blocks of
Snake -> ConvTranspose1d(k = 2s, stride s, halving channels; strides 8, 8, 4,
2) -> three dilated residual units (dilation 1, 3, 9), then Snake ->
Conv1d(96 -> 1, k7) -> tanh. Hop 512, 44.1 kHz. Computation is fp32,
channels-first; the convolutions are ``torch.nn.functional.conv1d`` and
``conv_transpose1d`` (the JAX package leaves them to XLA). On a CUDA device
cuDNN would run fp32 convolutions in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; the pipeline sets it False.

Parameters keep the JAX tree; the conv weights are in PyTorch's layouts
(``utils/checkpoint.params_from_jax`` converts): conv ``[Cout, Cin, k]``,
transposed conv ``[Cin, Cout, k]`` (not flipped), Snake alpha ``[C]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class DACConfig:
    encoder_hidden_size: int = 64
    downsampling_ratios: tuple = (2, 4, 8, 8)
    decoder_hidden_size: int = 1536
    n_codebooks: int = 9
    codebook_size: int = 1024
    codebook_dim: int = 8
    sampling_rate: int = 44100

    @property
    def upsampling_ratios(self) -> tuple:
        return tuple(reversed(self.downsampling_ratios))

    @property
    def hidden_size(self) -> int:
        return self.encoder_hidden_size * (2 ** len(self.downsampling_ratios))

    @property
    def hop_length(self) -> int:
        n = 1
        for r in self.downsampling_ratios:
            n *= r
        return n


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake1d on ``[B, C, T]`` with per-channel ``alpha [C]``."""
    a = alpha[None, :, None]
    return x + torch.sin(a * x).square() / (a + 1e-9)


def _conv(x, p, padding=0, dilation=1):
    return F.conv1d(x, p["weight"], p["bias"], padding=padding, dilation=dilation)


def _res_unit(p, x, dilation: int):
    y = _conv(snake(x, p["snake1"]), p["conv1"], padding=3 * dilation, dilation=dilation)
    y = _conv(snake(y, p["snake2"]), p["conv2"])
    return x + y


def _init_conv(gen, k, cin, cout, device, transposed=False):
    lim = 1.0 / (cin * k) ** 0.5

    def uniform(shape):
        u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
        return (u * 2 - 1) * lim

    shape = (cin, cout, k) if transposed else (cout, cin, k)
    return {"weight": uniform(shape), "bias": uniform((cout,))}


def _init_res_unit(gen, dim, device):
    return {
        "snake1": torch.ones(dim, device=device),
        "conv1": _init_conv(gen, 7, dim, dim, device),
        "snake2": torch.ones(dim, device=device),
        "conv2": _init_conv(gen, 1, dim, dim, device),
    }


def rvq_scores(q: dict, residual: torch.Tensor) -> torch.Tensor:
    """One RVQ stage's scores ``[B, T', codebook_size]`` for a residual
    ``[B, 1024, T']``: ``-(|z|^2 - 2 z.c) + |c|^2`` on the l2-normalised
    in-projection ``z`` and codebook rows ``c`` (each norm + 1e-12); the
    code is the argmax."""
    z = _conv(residual, q["in_proj"]).transpose(1, 2)  # [B, T', 8]
    zn = z / (z.norm(dim=-1, keepdim=True) + 1e-12)
    cb = q["codebook"]
    cbn = cb / (cb.norm(dim=-1, keepdim=True) + 1e-12)
    return -((zn * zn).sum(-1, keepdim=True) - 2.0 * (zn @ cbn.T)) + (cbn * cbn).sum(-1)


def rvq_dequantize(q: dict, idx: torch.Tensor) -> torch.Tensor:
    """Codes ``[B, T']`` of one stage -> ``[B, 1024, T']``: the raw codebook
    rows through the stage's out-projection."""
    return _conv(q["codebook"][idx.long()].transpose(1, 2), q["out_proj"])


class DACModel:
    def __init__(self, config: DACConfig | None = None):
        self.config = config or DACConfig()

    def init(self, gen: torch.Generator, device="cpu") -> dict:
        """Random fp32 parameters at the shapes of the JAX ``init``. The
        decoder and the quantizers' codebooks and out-projections are drawn
        first, then the encoder and the in-projections."""
        cfg = self.config
        blocks = []
        for i, s in enumerate(cfg.upsampling_ratios):
            cin = cfg.decoder_hidden_size // (2 ** i)
            cout = cfg.decoder_hidden_size // (2 ** (i + 1))
            blocks.append({
                "snake": torch.ones(cin, device=device),
                "conv_t": _init_conv(gen, 2 * s, cin, cout, device, transposed=True),
                "res1": _init_res_unit(gen, cout, device),
                "res2": _init_res_unit(gen, cout, device),
                "res3": _init_res_unit(gen, cout, device),
            })
        dec_out = cfg.decoder_hidden_size // (2 ** len(cfg.upsampling_ratios))
        quantizers = [{
            "out_proj": _init_conv(gen, 1, cfg.codebook_dim, cfg.hidden_size, device),
            "codebook": torch.randn((cfg.codebook_size, cfg.codebook_dim), generator=gen,
                                    device=device),
        } for _ in range(cfg.n_codebooks)]
        enc_blocks = []
        for i, s in enumerate(cfg.downsampling_ratios):
            dim = cfg.encoder_hidden_size * (2 ** (i + 1))
            enc_blocks.append({
                "res1": _init_res_unit(gen, dim // 2, device),
                "res2": _init_res_unit(gen, dim // 2, device),
                "res3": _init_res_unit(gen, dim // 2, device),
                "snake": torch.ones(dim // 2, device=device),
                "conv": _init_conv(gen, 2 * s, dim // 2, dim, device),
            })
        encoder = {
            "conv1": _init_conv(gen, 7, 1, cfg.encoder_hidden_size, device),
            "blocks": enc_blocks,
            "snake": torch.ones(cfg.hidden_size, device=device),
            "conv2": _init_conv(gen, 3, cfg.hidden_size, cfg.hidden_size, device),
        }
        for q in quantizers:
            q["in_proj"] = _init_conv(gen, 1, cfg.hidden_size, cfg.codebook_dim, device)
        return {
            "encoder": encoder,
            "quantizers": quantizers,
            "decoder": {
                "conv1": _init_conv(gen, 7, cfg.hidden_size, cfg.decoder_hidden_size, device),
                "blocks": blocks,
                "snake": torch.ones(dec_out, device=device),
                "conv2": _init_conv(gen, 7, dec_out, 1, device),
            },
        }

    def encoder_forward(self, params: dict, audio: torch.Tensor) -> torch.Tensor:
        """``[B, 1, T] -> [B, 1024, T / hop]`` continuous latents."""
        p = params["encoder"]
        x = _conv(audio, p["conv1"], padding=3)
        for blk, s in zip(p["blocks"], self.config.downsampling_ratios):
            x = _res_unit(blk["res1"], x, 1)
            x = _res_unit(blk["res2"], x, 3)
            x = _res_unit(blk["res3"], x, 9)
            x = snake(x, blk["snake"])
            x = F.conv1d(x, blk["conv"]["weight"], blk["conv"]["bias"], stride=s,
                         padding=-(-s // 2))
        return _conv(snake(x, p["snake"]), p["conv2"], padding=1)

    def quantize(self, params: dict, latents: torch.Tensor) -> torch.Tensor:
        """RVQ encode: ``[B, 1024, T'] -> [B, K, T']`` int64 codes."""
        residual, codes = latents, []
        for q in params["quantizers"]:
            idx = rvq_scores(q, residual).argmax(dim=-1)  # [B, T']
            codes.append(idx)
            residual = residual - rvq_dequantize(q, idx)
        return torch.stack(codes, dim=1)

    def from_codes(self, params: dict, codes: torch.Tensor) -> torch.Tensor:
        """``[B, K, T'] -> [B, 1024, T']`` summed quantized latents."""
        acc = 0.0
        for i, q in enumerate(params["quantizers"]):
            acc = acc + rvq_dequantize(q, codes[:, i, :])
        return acc

    def decoder_forward(self, params: dict, latents: torch.Tensor) -> torch.Tensor:
        """``[B, 1024, T'] -> [B, 1, T' * hop]`` waveform in [-1, 1]."""
        p = params["decoder"]
        x = _conv(latents, p["conv1"], padding=3)
        for blk, s in zip(p["blocks"], self.config.upsampling_ratios):
            x = snake(x, blk["snake"])
            x = F.conv_transpose1d(x, blk["conv_t"]["weight"], blk["conv_t"]["bias"],
                                   stride=s, padding=-(-s // 2))
            x = _res_unit(blk["res1"], x, 1)
            x = _res_unit(blk["res2"], x, 3)
            x = _res_unit(blk["res3"], x, 9)
        x = snake(x, p["snake"])
        return torch.tanh(_conv(x, p["conv2"], padding=3))

    def encode(self, params: dict, audio: torch.Tensor) -> torch.Tensor:
        """``[B, 1, T]`` float (T a multiple of the hop) -> ``[B, K, T / hop]``
        int64 codes."""
        return self.quantize(params, self.encoder_forward(params, audio))

    def decode(self, params: dict, codes: torch.Tensor) -> torch.Tensor:
        """``[B, K, T'] -> [B, 1, T' * hop]`` float waveform."""
        return self.decoder_forward(params, self.from_codes(params, codes))
