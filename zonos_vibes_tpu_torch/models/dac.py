"""DAC audio codec, decode half (the JAX package's ``models/dac.py``).

``from_codes`` sums the 9 RVQ stages (codebook lookup, then a 1x1 conv
8 -> 1024); ``decoder_forward`` is Conv1d(1024 -> 1536, k7), four blocks of
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
The encoder and ``preprocess`` (audio-prefix continuation) are not ported.
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


class DACModel:
    def __init__(self, config: DACConfig | None = None):
        self.config = config or DACConfig()

    def init(self, gen: torch.Generator, device="cpu") -> dict:
        """Random fp32 decoder and quantizer out-projections (the shapes the
        JAX ``init`` gives them)."""
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
        return {
            "quantizers": quantizers,
            "decoder": {
                "conv1": _init_conv(gen, 7, cfg.hidden_size, cfg.decoder_hidden_size, device),
                "blocks": blocks,
                "snake": torch.ones(dec_out, device=device),
                "conv2": _init_conv(gen, 7, dec_out, 1, device),
            },
        }

    def from_codes(self, params: dict, codes: torch.Tensor) -> torch.Tensor:
        """``[B, K, T'] -> [B, 1024, T']`` summed quantized latents."""
        acc = 0.0
        for i, q in enumerate(params["quantizers"]):
            zq = q["codebook"][codes[:, i, :].long()].transpose(1, 2)  # [B, 8, T']
            acc = acc + _conv(zq, q["out_proj"])
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

    def decode(self, params: dict, codes: torch.Tensor) -> torch.Tensor:
        """``[B, K, T'] -> [B, 1, T' * hop]`` float waveform."""
        return self.decoder_forward(params, self.from_codes(params, codes))
