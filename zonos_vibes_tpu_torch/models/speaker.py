"""Speaker encoder (the JAX package's ``models/speaker.py``): ResNet293 with
SimAM blocks, attentive statistics pooling and LDA.

    wav -> mono mix -> 16 kHz -> log mel (80 bins, 25 ms / 10 ms)
        -> ResNet293 (2D, width 64, depths 10/20/64/3) -> ASP -> 256-d
        -> LDA -> 128-d

The 128-d LDA output is the Zonos model's speaker conditioning. Inference
BatchNorm is folded into the preceding convolution when a reference
checkpoint is converted (:func:`convert_speaker_state_dict`), so a block is
conv + bias only. Layouts: NCHW activations with H = mel bin and W = time;
convolution weights ``[Cout, Cin, kh, kw]``; ASP's 1x1 convolutions, the
bottleneck and the LDA ``[in, out]``. Each stage is a strided head block and
a tail of identical blocks whose weights are stacked on a leading axis (JAX
scans over them; here a loop does). Everything runs in fp32 on the
parameters' device (TF32 off on CUDA, as ``utils/device.resolve_device``
sets), the DSP of :meth:`SpeakerEncoder.__call__` included.

SimAM (parameter free): ``x * sigmoid(d / (4 (v + 1e-4)) + 0.5)`` with
``d = (x - mean)^2`` and ``v`` the spatial variance over ``H * W - 1``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.checkpoint import stack_trees
from ..utils.dsp import log_fbank, resample

_LAMBDA_P = 1e-4
_DEPTHS = (10, 20, 64, 3)
# The mel frontend reflect-pads n_fft / 2 = 256 samples per side, which
# fails on shorter input: shorter 16 kHz clips are zero-padded to this.
MIN_16K = 512


def _conv(x, p, stride: int = 1, padding: int = 1):
    return F.conv2d(x, p["weight"], p["bias"], stride=stride, padding=padding)


def _simam(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[2] * x.shape[3] - 1
    d = (x - x.mean(dim=(2, 3), keepdim=True)).square()
    v = d.sum(dim=(2, 3), keepdim=True) / n
    return x * torch.sigmoid(d / (4.0 * (v + _LAMBDA_P)) + 0.5)


def _block(p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    """SimAM basic block, BatchNorm folded."""
    out = torch.relu(_conv(x, p["conv1"], stride))
    out = _simam(_conv(out, p["conv2"]))
    if "downsample" in p:
        x = _conv(x, p["downsample"], stride, padding=0)
    return torch.relu(out + x)


def _stage(p: dict, x: torch.Tensor, stride: int) -> torch.Tensor:
    x = _block(p["head"], x, stride)
    tail = p.get("tail")
    if tail is not None:
        for i in range(tail["conv1"]["weight"].shape[0]):
            x = _block({name: {k: t[i] for k, t in conv.items()} for name, conv in tail.items()},
                       x, 1)
    return x


class SpeakerEncoder:
    """Static wrapper; the parameter dict comes from :meth:`init`,
    :func:`convert_speaker_state_dict` or
    ``utils.checkpoint.speaker_params_from_jax``."""

    def __init__(self, in_planes: int = 64, embd_dim: int = 256, acoustic_dim: int = 80,
                 lda_dim: int = 128, depths: tuple = _DEPTHS):
        self.in_planes = in_planes
        self.depths = depths
        self.embd_dim = embd_dim
        self.acoustic_dim = acoustic_dim
        self.lda_dim = lda_dim
        # ASP input channels: in_planes * 8 channels x acoustic_dim / 8 bins.
        self.asp_channels = in_planes * 8 * (acoustic_dim // 8)

    def init(self, gen: torch.Generator, device="cpu") -> dict:
        """Random fp32 parameters at the JAX ``init``'s shapes and scales
        (normal / sqrt(fan_in) convolutions, zero biases), from ``gen``."""

        def normal(*shape):
            return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)

        def conv(k, cin, cout):
            return {"weight": normal(cout, cin, k, k) / (k * k * cin) ** 0.5,
                    "bias": torch.zeros(cout, device=device)}

        def block(cin, cout, downsample):
            p = {"conv1": conv(3, cin, cout), "conv2": conv(3, cout, cout)}
            if downsample:
                p["downsample"] = conv(1, cin, cout)
            return p

        def stage(cin, cout, depth, stride):
            p = {"head": block(cin, cout, downsample=(stride != 1 or cin != cout))}
            if depth > 1:
                p["tail"] = stack_trees([block(cout, cout, False) for _ in range(depth - 1)])
            return p

        ip, C = self.in_planes, self.asp_channels
        zeros = lambda n: torch.zeros(n, device=device)  # noqa: E731
        return {
            "conv1": conv(3, 1, ip),
            "layer1": stage(ip, ip, self.depths[0], 1),
            "layer2": stage(ip, ip * 2, self.depths[1], 2),
            "layer3": stage(ip * 2, ip * 4, self.depths[2], 2),
            "layer4": stage(ip * 4, ip * 8, self.depths[3], 2),
            "asp": {
                "conv1": {"weight": normal(C, 128) * 0.02, "bias": zeros(128)},
                "bn": {"scale": torch.ones(128, device=device), "shift": zeros(128)},
                "conv2": {"weight": normal(128, C) * 0.02, "bias": zeros(C)},
            },
            "bottleneck": {"weight": normal(2 * C, self.embd_dim) * 0.01,
                           "bias": zeros(self.embd_dim)},
            "lda": {"weight": normal(self.embd_dim, self.lda_dim) * 0.01,
                    "bias": zeros(self.lda_dim)},
        }

    def resnet_forward(self, params: dict, mel: torch.Tensor) -> torch.Tensor:
        """``[B, 80, T] -> [B, C * F', T']``, channel-major as the reference's
        reshape of ``[B, C, F', T']``."""
        x = torch.relu(_conv(mel[:, None], params["conv1"]))
        x = _stage(params["layer1"], x, 1)
        x = _stage(params["layer2"], x, 2)
        x = _stage(params["layer3"], x, 2)
        x = _stage(params["layer4"], x, 2)
        B, C, Fr, T = x.shape
        return x.reshape(B, C * Fr, T)

    def asp_forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Attentive statistics pooling ``[B, C, T] -> [B, 2C]``."""
        p = params["asp"]
        h = torch.einsum("bct,cd->bdt", x, p["conv1"]["weight"]) + p["conv1"]["bias"][None, :, None]
        h = torch.relu(h)
        h = h * p["bn"]["scale"][None, :, None] + p["bn"]["shift"][None, :, None]
        h = torch.einsum("bdt,dc->bct", h, p["conv2"]["weight"]) + p["conv2"]["bias"][None, :, None]
        w = torch.softmax(h, dim=-1)
        mu = (x * w).sum(dim=-1)
        sg = torch.sqrt(((x.square() * w).sum(dim=-1) - mu.square()).clamp(min=1e-5))
        return torch.cat([mu, sg], dim=1)

    def embed(self, params: dict, mel: torch.Tensor) -> torch.Tensor:
        """``[B, 80, T] -> [B, 256]`` speaker embedding."""
        x = self.asp_forward(params, self.resnet_forward(params, mel))
        return x @ params["bottleneck"]["weight"] + params["bottleneck"]["bias"]

    def embed_with_lda(self, params: dict, mel: torch.Tensor):
        """``[B, 80, T]`` mel -> ``(emb_256, lda_128)``."""
        with torch.inference_mode():
            emb = self.embed(params, mel)
            return emb, emb @ params["lda"]["weight"] + params["lda"]["bias"]

    def __call__(self, params: dict, wav, sample_rate: int):
        """``wav [C, T]`` or ``[T]`` -> ``(emb_256, lda_128)``: mono mix, 16 kHz,
        zero pad to ``MIN_16K`` samples, ``log_fbank``, all on the
        parameters' device."""
        dev = params["conv1"]["weight"].device
        wav = torch.as_tensor(wav, dtype=torch.float32).to(dev)
        if wav.ndim == 2:
            wav = wav.mean(dim=0)
        wav16 = resample(wav[None, :], sample_rate, 16_000)
        if wav16.shape[-1] < MIN_16K:
            wav16 = F.pad(wav16, (0, MIN_16K - wav16.shape[-1]))
        return self.embed_with_lda(params, log_fbank(wav16))


def _fold_bn(conv_w: np.ndarray, bn: dict, eps: float = 1e-5):
    """Fold inference BatchNorm into the preceding conv ``[Cout, Cin, kh,
    kw]``; returns (weight in the same layout, bias)."""
    scale = bn["weight"] / np.sqrt(bn["running_var"] + eps)
    return conv_w * scale[:, None, None, None], bn["bias"] - bn["running_mean"] * scale


def convert_speaker_state_dict(resnet_sd: dict, lda_sd: dict, depths: tuple = _DEPTHS) -> dict:
    """The reference's ``ResNet293_based`` and LDA state dicts (tensors or
    arrays) -> the port's fp32 parameter dict (on the CPU), BatchNorm folded
    into each convolution."""

    def arr(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(torch.float32).cpu().numpy()
        return np.asarray(x, np.float32)

    sd = {k: arr(v) for k, v in resnet_sd.items()}

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32))

    def folded(conv_key, bn_key):
        bn = {k: sd[f"{bn_key}.{k}"] for k in ("weight", "bias", "running_mean", "running_var")}
        w, b = _fold_bn(sd[conv_key + ".weight"], bn)
        return {"weight": t(w), "bias": t(b)}

    def block(base, has_down):
        p = {"conv1": folded(f"{base}.conv1", f"{base}.bn1"),
             "conv2": folded(f"{base}.conv2", f"{base}.bn2")}
        if has_down:
            p["downsample"] = folded(f"{base}.downsample.0", f"{base}.downsample.1")
        return p

    def stage(idx, depth, first_has_down):
        base = f"front.layer{idx}"
        p = {"head": block(f"{base}.0", first_has_down)}
        if depth > 1:
            p["tail"] = stack_trees([block(f"{base}.{i}", False) for i in range(1, depth)])
        return p

    asp_bn = {k: sd[f"pooling.attention.2.{k}"]
              for k in ("weight", "bias", "running_mean", "running_var")}
    asp_std = np.sqrt(asp_bn["running_var"] + 1e-5)
    return {
        "conv1": folded("front.conv1", "front.bn1"),
        "layer1": stage(1, depths[0], False),
        "layer2": stage(2, depths[1], True),
        "layer3": stage(3, depths[2], True),
        "layer4": stage(4, depths[3], True),
        "asp": {
            "conv1": {"weight": t(sd["pooling.attention.0.weight"][:, :, 0].T),
                      "bias": t(sd["pooling.attention.0.bias"])},
            "bn": {"scale": t(asp_bn["weight"] / asp_std),
                   "shift": t(asp_bn["bias"]
                              - asp_bn["running_mean"] * asp_bn["weight"] / asp_std)},
            "conv2": {"weight": t(sd["pooling.attention.3.weight"][:, :, 0].T),
                      "bias": t(sd["pooling.attention.3.bias"])},
        },
        "bottleneck": {"weight": t(sd["bottleneck.weight"].T), "bias": t(sd["bottleneck.bias"])},
        "lda": {"weight": t(arr(lda_sd["weight"]).T), "bias": t(arr(lda_sd["bias"]))},
    }
