"""Plain fp32 references of the audio ends of the path: the DAC decoder
(44.1 kHz, hop 512) from codes to PCM, and the speaker encoder (log mel,
ResNet293 with SimAM, attentive statistics pooling, LDA) from a 16 kHz WAV
to the 128-d embedding. Written from the published descriptions (descript
audio codec; Zonos's speaker model), over the benchmark's weights in the
port's layouts (conv ``[Cout, Cin, k]``, transposed conv ``[Cin, Cout, k]``,
a stage's tail blocks stacked, BatchNorm folded into the conv biases).
TF32 is off while these run.

Imports nothing but ``torch``, ``numpy`` and ``math``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _snake(x, alpha):
    a = alpha.float()[None, :, None]
    return x + torch.sin(a * x) ** 2 / (a + 1e-9)


def _conv(x, p, **kw):
    return F.conv1d(x, p["weight"].float(), p["bias"].float(), **kw)


def dac_decode(params: dict, codes: torch.Tensor, ratios=(8, 8, 4, 2)) -> torch.Tensor:
    """Codes ``[K, T]`` -> waveform ``[T * hop]`` fp32: the residual
    quantizers' codebook rows through their out-projections, summed; then
    the decoder (conv, four upsampling blocks of Snake, transposed conv and
    three dilated residual units, Snake, conv, tanh)."""
    z = 0.0
    for k, q in enumerate(params["quantizers"]):
        rows = q["codebook"].float()[codes[k].long()].T[None]  # [1, 8, T]
        z = z + _conv(rows, q["out_proj"])
    d = params["decoder"]
    x = _conv(z, d["conv1"], padding=3)
    for blk, s in zip(d["blocks"], ratios):
        x = _snake(x, blk["snake"])
        x = F.conv_transpose1d(x, blk["conv_t"]["weight"].float(), blk["conv_t"]["bias"].float(),
                               stride=s, padding=math.ceil(s / 2))
        for r, dil in (("res1", 1), ("res2", 3), ("res3", 9)):
            u = blk[r]
            y = _conv(_snake(x, u["snake1"]), u["conv1"], padding=3 * dil, dilation=dil)
            y = _conv(_snake(y, u["snake2"]), u["conv2"])
            x = x + y
    x = _snake(x, d["snake"])
    return torch.tanh(_conv(x, d["conv2"], padding=3))[0, 0]


def pcm16(wav: torch.Tensor) -> np.ndarray:
    """Float samples -> 16-bit PCM as a stream carries it (clipped, scaled
    by 32767, truncated)."""
    return (wav.clamp(-1.0, 1.0) * 32767.0).to(torch.int16).cpu().numpy()


# -- speaker encoder -----------------------------------------------------------

def _mel_fb(n_mels=80, n_fft=512, sr=16000) -> np.ndarray:
    """HTK-scale triangular filters ``[n_fft // 2 + 1, n_mels]`` over 0 ..
    sr / 2, without normalisation."""
    def hz2mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel2hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    pts = mel2hz(np.linspace(hz2mel(0.0), hz2mel(sr / 2), n_mels + 2))
    fb = np.zeros((n_fft // 2 + 1, n_mels))
    for m in range(n_mels):
        lo, c, hi = pts[m], pts[m + 1], pts[m + 2]
        fb[:, m] = np.maximum(0.0, np.minimum((freqs - lo) / (c - lo), (hi - freqs) / (hi - c)))
    return fb.astype(np.float32)


def log_fbank(wav16k: torch.Tensor) -> torch.Tensor:
    """``[T]`` at 16 kHz -> ``[1, 80, frames]``: a centred STFT (reflect
    padding, a periodic Hann window of 400 samples in 512, hop 160), power,
    the mel filters, ``log(mel + 1e-6)`` less its mean over time."""
    win = torch.hann_window(400, periodic=True, dtype=torch.float32, device=wav16k.device)
    spec = torch.stft(wav16k.float()[None], n_fft=512, hop_length=160, win_length=400,
                      window=win, center=True, pad_mode="reflect", return_complex=True)
    power = spec.abs() ** 2  # [1, 257, frames]
    fb = torch.from_numpy(_mel_fb()).to(wav16k.device)
    mel = torch.einsum("bft,fm->bmt", power, fb)
    out = torch.log(mel + 1e-6)
    return out - out.mean(dim=-1, keepdim=True)


def _c2(x, p, stride=1, padding=1):
    return F.conv2d(x, p["weight"].float(), p["bias"].float(), stride=stride, padding=padding)


def _basic_block(p, x, stride):
    out = torch.relu(_c2(x, p["conv1"], stride))
    out = _c2(out, p["conv2"])
    # SimAM: energy of each activation against its channel's spatial mean.
    n = out.shape[2] * out.shape[3] - 1
    d = (out - out.mean(dim=(2, 3), keepdim=True)) ** 2
    v = d.sum(dim=(2, 3), keepdim=True) / n
    out = out * torch.sigmoid(d / (4 * (v + 1e-4)) + 0.5)
    short = _c2(x, p["downsample"], stride, padding=0) if "downsample" in p else x
    return torch.relu(out + short)


def speaker_embedding(params: dict, wav16k: torch.Tensor) -> torch.Tensor:
    """A 16 kHz mono waveform ``[T]`` -> the 128-d LDA embedding (fp32)."""
    if wav16k.shape[-1] < 512:
        wav16k = F.pad(wav16k, (0, 512 - wav16k.shape[-1]))
    x = torch.relu(_c2(log_fbank(wav16k)[:, None], params["conv1"]))
    for s, stride in zip(range(1, 5), (1, 2, 2, 2)):
        stage = params[f"layer{s}"]
        x = _basic_block(stage["head"], x, stride)
        tail = stage.get("tail")
        if tail is not None:
            for i in range(tail["conv1"]["weight"].shape[0]):
                x = _basic_block({k: {n: t[i] for n, t in v.items()} for k, v in tail.items()},
                                 x, 1)
    B, C, Fq, T = x.shape
    x = x.reshape(B, C * Fq, T)
    a = params["asp"]
    h = torch.relu(torch.einsum("bct,cd->bdt", x, a["conv1"]["weight"].float())
                   + a["conv1"]["bias"].float()[None, :, None])
    h = h * a["bn"]["scale"].float()[None, :, None] + a["bn"]["shift"].float()[None, :, None]
    w = torch.softmax(torch.einsum("bdt,dc->bct", h, a["conv2"]["weight"].float())
                      + a["conv2"]["bias"].float()[None, :, None], dim=-1)
    mu = (x * w).sum(-1)
    sg = torch.sqrt((((x ** 2) * w).sum(-1) - mu ** 2).clamp(min=1e-5))
    emb = torch.cat([mu, sg], 1) @ params["bottleneck"]["weight"].float() \
        + params["bottleneck"]["bias"].float()
    return (emb @ params["lda"]["weight"].float() + params["lda"]["bias"].float())[0]
