"""Audio DSP (the JAX package's ``utils/dsp.py``): windowed-sinc resampling,
STFT, mel spectrogram and the speaker frontend's log filterbank.

* ``resample``: torchaudio's polyphase windowed sinc (gcd reduction,
  rolloff 0.99, lowpass filter width 6, hann^2 window) as one strided
  ``conv1d`` whose output channels are the phases.
* ``mel_spectrogram``: centred, reflect-padded STFT (periodic hann window of
  400 samples centred in 512) -> power -> HTK mel filterbank (no norm), as
  torchaudio's ``MelSpectrogram`` defaults.
* ``log_fbank``: ``log(mel + 1e-6)`` less its mean over time.

The filter banks are built once with numpy (``_sinc_kernel`` and
``mel_filterbank`` are the JAX package's own numpy code); everything else
runs on the input tensor's device, in fp32.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=32)
def _sinc_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                 rolloff: float = 0.99):
    """Polyphase kernel bank ``[new_freq, 2 * width + orig_freq]`` (numpy,
    cached) with the gcd-reduced rates and ``width``. Output phase ``p``
    has taps ``sinc(base_freq * t) * hann^2`` at ``t = idx - p / new_freq``,
    ``idx = arange(-width, width + orig_freq) / orig_freq``,
    ``base_freq = min(orig, new) * rolloff``."""
    g = math.gcd(orig_freq, new_freq)
    orig_freq, new_freq = orig_freq // g, new_freq // g
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64) / orig_freq
    t = (-np.arange(new_freq, dtype=np.float64) / new_freq)[:, None] + idx[None, :]
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * window * (base_freq / orig_freq)
    return kernel.astype(np.float32), orig_freq, new_freq, width


def resample(x: torch.Tensor, orig_sr: int, new_sr: int) -> torch.Tensor:
    """Resample ``[..., T]`` from ``orig_sr`` to ``new_sr``: ``ceil(new * T /
    orig)`` samples (rates gcd-reduced), in ``x``'s dtype."""
    if orig_sr == new_sr:
        return x
    kernel, orig_f, new_f, width = _sinc_kernel(orig_sr, new_sr)
    length = x.shape[-1]
    target_len = int(math.ceil(new_f * length / orig_f))
    xf = F.pad(x.reshape(-1, 1, length).float(), (width, width + orig_f))
    k = torch.from_numpy(kernel).to(x.device)[:, None, :]  # [new_f, 1, K]
    y = F.conv1d(xf, k, stride=orig_f)  # [N, new_f, frames]
    y = y.transpose(1, 2).reshape(xf.shape[0], -1)[:, :target_len]
    return y.reshape(x.shape[:-1] + (target_len,)).to(x.dtype)


def hann_window(win_length: int) -> np.ndarray:
    """Periodic hann (``torch.hann_window``'s default)."""
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(win_length) / win_length))


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int, f_min: float = 0.0,
                   f_max: float | None = None) -> np.ndarray:
    """Triangular HTK-scale filterbank ``[n_fft // 2 + 1, n_mels]``
    (torchaudio ``melscale_fbanks``, norm None, mel_scale 'htk')."""
    f_max = f_max or sample_rate / 2.0
    freqs = np.linspace(0, sample_rate / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(mel_pts)
    slopes = f_pts[None, :] - freqs[:, None]  # [F, n_mels + 2]
    down = -slopes[:, :-2] / np.maximum(f_pts[1:-1] - f_pts[:-2], 1e-10)
    up = slopes[:, 2:] / np.maximum(f_pts[2:] - f_pts[1:-1], 1e-10)
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


def stft_power(x: torch.Tensor, n_fft: int = 512, win_length: int = 400,
               hop_length: int = 160) -> torch.Tensor:
    """Power spectrogram ``[..., n_fft // 2 + 1, frames]`` (``torch.stft``'s
    centred framing: reflect pad of ``n_fft // 2`` each side, the window
    zero-padded to ``n_fft`` about its centre)."""
    pad, lead = n_fft // 2, x.shape[:-1]
    x = F.pad(x.float().reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    x = x.reshape(lead + (x.shape[-1],))
    frames = x.unfold(-1, n_fft, hop_length)  # [..., frames, n_fft]
    win = np.zeros(n_fft, np.float32)
    ofs = (n_fft - win_length) // 2
    win[ofs: ofs + win_length] = hann_window(win_length)
    spec = torch.fft.rfft(frames * torch.from_numpy(win).to(x.device), n=n_fft, dim=-1)
    power = spec.real.square() + spec.imag.square()
    return power.transpose(-1, -2)


def mel_spectrogram(x: torch.Tensor, sample_rate: int = 16_000, n_fft: int = 512,
                    win_length: int = 400, hop_length: int = 160,
                    n_mels: int = 80) -> torch.Tensor:
    """``[..., T] -> [..., n_mels, frames]`` power mel."""
    power = stft_power(x, n_fft, win_length, hop_length)
    fb = torch.from_numpy(mel_filterbank(n_mels, n_fft, sample_rate)).to(x.device)
    return torch.einsum("...ft,fm->...mt", power, fb)


def log_fbank(x: torch.Tensor, sample_rate: int = 16_000) -> torch.Tensor:
    """The speaker frontend: ``[B, T] -> [B, 80, frames]`` log mel, less its
    mean over time."""
    out = torch.log(mel_spectrogram(x, sample_rate) + 1e-6)
    return out - out.mean(dim=-1, keepdim=True)
