"""DAC autoencoder wrapper (the JAX package's ``models/autoencoder.py``):
9 codebooks x 1024 codes at ~86.13 Hz, 44.1 kHz audio, hop 512, with the
reference's preprocessing (resample to 44.1 kHz, right pad to a multiple of
the hop)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.dsp import resample
from .dac import DACConfig, DACModel


class DACAutoencoder:
    def __init__(self, config: DACConfig | None = None):
        self.model = DACModel(config)
        cfg = self.model.config
        self.codebook_size = cfg.codebook_size
        self.num_codebooks = cfg.n_codebooks
        self.sampling_rate = cfg.sampling_rate
        self.hop = cfg.hop_length

    def init(self, gen: torch.Generator, device="cpu") -> dict:
        return self.model.init(gen, device)

    def preprocess(self, wav: torch.Tensor, sr: int) -> torch.Tensor:
        """``[..., T]`` at ``sr`` -> 44.1 kHz, right-padded with zeros to a
        multiple of the hop."""
        wav = resample(wav, sr, self.sampling_rate)
        return F.pad(wav, (0, -wav.shape[-1] % self.hop))

    def encode(self, params: dict, wav: torch.Tensor) -> torch.Tensor:
        """``[B, 1, T] -> [B, 9, T / 512]`` int64 codes."""
        return self.model.encode(params, wav)

    def decode(self, params: dict, codes: torch.Tensor) -> torch.Tensor:
        """``[B, 9, T'] -> [B, 1, T' * 512]`` float waveform in [-1, 1]."""
        return self.model.decode(params, codes)
