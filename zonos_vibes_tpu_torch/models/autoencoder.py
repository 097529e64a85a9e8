"""DAC autoencoder wrapper (the JAX package's ``models/autoencoder.py``):
9 codebooks x 1024 codes at ~86.13 Hz, 44.1 kHz audio, hop 512. Decode only;
the encoder waits for the audio-prefix slice."""

from __future__ import annotations

import torch

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

    def decode(self, params: dict, codes: torch.Tensor) -> torch.Tensor:
        """``[B, 9, T'] -> [B, 1, T' * 512]`` float waveform in [-1, 1]."""
        return self.model.decode(params, codes)
