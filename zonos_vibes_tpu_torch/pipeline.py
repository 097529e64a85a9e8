"""User-facing pipeline (the JAX package's ``pipeline.py``): text ->
phonemes -> conditioning -> prefill -> staged decode -> codes -> DAC decode.

    pipe = ZonosPipeline.from_config(ZONOS_V01_TRANSFORMER)    # on "cuda"
    # or ZonosPipeline.from_local("config.json", "model.safetensors", dac_params=...)
    spk = pipe.make_speaker_embedding(wav, sr)                  # voice cloning
    cond = pipe.make_cond_dict(text="Hello!", language="en-us", speaker=spk)
    result = pipe.generate(cond, generator=torch.Generator("cuda").manual_seed(421))
    wav44k = pipe.decode_audio(result)                          # [B, samples]
    for chunk in pipe.generate_stream(cond, generator=...):     # the same audio, in chunks
        ...
    codes = pipe.encode_audio(prefix_wav, sr)                   # continuation
    result = pipe.generate(cond, codes, generator=...)
    batch = pipe.merge_cond_dicts([cond_a, cond_b], pad_len=64)  # server batching

The speaker embedding (ResNet293, ``models/speaker.py``) and the audio
prefix's codes (``DACAutoencoder.preprocess`` + ``encode``) are computed on
``pipe.device``, their DSP included. Without loaded speaker weights,
``make_speaker_embedding`` draws random ones from seed 0 on that device.

The int8 serving configuration: ``pipe.quantize_int8()`` (int8 projections
and heads, on either backbone), then ``DecodeEngine(pipe.model,
kv_int8=True).generate(pipe.params, pipe.prepare_conditioning(cond), ...)``
for the int8 KV cache (the transformer's). ``pipe.quantize_int4()``: the MLP
as packed int4 in 128-row groups, the rest int8 (``mixed=False``: every
backbone projection int4); other widths through
``ops/quant.quantize_zonos_params``.
The hybrid backbone: ``ZonosPipeline.from_config(ZONOS_V01_HYBRID)``, the
same calls (its extra quality conditioners take ``make_cond_dict``'s
``vqscore_8``, ``ctc_loss``, ``dnsmos_ovrl`` and ``speaker_noised``);
``DecodeEngine(pipe.model, state_bf16=True)`` stores its SSM state in bf16.

Text normalization, phonemization and tokenization run on the host
(``frontend/``); everything numeric runs on ``pipe.device``. Entry points
run on CUDA unless the caller passes ``device="cpu"``, and raise without a
GPU otherwise. On the card each generate replays one captured decode step
(``engine/graphs.py``), captured once per static signature and kept in
``pipe.engine``'s cache; ``DecodeEngine(pipe.model, cuda_graphs=False)``
runs the same steps eagerly. Phases are timed into ``utils/tracing``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .config import ZonosConfig
from .engine.generate import DecodeEngine, GenerateResult
from .frontend.phonemize import phonemize
from .frontend.text import tokenize_phonemes
from .models.autoencoder import DACAutoencoder
from .models.dac import DACConfig
from .models.speaker import SpeakerEncoder
from .models.zonos import ZonosModel
from .ops.quant import quantize_zonos_params
from .ops.sampling import SamplingParams
from .utils import tracing
from .utils.device import resolve_device

# 108 eSpeak language codes, in the order of the language-id conditioner.
supported_language_codes = [
    'af', 'am', 'an', 'ar', 'as', 'az', 'ba', 'bg', 'bn', 'bpy', 'bs', 'ca', 'cmn',
    'cs', 'cy', 'da', 'de', 'el', 'en-029', 'en-gb', 'en-gb-scotland', 'en-gb-x-gbclan',
    'en-gb-x-gbcwmd', 'en-gb-x-rp', 'en-us', 'eo', 'es', 'es-419', 'et', 'eu', 'fa',
    'fa-latn', 'fi', 'fr-be', 'fr-ch', 'fr-fr', 'ga', 'gd', 'gn', 'grc', 'gu', 'hak',
    'hi', 'hr', 'ht', 'hu', 'hy', 'hyw', 'ia', 'id', 'is', 'it', 'ja', 'jbo', 'ka',
    'kk', 'kl', 'kn', 'ko', 'kok', 'ku', 'ky', 'la', 'lfn', 'lt', 'lv', 'mi', 'mk',
    'ml', 'mr', 'ms', 'mt', 'my', 'nb', 'nci', 'ne', 'nl', 'om', 'or', 'pa', 'pap',
    'pl', 'pt', 'pt-br', 'py', 'quc', 'ro', 'ru', 'ru-lv', 'sd', 'shn', 'si', 'sk',
    'sl', 'sq', 'sr', 'sv', 'sw', 'ta', 'te', 'tn', 'tr', 'tt', 'ur', 'uz', 'vi',
    'vi-vn-x-central', 'vi-vn-x-south', 'yue',
]
_LANGUAGE_TO_ID = {lang: i for i, lang in enumerate(supported_language_codes)}

DEFAULT_EMOTION = [0.3077, 0.0256, 0.0256, 0.0256, 0.0256, 0.0256, 0.2564, 0.3077]


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


@dataclass
class ZonosPipeline:
    model: ZonosModel
    params: dict
    device: torch.device
    dac: DACAutoencoder = field(default_factory=DACAutoencoder)
    dac_params: dict | None = None
    speaker_encoder: SpeakerEncoder | None = None
    speaker_params: dict | None = None

    def __post_init__(self):
        self.engine = DecodeEngine(self.model)

    @classmethod
    def from_config(cls, config: ZonosConfig, device=None,
                    generator: torch.Generator | None = None, dtype=torch.bfloat16,
                    dac_config: DACConfig | None = None) -> "ZonosPipeline":
        """Random weights at ``config``'s shapes (no checkpoint needed),
        drawn from ``generator`` (default: seed 0 on ``device``); the DAC is
        fp32."""
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator(dev).manual_seed(0)
        model = ZonosModel(config)
        dac = DACAutoencoder(dac_config)
        return cls(model=model, params=model.init(gen, dtype, dev), device=dev, dac=dac,
                   dac_params=dac.init(gen, dev))

    @classmethod
    def from_params(cls, config: ZonosConfig, params: dict, dac_params: dict | None = None,
                    device=None, dac_config: DACConfig | None = None) -> "ZonosPipeline":
        """Wrap existing port parameters (for example from
        ``utils.checkpoint.params_from_jax``), moved to ``device``."""
        dev = resolve_device(device)
        return cls(model=ZonosModel(config), params=_to_device(params, dev), device=dev,
                   dac=DACAutoencoder(dac_config),
                   dac_params=None if dac_params is None else _to_device(dac_params, dev))

    @classmethod
    def from_local(cls, config_path: str, model_path: str, dtype=torch.bfloat16, device=None,
                   **kwargs) -> "ZonosPipeline":
        """A reference checkpoint pair (``config.json`` + ``model.safetensors``,
        ``utils.checkpoint.load_zonos_checkpoint``) on ``device``. ``kwargs``
        are the other fields (``dac``, ``dac_params``, ``speaker_encoder``,
        ``speaker_params``), as in JAX; parameter trees move to ``device``."""
        from .utils.checkpoint import load_zonos_checkpoint

        dev = resolve_device(device)
        config, params = load_zonos_checkpoint(config_path, model_path, dtype)
        for name in ("dac_params", "speaker_params"):
            if kwargs.get(name) is not None:
                kwargs[name] = _to_device(kwargs[name], dev)
        return cls(model=ZonosModel(config), params=_to_device(params, dev), device=dev,
                   **kwargs)

    def make_speaker_embedding(self, wav, sr: int) -> torch.Tensor:
        """``[C, T]`` or ``[T]`` reference audio (array or tensor) -> the
        ``[1, 1, 128]`` bf16 LDA embedding on ``self.device``."""
        if self.speaker_encoder is None:
            self.speaker_encoder = SpeakerEncoder()
        if self.speaker_params is None:
            self.speaker_params = self.speaker_encoder.init(
                torch.Generator(self.device).manual_seed(0), self.device)
        _, lda = self.speaker_encoder(self.speaker_params, wav, sr)
        return lda.reshape(1, 1, -1).to(torch.bfloat16)

    def speaker_shape(self) -> tuple:
        """Shape of a speaker cond entry, ``[1, 1, cond_dim]``."""
        for s in self.model.prefix_conditioner.specs:
            if s.name == "speaker":
                return (1, 1, s.cond_dim)
        raise ValueError("model has no speaker conditioner")

    def quantize_int8(self) -> "ZonosPipeline":
        """Backbone projections (the transformer's, or the hybrid's Mamba and
        attention layers') and the 9 heads to int8 weight-only storage
        (``ops/quant.quantize_zonos_params``), as the JAX pipeline's
        ``quantize_int8``. The pipeline's own engine keeps an exact KV cache;
        its graph cache is cleared, so it keeps no entry (nor the bf16 tree
        such an entry holds) alive. Returns self."""
        self.params = quantize_zonos_params(self.params)
        self.engine.clear()
        return self

    def quantize_int4(self, mixed: bool = True) -> "ZonosPipeline":
        """The backbone's MLP (fc1, fc2) as packed int4 in 128-row groups with
        the clip search, as the JAX pipeline's ``quantize_int4``: with
        ``mixed`` the attention (or Mamba) projections and the heads are
        int8, else every backbone projection is int4 (the heads stay int8).
        The graph cache is cleared, as by :meth:`quantize_int8`. Returns
        self."""
        self.params = quantize_zonos_params(self.params, bits=8 if mixed else 4, mlp_bits=4)
        self.engine.clear()
        return self

    def make_cond_dict(
        self,
        text: str = "It would be nice to have time for testing, indeed.",
        language: str = "en-us",
        speaker: torch.Tensor | None = None,
        emotion: list[float] | None = None,
        fmax: float = 22050.0,
        pitch_std: float = 20.0,
        speaking_rate: float = 15.0,
        vqscore_8: list[float] | None = None,
        ctc_loss: float = 0.0,
        dnsmos_ovrl: float = 4.0,
        speaker_noised: bool = False,
        unconditional_keys: Any = frozenset({"vqscore_8", "dnsmos_ovrl"}),
        _phoneme_ids: list | None = None,  # precomputed (the batch path)
    ) -> dict:
        """The numeric cond dict, phonemized on the host. A ``speaker``
        embedding (``make_speaker_embedding``) is ``[1, 1, 128]``; without
        one the learned unconditional vector stands in."""
        language = language.lower()
        if language not in _LANGUAGE_TO_ID:
            raise ValueError(f"Unsupported language: {language}")
        emotion = emotion if emotion is not None else list(DEFAULT_EMOTION)
        vqscore_8 = vqscore_8 if vqscore_8 is not None else [0.78] * 8
        if _phoneme_ids is not None:
            phoneme_ids = _phoneme_ids
        else:
            with tracing.phase("phonemize"):
                phoneme_ids, _ = tokenize_phonemes(phonemize([text], [language]))
        cond: dict[str, Any] = {
            "espeak": phoneme_ids, "speaker": speaker, "emotion": emotion, "fmax": fmax,
            "pitch_std": pitch_std, "speaking_rate": speaking_rate,
            "language_id": _LANGUAGE_TO_ID[language], "vqscore_8": vqscore_8,
            "ctc_loss": ctc_loss, "dnsmos_ovrl": dnsmos_ovrl,
            "speaker_noised": int(speaker_noised),
        }
        for k in unconditional_keys:
            cond.pop(k, None)
        present = {s.name for s in self.model.prefix_conditioner.specs}
        out = {}
        for k, v in cond.items():
            if v is None:
                continue
            if k == "espeak":
                out[k] = torch.tensor(v, dtype=torch.long, device=self.device)
            elif k in present:
                # The speaker embedding too goes to fp32, as in JAX.
                arr = torch.as_tensor(v, dtype=torch.float32, device=self.device).reshape(1, 1, -1)
                if k == "emotion":
                    arr = arr / arr.sum(dim=-1, keepdim=True)
                out[k] = arr
        return out

    def make_batch_cond_dict(self, texts: list[str], languages: list[str] | str = "en-us",
                             speaker: torch.Tensor | None = None, **kwargs) -> dict:
        """Batched conditioning of texts of different lengths: phoneme ids
        LEFT-padded to the longest (``frontend/text.tokenize_phonemes``);
        the other entries are the first text's, broadcast over the batch,
        except the language ids, stacked ``[B, 1, 1]``."""
        if isinstance(languages, str):
            languages = [languages] * len(texts)
        if len(texts) != len(languages):
            raise ValueError("texts and languages length mismatch")
        languages = [lang.lower() for lang in languages]
        for lang in languages:
            if lang not in _LANGUAGE_TO_ID:
                raise ValueError(f"Unsupported language: {lang}")
        phoneme_ids, _ = tokenize_phonemes(phonemize(texts, languages))
        base = self.make_cond_dict(text=texts[0], language=languages[0], speaker=speaker,
                                   _phoneme_ids=[phoneme_ids[0]], **kwargs)
        base["espeak"] = torch.tensor(phoneme_ids, dtype=torch.long, device=self.device)
        if "language_id" in base:
            base["language_id"] = torch.tensor(
                [[[_LANGUAGE_TO_ID[lang]]] for lang in languages], dtype=torch.float32,
                device=self.device)
        return base

    @staticmethod
    def merge_cond_dicts(conds: list[dict], pad_len: int | None = None) -> dict:
        """Per-request cond dicts (batch 1 each, the same keys: group
        requests by their unconditional keys first) -> one batched dict.
        Phoneme ids are LEFT-padded with PAD (0) to the longest row, or to
        ``pad_len`` if that is longer (the server's length buckets)."""
        keys = set(conds[0])
        for c in conds[1:]:
            if set(c) != keys:
                raise ValueError("cond dicts have mismatched keys")
        ph = [c["espeak"] for c in conds]
        longest = max(p.shape[1] for p in ph)
        if pad_len is not None:
            longest = max(longest, pad_len)
        out = {"espeak": torch.stack([torch.nn.functional.pad(p[0], (longest - p.shape[1], 0))
                                      for p in ph])}
        for k in keys - {"espeak"}:
            out[k] = torch.cat([c[k] for c in conds], dim=0)
        return out

    def prepare_conditioning(self, cond_dict: dict, uncond_dict: dict | None = None):
        with torch.inference_mode():
            return self.model.prepare_conditioning(self.params, cond_dict, uncond_dict)

    def generate(self, cond_dict: dict, audio_prefix_codes: torch.Tensor | None = None, *,
                 generator: torch.Generator, max_new_tokens: int = 86 * 30,
                 cfg_scale: float = 2.0, sampling_params: SamplingParams | dict | None = None,
                 disable_eos: bool = False, callback=None,
                 callback_interval: int = 43) -> GenerateResult:
        """DAC codes for ``cond_dict``; ``generator`` lies on ``self.device``.
        ``callback(frames_done, step, max_steps)`` is the abort hook: called
        every ``callback_interval`` decode steps (between segments of
        ``DecodeEngine.generate_stream``), it stops the generation when it
        returns False, and what exists so far is returned."""
        with tracing.phase("conditioning"):
            prefix = self.prepare_conditioning(cond_dict)
        with tracing.phase("generate"):
            kw = dict(generator=generator, max_new_tokens=max_new_tokens, cfg_scale=cfg_scale,
                      sampling_params=sampling_params, disable_eos=disable_eos)
            if callback is None:
                result = self.engine.generate(self.params, prefix, audio_prefix_codes, **kw)
            else:
                result, step = None, 0
                it = self.engine.generate_stream(self.params, prefix, audio_prefix_codes,
                                                 chunk_steps=callback_interval, **kw)
                try:
                    for result in it:
                        step = min(step + callback_interval, max_new_tokens)
                        if callback(int(result.valid_length), step, max_new_tokens) is False:
                            break
                finally:
                    it.close()
        return result

    def generate_stream(self, cond_dict: dict, audio_prefix_codes: torch.Tensor | None = None, *,
                        generator: torch.Generator, max_new_tokens: int = 86 * 30,
                        cfg_scale: float = 2.0,
                        sampling_params: SamplingParams | dict | None = None,
                        chunk_frames: int = 43, margin_frames: int = 32):
        """Streaming synthesis: yields ``[B, samples]`` float32 waveform
        chunks as decoding goes on; their concatenation equals one-shot
        :meth:`generate` + :meth:`decode_audio` for the same generator
        state. The codes are the same (``DecodeEngine.generate_stream``),
        and each emitted span is vocoded with ``margin_frames`` of code
        context on both sides, then trimmed, so the DAC's edge effects never
        reach an emitted sample. The decoder is non-causal, so the last
        ``margin_frames`` decoded frames are withheld until more context
        arrives; the final chunk vocodes them against the true end.
        ``margin_frames`` must exceed the decoder's half receptive field in
        code frames (about 9 for the 44.1 kHz decoder)."""
        if self.dac_params is None:
            raise RuntimeError("DAC params not loaded")
        with tracing.span("conditioning", device=self.device):
            prefix = self.prepare_conditioning(cond_dict)
        hop = self.dac.hop
        emitted = 0  # frames whose samples have been yielded

        def vocode_span(codes_all, start, end, avail):
            # Decode [start - m, min(avail, end + m)) and trim both contexts.
            # The window's length rounds up to a multiple of 8 frames by
            # widening the left context (never less exact), which bounds
            # the distinct vocoder shapes of a stream.
            c0 = max(0, start - margin_frames)
            c1 = min(avail, end + margin_frames)
            c0 = max(0, c1 - (c1 - c0 + 7) // 8 * 8)
            with tracing.span("vocode", device=self.device), torch.inference_mode():
                wav = self.dac.decode(self.dac_params, codes_all[:, :, c0:c1].to(self.device))
            with tracing.span("read"):
                wav = wav[:, 0, :].float().cpu().numpy()
            off = (start - c0) * hop
            return wav[:, off: off + (end - start) * hop]

        last = None
        it = self.engine.generate_stream(
            self.params, prefix, audio_prefix_codes, generator=generator,
            max_new_tokens=max_new_tokens, cfg_scale=cfg_scale,
            sampling_params=sampling_params, chunk_steps=chunk_frames)
        try:
            for res in it:
                last = res
                stable = max(0, res.valid_length - margin_frames)  # right margin withheld
                if stable > emitted:
                    yield vocode_span(res.codes, emitted, stable, res.valid_length)
                    emitted = stable
        finally:
            it.close()  # gives the engine's cache entry back when the caller stops early
        if last is not None and last.valid_length > emitted:
            yield vocode_span(last.codes, emitted, last.valid_length, last.valid_length)

    def decode_audio(self, result: GenerateResult | torch.Tensor) -> np.ndarray:
        """Codes -> ``[B, samples]`` float32 waveform at 44.1 kHz (trimmed
        to the valid frames for a :class:`GenerateResult`)."""
        if self.dac_params is None:
            raise RuntimeError("DAC params not loaded")
        codes = result.codes if isinstance(result, GenerateResult) else result
        with tracing.phase("vocode", device=self.device), torch.inference_mode():
            wav = self.dac.decode(self.dac_params, codes.to(self.device))
            wav = wav[:, 0, :].float().cpu().numpy()
        if isinstance(result, GenerateResult):
            wav = wav[:, : result.valid_length * self.dac.hop]
        return wav

    def encode_audio(self, wav, sr: int) -> torch.Tensor:
        """Audio prefix ``[C, T]`` or ``[T]`` at ``sr`` -> ``[1, 9, T']`` int64
        codes on ``self.device``: mono mix, ``preprocess`` (44.1 kHz, padded
        to the hop), DAC encode."""
        if self.dac_params is None:
            raise RuntimeError("DAC params not loaded")
        wav = torch.as_tensor(wav, dtype=torch.float32).to(self.device)
        if wav.ndim == 2:
            wav = wav.mean(dim=0)
        with torch.inference_mode():
            wav = self.dac.preprocess(wav[None, :], sr)
            return self.dac.encode(self.dac_params, wav[:, None, :])
