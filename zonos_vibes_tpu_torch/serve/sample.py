"""Text -> WAV from the command line (the JAX package's ``serve/sample.py``):
model -> speaker embedding -> cond dict -> generate -> DAC decode -> WAV.

``--config``/``--weights`` load a reference checkpoint (``config.json`` +
``model.safetensors``); without them the pipeline draws random weights at
the flagship transformer's shapes from ``--seed``: the audio is
noise-shaped but every stage of the path runs. There is no flag for a DAC
or speaker checkpoint, as in JAX: those weights are random (the speaker
encoder's from seed 0).

    python -m zonos_vibes_tpu_torch.serve.sample --text "Hello" --out sample.wav
    python -m zonos_vibes_tpu_torch.serve.sample --speaker-wav voice.wav --out cloned.wav
"""

from __future__ import annotations

import argparse
import io
import sys
import wave

import numpy as np
import torch


def wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    """float [-1, 1] mono -> 16-bit PCM WAV bytes."""
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def read_wav(path) -> tuple[np.ndarray, int]:
    """A WAV file (path or file-like) -> float32 ``[C, T]`` and its sample
    rate (8-, 16- and 32-bit PCM)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported WAV sample width: {width}")
    return data.reshape(-1, ch).T, sr


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, help="checkpoint config.json")
    ap.add_argument("--weights", default=None, help="model.safetensors")
    ap.add_argument("--text", default="Hello, world!")
    ap.add_argument("--language", default="en-us")
    ap.add_argument("--speaker-wav", default=None)
    ap.add_argument("--seed", type=int, default=421)
    ap.add_argument("--out", default="sample.wav")
    ap.add_argument("--max-seconds", type=float, default=10.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from zonos_vibes_tpu_torch.pipeline import ZonosPipeline

    if args.config and args.weights:
        pipe = ZonosPipeline.from_local(args.config, args.weights, device=args.device)
        print("no DAC checkpoint is loaded: random DAC weights", file=sys.stderr)
        pipe.dac_params = pipe.dac.init(torch.Generator(pipe.device).manual_seed(args.seed),
                                        pipe.device)
    else:
        from zonos_vibes_tpu_torch.config import ZONOS_V01_TRANSFORMER

        pipe = ZonosPipeline.from_config(ZONOS_V01_TRANSFORMER, device=args.device)

    speaker = None
    if args.speaker_wav:
        wav, sr = read_wav(args.speaker_wav)
        speaker = pipe.make_speaker_embedding(wav, sr)

    cond = pipe.make_cond_dict(text=args.text, language=args.language, speaker=speaker)
    result = pipe.generate(cond, generator=torch.Generator(pipe.device).manual_seed(args.seed),
                           max_new_tokens=int(86 * args.max_seconds))
    wav = pipe.decode_audio(result)[0]
    with open(args.out, "wb") as f:
        f.write(wav_bytes(wav, pipe.dac.sampling_rate))
    print(f"wrote {args.out}: {wav.shape[-1] / pipe.dac.sampling_rate:.2f}s")


if __name__ == "__main__":
    main()
