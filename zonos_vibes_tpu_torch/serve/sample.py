"""Text -> WAV from the command line (the JAX package's ``serve/sample.py``).

With no checkpoint in the repository the pipeline draws random weights at
the flagship transformer's shapes from ``--seed``; the audio is noise-shaped
but every stage of the path runs.

    python -m zonos_vibes_tpu_torch.serve.sample --text "Hello" --out sample.wav
"""

from __future__ import annotations

import argparse
import io
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


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--text", default="Hello, world!")
    ap.add_argument("--language", default="en-us")
    ap.add_argument("--seed", type=int, default=421)
    ap.add_argument("--out", default="sample.wav")
    ap.add_argument("--max-seconds", type=float, default=10.0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from zonos_vibes_tpu_torch.config import ZONOS_V01_TRANSFORMER
    from zonos_vibes_tpu_torch.pipeline import ZonosPipeline

    pipe = ZonosPipeline.from_config(ZONOS_V01_TRANSFORMER, device=args.device)
    cond = pipe.make_cond_dict(text=args.text, language=args.language)
    result = pipe.generate(cond, generator=torch.Generator(pipe.device).manual_seed(args.seed),
                           max_new_tokens=int(86 * args.max_seconds))
    wav = pipe.decode_audio(result)[0]
    with open(args.out, "wb") as f:
        f.write(wav_bytes(wav, pipe.dac.sampling_rate))
    print(f"wrote {args.out}: {wav.shape[-1] / pipe.dac.sampling_rate:.2f}s")


if __name__ == "__main__":
    main()
