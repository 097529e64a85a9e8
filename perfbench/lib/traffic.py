"""The one traffic generator: a mix file (``perfbench/mixes/<name>.json``)
and a seed give the requests of a run.

Every seed gets the same set of sizes, in another order, so that seeds
change which request comes when and not how much work a run holds:
requested lengths come in blocks of ``LENGTH_BLOCK`` evenly spaced
quantiles of the mix's uniform range, each block shuffled; speakers come
in shuffled blocks of ``speakers``. The open loop's arrivals are a Poisson
process: independent exponential gaps at the mix's rate, drawn from the
seed, so that a window holds the bursts and lulls independent users send.
The words of each text are drawn from ``perfbench/words.txt``,
``words_per_second`` of them per second of requested audio.

Mix keys: ``loop`` (``closed`` or ``open``), ``clients`` (closed),
``rate_per_s`` (open), ``seconds`` ``{"min", "max"}``,
``words_per_second``, ``frames_per_second``, ``speakers``,
``sampling`` (the payload's sampler), ``server`` (the server's settings),
``lead_in_s`` (load before the window, counted as set-up), ``grace_s``
(how long past the window a stream may take to finish), ``trace_s`` (the
least length of a traced run's profiler stretch, which starts about two of
it before the window's end), ``check`` (how many finished requests the
reference judges).
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

WORDS = Path(__file__).resolve().parents[1] / "words.txt"
# The server's default unconditional keys (the reference contract's).
UNCONDITIONAL = ["emotion", "vqscore_8", "fmax", "pitch_std", "dnsmos_ovrl", "speaker_noised"]
LENGTH_BLOCK = 12  # requested lengths per shuffled block of evenly spaced quantiles


def words() -> list[str]:
    return [w for w in WORDS.read_text().split() if w]


def _blocks(rng: np.random.Generator, values: np.ndarray, n: int) -> np.ndarray:
    out = []
    while len(out) < n:
        out.extend(rng.permutation(values).tolist())
    return np.asarray(out[:n])


def lengths(mix: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    lo, hi, b = mix["seconds"]["min"], mix["seconds"]["max"], LENGTH_BLOCK
    q = lo + (hi - lo) * (np.arange(b) + 0.5) / b
    return _blocks(rng, q, n)


def gaps(mix: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.exponential(1.0 / float(mix["rate_per_s"]), n)


def text(rng: np.random.Generator, vocab: list[str], n_words: int) -> str:
    ws = [vocab[i] for i in rng.integers(0, len(vocab), n_words)]
    return " ".join(ws).capitalize() + "."


def payload(mix: dict, txt: str, frames: int, speaker_path: str, rid: str) -> dict:
    """A request as a client of the reference contract sends it, every
    conditioning value spelled out."""
    return {"text": txt, "speaker_audio_path": speaker_path, "language": "en-us",
            "speaking_rate": 15.0, "ctc_loss": 0.0, "cfg_scale": 2.0,
            "unconditional_keys": UNCONDITIONAL, "sampling": dict(mix["sampling"]),
            "max_new_tokens": int(frames), "stream": True, "request_id": rid}


def requests(mix: dict, seed: int, n: int, speaker_paths: list[str]) -> list[dict]:
    """The run's first ``n`` requests: ``payload``, ``seconds``, ``words``,
    ``frames``, ``speaker`` and, for the open loop, ``due`` (seconds from
    the load's start)."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), 0x5EED])
    vocab = words()
    secs = lengths(mix, rng, n)
    spk = _blocks(rng, np.arange(mix["speakers"]), n)
    due = np.cumsum(gaps(mix, rng, n)) if mix["loop"] == "open" else np.zeros(n)
    out = []
    for i in range(n):
        nw = max(1, int(round(mix["words_per_second"] * secs[i])))
        frames = int(round(mix["frames_per_second"] * secs[i]))
        out.append({"payload": payload(mix, text(rng, vocab, nw), frames,
                                       speaker_paths[int(spk[i])], f"r{i}"),
                    "seconds": float(secs[i]), "words": nw, "frames": frames,
                    "speaker": int(spk[i]), "due": float(due[i])})
    return out


def warm_payloads(mix: dict, speaker_paths: list[str], frame_bucket, text_bucket) -> list[dict]:
    """Requests that reach every shape the mix can send, each hung up at its
    first audio: for every word count the mix can ask for, its shortest and
    longest text (the list's shortest and longest words) at the shortest
    and longest length of that word count, kept once per (text bucket,
    frame bucket): the server's length buckets, by which it keys its
    captured steps (a text's length in characters stands for its phoneme
    count); then every voice once."""
    vocab = sorted(words(), key=len)
    short, long_ = vocab[0], vocab[-1]
    lo, hi, wps, fps = (mix["seconds"]["min"], mix["seconds"]["max"], mix["words_per_second"],
                        mix["frames_per_second"])
    seen, out = set(), []
    for nw in range(max(1, round(wps * lo)), round(wps * hi) + 1):
        s0, s1 = max(lo, (nw - 0.5) / wps), min(hi, (nw + 0.5) / wps)
        for s in (s0, s1):
            for w in (short, long_):
                txt = " ".join([w] * nw).capitalize() + "."
                frames = int(round(fps * s))
                key = (text_bucket(len(txt) + 2), frame_bucket(frames))
                if key in seen:
                    continue
                seen.add(key)
                spk = speaker_paths[len(out) % len(speaker_paths)]
                out.append(payload(mix, txt, frames, spk, f"w{len(out)}"))
    for i, spk in enumerate(speaker_paths[len(out):]):  # every voice at least once
        out.append(payload(mix, short.capitalize() + ".", int(round(fps * lo)), spk, f"v{i}"))
    return out


def speaker_wav(seed: int, index: int, sr: int = 16000, seconds: float = 4.0) -> np.ndarray:
    """A synthetic voice: a glottal-like harmonic series on a gliding pitch
    with formant-like weights, syllable-rate amplitude and a little noise,
    its parameters drawn from ``(seed, index)``. int16 samples."""
    rng = np.random.default_rng([int(seed) % (2 ** 63), 0x50EA, index])
    t = np.arange(int(sr * seconds)) / sr
    f0 = rng.uniform(90, 240) * (1 + 0.08 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    formants = rng.uniform([500, 1200, 2400], [900, 2000, 3200])
    wav = np.zeros_like(t)
    for h in range(1, 30):
        f = h * f0.mean()
        w = sum(math.exp(-((f - fm) / 250.0) ** 2) for fm in formants) + 0.05 / h
        wav += w * np.sin(h * phase)
    env = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(3, 5) * t) ** 2
    wav = wav * env + 0.01 * rng.standard_normal(t.shape)
    wav = 0.5 * wav / np.abs(wav).max()
    return (wav * 32767).astype(np.int16)
