"""The traffic generator: the same requests for the same seed, the same
set of sizes for every seed, and Poisson arrivals at the mix's rate."""

from __future__ import annotations

import json
import statistics
from pathlib import Path

import numpy as np
import pytest

from perfbench.lib import traffic

MIXES = Path(__file__).resolve().parent / "mixes"
SPK = [f"voice{i}.wav" for i in range(8)]


def mix(name):
    if name == "open-loop":  # the open loop's arrivals, over the solo mix's lengths
        return dict(mix("agent-solo"), loop="open", rate_per_s=1.2,
                    server={"pooled": True, "pool_slots": 8})
    return json.loads((MIXES / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["narration-closed8", "open-loop", "agent-solo"])
def test_the_same_seed_gives_the_same_requests(name):
    a = traffic.requests(mix(name), 2 ** 31 + 77, 60, SPK)
    b = traffic.requests(mix(name), 2 ** 31 + 77, 60, SPK)
    c = traffic.requests(mix(name), 2 ** 31 + 78, 60, SPK)
    assert a == b
    assert [r["payload"]["text"] for r in a] != [r["payload"]["text"] for r in c]


@pytest.mark.parametrize("name", ["narration-closed8", "open-loop"])
def test_every_seed_gets_the_same_sizes_in_another_order(name):
    m = mix(name)
    b = traffic.LENGTH_BLOCK
    sizes = [sorted(r["frames"] for r in traffic.requests(m, s, 4 * b, SPK))
             for s in (1, 2, 3 ** 20)]
    assert sizes[0] == sizes[1] == sizes[2]
    lo, hi = m["seconds"]["min"], m["seconds"]["max"]
    secs = [r["seconds"] for r in traffic.requests(m, 5, b, SPK)]
    assert lo <= min(secs) and max(secs) <= hi
    words = [r["words"] for r in traffic.requests(m, 5, b, SPK)]
    assert all(len(r["payload"]["text"].split()) == r["words"]
               for r in traffic.requests(m, 5, b, SPK))
    assert min(words) >= round(m["words_per_second"] * lo) - 1


def test_the_poisson_rate_within_its_spread():
    m = mix("open-loop")
    rate = m["rate_per_s"]
    n = 2000
    due = [r["due"] for r in traffic.requests(m, 9, n, SPK)]
    gaps = np.diff([0.0] + due)
    # The gaps of a Poisson process: mean 1 / rate, sd 1 / rate.
    assert abs(gaps.mean() - 1 / rate) < 3 / rate / np.sqrt(n)
    assert abs(gaps.std() - 1 / rate) < 0.15 / rate
    # Over many seeds the count in a window of W seconds spreads as a
    # Poisson count does: mean and variance rate * W (not smoothed).
    W, seeds = 30.0, 200
    counts = [sum(1 for r in traffic.requests(m, s, 100, SPK) if r["due"] < W)
              for s in range(seeds)]
    assert abs(statistics.mean(counts) - rate * W) < 3 * np.sqrt(rate * W / seeds)
    assert 0.8 < statistics.pvariance(counts) / (rate * W) < 1.25


@pytest.mark.parametrize("name", ["narration-closed8", "open-loop", "agent-solo"])
def test_warm_up_reaches_every_bucket_the_traffic_does(name):
    from zonos_vibes_tpu_torch.serve.server import TTSServer

    m = mix(name)
    warm = traffic.warm_payloads(m, SPK, TTSServer._bucket, TTSServer._cond_bucket)
    shapes = {(TTSServer._cond_bucket(len(p["text"]) + 2), TTSServer._bucket(p["max_new_tokens"]))
              for p in warm}
    sent = {(TTSServer._cond_bucket(len(r["payload"]["text"]) + 2),
             TTSServer._bucket(r["frames"])) for r in traffic.requests(m, 11, 400, SPK)}
    assert sent <= shapes
    assert {p["speaker_audio_path"] for p in warm} == set(SPK)


def test_speaker_voices_are_seeded():
    a, b = traffic.speaker_wav(3, 0), traffic.speaker_wav(3, 0)
    assert (a == b).all() and not (a == traffic.speaker_wav(3, 1)).all()
    assert a.dtype == np.int16 and 0 < np.abs(a).max() < 32767
