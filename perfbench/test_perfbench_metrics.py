"""The end-to-end metrics' window arithmetic: a rate over all of the
window, tails over every sample, and a stall inside the window that moves
the tails."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench.run import reader

SR2 = 2 * 44100  # bytes of 16-bit PCM per second of audio


def stream(due, first, n, every, nbytes=SR2 // 2):
    """A request due at ``due`` whose chunks arrive from ``first`` on, one
    each ``every`` seconds."""
    return {"due": due, "sent": due, "status": 200, "end": first + n * every,
            "chunks": [(first + i * every, nbytes) for i in range(n)], "error": None}


def ctx(records, window=(10.0, 20.0), give_up=30.0):
    return SimpleNamespace(window=window, records=records, give_up_at=give_up,
                           seconds=window[1] - window[0], mix={"loop": "open"})


def steady():
    return [stream(10.0 + i, 10.5 + i, 10, 0.4) for i in range(10)]


def test_rate_counts_every_chunk_inside_the_window():
    recs = [stream(5.0, 5.0, 100, 0.25)]  # 4 chunks a second of 0.5 s each, 5 .. 30 s
    got = reader("audio_s_per_s")(ctx(recs))
    assert got == pytest.approx(40 * 0.5 / 10.0)
    # Chunks outside the window do not count.
    assert reader("audio_s_per_s")(ctx(recs, window=(31.0, 41.0))) == 0.0


def test_ttfa_tail_over_every_request_due_in_the_window():
    recs = steady()
    assert reader("ttfa_p90_ms")(ctx(recs)) == pytest.approx(500.0)
    # A request due in the window with no audio counts at the grace's end.
    recs[3] = dict(recs[3], chunks=[], status=500)
    assert reader("ttfa_p90_ms")(ctx(recs)) == pytest.approx(500.0)
    recs[4] = dict(recs[4], chunks=[], status=500)
    assert reader("ttfa_p90_ms")(ctx(recs)) == pytest.approx((30.0 - 14.0) * 1000)
    # Requests due outside the window are not counted.
    late = steady() + [stream(25.0, 29.0, 2, 0.4)]
    assert reader("ttfa_p90_ms")(ctx(late)) == pytest.approx(500.0)


def test_a_stall_in_the_window_moves_both_tails():
    base = ctx(steady())
    gap0, ttfa0 = reader("chunk_gap_p95_ms")(base), reader("ttfa_p90_ms")(base)
    assert gap0 == pytest.approx(400.0)
    stalled = []
    for r in steady():  # the server stops for 2 s at t = 15
        chunks = [(t + 2.0 if t >= 15.0 else t, n) for t, n in r["chunks"]]
        stalled.append(dict(r, chunks=chunks))
    c = ctx(stalled)
    assert reader("chunk_gap_p95_ms")(c) > gap0 + 1500
    assert reader("ttfa_p90_ms")(c) > ttfa0 + 1000


def test_chunk_gaps_only_inside_the_window():
    recs = [stream(0.0, 0.5, 100, 0.3)]
    recs[0]["chunks"].insert(0, (0.1, 10))  # a gap before the window
    assert reader("chunk_gap_p95_ms")(ctx(recs)) == pytest.approx(300.0)


def test_generator_lag_is_the_send_time_past_due():
    recs = steady()
    for i, r in enumerate(recs):
        r["sent"] = r["due"] + 0.001 * i
    assert reader("gen_lag_ms_p99")(ctx(recs)) == pytest.approx(9.0)
