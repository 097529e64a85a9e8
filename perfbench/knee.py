#!/usr/bin/env python3
"""The knee of an open-loop mix on a configuration: the highest arrival
rate the server sustains without a growing backlog. One process, one
set-up, then one window per rate (the mix's ``rate_per_s`` replaced),
lowest first, each drained before the next.

    python3 perfbench/knee.py --config zonos-v0.1-transformer.int8 \\
        --traffic <open-loop mix> --seed 7 --rates 1,1.5,2,2.5,3 --seconds 20

For each rate it prints one JSON line: requests due in the window, time to
first audio (median and 90th percentile, ms) over the window's first and
second halves, and the backlog at the window's end (requests due by then
whose first audio had not come). A rate holds when the backlog at the end
is at most ``--backlog`` requests and the second half's median time to
first audio is at most 1.5 times the first half's. The last line names
the knee (the highest rate that holds below the first that does not) and
four fifths of it, the cell's rate.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench import run as R  # noqa: E402
from perfbench.lib import loadgen, traffic  # noqa: E402
from perfbench.lib.stats import percentile  # noqa: E402


def sweep(run: R.Run, rates: list[float], backlog_limit: int) -> list[dict]:
    speakers = []
    for i in range(run.mix["speakers"]):
        path = run.tmp / f"voice{i}.wav"
        R.write_wav(path, traffic.speaker_wav(run.seed, i), 16000)
        speakers.append(str(path))
    pipe, obs, srv, _ = run.setup(speakers)
    out = []
    try:
        for rate in rates:
            mix = dict(run.mix, rate_per_s=rate)
            lead = float(mix["lead_in_s"])
            n = int(rate * (lead + run.seconds) * 1.2) + 20
            reqs = traffic.requests(mix, run.seed, n, speakers)
            load_at = time.monotonic() + 0.5
            t0, t1 = load_at + lead, load_at + lead + run.seconds
            recs = run._call({"op": "run", "port": srv.port, "requests": reqs, "loop": "open",
                              "clients": 0, "start_at": load_at, "stop_at": t1,
                              "give_up_at": t1 + float(mix["grace_s"])},
                             timeout=t1 - time.monotonic() + float(mix["grace_s"]) + 120)["records"]
            due = [r for r in recs if t0 <= r["due"] < t1]

            def ttfa(r):
                return (r["chunks"][0][0] - r["due"]) * 1000.0 if r["chunks"] else float("inf")

            mid = (t0 + t1) / 2
            first = [ttfa(r) for r in due if r["due"] < mid]
            second = [ttfa(r) for r in due if r["due"] >= mid]
            backlog = sum(1 for r in recs if r["due"] < t1 and (not r["chunks"]
                                                                 or r["chunks"][0][0] > t1))
            m1 = statistics.median(first) if first else float("inf")
            m2 = statistics.median(second) if second else float("inf")
            row = {"rate_per_s": rate, "due": len(due), "backlog_at_end": backlog,
                   "ttfa_median_ms": [m1, m2],
                   "ttfa_p90_ms": [percentile(first, 90), percentile(second, 90)],
                   "holds": backlog <= backlog_limit and m2 <= 1.5 * m1}
            print(json.dumps(row), flush=True)
            out.append(row)
    finally:
        srv.shutdown()
        obs.uninstall()
        del pipe
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--backlog", type=int, default=2)
    args = ap.parse_args()
    spec = R.cell_spec("knee", args.config, args.traffic)
    run = R.Run(spec, args.seed, args.seconds, traced=False)
    run.tmp = Path(tempfile.mkdtemp(prefix="perfbench-knee-"))
    ctx = multiprocessing.get_context("spawn")
    conn, child_conn = ctx.Pipe()
    child = ctx.Process(target=loadgen.child_main, args=(child_conn,), daemon=True)
    child.start()
    run._conn, run._child = conn, child
    try:
        rows = sweep(run, [float(r) for r in args.rates.split(",")], args.backlog)
    finally:
        conn.send({"op": "quit"})
        child.join(30)
        shutil.rmtree(run.tmp, ignore_errors=True)
    knee = None
    for row in rows:
        if not row["holds"]:
            break
        knee = row["rate_per_s"]
    print(json.dumps({"knee_per_s": knee, "cell_rate_per_s": None if knee is None else 0.8 * knee}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
