#!/usr/bin/env python3
"""Runs of one cell, one process each, in turn, and their spread: the tool
behind the bounds in ``BENCHMARK.json``.

    python3 perfbench/sets.py --workload <cell> --seeds 11,12,13 [--seconds S] [--trace 0|1]
        [--sets 2] [--out chiprun_out/perfbench]

Each run is ``perfbench/run.py`` with its seed; with ``--sets 2`` the same
seeds run twice, as the two sets of a bound's measurement. Every run's
result line goes to ``<out>/<cell>.jsonl`` (with its wall time and exit
code); the end of its standard error to ``<out>/<cell>.err``. At the end it
prints, per metric, each set's values, median and spread (the distance
between the first and third quartile, ``statistics.quantiles(n=4)``, over
the median) and whether every run was correct.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench.lib.stats import spread  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "perfbench"))
    args = ap.parse_args()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or bench["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    sets: list[list[dict]] = []
    for k in range(args.sets):
        rows = []
        for seed in seeds:
            t = time.monotonic()
            cmd = [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
                   args.workload, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(args.trace), "--control", str(args.control)]
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
            wall = time.monotonic() - t
            last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
            try:
                res = json.loads(last)
            except json.JSONDecodeError:
                res = {"correct": False, "metrics": {}, "error": last[-500:]}
            res.update(seed=seed, set=k, wall_s=wall, rc=p.returncode, trace=args.trace)
            rows.append(res)
            with open(out / f"{args.workload}.jsonl", "a") as f:
                f.write(json.dumps(res) + "\n")
            with open(out / f"{args.workload}.err", "a") as f:
                f.write(f"=== set {k} seed {seed} rc {p.returncode} wall {wall:.1f}\n")
                notes = [ln for ln in p.stderr.splitlines() if not ln.startswith('{"ts"')]
                f.write("\n".join(notes)[-6000:] + "\n")
            print(f"set {k} seed {seed} rc {p.returncode} wall {wall:.1f} s correct "
                  f"{res.get('correct')} {json.dumps(res.get('metrics'))} "
                  f"check {json.dumps(res.get('check'))}",
                  flush=True)
        sets.append(rows)
    names = sorted({m for rows in sets for r in rows for m in r.get("metrics", {})})
    for name in names:
        for k, rows in enumerate(sets):
            vals = [r["metrics"][name]["value"] for r in rows if name in r.get("metrics", {})]
            if len(vals) >= 2:
                print(f"{name} set {k}: median {statistics.median(vals)} spread "
                      f"{spread(vals)} values {vals}")
    print("all correct:", all(r.get("correct") for rows in sets for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
