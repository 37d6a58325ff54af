#!/usr/bin/env python
"""Summarize sweep CSV logs (the plots-notebook analog, reference:
plots/performance_evaluation.ipynb): per-schedule geomean elapsed,
win counts, and the best-of-all-schedules "oracle" mix.

    python scripts/summarize_sweep.py sweep_logs/
"""
from __future__ import annotations

import os
import sys
from collections import defaultdict

import numpy as np

COLS = ["kernel", "dataset", "rows", "cols", "nnzs", "elapsed"]


def load_logs(d):
    runs = defaultdict(dict)  # dataset -> schedule -> elapsed
    for fname in sorted(os.listdir(d)):
        if not fname.endswith(".csv"):
            continue
        sched = fname[:-4]
        for line in open(os.path.join(d, fname)):
            parts = line.strip().split(",")
            # col 0 echoes the schedule in every sweep log row — bare
            # (sweep_battery.py) or format-prefixed (run.sh via
            # examples/spmv.py prints "{format}_{schedule}"). Requiring
            # the stem match skips TIMEOUT markers and foreign CSVs that
            # later land in the dir (e.g. the fitter's heuristics.csv).
            if len(parts) < 6 or not (
                    parts[0] == sched or parts[0].endswith("_" + sched)):
                continue
            ms = float(parts[5])
            if ms <= 0:     # slope-timing noise on a ~us kernel
                continue
            runs[parts[1]][sched] = ms
    return runs


SCHEDULES = ("row_mapped", "group_mapped", "work_oriented",
             "merge_path")


def main(argv):
    d = argv[0] if argv else "sweep_logs"
    raw = load_logs(d)
    # restrict to the known schedules: load_logs ingests every *.csv in
    # the directory, so a vendor.csv baseline (sweep_vendor.py) or a
    # stray impl-variant log would otherwise be counted as a schedule
    # and corrupt the win counts / oracle geomean (ADVICE r2, medium)
    vendor = {ds: r["vendor"] for ds, r in raw.items() if "vendor" in r}
    runs = {ds: {s: v for s, v in r.items() if s in SCHEDULES}
            for ds, r in raw.items()}
    runs = {ds: r for ds, r in runs.items() if r}
    if not runs:
        print(f"no sweep logs under {d}")
        return 1
    scheds = sorted({s for r in runs.values() for s in r})
    print(f"{len(runs)} datasets x {len(scheds)} schedules\n")
    print(f"{'schedule':16s} {'geomean ms':>12s} {'wins':>6s}")
    wins = defaultdict(int)
    for ds, r in runs.items():
        if r:
            wins[min(r, key=r.get)] += 1
    for s in scheds:
        vals = [r[s] for r in runs.values() if s in r]
        gm = float(np.exp(np.mean(np.log(vals)))) if vals else float("nan")
        print(f"{s:16s} {gm:12.4f} {wins[s]:6d}")
    oracle = [min(r.values()) for r in runs.values() if r]
    print(f"\noracle geomean: {np.exp(np.mean(np.log(oracle))):.4f} ms")
    if vendor:
        # reported separately from the schedule table by design: the
        # vendor baseline competes against the oracle, it is not a
        # schedule of ours
        both = [ds for ds in vendor if ds in runs]
        if both:
            sp = [vendor[ds] / min(runs[ds].values()) for ds in both]
            gm = float(np.exp(np.mean(np.log(sp))))
            print(f"vendor baseline: {len(vendor)} matrices; "
                  f"best-of-schedules vs vendor geomean {gm:.2f}x "
                  f"on {len(both)} joined")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
