#!/usr/bin/env python
"""Plot sweep CSV logs — the reference's plots notebook analog
(reference: plots/performance_evaluation.ipynb, Figures 2-4 of the
PPoPP'23 paper) rendered with matplotlib from scripts/run.sh output.

    python scripts/plot_sweep.py sweep_logs/ [out.png]

Panels:
  1. per-schedule elapsed ECDFs (log-x) — the distribution view
  2. oracle (best-of-schedules) speedup over the best *fixed* schedule
  3. oracle schedule mix — how often each schedule wins
  4. (when vendor.csv exists) best-of-schedules speedup vs the vendor
     sparse library — the reference's headline cuSPARSE figure
"""
from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from summarize_sweep import load_logs  # noqa: E402

# fixed schedule -> color assignment (validated categorical order;
# color follows the schedule identity in every panel)
COLORS = {
    "row_mapped": "#2a78d6",
    "group_mapped": "#eb6834",
    "work_oriented": "#1baf7a",
    "merge_path": "#eda100",
}
SURFACE, INK, MUTED = "#fcfcfb", "#0b0b0b", "#52514e"


def _style(ax):
    ax.set_facecolor(SURFACE)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)
    for side in ("left", "bottom"):
        ax.spines[side].set_color(MUTED)
    ax.tick_params(colors=MUTED, labelsize=8)
    ax.grid(True, color=MUTED, alpha=0.15, linewidth=0.5)
    ax.set_axisbelow(True)


def _ecdf(vals):
    v = np.sort(np.asarray(vals, float))
    return v, np.arange(1, len(v) + 1) / len(v)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    log_dir = argv[0] if argv else "sweep_logs"
    out = argv[1] if len(argv) > 1 else os.path.join(log_dir, "sweep.png")

    raw = load_logs(log_dir)
    # vendor baseline rows (sweep_vendor.py) feed the 4th panel
    vendor = {ds: r["vendor"] for ds, r in raw.items() if "vendor" in r}
    # load_logs ingests every *.csv in the directory; restrict each run
    # to the known schedules so stray logs (pallas/impl variants) can't
    # break the win counts or the completeness check below.
    runs = {ds: {s: v for s, v in r.items() if s in COLORS}
            for ds, r in raw.items()}
    runs = {ds: r for ds, r in runs.items() if r}
    if not runs:
        print(f"no sweep logs under {log_dir}")
        return 1

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    scheds = [s for s in COLORS if any(s in r for r in runs.values())]
    vds = sorted(ds for ds in vendor if ds in runs)
    n_panels = 4 if vds else 3
    fig, axes = plt.subplots(1, n_panels, figsize=(4 * n_panels, 3.6),
                             facecolor=SURFACE)

    # 1 — elapsed distributions
    ax = axes[0]
    _style(ax)
    for s in scheds:
        vals = [r[s] for r in runs.values() if s in r]
        if not vals:
            continue
        x, y = _ecdf(vals)
        ax.plot(x, y, color=COLORS[s], linewidth=2, label=s,
                drawstyle="steps-post")
    ax.set_xscale("log")
    ax.set_xlabel("elapsed (ms)", color=MUTED, fontsize=9)
    ax.set_ylabel("fraction of matrices", color=MUTED, fontsize=9)
    ax.set_title("SpMV elapsed, ECDF per schedule", color=INK, fontsize=10)
    ax.legend(frameon=False, fontsize=8, labelcolor=INK)

    # 2 — oracle speedup over the best fixed schedule
    ax = axes[1]
    _style(ax)
    complete = {ds: r for ds, r in runs.items() if len(r) == len(scheds)}
    if complete:
        geomeans = {s: np.exp(np.mean([np.log(r[s])
                                       for r in complete.values()]))
                    for s in scheds}
        fixed = min(geomeans, key=geomeans.get)
        sp = [r[fixed] / min(r.values()) for r in complete.values()]
        x, y = _ecdf(sp)
        ax.plot(x, y, color=COLORS[fixed], linewidth=2,
                drawstyle="steps-post")
        gm = float(np.exp(np.mean(np.log(sp))))
        ax.axvline(gm, color=MUTED, linewidth=1, linestyle="--")
        ax.annotate(f"geomean {gm:.2f}x", (gm, 0.1), color=INK,
                    fontsize=8, xytext=(4, 0), textcoords="offset points")
        ax.set_title(f"oracle speedup over fixed {fixed}",
                     color=INK, fontsize=10)
        if max(sp) / max(min(sp), 1e-9) > 20:
            ax.set_xscale("log")
    ax.set_xlabel("speedup (x)", color=MUTED, fontsize=9)
    ax.set_ylabel("fraction of matrices", color=MUTED, fontsize=9)

    # 3 — oracle schedule mix
    ax = axes[2]
    _style(ax)
    wins = {s: 0 for s in scheds}
    for r in runs.values():
        if r:
            wins[min(r, key=r.get)] += 1
    ax.bar(range(len(scheds)), [wins[s] for s in scheds],
           color=[COLORS[s] for s in scheds], width=0.55)
    for i, s in enumerate(scheds):
        ax.annotate(str(wins[s]), (i, wins[s]), ha="center", va="bottom",
                    color=INK, fontsize=8)
    ax.set_xticks(range(len(scheds)))
    ax.set_xticklabels(scheds, rotation=20, ha="right", color=INK,
                       fontsize=8)
    ax.set_ylabel("matrices won", color=MUTED, fontsize=9)
    ax.set_title("oracle schedule mix", color=INK, fontsize=10)

    # 4 — best-of-schedules speedup vs the vendor sparse library (the
    # reference's headline figure: best-of-3 vs cuSPARSE, geomean 2.66x)
    if vds:
        ax = axes[3]
        _style(ax)
        # complete schedule coverage only, matching the fitter's
        # complete-coverage metric: a partially-swept dataset's
        # min-over-logged-schedules is biased low-N (ADVICE r2)
        n_partial = sum(1 for ds in vds
                        if len(runs[ds]) < len(scheds))
        vds = [ds for ds in vds if len(runs[ds]) == len(scheds)]
        sp = [vendor[ds] / min(runs[ds].values()) for ds in vds] or [1.0]
        x, y = _ecdf(sp)
        ax.plot(x, y, color=INK, linewidth=2, drawstyle="steps-post")
        gm = float(np.exp(np.mean(np.log(sp))))
        ax.axvline(gm, color=MUTED, linewidth=1, linestyle="--")
        ax.axvline(1.0, color=MUTED, linewidth=0.8, alpha=0.5)
        ax.annotate(f"geomean {gm:.2f}x", (gm, 0.1), color=INK,
                    fontsize=8, xytext=(4, 0), textcoords="offset points")
        if max(sp) / max(min(sp), 1e-9) > 20:
            ax.set_xscale("log")
        ax.set_xlabel("speedup (x)", color=MUTED, fontsize=9)
        ax.set_ylabel("fraction of matrices", color=MUTED, fontsize=9)
        ax.set_title(f"best-of-schedules vs vendor BCOO "
                     f"(n={len(vds)} complete, {n_partial} partial "
                     f"excluded)", color=INK, fontsize=10)

    fig.tight_layout()
    fig.savefig(out, dpi=150, facecolor=SURFACE)
    print(f"wrote {out} ({len(runs)} datasets, {len(scheds)} schedules)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
