#!/usr/bin/env python
"""In-process schedule sweep over the synthetic battery — the
heuristic-study driver (reference: scripts/run.sh + plots notebook).

Why in-process: the reference's sweep shells one binary per (matrix,
kernel); here each process would pay interpreter + runtime + compile
startup. One process shares the runtime and uses a *dynamic-length*
chained timer (``fori_loop`` with a traced bound: one compile, two
measured lengths, the slope cancels the fixed dispatch cost).

Writes reference-format CSV logs (kernel,dataset,rows,cols,nnzs,
elapsed_ms) per schedule into the output dir — consumable by
scripts/summarize_sweep.py, scripts/plot_sweep.py and
scripts/fit_heuristic.py.

Every schedule runs through its XLA implementation (what
``schedule="auto"`` users get).

    python scripts/sweep_battery.py [out_dir] [--max-rows N] [--limit K]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from loops_tpu.utils.platform import (  # noqa: E402
    enable_compilation_cache,
    ensure_platform,
)

ensure_platform()
enable_compilation_cache()

SCHEDULES = ("row_mapped", "group_mapped", "work_oriented", "merge_path")


def _build_op(csr, sched, **kw):
    from loops_tpu.ops.spmv import SpMVOperator
    return SpMVOperator(csr, sched, **kw)


def _run_cell(csr, sched, x):
    """Build + first-call with the group_mapped escape: huge uniform
    degree classes can fail to compile; retry once with finer classes
    (class_step=0.5, same semantics).
    Returns (op, y, build_ms) — build_ms excludes compile/first-call,
    preserving the plan_ms column's preprocess-only meaning."""
    import time as _t

    import numpy as np
    try:
        t0 = _t.perf_counter()
        op = _build_op(csr, sched)
        build_ms = (_t.perf_counter() - t0) * 1e3
        return op, np.asarray(op._fn(x)), build_ms
    except Exception as first_err:
        if sched != "group_mapped":
            raise
        # the escape targets compile failures on huge uniform degree
        # classes; surface the first error so an OOM or a real
        # plan bug is never silently double-counted into build_ms
        print(f"    [group_mapped retry with class_step=0.5 after: "
              f"{type(first_err).__name__}: {first_err}]", flush=True)
        t0 = _t.perf_counter()
        op = _build_op(csr, sched, class_step=0.5)
        build_ms = (_t.perf_counter() - t0) * 1e3
        return op, np.asarray(op._fn(x)), build_ms


def dyn_chain(fn):
    """jit (bufs, x, n) -> fn^n(x) with a *traced* n: one compile.

    Non-square operators (y shape != x shape, e.g. rectangular SpMV)
    chain by re-injecting a scalar of the output into the input, which
    preserves the data dependence the timing needs."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(bufs, x, n):
        def body(i, a):
            out = fn(bufs, a)
            if out.shape == a.shape:
                return out
            return a + jnp.ravel(out)[0] * 0
        return jax.lax.fori_loop(0, n, body, x)
    return run


def time_op(op, x, lo=4, repeats=3, target_delta_s=0.08):
    """Adaptive slope timing: the dynamic fori bound means ONE compiled
    executable serves every chain length, so the hi length is scaled
    until the true work delta dwarfs the dispatch noise.
    Min of each side (paired-delta minima are biased low — they
    produced negative readings on sub-ms kernels)."""
    import jax
    import jax.numpy as jnp

    chain = dyn_chain(lambda b, v: op._jit(b, v))
    x = jnp.asarray(x)

    def t(n):
        t0 = time.perf_counter()
        jax.device_get(jnp.ravel(chain(op._bufs, x, n))[0])
        return time.perf_counter() - t0

    t(lo)                        # compile + warm
    est = max((t(64) - t(lo)) / 60, 1e-6)
    hi = min(lo + max(int(target_delta_s / est), 64), 100_000)
    for _ in range(3):
        tlo = min(t(lo) for _ in range(repeats))
        thi = min(t(hi) for _ in range(repeats))
        ms = (thi - tlo) / (hi - lo) * 1e3
        if ms > 0:
            return ms
        # slope noise swallowed a ~us kernel: lengthen the chain so the
        # true delta dwarfs the dispatch-RTT jitter and try again
        hi = min(lo + (hi - lo) * 8, 400_000)
    # retries exhausted: the non-positive slope the caller writes will
    # be dropped by load_logs, silently removing this (matrix, schedule)
    # pair from the fitter's complete-coverage set — make that visible
    print(f"WARNING: slope timing non-positive after retries "
          f"(ms={ms:.6f}); row will be dropped by load_logs", flush=True)
    return ms


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="sweep_logs")
    ap.add_argument("--max-rows", type=int, default=65536)
    ap.add_argument("--limit", type=int, default=0,
                    help="only the first K matrices (smoke mode)")
    ap.add_argument("--budget-s", type=float, default=0,
                    help="stop cleanly after this many seconds")
    ap.add_argument("--population", choices=("synthetic", "statmatched"),
                    default="synthetic",
                    help="'statmatched': size+structure-prior replicas "
                         "of the reference's 4,831-matrix SuiteSparse "
                         "sweep (utils/statmatch.py) instead of the "
                         "labeled synthetic battery")
    ap.add_argument("--statmatched-k", type=int, default=250,
                    help="sample size for --population statmatched")
    ap.add_argument("--statmatched-seed", type=int, default=0,
                    help="sample seed (replication studies)")
    args = ap.parse_args(argv)

    import numpy as np

    from loops_tpu.ops.spmv import SpMVOperator
    from loops_tpu.utils import battery
    from loops_tpu.utils.generate import make_input_vector

    os.makedirs(args.out, exist_ok=True)
    if args.population == "statmatched":
        import json

        from loops_tpu.utils.statmatch import statmatched_battery
        mats, sminfo = statmatched_battery(args.statmatched_k,
                                           seed=args.statmatched_seed)
        with open(os.path.join(args.out, "statmatch_info.json"), "w") as f:
            json.dump(sminfo, f, indent=1)
        print(f"stat-matched population: {sminfo['sampled']} sampled of "
              f"{sminfo['eligible']} eligible "
              f"({sminfo['eligible_frac']:.1%} of "
              f"{sminfo['population']}); families "
              f"{sminfo['family_counts']}", flush=True)
        # nnz-ascending: cheap matrices stream results early
        names = sorted(mats)
    else:
        mats = battery.battery(args.max_rows)
        # interleave structure families (round-robin over the name
        # prefix) so a budget-limited partial sweep spans every regime
        fams = {}
        for n in sorted(mats):
            fams.setdefault(n.split("_")[0], []).append(n)
        names = []
        for i in range(max(len(v) for v in fams.values())):
            for f in sorted(fams):
                if i < len(fams[f]):
                    names.append(fams[f][i])
    if args.limit:
        names = names[: args.limit]

    logs = {s: open(os.path.join(args.out, f"{s}.csv"), "a")
            for s in SCHEDULES}
    # per-(matrix, schedule) resume from the logs themselves, so adding
    # a new schedule re-runs only the missing column (done.txt alone
    # would skip whole matrices)
    done_pairs = set()
    for s in SCHEDULES:
        p = os.path.join(args.out, f"{s}.csv")
        if os.path.exists(p):
            for line in open(p):
                parts = line.strip().split(",")
                if len(parts) >= 2:
                    done_pairs.add((parts[1], s))
    done_key = os.path.join(args.out, "done.txt")

    t_start = time.time()
    for i, name in enumerate(names):
        if all((name, s) in done_pairs for s in SCHEDULES):
            continue
        if args.budget_s and time.time() - t_start > args.budget_s:
            print(f"budget reached after {i} matrices", flush=True)
            break
        csr = mats[name]()
        x = make_input_vector(csr.shape[1])
        ref = None
        row = f"{csr.shape[0]},{csr.shape[1]},{csr.nnz}"
        for sched in SCHEDULES:
            if (name, sched) in done_pairs:
                continue
            t0 = time.time()
            try:
                import warnings
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    op, y, plan_ms = _run_cell(csr, sched, x)
                if ref is None:
                    from loops_tpu.utils import reference
                    ref = reference.spmv(csr, x)
                err = np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-9)
                if err > 1e-2:
                    raise ValueError(f"mismatch {err:.2e}")
                ms = time_op(op, x)
                # 7th column: host plan/build cost (the reference's
                # preprocess-vs-kernel separation, merge_path_flat.cuh:
                # 97-138); consumers index cols 0-5 so it is additive
                logs[sched].write(
                    f"{sched},{name},{row},{ms:.5f},{plan_ms:.2f}\n")
                logs[sched].flush()
                print(f"[{i+1}/{len(names)}] {name} {sched}: {ms:.4f} ms "
                      f"(wall {time.time()-t0:.0f}s)", flush=True)
            except Exception as e:
                logs[sched].write(f"TIMEOUT,{name}\n")
                logs[sched].flush()
                print(f"[{i+1}/{len(names)}] {name} {sched}: FAILED "
                      f"{type(e).__name__}: {e}", flush=True)
        with open(done_key, "a") as f:
            f.write(name + "\n")
    for f in logs.values():
        f.close()
    print(f"sweep done in {time.time()-t_start:.0f}s -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
