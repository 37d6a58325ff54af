#!/usr/bin/env python
"""Vendor-baseline sweep: jax.experimental.sparse BCOO SpMV over the
same synthetic battery as sweep_battery.py.

The reference's headline number is best-of-3-schedules speedup vs the
*vendor* sparse library (cuSPARSE): geomean 2.66x over 4,831 matrices
(the reference's plots/data/{cusparse,heuristics}.csv). Here the
vendor analog is XLA's own sparse support, jax.experimental.sparse
(BCOO + bcoo_dot_general). This writes a ``vendor.csv`` log in the
same reference row format next to the schedule logs, so
fit_heuristic.py can report the speedup-vs-vendor column.

Uses the identical slope timer as the schedule sweep (imported, not
copied) so the comparison is methodology-matched.

    python scripts/sweep_vendor.py [out_dir] [--budget-s S]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from loops_tpu.utils.platform import (  # noqa: E402
    enable_compilation_cache,
    ensure_platform,
)

ensure_platform()
enable_compilation_cache()

from sweep_battery import time_op  # noqa: E402  (shared slope timer)


class _VendorOp:
    """Duck-typed shim with the (_jit, _bufs) surface time_op expects.

    _bufs is the BCOO matrix itself (a pytree, so it passes straight
    through jit); the op is XLA's bcoo matvec.
    """

    def __init__(self, csr):
        import jax.numpy as jnp
        import numpy as np
        from jax.experimental import sparse as jsparse

        idx = np.stack([csr.row_ids(), csr.indices], axis=1)
        self._bufs = jsparse.BCOO(
            (jnp.asarray(csr.vals), jnp.asarray(idx.astype(np.int32))),
            shape=csr.shape, indices_sorted=True, unique_indices=True)
        self._jit = lambda b, v: b @ v


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="sweep_logs")
    ap.add_argument("--max-rows", type=int, default=65536)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--budget-s", type=float, default=0)
    ap.add_argument("--population", choices=("synthetic", "statmatched"),
                    default="synthetic",
                    help="must match the schedule sweep's population")
    ap.add_argument("--statmatched-k", type=int, default=250)
    ap.add_argument("--statmatched-seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np

    from loops_tpu.utils import battery
    from loops_tpu.utils import reference
    from loops_tpu.utils.generate import make_input_vector

    os.makedirs(args.out, exist_ok=True)
    if args.population == "statmatched":
        # identical deterministic sample as sweep_battery.py's
        from loops_tpu.utils.statmatch import statmatched_battery
        mats, _ = statmatched_battery(args.statmatched_k,
                                      seed=args.statmatched_seed)
        names = sorted(mats)
    else:
        mats = battery.battery(args.max_rows)
        # same family-interleaved order as the schedule sweep, so
        # partial vendor coverage aligns with partial schedule coverage
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

    log_path = os.path.join(args.out, "vendor.csv")
    done = set()
    if os.path.exists(log_path):
        for line in open(log_path):
            parts = line.split(",")
            # only successful rows count as done: a TIMEOUT row's
            # parts[1] is also the dataset name, and marking it done
            # would permanently exclude a transiently-failing matrix
            # from the baseline on every rerun (ADVICE r2)
            if len(parts) >= 2 and parts[0] == "vendor":
                done.add(parts[1])

    log = open(log_path, "a")
    t_start = time.time()
    for i, name in enumerate(names):
        if name in done:
            continue
        if args.budget_s and time.time() - t_start > args.budget_s:
            print(f"budget reached after {i} matrices", flush=True)
            break
        csr = mats[name]()
        x = make_input_vector(csr.shape[1])
        t0 = time.time()
        try:
            op = _VendorOp(csr)
            y = np.asarray(op._jit(op._bufs, x))
            ref = reference.spmv(csr, x)
            err = np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-9)
            if err > 1e-2:
                raise ValueError(f"mismatch {err:.2e}")
            ms = time_op(op, x)
            log.write(f"vendor,{name},{csr.shape[0]},{csr.shape[1]},"
                      f"{csr.nnz},{ms:.5f}\n")
            log.flush()
            print(f"[{i+1}/{len(names)}] {name} vendor: {ms:.4f} ms "
                  f"(wall {time.time()-t0:.0f}s)", flush=True)
        except Exception as e:
            log.write(f"TIMEOUT,{name}\n")
            log.flush()
            print(f"[{i+1}/{len(names)}] {name} vendor: FAILED "
                  f"{type(e).__name__}: {e}", flush=True)
    log.close()
    print(f"vendor sweep done in {time.time()-t_start:.0f}s -> {log_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
