#!/usr/bin/env python
"""Out-of-core staging benchmark — papers100M-shaped, scaled by --nodes.

Builds a power-law adjacency of the requested size, stages it into a
memmapped ShardedCSR, then measures partition-then-plan throughput and
a full streamed aggregation pass with a disk-backed feature table.

Runs on the CPU backend as shown; on a GPU host the same shards feed
DistSpMM/DistSpMMHalo over the mesh.

    LOOPS_PLATFORM=cpu python scripts/bench_outofcore.py \
        --nodes 10000000 --avg-deg 15 --shards 16 --feat 128
"""
from __future__ import annotations

import argparse
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from loops_tpu.utils.platform import ensure_platform  # noqa: E402

ensure_platform()


def powerlaw_csr(n: int, avg_deg: int, seed: int = 0):
    """Adjacency-only zipf-flavored digraph, built in O(E) memory.

    Large n (>= 2^22) takes the billion-edge path: closed-form inverse-
    CDF zipf draws (``n**u`` instead of an alias table over n
    probabilities) and the native counting-sort COO->CSR
    (native/src/coo_to_csr.cpp) with no dedup pass — duplicate edges
    simply act as weight-2 edges, which is fine for a staging
    benchmark and keeps peak memory at ~3 copies of the edge list.
    """
    from loops_tpu.formats import COO, CSR

    rng = np.random.default_rng(seed)
    m = n * avg_deg
    if n >= 1 << 22:
        # P(rank <= k) ~ ln(k)/ln(n) for zipf(1)  =>  rank = n**u;
        # chunked so the f64 temporaries stay ~1 GB
        src = np.empty(m, np.int32)
        step = 1 << 27
        for i in range(0, m, step):
            u = rng.random(min(step, m - i))
            src[i:i + len(u)] = np.minimum(
                (n ** u).astype(np.int64) - 1, n - 1).astype(np.int32)
        dst = rng.integers(0, n, size=m, dtype=np.int32)
        from loops_tpu.native.convert import coo_to_csr
        nat = coo_to_csr(dst, src, np.ones(m, np.float32), n)
        if nat is not None:
            offsets, cols, vals = nat
            return CSR((n, n), offsets.astype(np.int64), cols, vals)
        order = np.argsort(dst, kind="stable")
        dst, src = dst[order], src[order]
        offsets = np.searchsorted(dst, np.arange(n + 1)).astype(np.int64)
        return CSR((n, n), offsets, src.astype(np.int32),
                   np.ones(m, np.float32))
    ranks = np.arange(1, n + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.log(n + 1)  # ~zipf normalizer
    probs /= probs.sum()
    src = rng.choice(n, size=m, p=probs).astype(np.int32)
    dst = rng.integers(0, n, size=m, dtype=np.int32)
    coo = COO((n, n), dst, src, np.ones(m, np.float32))
    coo = coo.sort_by_row().remove_duplicates(op="sum")
    return CSR.from_coo(coo)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nodes", type=int, default=2_000_000)
    p.add_argument("--avg-deg", type=int, default=15)
    p.add_argument("--shards", type=int, default=16)
    p.add_argument("--feat", type=int, default=128)
    p.add_argument("--dir", default="sweep_logs/shards")
    args = p.parse_args(argv)

    from loops_tpu.io.shards import ShardedCSR, StreamedSpMM

    t0 = time.perf_counter()
    csr = powerlaw_csr(args.nodes, args.avg_deg)
    print(f"graph: {csr.shape[0]:,} nodes {csr.nnz:,} edges "
          f"(built {time.perf_counter()-t0:.1f}s)", flush=True)

    shutil.rmtree(args.dir, ignore_errors=True)
    t0 = time.perf_counter()
    sharded = ShardedCSR.build(csr, args.shards, args.dir)
    dt = time.perf_counter() - t0
    import os
    nbytes = sum(os.path.getsize(f"{args.dir}/{f}")
                 for f in os.listdir(args.dir))
    print(f"stage: {args.shards} shards, {nbytes/2**20:.0f} MiB in "
          f"{dt:.1f}s ({csr.nnz/dt/1e6:.1f} M edges/s)", flush=True)

    t0 = time.perf_counter()
    blocks = 0
    for s in range(args.shards):
        plan = sharded.plan(s, "merge_path", block_work=4096)
        blocks += plan.num_blocks
    dt = time.perf_counter() - t0
    print(f"plan:  merge_path x{args.shards} shards, {blocks:,} blocks "
          f"in {dt:.1f}s ({csr.nnz/dt/1e6:.1f} M edges/s)", flush=True)

    # disk-backed feature table + output
    X = np.lib.format.open_memmap(
        f"{args.dir}/X.npy", mode="w+", dtype=np.float32,
        shape=(csr.shape[1], args.feat))
    rng = np.random.default_rng(1)
    for i in range(0, csr.shape[1], 1 << 20):
        X[i:i + (1 << 20)] = rng.normal(
            size=(min(1 << 20, csr.shape[1] - i), args.feat)
        ).astype(np.float32)
    Y = np.lib.format.open_memmap(
        f"{args.dir}/Y.npy", mode="w+", dtype=np.float32,
        shape=(csr.shape[0], args.feat))
    t0 = time.perf_counter()
    op = StreamedSpMM(sharded)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    op(X, out=Y)
    dt = time.perf_counter() - t0
    print(f"spmm:  streamed F={args.feat} in {dt:.1f}s "
          f"({csr.nnz/dt/1e6:.1f} M edges/s incl. host gathers; "
          f"setup {setup:.1f}s)", flush=True)

    # spot-check a row against the direct computation
    r = int(np.argmax(np.diff(csr.offsets)))  # heaviest row
    a0, a1 = csr.offsets[r], csr.offsets[r + 1]
    want = (csr.vals[a0:a1, None] * X[csr.indices[a0:a1]]).sum(axis=0)
    ok = np.allclose(Y[r], want, atol=1e-2, rtol=1e-3)
    print(f"check: heaviest row ({a1-a0} nnz) {'OK' if ok else 'MISMATCH'}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
