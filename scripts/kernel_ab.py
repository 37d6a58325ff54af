#!/usr/bin/env python
"""Time the BCSR Triton kernel and the GNN aggregation routes on a GPU.

    python scripts/kernel_ab.py [--scale 1.0] [--bcsr-n 16384] [--json out.json]

On one GPU, in one process:

1. CSR SpMM over the GCN-normalised ogbn-arxiv-sized adjacency at F=128
   (hidden width) and F=40 (classes), f32 and bf16: ``row_mapped``
   against ``group_mapped``.
2. The 3-layer GCN train step (hidden 128, ``loss_rows``) with each
   aggregation route, f32 and bf16 aggregation.
3. BCSR SpMM, 16384^2 with 6% of 8x128 blocks, F=512, f32 and bf16: the
   kernel at two feature tiles against the einsum path.

Each case is timed twice, in the order A B C ... C B A, so drift shows
as a gap between a case's two readings. A reading is the best of three
windows of back-to-back calls ended by ``block_until_ready``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402


def window_ms(fn, args, iters=20, windows=3):
    import jax

    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters * 1e3)
    return best


def ab(cases, iters=20):
    """cases: {label: (fn, args)} -> {label: [ms_first, ms_last]}."""
    import jax

    for fn, args in cases.values():          # compile + warm
        jax.block_until_ready(fn(*args))
    order = list(cases) + list(reversed(cases))
    res = {k: [] for k in cases}
    for k in order:
        fn, args = cases[k]
        res[k].append(window_ms(fn, args, iters))
    for k, v in res.items():
        print(f"  {k:44s} {v[0]:9.4f} {v[1]:9.4f} ms", flush=True)
    return res


def csr_spmm_cases(adj, F, dtype):
    import jax

    from loops_tpu.ops.spmm import SpMMOperator

    B = jax.device_put(np.random.default_rng(0).normal(
        size=(adj.shape[1], F)).astype(np.float32))
    cases = {}
    for sched in ("row_mapped", "group_mapped"):
        op = SpMMOperator(adj, sched, dtype=dtype)
        cases[sched] = (op._jit, (op._bufs, B))
    return cases


def gcn_step_cases(data, dtype, schedules):
    import jax
    import optax

    from loops_tpu.models import GCN
    from loops_tpu.models import train as T

    g = data.graph
    dims = [data.features.shape[1], 128, 128, data.num_classes]
    cases = {}
    for sched in schedules:
        model = GCN(g, dims, dropout=0.5, dtype=dtype, schedule=sched,
                    loss_rows=data.train_mask)
        p = model.init(jax.random.PRNGKey(0))
        opt = optax.adam(1e-2)
        step = jax.jit(T.make_train_step(model, opt, data.features,
                                         data.labels, data.train_mask))
        cases[f"gcn step {sched}"] = (
            step, (p, opt.init(p), jax.random.PRNGKey(1)))
    return cases


def bcsr_cases(bcsr, F, dtype):
    import jax

    from loops_tpu.ops.kernels.spmm_bcsr import bcsr_spmm_pallas
    from loops_tpu.ops.spmm import SpMMOperator

    B = jax.device_put(np.random.default_rng(1).normal(
        size=(bcsr.shape[1], F)).astype(np.float32))
    op = SpMMOperator(bcsr, impl="xla", dtype=dtype)
    cases = {"einsum": (op._jit, (op._bufs, B))}
    for ft in (64, 128):
        bufs, fn = bcsr_spmm_pallas(bcsr, block_f=ft, dtype=dtype)
        cases[f"kernel FT {ft}"] = (jax.jit(fn), (bufs, B))
    return cases


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--bcsr-n", type=int, default=16384)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    from loops_tpu.utils.platform import (
        enable_compilation_cache,
        ensure_platform,
    )

    ensure_platform()
    enable_compilation_cache()
    import jax

    from loops_tpu.io import ogb
    from loops_tpu.utils.generate import block_sparse

    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind} x{len(jax.devices())}")
    out = {}
    data = ogb.load("ogbn-arxiv", scale=args.scale)
    adj = data.graph.gcn_normalized().adj
    for dtype in (None, "bfloat16"):
        tag = "f32" if dtype is None else "bf16"
        for F in (128, 40):
            print(f"csr spmm {tag} F={F} nnz={adj.nnz}", flush=True)
            out[f"csr_spmm_{tag}_F{F}"] = ab(csr_spmm_cases(adj, F, dtype))
    schedules = ("row_mapped", "group_mapped")
    for dtype in (None, "bfloat16"):
        tag = "f32" if dtype is None else "bf16"
        print(f"gcn train step, {tag} aggregation", flush=True)
        out[f"gcn_step_{tag}"] = ab(gcn_step_cases(data, dtype, schedules),
                                    iters=10)
    _, bcsr = block_sparse(N=args.bcsr_n, R=8, C=128, block_density=0.06)
    for dtype in (None, "bfloat16"):
        tag = "f32" if dtype is None else "bf16"
        print(f"bcsr spmm {tag} blocks={bcsr.num_blocks} F=512", flush=True)
        out[f"bcsr_spmm_{tag}"] = ab(bcsr_cases(bcsr, 512, dtype))
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(dict(device=d.device_kind, results=out), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
