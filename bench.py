#!/usr/bin/env python
"""Benchmark of the sparse ops and GNN training steps on one GPU.

    python bench.py

Prints the device, then progress lines on stderr, and ONE JSON line on
stdout:

    {"metric": "spmm_gflops", "value": N, "unit": "GFLOP/s",
     "vs_baseline": F, "device": {...}, "extras": [...]}

1. Two probes of what the card reaches: a large copy (bytes/s) and a
   large bf16 matmul (FLOP/s), beside the launch box's published peaks.
2. The headline: block-sparse SpMM (16384², dense 8x128 blocks at ~6%
   block fill, F=512) through the BCSR kernel, checked against a host
   float64 reference on 256 sampled rows. ``vs_baseline`` is the time
   the minimum traffic (A payload + B + C once each) takes at the
   published HBM rate, over the measured time.
3. Sub-benchmarks: bf16 BCSR SpMM, CSR SpMV (merge_path and auto), BCSR
   SpMV, the CSR SpMM that GNN layers aggregate with, bf16 SDDMM, and
   the GCN and GAT train steps on the ogbn-arxiv-sized graph.

No sub-benchmark catches its own failure: a failing one fails the run.
Times come from back-to-back calls ended by ``block_until_ready``.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 1)[0])


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def steady_ms(fn, *args, iters=20, windows=3):
    """Best-of-``windows`` ms per call of back-to-back ``fn(*args)``."""
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters * 1e3)
    return best


def probe_copy_gbps(n_bytes=1 << 30):
    """Bytes/s of a large device copy (read + write counted)."""
    import jax
    import jax.numpy as jnp

    x = jnp.ones(n_bytes // 4, jnp.float32)
    ms = steady_ms(jax.jit(lambda v: v + 1.0), x, iters=10)
    return 2 * n_bytes / (ms * 1e-3) / 1e9


def probe_matmul_tflops(n=8192):
    """FLOP/s of a large bf16 matmul with f32 accumulation."""
    import jax
    import jax.numpy as jnp

    a = jnp.ones((n, n), jnp.bfloat16)
    f = jax.jit(lambda u, v: jnp.dot(u, v,
                                     preferred_element_type=jnp.float32))
    ms = steady_ms(f, a, a, iters=10)
    return 2 * n ** 3 / (ms * 1e-3) / 1e12


def check_rows(csr, y, B, n=256, seed=7):
    """Relative error of ``y`` on ``n`` sampled rows vs host float64."""
    from loops_tpu.models.message_passing import _take_rows_csr
    from loops_tpu.utils import reference

    rows = np.sort(np.random.default_rng(seed).choice(
        csr.shape[0], n, replace=False))
    ref = reference.spmm(_take_rows_csr(csr, rows), np.asarray(B),
                         dtype=np.float64)
    err = np.abs(np.asarray(y)[rows] - ref).max()
    return float(err / max(np.abs(ref).max(), 1e-30))


def main():
    import jax
    import jax.numpy as jnp

    from loops_tpu.ops.spmm import SpMMOperator
    from loops_tpu.tuning import launch_params
    from loops_tpu.utils.generate import block_sparse, random_csr
    from loops_tpu.utils.platform import (
        enable_compilation_cache,
        ensure_platform,
    )

    ensure_platform()
    enable_compilation_cache()
    d = jax.devices()[0]
    device = dict(platform=d.platform, kind=d.device_kind,
                  count=len(jax.devices()))
    params = launch_params()
    log(f"# device {device}; peaks: {params.hbm_gbps} GB/s, "
        f"{params.peak_bf16_tflops} TFLOP/s bf16 ({params.source})")
    extras = []

    # 1 — what the card reaches
    gbps, tflops = probe_copy_gbps(), probe_matmul_tflops()
    log(f"# copy {gbps:.0f} GB/s, bf16 matmul {tflops:.0f} TFLOP/s")
    extras.append({"metric": "copy_gbps", "value": round(gbps, 1)})
    extras.append({"metric": "bf16_matmul_tflops", "value": round(tflops, 1)})

    # 2 — block-sparse SpMM headline
    N, F, R, C = 16384, 512, 8, 128
    csr, bcsr = block_sparse(N=N, R=R, C=C)
    flops = 2 * csr.nnz * F
    B = jax.device_put(np.random.default_rng(1).normal(
        size=(N, F)).astype(np.float32))
    op = SpMMOperator(bcsr, impl="pallas")
    rel = check_rows(csr, op(B), B)
    # f32 result through an IEEE f32 dot (Precision.HIGHEST): f32
    # summation order only
    if rel > 1e-5:
        raise SystemExit(f"BCSR SpMM correctness failure: rel {rel:.3e}")
    ms = steady_ms(op._jit, op._bufs, B)
    gflops = flops / (ms * 1e-3) / 1e9
    min_bytes = (bcsr.num_blocks * R * C + 2 * N * F) * 4
    roof_ms = min_bytes / (params.hbm_gbps * 1e9) * 1e3
    log(f"# bcsr spmm {ms:.4f} ms, {gflops:.0f} GFLOP/s, rel err {rel:.2e}"
        f", min-traffic roofline {roof_ms:.4f} ms")

    # 3 — sub-benchmarks
    op_bf = SpMMOperator(bcsr, impl="pallas", dtype="bfloat16")
    m = steady_ms(op_bf._jit, op_bf._bufs, B)
    extras.append({"metric": "spmm_bf16_gflops",
                   "value": round(flops / m / 1e6, 1), "ms": round(m, 4)})

    from loops_tpu.ops.spmv import SpMVOperator

    csr_v = random_csr(32768, 32768, 4e-6 * 1024, seed=3)
    x = jax.device_put(np.random.default_rng(4).normal(
        size=32768).astype(np.float32))
    for sched in ("merge_path", "auto"):
        op_v = SpMVOperator(csr_v, sched)
        m = steady_ms(op_v._jit, op_v._bufs, x)
        extras.append({"metric": f"spmv_{sched}_ms", "value": round(m, 4),
                       "schedule": op_v.schedule, "nnz": int(csr_v.nnz)})
        log(f"# spmv {sched}->{op_v.schedule}: {m:.4f} ms")

    csr_b, bcsr_b = block_sparse(N=32768, R=8, C=128, block_density=0.015)
    xb = jax.device_put(np.random.default_rng(5).normal(
        size=32768).astype(np.float32))
    op_bv = SpMVOperator(bcsr_b)
    m = steady_ms(op_bv._jit, op_bv._bufs, xb)
    extras.append({"metric": "bcsr_spmv_ms", "value": round(m, 4),
                   "nnz": int(csr_b.nnz)})

    from loops_tpu.io import ogb
    from loops_tpu.models.message_passing import aggregate_operator

    data = ogb.load("ogbn-arxiv")
    agg = aggregate_operator(data.graph, op="gcn", dtype="bfloat16",
                             custom_vjp=False)
    Bf = jax.device_put(np.random.default_rng(10).normal(
        size=(data.graph.num_nodes, 128)).astype(np.float32))
    m = steady_ms(agg._jit, agg._bufs, Bf)
    extras.append({"metric": "gcn_aggregation_bf16_ms", "value": round(m, 4),
                   "schedule": agg.schedule,
                   "nnz": int(agg.mat.nnz), "F": 128})
    log(f"# gcn aggregation bf16 {agg.schedule}: {m:.4f} ms")

    from loops_tpu.ops.sddmm import SDDMMOperator

    csr_s = random_csr(65536, 65536, 2.47e6 / 65536 ** 2, seed=6)
    rng_s = np.random.default_rng(8)
    Xs, Ys = (jax.device_put(rng_s.normal(size=(65536, 128))
                             .astype(np.float32)) for _ in range(2))
    sd = SDDMMOperator(csr_s, dtype="bfloat16")
    m = steady_ms(sd._jit, sd._bufs, Xs, Ys)
    extras.append({"metric": "sddmm_bf16_ms", "value": round(m, 4),
                   "nnz": int(csr_s.nnz), "F": 128})

    import optax

    from loops_tpu.models import GAT, GCN
    from loops_tpu.models import train as T

    g = data.graph
    dims = [data.features.shape[1], 128, 128, data.num_classes]
    model = GCN(g, dims, dropout=0.5, dtype="bfloat16",
                precompute_first=True, loss_rows=data.train_mask)
    p0 = model.init(jax.random.PRNGKey(0))
    opt = optax.adam(1e-2)
    step = jax.jit(T.make_train_step(model, opt, data.features,
                                     data.labels, data.train_mask))
    m = steady_ms(step, p0, opt.init(p0), jax.random.PRNGKey(1), iters=10)
    extras.append({"metric": "gcn_train_ms_per_step", "value": round(m, 3),
                   "edges_per_s_M": round(g.adj.nnz / m / 1e3, 1),
                   "nodes": int(g.num_nodes), "edges": int(g.adj.nnz)})
    log(f"# gcn train step {m:.3f} ms")

    gat = GAT(g, [data.features.shape[1], 64, data.num_classes], heads=4,
              fused=True, vjp=True, dtype="bfloat16")
    Xg, yg = jnp.asarray(data.features), jnp.asarray(data.labels)
    mg = jnp.asarray(data.train_mask)
    pg = gat.init(jax.random.PRNGKey(0))

    @jax.jit
    def gat_step(prm, st):
        loss, grads = jax.value_and_grad(
            lambda q: T.cross_entropy(gat.apply(q, Xg), yg, mg))(prm)
        upd, st = opt.update(grads, st, prm)
        return optax.apply_updates(prm, upd), st, loss

    m = steady_ms(gat_step, pg, opt.init(pg), iters=5)
    extras.append({"metric": "gat_train_ms_per_step", "value": round(m, 3),
                   "edges_per_s_M": round(g.num_edges / m / 1e3, 1),
                   "heads": 4, "scale": 1.0})
    log(f"# gat train step {m:.3f} ms")

    print(json.dumps({"metric": "spmm_gflops", "value": round(gflops, 1),
                      "unit": "GFLOP/s",
                      "vs_baseline": round(roof_ms / ms, 4),
                      "device": device, "extras": extras}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
