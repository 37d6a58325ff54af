#!/usr/bin/env python
"""Where the device time goes: profiler traces of the main workloads.

    python scripts/trace_breakdown.py [--scale 1.0] [--out traces]

On one GPU, for the 3-layer GCN train step (f32 and bf16 aggregation),
the GAT train step and the BCSR SpMM kernel: warm up, trace a short
window of steps, and reduce the trace (``utils/trace.device_breakdown``)
to the device's busy and idle share of the window and the top kernels
by device time per step, written to ``<out>/breakdown.json``; the raw
traces are deleted once reduced.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402


def traced(name, fn, args, steps, out):
    """Trace ``steps`` calls of ``fn(*args)`` (args threaded when fn
    returns a tuple of the same arity); returns the breakdown."""
    import jax

    from loops_tpu.utils.trace import device_breakdown

    res = jax.block_until_ready(fn(*args))      # compile + warm
    logdir = os.path.join(out, name)
    with jax.profiler.trace(logdir):
        for _ in range(steps):
            res = fn(*args)
            if isinstance(res, tuple) and len(res) >= len(args):
                args = res[:len(args)]
        jax.block_until_ready(res)
    path = sorted(glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    bd = device_breakdown(path)
    shutil.rmtree(logdir)   # raw traces run to hundreds of MB
    for plane, d in bd.items():
        top = sorted(d["kernels"].items(), key=lambda kv: -kv[1])[:10]
        print(f"{name} [{plane}]: window {d['window_ns'] / 1e6:.3f} ms, "
              f"busy {d['busy_ns'] / 1e6:.3f} ms, idle share "
              f"{d['idle_share']:.3f}", flush=True)
        for k, ns in top:
            print(f"    {ns / steps / 1e6:9.4f} ms/step  {k[:90]}")
        d["kernels"] = dict(top)
    return bd


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="traces")
    args = ap.parse_args(argv)

    from loops_tpu.utils.platform import (
        enable_compilation_cache,
        ensure_platform,
    )

    ensure_platform()
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp
    import optax

    from loops_tpu.io import ogb
    from loops_tpu.models import GAT, GCN
    from loops_tpu.models import train as T
    from loops_tpu.ops.spmm import SpMMOperator
    from loops_tpu.utils.generate import block_sparse

    data = ogb.load("ogbn-arxiv", scale=args.scale)
    g = data.graph
    dims = [data.features.shape[1], 128, 128, data.num_classes]
    opt = optax.adam(1e-2)
    report = {}
    for dtype in (None, "bfloat16"):
        model = GCN(g, dims, dropout=0.5, dtype=dtype,
                    loss_rows=data.train_mask)
        p = model.init(jax.random.PRNGKey(0))
        step = jax.jit(T.make_train_step(model, opt, data.features,
                                         data.labels, data.train_mask))
        tag = "gcn_f32" if dtype is None else "gcn_bf16"
        report[tag] = traced(tag, step, (p, opt.init(p),
                                         jax.random.PRNGKey(1)),
                             args.steps, args.out)

    gat = GAT(g, [data.features.shape[1], 64, data.num_classes], heads=4,
              fused=True, vjp=True, dtype="bfloat16")
    X, y = jnp.asarray(data.features), jnp.asarray(data.labels)
    m = jnp.asarray(data.train_mask)

    @jax.jit
    def gat_step(prm, st):
        loss, grads = jax.value_and_grad(
            lambda q: T.cross_entropy(gat.apply(q, X), y, m))(prm)
        upd, st = opt.update(grads, st, prm)
        return optax.apply_updates(prm, upd), st, loss

    pg = gat.init(jax.random.PRNGKey(0))
    report["gat"] = traced("gat", gat_step, (pg, opt.init(pg)), args.steps,
                           args.out)

    _, bcsr = block_sparse(N=16384, R=8, C=128, block_density=0.06)
    op = SpMMOperator(bcsr, impl="pallas")
    B = jax.device_put(np.random.default_rng(1).normal(
        size=(16384, 512)).astype(np.float32))
    report["bcsr_spmm_f32"] = traced(
        "bcsr_spmm_f32", lambda b: op._jit(op._bufs, b), (B,), args.steps,
        args.out)
    with open(os.path.join(args.out, "breakdown.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
