#!/usr/bin/env python
"""Accuracy + throughput record for the GNN model tier (north-star
config 4: 3-layer GCN and GraphSAGE, accuracy-matched).

Trains each model twice on the same dataset/seed — through the exact
f32 aggregation path and through the bf16 throughput path (auto-routed
aggregation, models/message_passing.py) — and prints a
markdown table of test accuracy and train-step throughput. The
accuracy-matched claim of the kernel tier is exactly this table: the
throughput path must land within noise of the exact path.

Zero-egress note: with no local OGB copy the dataset is the
size-matched synthetic power-law fixture (io/ogb.py); the table
records which one was used.

    python scripts/train_record.py --dataset ogbn-arxiv --epochs 100
"""
from __future__ import annotations

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from loops_tpu.utils.platform import (  # noqa: E402
    enable_compilation_cache,
    ensure_platform,
)

ensure_platform()
enable_compilation_cache()


def run_one(ds, model_name, mode, epochs, lr, hidden, seed):
    import jax
    import optax

    from loops_tpu.models import GCN, GraphSAGE
    from loops_tpu.models import train as T

    dims = [ds.features.shape[1], hidden, hidden, ds.num_classes]
    kw = {}
    if mode == "throughput":
        kw = dict(schedule="auto", dtype="bfloat16")
    elif mode == "exact":
        kw = dict(schedule="group_mapped")
    if model_name == "gcn":
        if mode == "throughput":
            kw["precompute_first"] = True   # (AX)W1 hoist, exact
        model = GCN(ds.graph, dims, dropout=0.5, **kw)
    else:
        model = GraphSAGE(ds.graph, dims, **kw)

    params = model.init(jax.random.PRNGKey(seed))
    opt = optax.adam(lr)
    step = jax.jit(T.make_train_step(model, opt, ds.features, ds.labels,
                                     ds.train_mask))
    st = opt.init(params)
    rng = jax.random.PRNGKey(seed + 1)
    params, st, rng, loss = step(params, st, rng)   # compile
    jax.block_until_ready(loss)
    t0 = time.perf_counter()
    for _ in range(epochs - 1):
        params, st, rng, loss = step(params, st, rng)
    jax.block_until_ready(loss)
    ms = (time.perf_counter() - t0) / max(epochs - 1, 1) * 1e3
    acc = float(T.evaluate(model, params, ds.features, ds.labels,
                           ds.test_mask))
    eps = ds.graph.num_edges / (ms * 1e-3) / 1e6
    return acc, ms, eps


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="ogbn-arxiv")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--models", default="gcn,sage")
    args = p.parse_args(argv)

    from loops_tpu.io import ogb

    ds = ogb.load(args.dataset, scale=args.scale)
    src = "synthetic power-law fixture" if ds.synthetic else "real OGB"
    print(f"dataset={ds.name} ({src}) nodes={ds.graph.num_nodes:,} "
          f"edges={ds.graph.num_edges:,} classes={ds.num_classes}\n")
    print("| model | path | test acc | ms/step | M edges/s |")
    print("|---|---|---|---|---|")
    for model_name in args.models.split(","):
        for mode in ("exact", "throughput"):
            acc, ms, eps = run_one(ds, model_name, mode, args.epochs,
                                   args.lr, args.hidden, args.seed)
            print(f"| {model_name} | {mode} | {acc:.4f} | {ms:.1f} "
                  f"| {eps:.1f} |", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
