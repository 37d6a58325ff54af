#!/usr/bin/env python
"""Train a 3-layer GCN (or GraphSAGE) on an OGB-style node-classification
dataset (north-star config 4, BASELINE.json). Uses a locally available
OGB copy when present; otherwise a size-matched synthetic power-law
graph (zero-egress safe).

    python examples/train_gcn.py --dataset ogbn-arxiv --scale 0.05 \
        --model gcn --epochs 100
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from loops_tpu.utils.platform import (  # noqa: E402
    enable_compilation_cache,
    ensure_platform,
)

ensure_platform()
enable_compilation_cache()


def main(argv=None):
    import jax
    import optax

    from loops_tpu.io import ogb
    from loops_tpu.models import GAT, GCN, GraphSAGE
    from loops_tpu.models import train as T

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="ogbn-arxiv")
    p.add_argument("--scale", type=float, default=0.05,
                   help="node-count scale for the synthetic fallback")
    p.add_argument("--model", default="gcn", choices=["gcn", "sage", "gat"])
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps-per-call", type=int, default=None,
                   help="training steps batched per device dispatch")
    args = p.parse_args(argv)

    ds = ogb.load(args.dataset, scale=args.scale)
    print(f"dataset={ds.name}{' (synthetic)' if ds.synthetic else ''} "
          f"nodes={ds.graph.num_nodes:,} edges={ds.graph.num_edges:,} "
          f"feat={ds.features.shape[1]} classes={ds.num_classes}")

    dims = [ds.features.shape[1], args.hidden, args.hidden, ds.num_classes]
    if args.model == "gcn":
        model = GCN(ds.graph, dims, dropout=args.dropout)
    elif args.model == "gat":
        model = GAT(ds.graph, dims, heads=4)
    else:
        model = GraphSAGE(ds.graph, dims)
    params = model.init(jax.random.PRNGKey(args.seed))

    opt = optax.adam(args.lr)
    if args.model == "gcn":
        # several steps per dispatch (models/train.py)
        spc = max(args.epochs // 10, 1) if args.steps_per_call is None \
            else args.steps_per_call
        step = jax.jit(T.make_train_epochs(model, opt, ds.features,
                                           ds.labels, ds.train_mask,
                                           steps_per_call=spc))
    else:
        spc = 1
        import jax.numpy as jnp

        feats = jnp.asarray(ds.features)
        lab = jnp.asarray(ds.labels)
        msk = jnp.asarray(ds.train_mask)

        def loss_fn(prm, rng):
            logits = model.apply(prm, feats)
            return T.cross_entropy(logits, lab, msk)

        @jax.jit
        def step(prm, opt_state, rng):
            rng, sub = jax.random.split(rng)
            loss, grads = jax.value_and_grad(loss_fn)(prm, sub)
            updates, opt_state = opt.update(grads, opt_state, prm)
            return optax.apply_updates(prm, updates), opt_state, rng, loss

    opt_state = opt.init(params)
    rng = jax.random.PRNGKey(args.seed + 1)
    t0 = time.time()
    for epoch in range(0, args.epochs, spc):
        params, opt_state, rng, loss = step(params, opt_state, rng)
        if (epoch // spc) % max(args.epochs // spc // 10, 1) == 0:
            val = T.evaluate(model, params, ds.features, ds.labels,
                             ds.val_mask)
            print(f"epoch {epoch:4d} loss {float(loss):.4f} val {val:.4f}")
    dt = time.time() - t0

    test = T.evaluate(model, params, ds.features, ds.labels, ds.test_mask)
    eps = ds.graph.num_edges * args.epochs / dt
    print(f"test_accuracy: {test:.4f}")
    print(f"train_time_s: {dt:.1f}  edges_per_s: {eps:,.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
