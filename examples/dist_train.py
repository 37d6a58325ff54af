#!/usr/bin/env python
"""Distributed GCN training over a device mesh.

Runs on whatever devices exist — the GPUs of one host, or a virtual CPU
mesh:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    LOOPS_PLATFORM=cpu python examples/dist_train.py --epochs 20
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
    from loops_tpu.models import train as T
    from loops_tpu.parallel import DistGCN, make_mesh

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="tiny")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--exchange", default="all_gather",
                   choices=["all_gather", "halo"])
    args = p.parse_args(argv)

    ds = ogb.load(args.dataset, scale=args.scale)
    mesh = make_mesh()
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    print(f"dataset={ds.name} nodes={ds.graph.num_nodes:,} "
          f"edges={ds.graph.num_edges:,} devices={n_dev} "
          f"exchange={args.exchange}")

    dims = [ds.features.shape[1], args.hidden, ds.num_classes]
    model = DistGCN(ds.graph, dims, mesh, exchange=args.exchange)
    params = model.init(jax.random.PRNGKey(0))
    opt = optax.adam(args.lr)
    step = model.make_train_step(opt, ds.features, ds.labels,
                                 ds.train_mask)
    opt_state = opt.init(params)

    t0 = time.time()
    for epoch in range(args.epochs):
        params, opt_state, loss = step(params, opt_state)
        if epoch % max(args.epochs // 5, 1) == 0:
            print(f"epoch {epoch:4d} loss {float(loss):.4f}")
    dt = time.time() - t0
    eps = ds.graph.num_edges * args.epochs / dt

    # evaluate on the single-device model with the trained params
    from loops_tpu.models import GCN

    single = GCN(ds.graph, dims, dropout=0.0)
    acc = T.evaluate(single, params, ds.features, ds.labels, ds.test_mask)
    print(f"test_accuracy: {acc:.4f}")
    print(f"train_time_s: {dt:.1f}  edges_per_s: {eps:,.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
