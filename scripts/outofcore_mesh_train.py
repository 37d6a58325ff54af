"""Out-of-core store -> virtual-mesh train step at >=10M nodes.

Stages the GCN-normalized adjacency of a 10M-node power-law graph into
a memmapped ShardedCSR, assembles the mesh partition with
``EdgePartition.from_shards`` (no global CSR in device memory), and
trains a DistGCN through the halo exchange on the virtual CPU mesh of
``shards x chips`` devices — the papers100M pipeline shape, scaled to
what one machine holds.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    LOOPS_PLATFORM=cpu python scripts/outofcore_mesh_train.py \
        --nodes 10000000 --avg-deg 8 --shards 2 --chips 4 --feat 32
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

os.environ.setdefault("LOOPS_PLATFORM", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

from loops_tpu.utils.platform import ensure_platform  # noqa: E402

ensure_platform()

from bench_outofcore import powerlaw_csr  # noqa: E402


def main(argv=None):
    import jax
    import optax

    from loops_tpu.formats import CSR
    from loops_tpu.io.shards import ShardedCSR
    from loops_tpu.parallel import DistGCN, EdgePartition, make_mesh

    p = argparse.ArgumentParser()
    p.add_argument("--nodes", type=int, default=10_000_000)
    p.add_argument("--avg-deg", type=int, default=8)
    p.add_argument("--shards", type=int, default=2)
    p.add_argument("--chips", type=int, default=4)
    p.add_argument("--feat", type=int, default=32)
    p.add_argument("--classes", type=int, default=16)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--dir", default="sweep_logs/mesh_shards")
    args = p.parse_args(argv)

    n = args.nodes
    t0 = time.perf_counter()
    csr = powerlaw_csr(n, args.avg_deg, seed=3)
    print(f"graph: {n:,} nodes {csr.nnz:,} edges "
          f"({time.perf_counter()-t0:.1f}s)", flush=True)

    # GCN normalization D^-1/2 (A+I) D^-1/2, computed on host arrays
    t0 = time.perf_counter()
    from loops_tpu.models.graph import Graph
    g = Graph(csr).add_self_loops().gcn_normalized()
    norm = g.adj
    print(f"normalize: {norm.nnz:,} nnz "
          f"({time.perf_counter()-t0:.1f}s)", flush=True)

    shutil.rmtree(args.dir, ignore_errors=True)
    t0 = time.perf_counter()
    store = ShardedCSR.build(norm, args.shards, args.dir)
    nbytes = sum(os.path.getsize(f"{args.dir}/{f}")
                 for f in os.listdir(args.dir))
    print(f"stage: {args.shards} shards, {nbytes/2**20:.0f} MiB "
          f"({time.perf_counter()-t0:.1f}s)", flush=True)

    t0 = time.perf_counter()
    part = EdgePartition.from_shards(store, chips_per_shard=args.chips)
    print(f"from_shards: P={part.num_devices} rows_pd={part.rows_per_dev:,} "
          f"nnz_pd={part.nnz_per_dev:,} "
          f"({time.perf_counter()-t0:.1f}s)", flush=True)

    mesh = make_mesh(args.shards * args.chips)
    dims = [args.feat, 32, args.classes]
    model = DistGCN(None, dims, mesh, plan=part)

    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, args.feat)).astype(np.float32)
    labels = rng.integers(0, args.classes, n).astype(np.int32)
    mask = (rng.random(n) < 0.5).astype(np.float32)

    params = model.init(jax.random.PRNGKey(0))
    opt = optax.adam(1e-2)
    st = opt.init(params)
    step = model.make_train_step(opt, X, labels, mask)
    t0 = time.perf_counter()
    params, st, loss = step(params, st)
    jax.block_until_ready(loss)
    print(f"step 0 (compile): loss={float(loss):.4f} "
          f"({time.perf_counter()-t0:.1f}s)", flush=True)
    t0 = time.perf_counter()
    for i in range(args.steps):
        params, st, loss = step(params, st)
    jax.block_until_ready(loss)
    ms = (time.perf_counter() - t0) / args.steps * 1e3
    eps = norm.nnz * 2 * (len(dims) - 1) / (ms * 1e-3)
    print(f"train: {ms:.0f} ms/step ({eps/1e6:.1f} M layer-edges/s "
          f"fwd+bwd, {args.shards * args.chips}-device virtual mesh), "
          f"final loss={float(loss):.4f}", flush=True)
    first = float(loss)
    assert np.isfinite(first)
    print("check: OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
