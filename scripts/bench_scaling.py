#!/usr/bin/env python
"""Multi-chip scaling benchmark: edges/s for distributed SpMM
(aggregation layer) at 1..N devices (north-star config 5: >=80%
edges/s scaling efficiency).

Runs on whatever devices exist — the GPUs of one host, or the virtual
CPU mesh (functional only; CPU numbers say nothing of device scaling):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    LOOPS_PLATFORM=cpu python scripts/bench_scaling.py --nodes 20000

Reports edges/s at each device count and efficiency vs the 1-device
baseline, for both exchange protocols (all_gather, halo-overlap).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from loops_tpu.utils.platform import ensure_platform  # noqa: E402

ensure_platform()


def main(argv=None):
    import jax

    from loops_tpu.io import ogb
    from loops_tpu.parallel import EdgePartition, make_mesh
    from loops_tpu.parallel.dist_ops import DistSpMM
    from loops_tpu.parallel.halo import DistSpMMHalo, HaloPlan
    from loops_tpu.utils.bench import chained_ms

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nodes", type=int, default=20000)
    p.add_argument("--avg-deg", type=int, default=15)
    p.add_argument("--feature-dim", type=int, default=128)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--volume-model", action="store_true",
                   help="print the per-layer exchange volume model "
                        "(predicted bytes + time per protocol) instead "
                        "of wall-clock rates")
    p.add_argument("--reorder", action="store_true",
                   help="BFS-reorder the graph before partitioning "
                        "(locality is what makes the halo protocol "
                        "beat all_gather)")
    p.add_argument("--graph", choices=("powerlaw", "banded"),
                   default="powerlaw",
                   help="banded ~= mesh/PDE locality (the halo "
                        "protocol's home turf); powerlaw ~= citation "
                        "expanders where all_gather is competitive")
    p.add_argument("--link-gbps", type=float, default=450.0,
                   help="per-card link bandwidth each way (GB/s); "
                        "NVLink on an H100 host: 450 GB/s each way "
                        "(NVIDIA H100 data sheet)")
    args = p.parse_args(argv)

    if args.graph == "banded":
        from loops_tpu.utils import generate

        class _DS:  # feature table only matters for the rate mode
            pass
        ds = _DS()
        csr0 = generate.banded_csr(args.nodes, args.nodes,
                                   band=max(args.avg_deg // 2, 1))
        from loops_tpu.models.graph import Graph
        ds.graph = Graph(csr0)
        rng = np.random.default_rng(0)
        ds.features = rng.normal(
            size=(args.nodes, args.feature_dim)).astype(np.float32)
    else:
        ds = ogb.synthetic_powerlaw("scaling", args.nodes, args.avg_deg,
                                    args.feature_dim, 8)
    csr = ds.graph.adj
    if args.reorder:
        from loops_tpu.layout import reorder as R
        csr = R.permute_csr(csr, R.bfs_order(csr))
    edges = csr.nnz
    print(f"graph: {args.nodes:,} nodes, {edges:,} edges, "
          f"F={args.feature_dim}; devices={jax.device_count()}")

    X = ds.features.astype(np.float32)
    counts = [1]
    n = 2
    while n <= jax.device_count():
        counts.append(n)
        n *= 2

    if args.volume_model:
        # exact per-layer exchange volumes from the plan arrays — the
        # paper trail for the >=80% scaling claim without multi-chip
        # hardware. Predicted exchange time uses
        # the nominal link rate.
        from loops_tpu.parallel import EdgePartition
        from loops_tpu.parallel.halo import HaloPlan
        F = args.feature_dim
        print(f"\nper-layer exchange volume model (F={F}, f32, "
              f"link={args.link_gbps:.0f} GB/s/card nominal):")
        print(f"{'P':>3} {'all_gather MB/chip':>19} {'halo MB/chip':>13} "
              f"{'halo(padded)':>13} {'ag ms':>7} {'halo ms':>8} "
              f"{'halo frac of N':>15}")
        for ndev in counts:
            if ndev == 1:
                print(f"{1:3d} {'0':>19} {'0':>13} {'0':>13} "
                      f"{0.0:7.3f} {0.0:8.3f} {'-':>15}")
                continue
            part = EdgePartition.build(csr, ndev)
            hp = HaloPlan.build(part)
            rows_pad = part.row_starts[-1] // ndev if hasattr(
                part, "row_starts") else -(-args.nodes // ndev)
            # all_gather: every chip receives the other P-1 shards
            ag_bytes = (ndev - 1) * rows_pad * F * 4
            # halo: true boundary rows shipped (valid slots), and the
            # padded-slab volume the current all_to_all implementation
            # actually moves (send buffers are padded to H)
            sends = int(hp.send_valid.sum())
            halo_bytes = sends * F * 4 / ndev           # per chip
            halo_pad = (ndev - 1) * hp.H * F * 4        # per chip
            frac = sends / ndev / max(rows_pad, 1)
            print(f"{ndev:3d} {ag_bytes/1e6:19.2f} {halo_bytes/1e6:13.2f} "
                  f"{halo_pad/1e6:13.2f} "
                  f"{ag_bytes/args.link_gbps/1e6:7.3f} "
                  f"{max(halo_bytes, halo_pad)/args.link_gbps/1e6:8.3f} "
                  f"{frac:15.1%}")

        return 0

    results = {}
    for proto in ("all_gather", "halo_overlap"):
        rates = []
        for ndev in counts:
            mesh = make_mesh(ndev)
            plan = EdgePartition.build(csr, ndev)
            if proto == "all_gather":
                op = DistSpMM(plan, mesh)
            else:
                op = DistSpMMHalo(HaloPlan.build(plan), mesh, overlap=True)
            h = plan.pad_features(X)

            def fn(hh, op=op):
                return op._fn(*op.buffers, hh)

            ms = chained_ms(fn, h, iters=args.iters)
            eps = edges / (ms * 1e-3)
            rates.append(eps)
            eff = eps / (rates[0] * ndev) if ndev > 1 else 1.0
            print(f"  {proto:13s} {ndev:3d} dev: {ms:8.3f} ms  "
                  f"{eps/1e6:8.1f} M edges/s  eff={eff:.2%}")
        results[proto] = rates
    return 0


if __name__ == "__main__":
    sys.exit(main())
