"""Scale- and adversarial-stress tests for the multi-chip tier on the
8-device virtual CPU mesh.

The toy-graph tests in test_parallel.py prove the protocols; these
prove the *static-shape padding math* where it actually breaks: 1e5-1e6
node graphs (realistic H/Hd/Hi magnitudes), empty shards, shards whose
column demand is 100% remote, and hub rows that push the halo slab to
its row-count extreme.  Every case must match the single-device oracle
exactly (same float path), not just approximately learn.
"""
import numpy as np

from loops_tpu.formats import CSR
from loops_tpu.models import Graph
from loops_tpu.parallel import DistSpMM, EdgePartition, make_mesh
from loops_tpu.parallel.halo import DistSpMMHalo, HaloPlan
from loops_tpu.utils import reference


def _random_graph(n, deg, seed):
    rng = np.random.default_rng(seed)
    m = deg * n
    return Graph.from_edges(rng.integers(0, n, m), rng.integers(0, n, m),
                            n, make_undirected=True)


def _check_all_protocols(csr, X, *, atol=1e-3,
                         protocols=("all_gather", "halo")):
    """Run each exchange protocol over the 8-device mesh; every output
    must match the host oracle."""
    expect = reference.spmm(csr, X)
    plan = EdgePartition.build(csr, 8)
    h = plan.pad_features(X)
    outs = {}
    if "all_gather" in protocols:
        op = DistSpMM(plan, make_mesh(8))
        outs["all_gather"] = plan.unpad_output(np.asarray(op(h)))
    if "halo" in protocols:
        halo = HaloPlan.build(plan)
        op = DistSpMMHalo(halo, make_mesh(8), overlap=True)
        outs["halo"] = plan.unpad_output(np.asarray(op(h)))
    for name, got in outs.items():
        np.testing.assert_allclose(
            got, expect, rtol=1e-4, atol=atol,
            err_msg=f"protocol {name} diverged from the oracle")
    return plan


def test_scale_1e5_all_protocols():
    """10^5 nodes / ~1.6M edges: realistic halo-slab sizes (H in the
    thousands) through every exchange protocol."""
    g = _random_graph(100_000, 8, seed=1)
    X = np.random.default_rng(2).normal(
        size=(100_000, 16)).astype(np.float32)
    plan = _check_all_protocols(g.adj, X, atol=1e-2)
    stats = plan.halo_stats()
    assert stats["max_halo"] > 1000  # genuinely large-scale halos


def test_scale_1e6_halo():
    """10^6 nodes / ~4M edges: the largest virtual-mesh case; skip the
    all_gather oracle protocol (it is O(P * n) memory) and check the
    production exchange against the host oracle directly."""
    g = _random_graph(1_000_000, 2, seed=3)
    X = np.random.default_rng(4).normal(
        size=(1_000_000, 4)).astype(np.float32)
    _check_all_protocols(g.adj, X, atol=1e-2, protocols=("halo",))


def _csr_from_coo(rows, cols, n):
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    offs = np.searchsorted(rows, np.arange(n + 1))
    vals = np.ones(len(rows), np.float32)
    return CSR((n, n), offs.astype(np.int64), cols, vals)


def test_empty_shards_match():
    """All edges live in the first 64 rows of a 4096-node graph: under
    an 8-way merge-path cut most shards own rows but zero edges.  The
    padding math (H may be 0 for some pairs) must stay exact."""
    rng = np.random.default_rng(5)
    src = rng.integers(0, 64, 2000)
    dst = rng.integers(0, 4096, 2000)
    csr = _csr_from_coo(src, dst, 4096)
    plan = EdgePartition.build(csr, 8)
    nnz_per_dev = [int(plan.offsets[p, -1]) for p in range(8)]
    assert min(nnz_per_dev) == 0, nnz_per_dev  # the case under test
    X = rng.normal(size=(4096, 8)).astype(np.float32)
    _check_all_protocols(csr, X)


def test_all_remote_columns():
    """Every shard's column demand is 100% remote (row i references
    only columns shifted by n/2 — 4 shards away on an 8-way cut)."""
    n = 8192
    src = np.repeat(np.arange(n), 2)
    dst = ((src + n // 2) + np.tile([0, 7], n)) % n
    csr = _csr_from_coo(src, dst, n)
    plan = EdgePartition.build(csr, 8)
    stats = plan.halo_stats()
    cm = stats["comm_matrix"]
    assert np.trace(cm) == 0, "expected zero local column touches"
    X = np.random.default_rng(6).normal(size=(n, 8)).astype(np.float32)
    _check_all_protocols(csr, X)


def test_column_hub_broadcast():
    """Every row references node 0: the send set degenerates to one row
    broadcast to all shards (minimal H, maximal fan-out)."""
    n = 4096
    src = np.arange(n)
    dst = np.zeros(n, np.int64)
    csr = _csr_from_coo(np.concatenate([src, src]),
                        np.concatenate([dst, src]), n)  # hub + self
    X = np.random.default_rng(7).normal(size=(n, 8)).astype(np.float32)
    _check_all_protocols(csr, X)


def test_row_hub_huge_degree():
    """Row 0 references every node: its shard demands ~rows_per_dev
    remote rows from every other shard — the H extreme where the halo
    slab is as large as a whole shard."""
    n = 4096
    src0 = np.zeros(n, np.int64)
    dst0 = np.arange(n)
    rng = np.random.default_rng(8)
    srcr = rng.integers(0, n, 2 * n)
    dstr = rng.integers(0, n, 2 * n)
    csr = _csr_from_coo(np.concatenate([src0, srcr]),
                        np.concatenate([dst0, dstr]), n)
    plan = EdgePartition.build(csr, 8)
    halo = HaloPlan.build(plan)
    assert halo.H >= plan.rows_per_dev // 2  # genuinely extreme slab
    X = rng.normal(size=(n, 8)).astype(np.float32)
    _check_all_protocols(csr, X)


def test_from_shards_scale_1e6(tmp_path):
    """Out-of-core glue at scale: a 1M-node graph staged to a 2-shard
    memmapped store, assembled via EdgePartition.from_shards (no global
    CSR), propagated through the halo exchange on the 8-device mesh —
    matches the host oracle exactly."""
    from loops_tpu.io.shards import ShardedCSR

    g = _random_graph(1_000_000, 2, seed=11)
    store = ShardedCSR.build(g.adj, 2, str(tmp_path / "st"))
    part = EdgePartition.from_shards(store, chips_per_shard=4)
    assert part.num_devices == 8
    assert part.row_starts[4] == store.row_starts[1]
    op = DistSpMMHalo(HaloPlan.build(part), make_mesh(8), overlap=True)
    X = np.random.default_rng(1).normal(
        size=(1_000_000, 4)).astype(np.float32)
    got = part.unpad_output(np.asarray(op(part.pad_features(X))))
    np.testing.assert_allclose(got, reference.spmm(g.adj, X),
                               rtol=1e-4, atol=1e-2)
