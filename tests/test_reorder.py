"""Reordering: permutation correctness (SpMV equivalence) + locality
improvement on a ring graph."""
import numpy as np

from loops_tpu.layout.reorder import (
    bandwidth,
    bfs_order,
    degree_order,
    inverse_permutation,
    permute_csr,
)
from loops_tpu.utils import generate, reference


def test_permutation_spmv_equivalence():
    csr = generate.random_csr(30, 30, 0.15, seed=6)
    x = generate.make_input_vector(30)
    perm = degree_order(csr)
    pcsr = permute_csr(csr, perm)
    # y'[i] = y[perm[i]] and x must be permuted the same way
    xp = x[perm]
    yp = reference.spmv(pcsr, xp)
    y = reference.spmv(csr, x)
    np.testing.assert_allclose(yp, y[perm], rtol=1e-5, atol=1e-6)


def test_bfs_order_is_permutation_and_improves_bandwidth():
    # scrambled ring: BFS ordering should recover locality
    n = 64
    rng = np.random.default_rng(7)
    scramble = rng.permutation(n)
    src = scramble[np.arange(n)]
    dst = scramble[(np.arange(n) + 1) % n]
    from loops_tpu.models import Graph

    g = Graph.from_edges(src, dst, n, make_undirected=True)
    order = bfs_order(g.adj)
    assert sorted(order.tolist()) == list(range(n))
    before = bandwidth(g.adj)
    after = bandwidth(permute_csr(g.adj, order))
    assert after < before
    assert after <= 2  # a ring relabeled by BFS is (nearly) tridiagonal


def test_inverse_permutation():
    perm = np.array([2, 0, 3, 1], dtype=np.int32)
    inv = inverse_permutation(perm)
    np.testing.assert_array_equal(perm[inv], np.arange(4))
    np.testing.assert_array_equal(inv[perm], np.arange(4))


def test_spmv_operator_reorder_option():
    """reorder='degree'/'bfs' permutes at plan time and folds the x/y
    permutation into the operator — results match the unordered op."""
    import numpy as np

    from loops_tpu.ops.spmv import SpMVOperator
    from loops_tpu.utils import generate, reference

    csr = generate.skewed_csr(60, 60, heavy_rows=3, heavy_nnz=30, seed=5)
    x = generate.make_input_vector(60, seed=6)
    expect = reference.spmv(csr, x)
    for order in ("degree", "bfs"):
        op = SpMVOperator(csr, schedule="merge_path", reorder=order)
        got = np.asarray(op(x))
        np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-5)
    # degree-class planes through the permuted plan
    op = SpMVOperator(csr, schedule="group_mapped", reorder="degree")
    got = np.asarray(op(x))
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-5)
