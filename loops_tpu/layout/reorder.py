"""Graph/matrix reordering for gather locality.

The SpMM cost for irregular graphs is the random gather of B rows.
Locality recovers when
consecutive edges hit nearby rows, which is a *plan-time* property:
reorder the matrix once, keep a permutation, undo it on outputs.

Two orderings:
  * ``degree_order``  — hubs first (groups heavy rows; also the sigma
    pass that tightens group_mapped's degree-class buckets).
  * ``bfs_order``     — Cuthill-McKee-style breadth-first from a
    min-degree seed; clusters neighborhoods so edge gathers walk nearby
    addresses.
"""
from __future__ import annotations

import numpy as np

from loops_tpu.formats import CSR
from loops_tpu.formats.base import INDEX_DTYPE


def degree_order(csr: CSR, descending: bool = True) -> np.ndarray:
    """Permutation sorting rows by degree (stable)."""
    deg = csr.row_sizes()
    key = -deg if descending else deg
    return np.argsort(key, kind="stable").astype(INDEX_DTYPE)


def bfs_order(csr: CSR) -> np.ndarray:
    """Cuthill-McKee-flavored BFS ordering over the symmetrized pattern;
    isolated/unreached nodes append at the end in index order."""
    n = csr.shape[0]
    sym = csr
    if csr.shape[0] == csr.shape[1]:
        # symmetrize pattern so ordering works on directed graphs
        coo = csr.to_coo()
        from loops_tpu.formats import COO

        rows = np.concatenate([coo.rows, coo.cols])
        cols = np.concatenate([coo.cols, coo.rows])
        vals = np.ones(len(rows), np.float32)
        sym = COO(csr.shape, rows, cols, vals).remove_duplicates().to_csr()
    deg = sym.row_sizes()
    visited = np.zeros(n, bool)
    order = np.empty(n, dtype=INDEX_DTYPE)
    pos = 0
    seeds = np.argsort(deg, kind="stable")
    for seed in seeds:
        if visited[seed]:
            continue
        queue = [int(seed)]
        visited[seed] = True
        while queue:
            u = queue.pop(0)
            order[pos] = u
            pos += 1
            nbrs = sym.indices[sym.offsets[u]: sym.offsets[u + 1]]
            fresh = nbrs[~visited[nbrs]]
            if len(fresh):
                # visit low-degree neighbors first (Cuthill-McKee)
                fresh = fresh[np.argsort(deg[fresh], kind="stable")]
                visited[fresh] = True
                queue.extend(int(v) for v in fresh)
    return order


def permute_csr(csr: CSR, perm: np.ndarray, permute_cols: bool = True) -> CSR:
    """Symmetric (or row-only) permutation: A'[i, j] = A[perm[i], perm[j]].

    ``perm`` maps new index -> old index. Returns the permuted CSR;
    ``y_original = y_permuted[inverse_permutation(perm)]`` style
    round-trips are the caller's contract (see tests).
    """
    inv = inverse_permutation(perm)
    coo = csr.to_coo()
    rows = inv[coo.rows]
    cols = inv[coo.cols] if permute_cols else coo.cols
    from loops_tpu.formats import COO

    return COO(csr.shape, rows, cols, coo.vals).to_csr()


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    return inv


def bandwidth(csr: CSR) -> int:
    """Max |row - col| over nonzeros — the locality metric BFS ordering
    minimizes (lower = nearer gathers)."""
    if csr.nnz == 0:
        return 0
    return int(np.abs(csr.row_ids().astype(np.int64)
                      - csr.indices).max())
