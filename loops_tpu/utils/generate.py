"""Deterministic synthetic matrix generators.

Parity with the reference's util/generate.hxx:54-113 (hash-seeded uniform
random CSR via random COO + dedup) plus the test-fixture factories from
unittests/test_helpers.hxx:92-225 (identity, banded, block-diagonal,
power-law skewed, empty-row) — those live here rather than in the test tree
because examples and benchmarks use them too.
"""
from __future__ import annotations

import numpy as np

from loops_tpu.formats import COO, CSR


def random_csr(rows: int, cols: int, sparsity: float = 0.1,
               seed: int = 0, dtype=np.float32) -> CSR:
    """Uniform random CSR: draw ~rows*cols*sparsity coordinates, dedupe
    (reference: generate.hxx:94-113)."""
    rng = np.random.default_rng(seed)
    n = int(rows * cols * sparsity)
    r = rng.integers(0, rows, size=n)
    c = rng.integers(0, cols, size=n)
    v = rng.uniform(0.0, 1.0, size=n).astype(dtype)
    coo = COO((rows, cols), r, c, v).remove_duplicates(op="first")
    return coo.to_csr()


def block_sparse(N: int = 4096, R: int = 8, C: int = 128,
                 block_density: float = 0.06, seed: int = 0):
    """Square ``N x N`` matrix of dense ``R x C`` blocks at a random
    ``block_density`` of the block grid; returns ``(csr, bcsr)`` of the
    same values (normal entries)."""
    from loops_tpu.formats import BCSR

    rng = np.random.default_rng(seed)
    nbr, nbc = N // R, N // C
    nb = int(nbr * nbc * block_density)
    key = np.unique(rng.integers(0, nbr, nb).astype(np.int64) * nbc
                    + rng.integers(0, nbc, nb))
    br = (key // nbc).astype(np.int32)
    bc = (key % nbc).astype(np.int32)
    nb = len(key)
    rr = np.repeat(br * R, R * C) + np.tile(np.repeat(np.arange(R), C), nb)
    cc = np.repeat(bc * C, R * C) + np.tile(np.tile(np.arange(C), R), nb)
    vv = rng.normal(size=nb * R * C).astype(np.float32)
    csr = COO((N, N), rr, cc, vv).to_csr()
    return csr, BCSR.from_csr(csr, R, C)


def identity_csr(n: int, dtype=np.float32) -> CSR:
    i = np.arange(n)
    return CSR((n, n), np.arange(n + 1), i, np.ones(n, dtype=dtype))


def banded_csr(rows: int, cols: int, band: int = 1, seed: int = 0,
               dtype=np.float32) -> CSR:
    """Banded matrix: nonzeros at |col - row| <= band (asymmetric shapes
    allowed)."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(rows), 2 * band + 1)
    c = (np.tile(np.arange(-band, band + 1), rows) + r)
    keep = (c >= 0) & (c < cols)
    r, c = r[keep], c[keep]
    v = rng.uniform(-1.0, 1.0, size=len(r)).astype(dtype)
    return COO((rows, cols), r, c, v).to_csr()


def block_diag_csr(num_blocks: int, block: int, seed: int = 0,
                   dtype=np.float32) -> CSR:
    """Dense blocks along the diagonal."""
    rng = np.random.default_rng(seed)
    n = num_blocks * block
    base = np.arange(block)
    r = (np.repeat(np.arange(num_blocks), block * block) * block
         + np.tile(np.repeat(base, block), num_blocks))
    c = (np.repeat(np.arange(num_blocks), block * block) * block
         + np.tile(np.tile(base, block), num_blocks))
    v = rng.uniform(-1.0, 1.0, size=len(r)).astype(dtype)
    return COO((n, n), r, c, v).to_csr()


def skewed_csr(rows: int, cols: int, heavy_rows: int = 1,
               heavy_nnz: int | None = None, light_nnz: int = 2,
               seed: int = 0, dtype=np.float32) -> CSR:
    """Power-law-style load-balance stress: a few rows carry most of the
    nonzeros (the schedule differentiator — reference test_helpers.hxx
    make_skewed_csr)."""
    rng = np.random.default_rng(seed)
    heavy_nnz = heavy_nnz if heavy_nnz is not None else max(cols // 2, 4)
    rs, cs = [], []
    for i in range(rows):
        k = heavy_nnz if i < heavy_rows else light_nnz
        k = min(k, cols)
        cs.append(rng.choice(cols, size=k, replace=False))
        rs.append(np.full(k, i))
    r = np.concatenate(rs)
    c = np.concatenate(cs)
    v = rng.uniform(-1.0, 1.0, size=len(r)).astype(dtype)
    return COO((rows, cols), r, c, v).to_csr()


def empty_row_csr(rows: int, cols: int, every: int = 3, seed: int = 0,
                  dtype=np.float32) -> CSR:
    """Every ``every``-th row is empty — the binary-search / planner edge
    case (reference test_helpers.hxx make_empty_row_csr)."""
    rng = np.random.default_rng(seed)
    rs, cs = [], []
    for i in range(rows):
        if i % every == 0:
            continue
        k = min(1 + int(rng.integers(0, 3)), cols)
        cs.append(rng.choice(cols, size=k, replace=False))
        rs.append(np.full(k, i))
    if not rs:
        return COO((rows, cols), [], [], []).to_csr()
    r = np.concatenate(rs)
    c = np.concatenate(cs)
    v = rng.uniform(-1.0, 1.0, size=len(r)).astype(dtype)
    return COO((rows, cols), r, c, v).to_csr()


def tridiag_csr(n: int, seed: int = 0, dtype=np.float32) -> CSR:
    return banded_csr(n, n, band=1, seed=seed, dtype=dtype)


def diag_csr(n: int, seed: int = 0, dtype=np.float32) -> CSR:
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    return CSR((n, n), np.arange(n + 1), i,
               rng.uniform(0.5, 1.5, size=n).astype(dtype))


def make_input_vector(n: int, seed: int = 1, dtype=np.float32) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, size=n).astype(dtype)
