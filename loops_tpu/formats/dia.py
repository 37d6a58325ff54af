"""DIA (diagonal) container.

Parity with the reference's ``dia_t`` (reference:
include/loops/container/dia.hxx:69-188): values stored per stored diagonal,
with a ``count_diagonals`` preflight probe (reference: dia.hxx:98-116 —
their hash-set probe is a vectorized ``np.unique`` here).

Storage convention (row-major): ``vals[d, i] = A[i, i +
diag_offsets[d]]`` for ``0 <= i < rows`` with zeros where the column falls
outside the matrix. Each diagonal is a contiguous length-``rows`` row —
SpMV over DIA is then a dense shifted multiply.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from loops_tpu.formats.base import as_value_array, check_shape


@dataclass
class DIA:
    shape: tuple
    diag_offsets: np.ndarray  # [num_diags] sorted k where k = col - row
    vals: np.ndarray          # [num_diags, rows]

    def __post_init__(self):
        self.shape = check_shape(self.shape)
        self.diag_offsets = np.ascontiguousarray(self.diag_offsets,
                                                 dtype=np.int32)
        self.vals = as_value_array(self.vals)
        if self.vals.shape != (len(self.diag_offsets), self.shape[0]):
            raise ValueError(
                f"vals shape {self.vals.shape} != (num_diags, rows) = "
                f"({len(self.diag_offsets)}, {self.shape[0]})")

    @property
    def num_diagonals(self) -> int:
        return len(self.diag_offsets)

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(self.vals))

    @staticmethod
    def count_diagonals(csr) -> int:
        """Preflight probe: number of occupied diagonals (reference:
        dia.hxx:98-116). O(nnz) vectorized."""
        if csr.nnz == 0:
            return 0
        k = csr.indices.astype(np.int64) - csr.row_ids()
        return len(np.unique(k))

    # -- conversions -------------------------------------------------------
    @classmethod
    def from_csr(cls, csr, max_diagonals: int | None = None) -> "DIA":
        """CSR -> DIA (reference: dia.hxx:135-188), vectorized scatter.

        ``max_diagonals`` is the blow-up guard the probe enables.
        """
        rows = csr.shape[0]
        if csr.nnz == 0:
            return cls(csr.shape, np.zeros(0, np.int32),
                       np.zeros((0, rows), dtype=csr.vals.dtype))
        rid = csr.row_ids()
        k = csr.indices.astype(np.int64) - rid
        uniq, inv = np.unique(k, return_inverse=True)
        if max_diagonals is not None and len(uniq) > max_diagonals:
            raise MemoryError(
                f"{len(uniq)} diagonals exceeds max_diagonals "
                f"{max_diagonals}; matrix too irregular for DIA")
        vals = np.zeros((len(uniq), rows), dtype=csr.vals.dtype)
        vals[inv, rid] = csr.vals
        return cls(csr.shape, uniq.astype(np.int32), vals)

    def to_csr(self):
        from loops_tpu.formats.coo import COO
        d, r = np.nonzero(self.vals)
        c = r + self.diag_offsets[d]
        keep = (c >= 0) & (c < self.shape[1])
        return COO(self.shape, r[keep], c[keep], self.vals[d, r][keep]).to_csr()

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.vals.dtype)
        for d, k in enumerate(self.diag_offsets):
            r = np.arange(self.shape[0])
            c = r + k
            keep = (c >= 0) & (c < self.shape[1])
            out[r[keep], c[keep]] = self.vals[d, r[keep]]
        return out

    def as_jax(self):
        import jax.numpy as jnp
        return jnp.asarray(self.diag_offsets), jnp.asarray(self.vals)
