"""ELL (ELLPACK) container — dense [rows, pitch] index/value planes.

Parity with the reference's ``ell_t`` (reference:
include/loops/container/ell.hxx:45-145): sentinel-padded row-major planes,
a ``max_nnz_per_row`` preflight probe guarding against memory blow-up on
skewed matrices, and host CSR bucket-fill.

ELL is the most regular sparse format: the planes are already
static-shape dense arrays, so gathers and FMAs vectorize with a sentinel
mask instead of control flow.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from loops_tpu.formats.base import INDEX_DTYPE, as_value_array, check_shape

SENTINEL = INDEX_DTYPE(-1)


@dataclass
class ELL:
    shape: tuple
    pitch: int                # max nonzeros per row (plane width)
    indices: np.ndarray       # [rows, pitch] col index, -1 = padding
    vals: np.ndarray          # [rows, pitch] value, 0 at padding

    def __post_init__(self):
        self.shape = check_shape(self.shape)
        self.pitch = int(self.pitch)
        self.indices = np.ascontiguousarray(self.indices, dtype=INDEX_DTYPE)
        self.vals = as_value_array(self.vals)
        if self.indices.shape != (self.shape[0], self.pitch):
            raise ValueError(
                f"indices shape {self.indices.shape} != "
                f"(rows, pitch) = ({self.shape[0]}, {self.pitch})")
        if self.vals.shape != self.indices.shape:
            raise ValueError("vals/indices shape mismatch")

    @property
    def nnz(self) -> int:
        return int((self.indices != SENTINEL).sum())

    @staticmethod
    def max_nnz_per_row(csr) -> int:
        """Preflight probe: the pitch a CSR would need (reference:
        ell.hxx:91-102). Call before converting to bound memory."""
        sizes = csr.row_sizes()
        return int(sizes.max()) if len(sizes) else 0

    # -- conversions -------------------------------------------------------
    @classmethod
    def from_csr(cls, csr, max_pitch: int | None = None) -> "ELL":
        """CSR -> ELL bucket fill (reference: ell.hxx:113-145), vectorized:
        scatter each nonzero to (row, rank-within-row).

        ``max_pitch`` guards skewed matrices: raises if the required pitch
        exceeds it (the reference leaves the guard to the caller; we make
        the probe enforceable here).
        """
        rows = csr.shape[0]
        pitch = cls.max_nnz_per_row(csr)
        if max_pitch is not None and pitch > max_pitch:
            raise MemoryError(
                f"ELL pitch {pitch} exceeds max_pitch {max_pitch}; "
                f"matrix too skewed for ELL")
        indices = np.full((rows, max(pitch, 1)), SENTINEL, dtype=INDEX_DTYPE)
        vals = np.zeros((rows, max(pitch, 1)), dtype=csr.vals.dtype)
        if csr.nnz:
            rid = csr.row_ids()
            rank = np.arange(csr.nnz, dtype=np.int64) - csr.offsets[rid]
            indices[rid, rank] = csr.indices
            vals[rid, rank] = csr.vals
        return cls(csr.shape, max(pitch, 1), indices, vals)

    def to_csr(self):
        from loops_tpu.formats.coo import COO
        mask = self.indices != SENTINEL
        rid, rank = np.nonzero(mask)
        return COO(self.shape, rid, self.indices[rid, rank],
                   self.vals[rid, rank]).to_csr()

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.vals.dtype)
        mask = self.indices != SENTINEL
        rid, rank = np.nonzero(mask)
        out[rid, self.indices[rid, rank]] = self.vals[rid, rank]
        return out

    def as_jax(self, pad_rows_to: int = 8, pad_pitch_to: int = 1):
        """Stage planes on device, padded to the given multiples.

        Sentinel columns are rewritten to index 0 (with value 0) so device
        gathers are always in-bounds; the value plane's zeros make the
        padding a mathematical no-op.
        """
        import jax.numpy as jnp

        def rup(x, m):
            return -(-x // m) * m

        r = rup(max(self.shape[0], 1), pad_rows_to)
        p = rup(self.pitch, pad_pitch_to)
        idx = np.zeros((r, p), dtype=INDEX_DTYPE)
        v = np.zeros((r, p), dtype=self.vals.dtype)
        safe = np.where(self.indices == SENTINEL, 0, self.indices)
        idx[: self.shape[0], : self.pitch] = safe
        v[: self.shape[0], : self.pitch] = np.where(
            self.indices == SENTINEL, 0, self.vals)
        return jnp.asarray(idx), jnp.asarray(v)
