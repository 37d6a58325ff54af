"""SDDMM — sampled dense-dense matrix multiplication.

``out_nz = vals_nz * <A[row_nz, :], B[col_nz, :]>`` — the second half of
the GNN primitive pair (attention-style edge scoring). No reference
analog (the reference stops at SpMV/SpMM); required by the north star
(BASELINE.json config 3).

* CSR/COO — XLA gather-einsum over nonzeros (returns values in storage
  order, composable with the containers); XLA fuses gather -> multiply
  -> reduce into one loop on the GPU.
* BCSR — per stored block, ``A_rows @ B_cols^T`` as one batched einsum.

Operator protocol: builders return ``(buffers, fn)`` with buffers passed
as jit arguments — never closure constants (see ops/spmv.py docstring).
"""
from __future__ import annotations

from loops_tpu.formats import BCSR, COO, CSR

__all__ = ["sddmm", "SDDMMOperator"]


class SDDMMOperator:
    def __init__(self, mat, dtype=None):
        import jax

        self.mat = mat
        self.dtype = dtype
        if isinstance(mat, CSR):
            self._bufs, fn = self._build_nz(mat.row_ids(), mat.indices,
                                            mat.vals, dtype)
        elif isinstance(mat, COO):
            self._bufs, fn = self._build_nz(mat.rows, mat.cols, mat.vals,
                                            dtype)
        elif isinstance(mat, BCSR):
            self._bufs, fn = self._build_bcsr_xla(mat)
        else:
            raise TypeError(f"sddmm: unsupported format {type(mat).__name__}")
        self._jit = jax.jit(fn)
        self._fn = lambda A, B: self._jit(self._bufs, A, B)

    @staticmethod
    def _build_nz(rid_np, cid_np, vals_np, dtype=None):
        import jax.numpy as jnp

        bufs = dict(rid=jnp.asarray(rid_np), cid=jnp.asarray(cid_np),
                    vals=jnp.asarray(vals_np))

        def fn(b, A, B):
            if dtype is not None:
                # dtype="bfloat16" halves the gathered-row traffic;
                # scores accumulate in f32
                A = A.astype(dtype)
                B = B.astype(dtype)
            if dtype is None:
                dots = jnp.einsum("nf,nf->n", A[b["rid"]], B[b["cid"]],
                                  precision="highest")
            else:
                dots = jnp.einsum("nf,nf->n", A[b["rid"]], B[b["cid"]],
                                  preferred_element_type=jnp.float32)
            return b["vals"] * dots
        return bufs, fn

    @staticmethod
    def _build_bcsr_xla(bcsr: BCSR):
        import jax.numpy as jnp

        R, C = bcsr.block_shape
        rows, cols = bcsr.shape
        nbr_R = bcsr.num_block_rows * R
        nbc_C = bcsr.num_block_cols * C
        bufs = dict(brow=jnp.asarray(bcsr.block_row_ids()),
                    bcol=jnp.asarray(bcsr.block_cols),
                    vals=jnp.asarray(bcsr.vals))

        def fn(b, A, B):
            F = A.shape[1]
            Ap = jnp.zeros((nbr_R, F), A.dtype).at[:rows].set(A)
            Bp = jnp.zeros((nbc_C, F), B.dtype).at[:cols].set(B)
            Ab = Ap.reshape(-1, R, F)[b["brow"]]      # [nb, R, F]
            Bb = Bp.reshape(-1, C, F)[b["bcol"]]      # [nb, C, F]
            dots = jnp.einsum("brf,bcf->brc", Ab, Bb, precision="highest")
            return b["vals"] * dots
        return bufs, fn

    def __call__(self, A, B):
        import jax.numpy as jnp
        return self._jit(self._bufs, jnp.asarray(A), jnp.asarray(B))


def _op_cache(mat) -> dict:
    cache = getattr(mat, "_sddmm_ops", None)
    if cache is None:
        cache = {}
        object.__setattr__(mat, "_sddmm_ops", cache)
    return cache


def sddmm(mat, A, B, dtype=None):
    """Sampled products at the sparsity pattern of ``mat``.

    Returns per-nonzero values in the container's storage order (CSR/COO)
    or per-block dense payloads (BCSR). ``dtype="bfloat16"`` rounds the
    dense operands before the edge dots (f32 accumulation).
    """
    key = str(dtype)
    cache = _op_cache(mat)
    if key not in cache:
        cache[key] = SDDMMOperator(mat, dtype)
    return cache[key](A, B)
