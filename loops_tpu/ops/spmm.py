"""SpMM — sparse matrix x dense matrix (the GNN aggregation primitive).

The reference ships a single thread-mapped SpMM (reference:
include/loops/algorithms/spmm/thread_mapped.cuh:32-90 — per row, loop over
B columns, inner atoms loop). Here:

* CSR ``row_mapped``  — gather-multiply-segment: C = segsum(vals * B[cols])
  (XLA fuses the gather into the reduction; the irregular baseline).
* CSR ``group_mapped`` — bucketed-ELL planes: dense masked
  [rows_b, pitch_b, F] reductions per degree class.
* ELL — one uniform dense plane reduction.
* BCSR — grouped block-sparse matmul. ``impl="xla"`` is a batched
  einsum + segment-sum over block rows; ``impl="pallas"`` is the Triton
  kernel that loops over a block row's blocks and accumulates their
  dots in registers (ops/kernels/spmm_bcsr.py).

Operator protocol: builders return ``(buffers, fn)`` with buffers passed
as jit arguments — never closure constants (see ops/spmv.py docstring).
"""
from __future__ import annotations

import numpy as np

from loops_tpu.formats import BCSR, COO, CSR, ELL
from loops_tpu.layout import CsrLayout
from loops_tpu.schedule.plans import make_plan

__all__ = ["spmm", "SpMMOperator"]


def _segment_sum(data, ids, num_segments, sorted_ids=False):
    import jax
    return jax.ops.segment_sum(data, ids, num_segments=num_segments,
                               indices_are_sorted=sorted_ids)


def _pallas_f64_fallback(impl: str, vals_dtype) -> str:
    """The BCSR kernel computes in f32 (or caller-requested bf16); f64
    values fall back to the XLA path with a warning instead of being
    silently downcast."""
    import warnings

    if impl == "pallas" and np.dtype(vals_dtype) == np.float64:
        warnings.warn(
            f"impl={impl!r} stages float32 registers; falling back to "
            "the XLA path for float64 values (pass float32 data to use "
            "the Pallas kernel)", stacklevel=3)
        return "xla"
    return impl


class SpMMOperator:
    """Compiled SpMM bound to one sparse matrix: ``op(B) -> C``.

    ``impl`` picks the BCSR path (``"xla"`` einsum or ``"pallas"``
    kernel); every other format runs through XLA only.
    """

    def __init__(self, mat, schedule: str = "row_mapped",
                 impl: str = "xla", block_f: int | None = None, dtype=None,
                 hub_dense_min: int | None = None):
        import jax

        if block_f is None:
            from loops_tpu.tuning.launch_box import launch_params
            block_f = launch_params().spmm_block_f

        self.mat = mat
        self.rows, self.cols = mat.shape
        self.schedule = schedule
        self.impl = impl
        self.block_f = block_f
        self.dtype = dtype
        self.hub_dense_min = hub_dense_min
        if impl != "xla" and not isinstance(mat, BCSR):
            raise ValueError(
                f"impl={impl!r} selects a BCSR kernel; "
                f"{type(mat).__name__} SpMM runs through XLA only")
        builder = getattr(self, f"_build_{type(mat).__name__.lower()}")
        self._bufs, fn = builder(mat, schedule)
        self._jit = jax.jit(fn)
        self._fn = lambda B: self._jit(self._bufs, B)

    def __call__(self, B):
        import jax.numpy as jnp
        return self._jit(self._bufs, jnp.asarray(B))

    # ------------------------------------------------------------- CSR
    def _build_csr(self, csr: CSR, schedule):
        import jax.numpy as jnp

        rows = self.rows
        if schedule == "auto":
            from loops_tpu.schedule.plans import choose_schedule
            pick = choose_schedule(CsrLayout.from_csr(csr))
            # the skew pick maps to the degree-class planes; the flat
            # picks lower to the same gather-segment XLA path as
            # row_mapped
            schedule = self.schedule = (
                "group_mapped" if pick == "group_mapped" else "row_mapped")
        if schedule == "group_mapped":
            plan = make_plan(CsrLayout.from_csr(csr), "group_mapped")
            # Hub-dense hybrid: rows denser than ~1/16 of the columns
            # gather a large fraction of B *randomly*; materializing them
            # as dense rows turns that into one streamed matmul (B is
            # read contiguously and reused across all hubs).
            hub_min = (self.hub_dense_min if self.hub_dense_min is not None
                       else max(self.cols // 16, 1024))
            hub_tiles, plane_buckets = [], []
            budget = 64 << 20  # cap dense payload at 64M elements
            for b in plan.buckets:
                pitch = b["atom_slots"].shape[1]
                h = len(b["tiles"])
                if (pitch >= hub_min
                        and (len(hub_tiles) + h) * self.cols <= budget):
                    hub_tiles.extend(b["tiles"].tolist())
                else:
                    plane_buckets.append(b)
            bufs = dict(buckets=[
                (jnp.asarray(b["tiles"]),
                 jnp.asarray(csr.indices[b["atom_slots"]]),
                 jnp.asarray(np.where(b["valid"],
                                      csr.vals[b["atom_slots"]], 0)))
                for b in plane_buckets])
            if hub_tiles:
                hub_tiles = np.asarray(hub_tiles, dtype=np.int64)
                dense = np.zeros((len(hub_tiles), self.cols), np.float32)
                for i, t in enumerate(hub_tiles):
                    a0, a1 = csr.offsets[t], csr.offsets[t + 1]
                    dense[i, csr.indices[a0:a1]] = csr.vals[a0:a1]
                bufs["hub_tiles"] = jnp.asarray(
                    hub_tiles.astype(np.int32))
                bufs["hub_rows"] = jnp.asarray(dense)

            dtype = self.dtype

            def fn(b, B):
                # dtype="bfloat16" halves the random B-row gather
                # traffic; accumulation stays f32
                Bg = B if dtype is None else B.astype(dtype)
                C = jnp.zeros((rows, B.shape[1]), jnp.float32)
                for tiles, idx, v in b["buckets"]:
                    vv = v if dtype is None else v.astype(dtype)
                    s = (vv[..., None] * Bg[idx]).astype(jnp.float32)
                    C = C.at[tiles].add(s.sum(axis=1))
                if "hub_rows" in b:
                    hub_out = jnp.dot(b["hub_rows"], B, precision="highest",
                                      preferred_element_type=jnp.float32)
                    C = C.at[b["hub_tiles"]].add(hub_out.astype(C.dtype))
                return C.astype(B.dtype)
            return bufs, fn

        bufs = dict(vals=jnp.asarray(csr.vals),
                    cols=jnp.asarray(csr.indices),
                    rid=jnp.asarray(csr.row_ids()))
        dtype = self.dtype

        def fn(b, B):
            if dtype is not None:
                # bf16 gather halves the dominant random-read traffic;
                # accumulation stays f32
                import jax.numpy as jnp
                prod = (b["vals"].astype(dtype)[:, None]
                        * B.astype(dtype)[b["cols"]]).astype(jnp.float32)
            else:
                prod = b["vals"][:, None] * B[b["cols"]]
            return _segment_sum(prod, b["rid"], rows, sorted_ids=True)
        return bufs, fn

    # ------------------------------------------------------------- COO
    def _build_coo(self, coo: COO, schedule):
        import jax.numpy as jnp

        if schedule not in ("row_mapped", "auto"):
            raise ValueError(
                "coo SpMM implements schedule='row_mapped' only, got "
                f"{schedule!r}")
        rows = self.rows
        sorted_rows = bool(np.all(np.diff(coo.rows) >= 0))
        bufs = dict(vals=jnp.asarray(coo.vals),
                    cols=jnp.asarray(coo.cols),
                    rid=jnp.asarray(coo.rows))

        def fn(b, B):
            return _segment_sum(b["vals"][:, None] * B[b["cols"]],
                                b["rid"], rows, sorted_ids=sorted_rows)
        return bufs, fn

    # ------------------------------------------------------------- ELL
    def _build_ell(self, ell: ELL, schedule):
        if schedule not in ("row_mapped", "auto"):
            raise ValueError(
                "ell SpMM implements schedule='row_mapped' only, got "
                f"{schedule!r}")
        rows = self.rows
        idx_plane, val_plane = ell.as_jax(pad_rows_to=1, pad_pitch_to=1)
        bufs = dict(idx=idx_plane, val=val_plane)

        def fn(b, B):
            return (b["val"][..., None] * B[b["idx"]]).sum(axis=1)[:rows]
        return bufs, fn

    # ------------------------------------------------------------- BCSR
    def _build_bcsr(self, bcsr: BCSR, schedule):
        import jax.numpy as jnp

        impl = _pallas_f64_fallback(self.impl, bcsr.vals.dtype)
        if impl == "pallas":
            from loops_tpu.ops.kernels.spmm_bcsr import bcsr_spmm_pallas
            return bcsr_spmm_pallas(bcsr, block_f=self.block_f,
                                    dtype=self.dtype)
        if impl != "xla":
            raise ValueError(
                f"bcsr SpMM implements impl in ('xla', 'pallas'), got "
                f"{impl!r}")

        rows = self.rows
        cols = self.cols
        R, C = bcsr.block_shape
        nbr = bcsr.num_block_rows
        ncols_pad = bcsr.num_block_cols * C
        bufs = dict(vals=jnp.asarray(bcsr.vals),
                    bcols=jnp.asarray(bcsr.block_cols),
                    brid=jnp.asarray(bcsr.block_row_ids()))

        dtype = self.dtype

        def fn(b, B):
            F = B.shape[1]
            vals = b["vals"]
            if dtype is not None:
                vals, B = vals.astype(dtype), B.astype(dtype)
            Bp = jnp.zeros((ncols_pad, F), B.dtype).at[:cols].set(B)
            Bb = Bp.reshape(-1, C, F)[b["bcols"]]            # [nb, C, F]
            # f32 promised: HIGHEST keeps the GPU off TF32; bf16 mode
            # accumulates in f32
            if dtype is None:
                prod = jnp.einsum("brc,bcf->brf", vals, Bb,
                                  precision="highest")
            else:
                prod = jnp.einsum("brc,bcf->brf", vals, Bb,
                                  preferred_element_type=jnp.float32)
            Cb = _segment_sum(prod, b["brid"], nbr, sorted_ids=True)
            return Cb.reshape(-1, F)[:rows]
        return bufs, fn


def _op_cache(mat) -> dict:
    cache = getattr(mat, "_spmm_ops", None)
    if cache is None:
        cache = {}
        object.__setattr__(mat, "_spmm_ops", cache)
    return cache


def spmm(mat, B, schedule: str = "row_mapped", impl: str = "xla",
         block_f: int | None = None, dtype=None):
    key = (schedule, impl, block_f, str(dtype))
    cache = _op_cache(mat)
    if key not in cache:
        cache[key] = SpMMOperator(mat, schedule, impl, block_f, dtype)
    return cache[key](B)
