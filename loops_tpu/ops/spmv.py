"""SpMV — sparse matrix x dense vector across all formats and schedules.

User-facing parity with the reference's 12 SpMV kernels (reference:
include/loops/algorithms/spmv/*.cuh). Every schedule's *plan* is host
precompute (loops_tpu.schedule.plans); the device executes static-shape
XLA programs (gather -> multiply -> reduce, which XLA fuses into one
loop on the GPU).

Schedule -> execution strategy (per format):

* ``row_mapped``   — segmented reduction over per-atom products; the
  analog of thread_mapped (reference: spmv/thread_mapped.cuh:31-91). For
  dense-plane formats (ELL/DIA/BCSR) this is a pure dense reduction with
  zero scatter.
* ``group_mapped`` — bucketed-ELL dense row reductions over the
  GroupMappedPlan (reference: spmv/group_mapped.cuh:31-105 pools a
  group's atoms; here the pool is a degree-class plane).
* ``work_oriented`` — even atom split into K-blocks, two-phase partial
  sums + seam accumulation (reference: spmv/work_oriented.cuh:39-121,
  whose atomicAdd seams become deterministic adds).
* ``merge_path``   — merge-path diagonal split of (tiles+atoms); the
  per-block <=K-atoms / <=K-row-span guarantee keeps every block's
  shape static (reference: spmv/merge_path_flat.cuh:96-139).

The ``original`` baseline (reference: spmv/original.cuh:26-76 — a raw
grid-stride row loop with no schedule) maps to ``schedule="row_mapped"``
since XLA owns the raw-loop tier.

Operator protocol: every builder returns ``(buffers, fn)`` where
``fn(buffers, x)`` is the pure device function — buffers ride as jit
*arguments*, never as closure constants (closure-captured arrays are
baked into the HLO as literals, which bloats executables for large
matrices).
"""
from __future__ import annotations

import numpy as np

from loops_tpu.formats import BCSR, COO, CSC, CSR, DIA, ELL
from loops_tpu.layout import (
    CooLayout,
    CsrLayout,
    EllLayout,
    FlatRebinLayout,
)
from loops_tpu.schedule.plans import SCHEDULES, make_plan

__all__ = ["spmv", "SpMVOperator", "SCHEDULES"]


def _segment_sum(data, ids, num_segments, sorted_ids=False):
    import jax
    return jax.ops.segment_sum(data, ids, num_segments=num_segments,
                               indices_are_sorted=sorted_ids)


def _require(fmt: str, schedule: str, schedules: tuple):
    """Restrict ``schedule`` to the names the format honors — the API
    must not pretend to honor a knob it ignores."""
    if schedule not in schedules:
        raise ValueError(
            f"{fmt} SpMV implements schedules {schedules}, got "
            f"{schedule!r} (every {fmt} strategy funnels into one "
            "execution shape; pick a supported name)")


class SpMVOperator:
    """A compiled SpMV bound to one matrix: plan once, execute many.

    The reference rebuilds its schedule inside every kernel launch from
    raw pointers; here planning is host work, so the operator form makes
    the plan/execute split explicit.
    """

    def __init__(self, mat, schedule: str = "row_mapped",
                 block: int | None = None,
                 reorder: str | None = None,
                 class_step: float | None = None):
        import jax

        if block is None:
            # device-keyed default (the reference's launch_box analog,
            # util/launch_box.hxx:176-214)
            from loops_tpu.tuning.launch_box import launch_params
            block = launch_params().spmv_block
        if schedule not in SCHEDULES and schedule != "auto":
            raise ValueError(
                f"unknown schedule {schedule!r}; expected one of "
                f"{SCHEDULES + ('auto',)}")
        # plan-time symmetric reorder (layout/reorder.py): the
        # permutation folds into the operator as in-graph x/y gathers;
        # default off (its effect on this card is not measured)
        self._perm = None
        if reorder is not None:
            from loops_tpu.formats import CSR
            from loops_tpu.layout.reorder import (
                bfs_order,
                degree_order,
                inverse_permutation,
                permute_csr,
            )
            if not isinstance(mat, CSR):
                raise ValueError("reorder= implements CSR only")
            if mat.shape[0] != mat.shape[1]:
                raise ValueError(
                    "reorder= is a symmetric (square) permutation")
            if reorder == "degree":
                perm = degree_order(mat)
            elif reorder == "bfs":
                perm = bfs_order(mat)
            else:
                raise ValueError(
                    f"unknown reorder {reorder!r}; 'degree' or 'bfs'")
            self._perm = perm
            self._inv = inverse_permutation(perm)
            mat = permute_csr(mat, perm)
        self.mat = mat
        self.reorder = reorder
        self.schedule = schedule
        self.block = block
        # group_mapped degree-class granularity override: finer classes
        # (0.5) shrink the largest bucket's slot count on huge uniform
        # planes
        self.class_step = class_step
        self.rows, self.cols = mat.shape
        builder = getattr(self, f"_build_{type(mat).__name__.lower()}")
        self._bufs, fn = builder(mat, schedule, block)
        if self._perm is not None:
            import jax.numpy as jnp
            inner = fn
            perm_d = jnp.asarray(self._perm)
            inv_d = jnp.asarray(self._inv)
            self._bufs = dict(_inner=self._bufs, _perm=perm_d,
                              _inv=inv_d)

            def fn(b, x):
                # y_orig[i] = y_perm[inv[i]];  x_perm[i] = x[perm[i]]
                return inner(b["_inner"], x[b["_perm"]])[b["_inv"]]
        self._jit = jax.jit(fn)
        self._fn = lambda x: self._jit(self._bufs, x)

    def __call__(self, x):
        import jax.numpy as jnp
        return self._jit(self._bufs, jnp.asarray(x))

    # ------------------------------------------------------------- CSR
    def _build_csr(self, csr: CSR, schedule, block):
        import jax.numpy as jnp

        rows = self.rows
        layout = CsrLayout.from_csr(csr)
        if schedule == "auto":
            from loops_tpu.schedule.plans import choose_schedule
            schedule = self.schedule = choose_schedule(layout)

        if schedule == "row_mapped":
            plan = make_plan(layout, schedule)
            bufs = dict(vals=jnp.asarray(csr.vals),
                        cols=jnp.asarray(csr.indices),
                        rid=jnp.asarray(plan.atom_tile_ids))

            def fn(b, x):
                return _segment_sum(b["vals"] * x[b["cols"]], b["rid"],
                                    rows, sorted_ids=True)
            return bufs, fn

        if schedule == "group_mapped":
            plan = make_plan(layout, schedule,
                             **({"class_step": self.class_step}
                                if self.class_step else {}))
            bufs = dict(buckets=[
                (jnp.asarray(b["tiles"]),
                 jnp.asarray(csr.indices[b["atom_slots"]]),
                 jnp.asarray(np.where(b["valid"],
                                      csr.vals[b["atom_slots"]], 0)))
                for b in plan.buckets])

            def fn(b, x):
                y = jnp.zeros(rows, dtype=x.dtype)
                for tiles, idx, v in b["buckets"]:
                    y = y.at[tiles].add((v * x[idx]).sum(axis=1))
                return y
            return bufs, fn

        # balanced flat schedules
        plan = make_plan(layout, schedule,
                         **({"block_atoms": block}
                            if schedule == "work_oriented"
                            else {"block_work": block}))
        return self._flat_xla(plan,
                              vals=np.where(plan.valid,
                                            csr.vals[plan.atom_gather], 0),
                              gather_cols=csr.indices[plan.atom_gather],
                              out_of_tile=None)

    # ------------------------------------------------------------- COO
    def _build_coo(self, coo: COO, schedule, block):
        import jax.numpy as jnp

        if schedule == "auto":
            schedule = self.schedule = "row_mapped"
        rows = self.rows
        sorted_rows = bool(np.all(np.diff(coo.rows) >= 0))

        if schedule in ("row_mapped", "group_mapped"):
            # tile == atom == nonzero: both collapse to the scatter
            # reduction (reference: spmv/coo_thread_mapped.cuh:37-89).
            bufs = dict(vals=jnp.asarray(coo.vals),
                        cols=jnp.asarray(coo.cols),
                        rid=jnp.asarray(coo.rows))

            def fn(b, x):
                return _segment_sum(b["vals"] * x[b["cols"]], b["rid"],
                                    rows, sorted_ids=sorted_rows)
            return bufs, fn

        # flat schedules over the degenerate COO layout: per-block partial
        # products, combined through the *matrix* row ids.
        layout = CooLayout.from_coo(coo)
        plan = make_plan(layout, schedule,
                         **({"block_atoms": block}
                            if schedule == "work_oriented"
                            else {"block_work": block}))
        return self._flat_xla(
            plan,
            vals=np.where(plan.valid, coo.vals[plan.atom_gather], 0),
            gather_cols=coo.cols[plan.atom_gather],
            out_of_tile=coo.rows)

    # ------------------------------------------------------------- CSC
    def _build_csc(self, csc: CSC, schedule, block):
        import jax.numpy as jnp

        if schedule == "auto":
            schedule = self.schedule = "row_mapped"
        # tile = column; atoms scatter to arbitrary output rows, so the
        # only execution shape is the scatter reduction — same as the
        # reference's single csc kernel (spmv/csc_thread_mapped.cuh:37-87).
        # Other schedule names would be silently ignored; reject them.
        _require("csc", schedule, ("row_mapped",))
        rows = self.rows
        bufs = dict(vals=jnp.asarray(csc.vals),
                    out_rows=jnp.asarray(csc.indices),
                    col_of_atom=jnp.asarray(csc.col_ids()))

        def fn(b, x):
            return _segment_sum(b["vals"] * x[b["col_of_atom"]],
                                b["out_rows"], rows)
        return bufs, fn

    # ------------------------------------------------------------- ELL
    def _build_ell(self, ell: ELL, schedule, block):
        import jax.numpy as jnp

        rows = self.rows
        idx_plane, val_plane = ell.as_jax(pad_rows_to=1, pad_pitch_to=1)

        if schedule in ("row_mapped", "group_mapped", "auto"):
            # The plane is already one uniform group: a dense masked
            # row-reduction (reference: spmv/ell_thread_mapped.cuh:28-76,
            # whose sentinel skips become multiply-by-zero).
            bufs = dict(idx=idx_plane, val=val_plane)

            def fn(b, x):
                return (b["val"] * x[b["idx"]]).sum(axis=1)[:rows]
            return bufs, fn

        # flat schedules over the closed-form uniform layout — the
        # contract stress test (reference: spmv/ell_merge_path.cuh:32-126)
        layout = EllLayout.from_ell(ell)
        plan = make_plan(layout, schedule,
                         **({"block_atoms": block}
                            if schedule == "work_oriented"
                            else {"block_work": block}))
        flat_vals = np.where(ell.indices == -1, 0, ell.vals).ravel()
        flat_cols = np.where(ell.indices == -1, 0, ell.indices).ravel()
        return self._flat_xla(
            plan,
            vals=np.where(plan.valid, flat_vals[plan.atom_gather], 0),
            gather_cols=flat_cols[plan.atom_gather],
            out_of_tile=None)

    # ------------------------------------------------------------- BCSR
    def _build_bcsr(self, bcsr: BCSR, schedule, block):
        import jax.numpy as jnp

        if schedule == "auto":
            schedule = self.schedule = "row_mapped"
        # atoms are stored blocks and the reduction is block-row-local,
        # so there is one execution shape (the reference likewise ships
        # only bcsr_thread_mapped)
        _require("bcsr", schedule, ("row_mapped",))

        rows = self.rows
        R, C = bcsr.block_shape
        nbr = bcsr.num_block_rows
        ncols_pad = bcsr.num_block_cols * C
        cols = self.cols
        bufs = dict(vals=jnp.asarray(bcsr.vals),
                    bcols=jnp.asarray(bcsr.block_cols),
                    brid=jnp.asarray(bcsr.block_row_ids()))

        # Atoms are stored blocks: per-atom work is a dense RxC
        # mini-matvec (reference: spmv/bcsr_thread_mapped.cuh:
        # 36-123 accumulates R registers; here it is a batched einsum).
        def fn(b, x):
            xp = jnp.zeros(ncols_pad, x.dtype).at[:cols].set(x)
            xb = xp.reshape(-1, C)[b["bcols"]]             # [nb, C]
            # f32 promised: HIGHEST keeps the GPU off TF32
            prod = jnp.einsum("brc,bc->br", b["vals"], xb,
                              precision="highest")          # [nb, R]
            yb = _segment_sum(prod, b["brid"], nbr, sorted_ids=True)
            return yb.reshape(-1)[:rows]
        return bufs, fn

    # ------------------------------------------------------------- DIA
    def _build_dia(self, dia: DIA, schedule, block):
        import jax.numpy as jnp

        if schedule == "auto":
            schedule = self.schedule = "row_mapped"
        # one execution shape: the dense diagonal sweep (the reference
        # likewise ships only dia_thread_mapped)
        _require("dia", schedule, ("row_mapped",))
        rows, cols = self.rows, self.cols
        offs = dia.diag_offsets.astype(np.int64)
        # per-diagonal column index of each row; clamped + masked
        col_idx = np.arange(rows)[None, :] + offs[:, None]   # [D, rows]
        mask = (col_idx >= 0) & (col_idx < cols)
        col_idx = np.clip(col_idx, 0, max(cols - 1, 0))
        bufs = dict(vals=jnp.asarray(np.where(mask, dia.vals, 0)),
                    col_idx=jnp.asarray(col_idx))

        # Diagonal sweep: dense shifted multiplies, no irregularity at all
        # (reference: spmv/dia_thread_mapped.cuh:36-96).
        def fn(b, x):
            return (b["vals"] * x[b["col_idx"]]).sum(axis=0)
        return bufs, fn

    # ------------------------------------------------- flat XLA executor
    def _flat_xla(self, plan, vals, gather_cols, out_of_tile):
        """Two-phase blocked reduction for the flat schedules.

        Phase 1: per-block products (static [num_blocks, K]).
        Phase 2: combine by output row. When the layout's tiles *are* the
        output rows (CSR/ELL) the ids come from the plan's
        tile_starts+rel_tile; COO routes through the matrix row ids
        (``out_of_tile``).
        """
        import jax.numpy as jnp

        rows = self.rows
        if out_of_tile is None:
            ids = (plan.tile_starts[:-1, None].astype(np.int64)
                   + plan.rel_tile)
            ids = np.where(plan.valid, np.minimum(ids, rows), rows)
            sorted_ids = True
        else:
            ids = np.where(plan.valid, out_of_tile[plan.atom_gather], rows)
            sorted_ids = False
        bufs = dict(v=jnp.asarray(vals), gc=jnp.asarray(gather_cols),
                    ids=jnp.asarray(ids.astype(np.int32)))

        def fn(b, x):
            products = b["v"] * x[b["gc"]]  # [B, K]
            y = _segment_sum(products.ravel(), b["ids"].ravel(), rows + 1,
                             sorted_ids=sorted_ids)
            return y[:rows]
        return bufs, fn


def _op_cache(mat) -> dict:
    cache = getattr(mat, "_spmv_ops", None)
    if cache is None:
        cache = {}
        object.__setattr__(mat, "_spmv_ops", cache)
    return cache


def spmv(mat, x, schedule: str = "row_mapped", block: int | None = None):
    """One-shot SpMV with operator caching on the container."""
    key = (schedule, block)
    cache = _op_cache(mat)
    if key not in cache:
        cache[key] = SpMVOperator(mat, schedule, block)
    return cache[key](x)


def flat_partitioned_spmv(csr: CSR, x, atoms_per_tile: int = 8):
    """SpMV through the flat re-binning partitioner: K-atom windows
    processed tile-agnostically, outputs addressed via the base layout
    (reference: spmv/flat_partitioned.cuh:46-106 — its per-atom
    ``base().tile_of`` binary search + atomicAdd becomes a materialized
    segment-id reduction)."""
    import jax.numpy as jnp

    flat = FlatRebinLayout(CsrLayout.from_csr(csr), atoms_per_tile)
    vals = jnp.asarray(csr.vals)
    cols = jnp.asarray(csr.indices)
    base_ids = jnp.asarray(flat.base_tile_ids())
    x = jnp.asarray(x)
    return _segment_sum(vals * x[cols], base_ids, csr.shape[0],
                        sorted_ids=True)
