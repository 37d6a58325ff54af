#!/usr/bin/env python
"""User-extensibility proof: a custom layout driving stock schedules.

The analog of the reference's ``custom_layout.cu`` (reference:
examples/spmv/custom_layout.cu:64-244): a user-defined *row-padded*
layout — rows padded to a fixed stride with explicit padding atoms, as a
user might store telemetry frames — plugged into the framework's stock
planners (row_mapped and merge_path) without touching framework code.
Anything exposing ``num_tiles``/``num_atoms``/``tile_offsets`` is
schedulable.
"""
from __future__ import annotations

import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from loops_tpu.utils.platform import (  # noqa: E402
    enable_compilation_cache,
    ensure_platform,
)

ensure_platform()
enable_compilation_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from loops_tpu.layout import UniformLayout, check_layout_invariants  # noqa: E402
from loops_tpu.schedule import make_plan  # noqa: E402
from loops_tpu.utils import generate, reference  # noqa: E402


class RowPaddedLayout(UniformLayout):
    """User-defined: every row stored padded to ``stride`` slots; atom k
    belongs to row k // stride, and slots beyond the row's true size are
    padding. Closed-form — no offsets array materialized."""

    def __init__(self, row_sizes, stride):
        super().__init__(num_tiles=len(row_sizes), pitch=int(stride))
        self.row_sizes = np.asarray(row_sizes)

    def valid_mask(self):
        k = np.arange(self.pitch)
        return k[None, :] < self.row_sizes[:, None]


def main():
    # user data: a random CSR re-stored in row-padded form
    csr = generate.random_csr(64, 48, 0.1, seed=7)
    stride = int(csr.row_sizes().max())
    layout = RowPaddedLayout(csr.row_sizes(), stride)
    check_layout_invariants(layout)  # the stock contract checker

    # pack the user's storage
    vals = np.zeros((64, stride), np.float32)
    cols = np.zeros((64, stride), np.int32)
    mask = layout.valid_mask()
    rid = csr.row_ids()
    rank = np.arange(csr.nnz) - csr.offsets[rid]
    vals[rid, rank] = csr.vals
    cols[rid, rank] = csr.indices

    x = generate.make_input_vector(48)
    y_ref = reference.spmv(csr, x)

    # stock row_mapped over the custom layout: segment ids come straight
    # from the layout contract
    seg = jnp.asarray(layout.atom_tile_ids())
    flat_vals = jnp.asarray(np.where(mask, vals, 0).ravel())
    flat_cols = jnp.asarray(cols.ravel())
    y = jax.ops.segment_sum(flat_vals * jnp.asarray(x)[flat_cols], seg,
                            num_segments=layout.num_tiles,
                            indices_are_sorted=True)
    err_row = np.abs(np.asarray(y) - y_ref).max()

    # stock merge_path planner over the same custom layout
    plan = make_plan(layout, "merge_path", block_work=32)
    fv = np.where(mask, vals, 0).ravel()
    fc = cols.ravel()
    pv = jnp.asarray(np.where(plan.valid, fv[plan.atom_gather], 0))
    pc = jnp.asarray(fc[plan.atom_gather])
    ids = np.where(plan.valid,
                   plan.tile_starts[:-1, None].astype(np.int64)
                   + plan.rel_tile, layout.num_tiles)
    y2 = jax.ops.segment_sum(
        (pv * jnp.asarray(x)[pc]).ravel(), jnp.asarray(ids.ravel()),
        num_segments=layout.num_tiles + 1)[: layout.num_tiles]
    err_mp = np.abs(np.asarray(y2) - y_ref).max()

    print(f"custom row-padded layout: {layout.num_tiles} tiles x "
          f"{stride} stride, {layout.num_atoms} atoms "
          f"({csr.nnz} real)")
    print(f"row_mapped max err:  {err_row:.2e}")
    print(f"merge_path max err:  {err_mp:.2e}")
    ok = err_row < 1e-4 and err_mp < 1e-4
    print("Errors: 0" if ok else "Errors: >0")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
