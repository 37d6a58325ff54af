"""Schedule planners — host-side work partitioning for the device ops.

The reference's ``schedule::setup`` templates run *on the device*, mapping
processor ids to (tile, atom) work at kernel time (reference:
include/loops/schedule.hxx:55-63 and schedule/*.hxx). Here the split is
different: **planning is a host/trace-time precompute producing
static-shape arrays**, and the device sees only dense, regular work. Each
planner here is the analog of one reference schedule:

==============  ====================================================
schedule        realization
==============  ====================================================
row_mapped      per-atom segment ids -> XLA segmented reduction
                (reference thread_mapped, schedule/thread_mapped.hxx)
group_mapped    bucketed-ELL / SELL-style row grouping: rows binned by
                degree class, each bucket a dense [rows_b, pitch_b]
                plane -> pure dense row reductions, zero scatter
                (reference group_mapped pools a group's atoms,
                schedule/group_mapped.hxx:104-143 — here the pool is a
                padded plane)
work_oriented   even split of atoms into K-sized blocks + per-block
                first-row carry info (reference work_oriented's
                even-share of tiles+atoms, schedule/work_oriented.hxx)
merge_path      merge-path diagonal split of (tiles + atoms) into
                blocks of K work items — the load-bearing guarantee:
                **each block has <= K atoms AND spans <= K rows**,
                so per-block one-hot reductions have static shapes
                (reference merge_path_flat's preprocess_t,
                schedule/merge_path_flat.hxx:99-172)
==============  ====================================================
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from loops_tpu.formats.base import INDEX_DTYPE
from loops_tpu.layout.contract import Layout
from loops_tpu.layout.merge_path import merge_path_partition

SCHEDULES = ("row_mapped", "group_mapped", "work_oriented", "merge_path")


# --------------------------------------------------------------------------
@dataclass
class RowMappedPlan:
    """Per-atom segment ids; the direct segmented-reduction schedule."""
    num_tiles: int
    num_atoms: int
    atom_tile_ids: np.ndarray  # [num_atoms]

    @classmethod
    def from_layout(cls, layout: Layout) -> "RowMappedPlan":
        return cls(layout.num_tiles, layout.num_atoms,
                   layout.atom_tile_ids())


# --------------------------------------------------------------------------
@dataclass
class GroupMappedPlan:
    """Bucketed-ELL (SELL-style) grouping.

    Tiles are binned by size class (geometric, ``2**class_step`` growth
    up to ``max_pitch``, with one overflow bucket for heavier tiles).
    Each bucket stores a permutation of its tile ids plus a dense
    atom-slot plane: slot (i, k) is atom ``tile_begin(tile_i) + k`` if
    k < tile_size else padding.

    The device then runs one dense masked row-reduction per bucket —
    regular compute, bounded padding (< 2**class_step by construction),
    no scatter. Padded slots gather index 0, so tighter classes cut
    padding, but each bucket is a separate op chain with its own fixed
    cost; pow-2 classes are the default, tuned per matrix via
    ``class_step``.
    """
    num_tiles: int
    num_atoms: int
    buckets: list = field(default_factory=list)
    # each bucket: dict(tiles=[n_b] tile ids, atom_slots=[n_b, pitch_b]
    #                   atom index or 0, valid=[n_b, pitch_b] bool)

    @classmethod
    def from_layout(cls, layout: Layout, max_pitch: int = 1 << 14,
                    class_step: float = 1.0) -> "GroupMappedPlan":
        sizes = layout.tile_sizes()
        begins = layout.tile_offsets()[:-1]
        plan = cls(layout.num_tiles, layout.num_atoms)
        if layout.num_tiles == 0:
            return plan
        # size class: smallest 2**(k*class_step) >= size (empty tiles
        # dropped — their output is zero by construction)
        classes = np.zeros(len(sizes), dtype=np.float64)
        nz = sizes > 0
        classes[nz] = (np.ceil(np.log2(sizes[nz]) / class_step)
                       * class_step)
        classes[sizes > max_pitch] = -1  # overflow bucket
        for c in np.unique(classes[nz]):
            tiles = np.nonzero(nz & (classes == c))[0]
            pitch = (int(sizes[tiles].max()) if c == -1
                     else int(np.ceil(2.0 ** c)))
            k = np.arange(pitch)
            slots = begins[tiles][:, None] + k[None, :]
            valid = k[None, :] < sizes[tiles][:, None]
            plan.buckets.append(dict(
                tiles=tiles.astype(INDEX_DTYPE),
                atom_slots=np.where(valid, slots, 0).astype(INDEX_DTYPE),
                valid=valid,
            ))
        return plan

    @property
    def padded_atoms(self) -> int:
        return sum(b["atom_slots"].size for b in self.buckets)


# --------------------------------------------------------------------------
@dataclass
class FlatBlockPlan:
    """Shared result type of the two balanced flat schedules.

    Work is cut into ``num_blocks`` blocks. Block b owns atoms
    [atom_starts[b], atom_starts[b+1]) and rows (tiles)
    [tile_starts[b], tile_starts[b+1]] — note the closed upper end: the
    row at ``tile_starts[b+1]`` may be split across the block seam.

    Also carries the dense per-block staging arrays the executors
    consume: ``atom_gather`` [num_blocks, block_atoms] (source atom per
    slot, 0-padded), ``rel_tile`` [num_blocks, block_atoms] (tile of each
    slot relative to the block's first tile), ``valid`` mask.
    """
    schedule: str
    num_tiles: int
    num_atoms: int
    block_atoms: int                  # K: max atoms per block (static)
    tile_starts: np.ndarray           # [num_blocks+1]
    atom_starts: np.ndarray           # [num_blocks+1]
    atom_gather: np.ndarray           # [num_blocks, K]
    rel_tile: np.ndarray              # [num_blocks, K]
    valid: np.ndarray                 # [num_blocks, K] bool

    @property
    def num_blocks(self) -> int:
        return len(self.atom_starts) - 1

    @property
    def max_rel_span(self) -> int:
        """Max rows any block touches — <= block_atoms for merge_path by
        the diagonal guarantee; data-dependent for work_oriented."""
        return int(self.rel_tile.max(initial=0)) + 1 if self.num_atoms else 1

    @classmethod
    def _stage(cls, schedule, layout, tile_starts, atom_starts, K):
        ids = layout.atom_tile_ids()
        nb = len(atom_starts) - 1
        slots = (atom_starts[:-1, None].astype(np.int64)
                 + np.arange(K)[None, :])
        valid = slots < atom_starts[1:, None]
        gather = np.where(valid, slots, 0)
        rel = np.where(
            valid,
            ids[np.minimum(gather, max(layout.num_atoms - 1, 0))]
            - tile_starts[:-1, None],
            0) if layout.num_atoms else np.zeros((nb, K), dtype=np.int64)
        return cls(schedule, layout.num_tiles, layout.num_atoms, K,
                   tile_starts.astype(INDEX_DTYPE),
                   atom_starts.astype(INDEX_DTYPE),
                   gather.astype(INDEX_DTYPE), rel.astype(INDEX_DTYPE),
                   valid)

    @classmethod
    def work_oriented(cls, layout: Layout, block_atoms: int = 512
                      ) -> "FlatBlockPlan":
        """Even split of *atoms* across blocks (the reference's
        work_oriented even-shares tiles+atoms per thread; here the
        atom-only split is the natural analog since tile crossings are
        free in a vectorized reduction)."""
        K = int(block_atoms)
        nb = max(-(-layout.num_atoms // K), 1)
        atom_starts = np.minimum(np.arange(nb + 1, dtype=np.int64) * K,
                                 layout.num_atoms)
        ids = layout.atom_tile_ids()
        tile_starts = np.zeros(nb + 1, dtype=np.int64)
        if layout.num_atoms:
            tile_starts[:-1] = ids[np.minimum(atom_starts[:-1],
                                              layout.num_atoms - 1)]
            tile_starts[-1] = layout.num_tiles
        return cls._stage("work_oriented", layout, tile_starts, atom_starts, K)

    @classmethod
    def merge_path(cls, layout: Layout, block_work: int = 512
                   ) -> "FlatBlockPlan":
        """Merge-path diagonal split of (tiles + atoms) into blocks of
        ``block_work`` items. Guarantees per-block atoms <= K and row span
        <= K — the static-shape contract the merge-path kernel relies on."""
        K = int(block_work)
        total = layout.num_tiles + layout.num_atoms
        nb = max(-(-total // K), 1)
        t, a = merge_path_partition(layout.tile_offsets(), nb, K)
        return cls._stage("merge_path", layout, t.astype(np.int64),
                          a.astype(np.int64), K)


# choose_schedule decision thresholds, in the form
# scripts/fit_heuristic.py fits from a schedule sweep
# (scripts/sweep_battery.py). These are the four-schedule regime logic
# of an earlier sweep; they are not yet fitted on the GPU.
HEURISTIC_THRESHOLDS_XLA = {
    "ratio": 1.25,
    "cv": 0.125,
    "small": 0.0,
    "flat": "work_oriented",
    "group": "group_mapped",
}


def choose_schedule(layout: Layout, thresholds: dict | None = None) -> str:
    """Heuristic schedule selection — the analog of the reference's
    best-of-3 oracle study (the right schedule per matrix beats any
    fixed one).

    Regimes:
      * skewed degree distributions -> group_mapped (degree-class
        planes avoid both scatter and worst-row padding)
      * tiny/uniform tiles -> row_mapped (segmented reduction is
        already balanced; no plan overhead)
      * otherwise -> the flat schedule (bounded blocks)
    """
    t = thresholds if thresholds is not None else HEURISTIC_THRESHOLDS_XLA
    sizes = layout.tile_sizes()
    if layout.num_tiles == 0 or layout.num_atoms == 0:
        return "row_mapped"
    mean = max(float(sizes.mean()), 1e-9)
    mx = float(sizes.max())
    cv = float(sizes.std()) / mean
    if mx / mean > t["ratio"] or cv > t["cv"]:
        return t.get("group", "group_mapped")
    if mx <= t["small"]:
        return "row_mapped"
    return t.get("flat", "merge_path")


def make_plan(layout: Layout, schedule: str, **kw):
    if schedule == "auto":
        schedule = choose_schedule(layout)
    if schedule == "row_mapped":
        return RowMappedPlan.from_layout(layout)
    if schedule in ("group_mapped", "bucketing"):
        # "bucketing" is accepted as an alias: the reference declares the
        # enum value but never implements it (schedule.hxx:26-32); our
        # group_mapped *is* a bucketing schedule (degree-class buckets).
        return GroupMappedPlan.from_layout(layout, **kw)
    if schedule == "work_oriented":
        return FlatBlockPlan.work_oriented(layout, **kw)
    if schedule == "merge_path":
        return FlatBlockPlan.merge_path(layout, **kw)
    raise ValueError(
        f"unknown schedule {schedule!r}; expected one of {SCHEDULES}")
