"""Flat uniform-occupancy partitioner.

The analog of the reference's ``layout::flat_uniform_occupancy<K, base>``
(reference: include/loops/container/partitioning.hxx:71-141): re-bins the
base layout's flat atom enumeration into K-atom tiles with pure closed-form
math — no precompute — and exposes ``base`` so kernels can recover the
original tile of an atom for output addressing.

Difference: where the reference recovers the original tile with a
per-atom device binary search (``base().tile_of(atom)``), we materialize
``base_tile_ids`` once on the host — it is exactly the COO row-index array
(SURVEY.md §7) — and the device sees only dense segment ids.
"""
from __future__ import annotations

import numpy as np

from loops_tpu.formats.base import INDEX_DTYPE
from loops_tpu.layout.contract import Layout


class FlatRebinLayout(Layout):
    def __init__(self, base: Layout, atoms_per_tile: int):
        if atoms_per_tile <= 0:
            raise ValueError("atoms_per_tile must be positive")
        self.base = base
        self.atoms_per_tile = int(atoms_per_tile)
        self.num_atoms = base.num_atoms
        self.num_tiles = -(-base.num_atoms // self.atoms_per_tile)

    def tile_offsets(self) -> np.ndarray:
        K = self.atoms_per_tile
        off = np.minimum(
            np.arange(self.num_tiles + 1, dtype=np.int64) * K,
            self.num_atoms)
        return off.astype(INDEX_DTYPE)

    def tile_begin(self, t):
        return min(t * self.atoms_per_tile, self.num_atoms)

    def tile_end(self, t):
        return min((t + 1) * self.atoms_per_tile, self.num_atoms)

    def tile_of(self, a):
        return (np.asarray(a) // self.atoms_per_tile).astype(INDEX_DTYPE)

    def base_tile_ids(self) -> np.ndarray:
        """Original tile of every atom — for output addressing after
        re-binning (the ``base().tile_of`` analog, partitioning.hxx:
        120-135)."""
        return self.base.atom_tile_ids()
