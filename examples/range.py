#!/usr/bin/env python
"""Layout/iteration demo (reference: examples/range.cu demos the range
abstraction): shows how tile/atom iteration is expressed as arrays —
the per-thread ranges of the reference become vectorized index math."""
from __future__ import annotations

import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from loops_tpu.layout import CsrLayout, FlatRebinLayout  # noqa: E402
from loops_tpu.utils import sample  # noqa: E402


def main():
    csr = sample.csr()
    lay = CsrLayout.from_csr(csr)
    print(f"tiles={lay.num_tiles} atoms={lay.num_atoms}")
    print("tile_offsets:", lay.tile_offsets().tolist())
    print("atom_tile_ids:", lay.atom_tile_ids().tolist())
    for t in range(lay.num_tiles):
        atoms = list(range(lay.tile_begin(t), lay.tile_end(t)))
        print(f"  tile {t}: atoms {atoms}")
    flat = FlatRebinLayout(lay, 3)
    print(f"rebinned to {flat.num_tiles} windows of 3:",
          flat.tile_offsets().tolist())
    print("base rows of atoms:", flat.base_tile_ids().tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
