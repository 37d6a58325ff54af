"""Offset/index converters — the primitive pair underlying every
cross-format conversion.

Mirrors the semantics of the reference's detail::{offsets_to_indices,
indices_to_offsets} (reference: include/loops/container/detail/convert.hxx:
37-78) but implemented the NumPy/XLA way: ``repeat`` for expansion and
``searchsorted`` for compression, both O(n) / O(n log r) vectorized — no
scatter+scan emulation needed on the host.

``offsets_to_indices_jax`` is the device-side variant used inside jitted
planners (segment-id materialization for segment_sum paths).
"""
from __future__ import annotations

import numpy as np

from loops_tpu.formats.base import INDEX_DTYPE


def offsets_to_indices(offsets: np.ndarray) -> np.ndarray:
    """CSR-style offsets [n_tiles+1] -> per-atom tile index [n_atoms].

    offsets = [0, 2, 2, 5] -> [0, 0, 2, 2, 2]   (empty tiles emit nothing)
    """
    offsets = np.asarray(offsets)
    sizes = np.diff(offsets)
    return np.repeat(
        np.arange(len(sizes), dtype=INDEX_DTYPE), sizes
    )


def indices_to_offsets(indices: np.ndarray, num_tiles: int) -> np.ndarray:
    """Sorted per-atom tile indices [n_atoms] -> offsets [num_tiles+1].

    Inverse of :func:`offsets_to_indices` for sorted input; tolerates empty
    tiles anywhere (reference: convert.hxx:70-78 uses vectorized
    lower_bound — ``searchsorted`` is the same operation).
    """
    indices = np.asarray(indices)
    return np.searchsorted(
        indices, np.arange(num_tiles + 1, dtype=np.int64), side="left"
    ).astype(INDEX_DTYPE)


def offsets_to_indices_jax(offsets, num_atoms: int):
    """Device-side offsets -> segment ids with a static output size.

    A jitted program cannot ``repeat`` with data-dependent counts, so
    this uses the
    standard static-shape identity: seg_id[a] = (# offsets[1:-1] <= a),
    computed as a searchsorted over the atom iota. O(n log r), fully
    vectorized, jit-safe.
    """
    import jax.numpy as jnp

    atoms = jnp.arange(num_atoms, dtype=jnp.int32)
    return jnp.searchsorted(offsets[1:-1], atoms, side="right").astype(jnp.int32)
