"""Shared helpers for the host-side sparse containers.

The reference keeps containers as owning host/device structs
(reference: include/loops/container/formats.hxx). Here the split is:
**host containers are plain NumPy** (cheap slicing, conversions,
I/O) and device residency is a late, explicit step (``as_jax``) so that the
jit boundary sees static shapes. Index dtype defaults to int32 (JAX runs
without 64-bit types unless ``jax_enable_x64`` is set) with an overflow
guard at construction (the reference guards at load time, market.hxx:143-167).
"""
from __future__ import annotations

import numpy as np

INDEX_DTYPE = np.int32
VALUE_DTYPE = np.float32


def as_index_array(a, name: str = "index array") -> np.ndarray:
    """Coerce to the canonical index dtype with an overflow guard."""
    a = np.asarray(a)
    if a.size and (a.max(initial=0) > np.iinfo(INDEX_DTYPE).max):
        raise OverflowError(
            f"{name} exceeds {INDEX_DTYPE.__name__} range; "
            "64-bit indices are not supported on the device path"
        )
    return np.ascontiguousarray(a, dtype=INDEX_DTYPE)


def as_value_array(a, dtype=None) -> np.ndarray:
    dtype = dtype or (a.dtype if isinstance(a, np.ndarray) and
                      np.issubdtype(a.dtype, np.floating) else VALUE_DTYPE)
    return np.ascontiguousarray(a, dtype=dtype)


def check_shape(shape) -> tuple:
    rows, cols = int(shape[0]), int(shape[1])
    if rows < 0 or cols < 0:
        raise ValueError(f"invalid matrix shape {shape}")
    return (rows, cols)
