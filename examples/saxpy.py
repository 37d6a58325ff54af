#!/usr/bin/env python
"""SAXPY demo (reference: examples/saxpy.cu — the grid-stride-loop hello
world). Here the grid-stride loop is one fused XLA elementwise op,
checked against the same arithmetic on the host."""
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


def saxpy_xla(a, x, y):
    return a * x + y


def main():
    n = 1 << 16
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(8, n // 8)).astype(np.float32))
    y = jnp.asarray(rng.normal(size=(8, n // 8)).astype(np.float32))
    a = 2.5
    out = np.asarray(jax.jit(saxpy_xla)(a, x, y))
    ref = a * np.asarray(x, np.float64) + np.asarray(y, np.float64)
    err = float(np.abs(out - ref).max())
    print(f"saxpy n={n}: device vs host max err {err:.2e}")
    print("Errors: 0" if err < 1e-6 else "Errors: >0")
    return 0 if err < 1e-6 else 1


if __name__ == "__main__":
    sys.exit(main())
