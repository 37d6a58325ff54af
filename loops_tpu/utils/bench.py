"""Chained benchmark timing.

``chained_ms`` times N *data-dependent* applications inside one jitted
``fori_loop`` and pulls one scalar to the host, so the measured interval
contains exactly N kernel executions and one dispatch. ``slope_ms``
runs the chain at two lengths and divides the time difference by the
iteration delta, which cancels the fixed dispatch and transfer cost.
"""
from __future__ import annotations

import time


def chained_ms(fn, x, iters: int = 20, warmup: bool = True) -> float:
    """Milliseconds per application of ``fn`` (shape-preserving x->x)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chain(v):
        return jax.lax.fori_loop(0, iters, lambda i, a: fn(a), v)

    x = jnp.asarray(x)
    if warmup:
        jax.device_get(jnp.ravel(chain(x))[0])
    t0 = time.perf_counter()
    r = chain(x)
    jax.device_get(jnp.ravel(r)[0])
    return (time.perf_counter() - t0) / iters * 1e3


def chained_ms_bufs(fn, bufs, x, iters: int = 20) -> float:
    """Like :func:`chained_ms` for operator-style ``fn(bufs, x)``.

    Buffers ride as jit *arguments* — closing over them would bake them
    into the HLO as literals, which bloats executables.
    """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chain(b, v):
        return jax.lax.fori_loop(0, iters, lambda i, a: fn(b, a), v)

    x = jnp.asarray(x)
    jax.device_get(jnp.ravel(chain(bufs, x))[0])
    t0 = time.perf_counter()
    r = chain(bufs, x)
    jax.device_get(jnp.ravel(r)[0])
    return (time.perf_counter() - t0) / iters * 1e3


def slope_ms(fn, x, lo: int = 4, hi: int = 20, repeats: int = 3) -> float:
    """Dispatch-overhead-free ms per application of shape-preserving
    ``fn``: chained timing at two lengths, slope over the delta."""
    import jax
    import jax.numpy as jnp

    def chain(n):
        @jax.jit
        def run(v):
            return jax.lax.fori_loop(0, n, lambda i, a: fn(a), v)
        return run

    f_lo, f_hi = chain(lo), chain(hi)
    x = jnp.asarray(x)

    def t(f):
        t0 = time.perf_counter()
        jax.device_get(jnp.ravel(f(x))[0])
        return time.perf_counter() - t0

    t(f_lo), t(f_hi)   # compile + warm
    # min of each side, NOT min of paired deltas (a noisy lo draw would
    # bias the estimate low, even below physical floors)
    tlo = min(t(f_lo) for _ in range(repeats))
    thi = min(t(f_hi) for _ in range(repeats))
    return (thi - tlo) / (hi - lo) * 1e3


def chained_ms_pair(fn, x, iters: int = 20) -> float:
    """Like :func:`chained_ms` for fn whose output shape differs from its
    input: re-injects a cheap scalar of the output into the input to keep
    the data dependence."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chain(v):
        def body(i, a):
            out = fn(a)
            return a + jnp.ravel(out)[0] * 0
        return jax.lax.fori_loop(0, iters, body, v)

    x = jnp.asarray(x)
    jax.device_get(jnp.ravel(chain(x))[0])
    t0 = time.perf_counter()
    r = chain(x)
    jax.device_get(jnp.ravel(r)[0])
    return (time.perf_counter() - t0) / iters * 1e3
