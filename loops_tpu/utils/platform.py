"""Which backend runs, and how kernels are compiled on it.

Three decisions live here and nowhere else:

* ``ensure_platform()`` picks the JAX platform. ``LOOPS_PLATFORM=cpu``
  (or ``JAX_PLATFORMS=cpu``) runs on the host CPU, which is how the
  tests run; otherwise the program requires a GPU and fails loudly when
  JAX finds none.
* ``pallas_interpret()`` says whether a Pallas kernel runs compiled
  (``gpu``) or in the interpreter (``cpu`` only). Any other backend is
  an error, never a silent interpreter run.
* ``enable_compilation_cache()`` points JAX's persistent compile cache
  at ``JAX_COMPILATION_CACHE_DIR`` when it is set, and otherwise at a
  fixed directory inside the checkout (listed in ``.gitignore``).
"""
from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# fixed so that successive processes hit the same cache entries
DEFAULT_CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def ensure_platform() -> str:
    """Select the backend and return its name (``"gpu"`` or ``"cpu"``).

    ``LOOPS_PLATFORM=cpu`` (or a ``JAX_PLATFORMS`` list that starts
    with ``cpu``) selects the CPU. Anything else requires a GPU: a run
    that asked for the card and silently got the CPU would report host
    numbers as device ones.
    """
    import jax

    want = os.environ.get("LOOPS_PLATFORM")
    if not want:
        first = os.environ.get("JAX_PLATFORMS", "").split(",")[0].strip()
        want = "cpu" if first == "cpu" else "gpu"
    if want not in ("cpu", "gpu", "cuda"):
        raise RuntimeError(
            f"LOOPS_PLATFORM={want!r}: this program runs on 'gpu' or "
            "(for tests) 'cpu'")
    jax.config.update("jax_platforms", "cpu" if want == "cpu" else "cuda")
    expected = "cpu" if want == "cpu" else "gpu"
    try:
        backend = jax.default_backend()
    except Exception as e:
        raise RuntimeError(
            f"JAX found no {expected!r} device; LOOPS_PLATFORM=cpu runs "
            "on the CPU") from e
    if backend != expected:
        raise RuntimeError(
            f"asked for {expected!r} but JAX initialised {backend!r}")
    return backend


def pallas_interpret(backend: str | None = None) -> bool:
    """``interpret=`` for every Pallas call: compiled through Triton on
    a GPU, interpreted on the CPU, refused anywhere else."""
    if backend is None:
        import jax
        backend = jax.default_backend()
    if backend == "gpu":
        return False
    if backend == "cpu":
        return True
    raise RuntimeError(
        f"no Pallas route for backend {backend!r}: kernels are written "
        "for the GPU (Triton) and interpreted only on the CPU")


def compilation_cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` when set, else the checkout's
    fixed cache directory."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache(min_compile_secs: float = 0.5) -> str:
    """Turn on JAX's persistent compilation cache; returns its path.

    When ``JAX_COMPILATION_CACHE_DIR`` is set JAX already reads it, and
    this sets no other directory. The cache is keyed on the HLO, so
    operators with equal shapes share one executable across processes.
    On the CPU nothing is cached here (returns ""): CPU executables are
    compiled for the exact host, and a checkout moved to another host
    would load code built for features it may lack.
    """
    import jax

    if (jax.default_backend() == "cpu"
            and not os.environ.get("JAX_COMPILATION_CACHE_DIR")):
        return ""
    path = compilation_cache_dir()
    os.makedirs(path, exist_ok=True)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return path
