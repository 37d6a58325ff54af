"""loops-tpu: a JAX framework for load-balanced irregular (sparse)
computation and GNN message passing, run on NVIDIA GPUs.

Built from scratch in JAX/XLA/Pallas with the capabilities of gunrock/loops
(PPoPP 2023, "A Programming Model for GPU Load Balancing") as its functional
reference. The core abstraction mirrors the reference's decoupling of *work
layout* from *work schedule* (reference: include/loops/container/layout.hxx,
include/loops/schedule.hxx):

- **formats**: host-side sparse containers (CSR/CSC/COO/ELL/BCSR/DIA) with
  the full cross-format conversion graph and preflight probes.
- **layout**: the tile/atom layout contract — every format exposes
  ``num_tiles``/``num_atoms``/``tile_offsets`` — plus the flat re-binning
  partitioner.
- **schedule**: planners that map balanced groups of (tile, atom) work onto
  device programs: row_mapped, group_mapped, work_oriented, merge_path.
- **ops**: SpMV / SpMM / SDDMM built on the planners — XLA paths, plus a
  Pallas (Triton) kernel for block-sparse SpMM.
- **models**: GNN message passing (gather -> edge transform -> segment
  aggregate), GCN, GraphSAGE, neighbor sampling.
- **parallel**: multi-chip edge-partitioned graphs, shard_map halo exchange.
- **utils**: host reference engines, the Wilkinson rigorous validator,
  matrix generators, timers.
"""

__version__ = "0.1.0"

from loops_tpu.formats import COO, CSR, CSC, ELL, BCSR, DIA  # noqa: F401

_SUBMODULES = ("formats", "io", "layout", "schedule", "ops", "models",
               "parallel", "tuning", "utils", "native")


def __getattr__(name):
    # lazy submodule access (loops_tpu.ops, loops_tpu.models, ...) keeps
    # `import loops_tpu` light — jax is only pulled in when device code
    # is actually requested
    if name in _SUBMODULES:
        import importlib

        mod = importlib.import_module(f"loops_tpu.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'loops_tpu' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
