"""Device-mesh helpers for multi-chip execution.

The reference is single-GPU (SURVEY.md §2 scope statement); this layer is
the north-star extension. Axis convention: ``graph`` shards graph rows /
destination nodes (the outer data axis), ``model`` shards feature/weight
dims when present.
"""
from __future__ import annotations

import numpy as np


def make_mesh(n_devices: int | None = None, axis: str = "graph"):
    """1-D mesh over the first n devices."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def make_mesh_2d(graph: int, model: int):
    """2-D mesh sharding graph rows x feature (model) dims — for wide-F
    distributed SpMM where each model rank owns an F-slice (see
    DistSpMM's ``feature_axis``)."""
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[: graph * model]).reshape(graph, model)
    return Mesh(devs, ("graph", "model"))
