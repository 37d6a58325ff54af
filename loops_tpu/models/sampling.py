"""Neighbor sampling — static-shape uniform k-neighbor sampling.

GraphSAGE-style minibatch sampling with static shapes: instead of
variable-length frontier lists, every fanout produces a dense
[batch, k] neighbor matrix (sampling with replacement; isolated nodes
self-loop), so the whole sampled block runs under jit with static shapes.
"""
from __future__ import annotations

import numpy as np

from loops_tpu.models.graph import Graph


def sample_neighbors(graph: Graph, seeds, k: int, key):
    """Uniform-with-replacement neighbor sample.

    Args:
      graph: CSR graph (row = destination, cols = sources).
      seeds: [b] node ids (device array ok).
      k: fanout (static).
      key: jax PRNG key.

    Returns:
      [b, k] int32 neighbor ids; isolated seeds sample themselves.
    """
    import jax
    import jax.numpy as jnp

    offsets = jnp.asarray(graph.adj.offsets)
    indices = jnp.asarray(graph.adj.indices)
    seeds = jnp.asarray(seeds)
    deg = offsets[seeds + 1] - offsets[seeds]
    r = jax.random.randint(key, (seeds.shape[0], k), 0, 1 << 30)
    slot = r % jnp.maximum(deg, 1)[:, None]
    nbr = indices[offsets[seeds][:, None] + slot]
    return jnp.where(deg[:, None] > 0, nbr, seeds[:, None])


def sampled_block(graph: Graph, seeds, fanouts, key):
    """Multi-hop sampled computation block.

    Returns a list of ([frontier_size, k] neighbor, frontier) pairs from
    the seeds outward; ``frontier[i+1] = unique-free flatten`` of hop i's
    samples (kept with duplicates for static shapes; duplicated compute
    is the documented trade, not yet measured against dedup on the
    GPU).
    """
    import jax
    import jax.numpy as jnp

    frontiers = [jnp.asarray(seeds)]
    hops = []
    for fanout in fanouts:
        key, sub = jax.random.split(key)
        nbr = sample_neighbors(graph, frontiers[-1], fanout, sub)
        hops.append(nbr)
        frontiers.append(nbr.reshape(-1))
    return hops, frontiers
