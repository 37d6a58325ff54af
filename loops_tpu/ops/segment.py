"""Segmented primitives over atom/edge arrays.

The deterministic replacements for every atomic-accumulation pattern in
the reference (SURVEY.md §5: "no atomics in XLA — segmented reductions
remove this bug class by construction"), plus ``segment_softmax`` — the
edge-score normalizer that attention models need.
"""
from __future__ import annotations


def segment_sum(data, segment_ids, num_segments, sorted_ids=False):
    import jax
    return jax.ops.segment_sum(data, segment_ids, num_segments=num_segments,
                               indices_are_sorted=sorted_ids)


def segment_max(data, segment_ids, num_segments, sorted_ids=False):
    import jax
    return jax.ops.segment_max(data, segment_ids, num_segments=num_segments,
                               indices_are_sorted=sorted_ids)


def segment_mean(data, segment_ids, num_segments, sorted_ids=False):
    import jax.numpy as jnp
    s = segment_sum(data, segment_ids, num_segments, sorted_ids)
    ones = jnp.ones(data.shape[:1], dtype=data.dtype)
    cnt = segment_sum(ones, segment_ids, num_segments, sorted_ids)
    if data.ndim > 1:
        cnt = cnt[:, None]
    return s / jnp.maximum(cnt, 1)


def segment_softmax(scores, segment_ids, num_segments, sorted_ids=False):
    """Numerically stable softmax within each segment.

    scores [E] (or [E, H] for multi-head), segment_ids [E] -> normalized
    weights of the same shape. Empty segments contribute nothing.
    """
    import jax.numpy as jnp

    mx = segment_max(scores, segment_ids, num_segments, sorted_ids)
    # segment_max yields -inf for empty segments; those ids never appear
    # in segment_ids so the gather below never reads them.
    e = jnp.exp(scores - mx[segment_ids])
    denom = segment_sum(e, segment_ids, num_segments, sorted_ids)
    return e / jnp.maximum(denom[segment_ids], 1e-30)
