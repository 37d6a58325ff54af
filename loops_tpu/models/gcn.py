"""GCN (Kipf & Welling) — functional JAX implementation.

3-layer GCN per the north star (BASELINE.json config 4). Pure-pytree
params with explicit init/apply so the model composes with jit, grad,
shard_map, and the framework's SpMM operators without a module system in
the way. Each layer is ``A_hat @ (H W) + b`` — the propagation is ONE
balanced SpMM.
"""
from __future__ import annotations

import numpy as np

from loops_tpu.models.graph import Graph
from loops_tpu.models.message_passing import aggregate_operator


def _glorot(key, fan_in, fan_out):
    import jax
    import jax.numpy as jnp

    lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
    return jax.random.uniform(key, (fan_in, fan_out), jnp.float32,
                              -lim, lim)


def init_gcn(key, dims):
    """dims = [in, hidden..., out]; returns the params pytree."""
    import jax

    keys = jax.random.split(key, len(dims) - 1)
    return [{"w": _glorot(k, dims[i], dims[i + 1]),
             "b": np.zeros(dims[i + 1], np.float32)}
            for i, k in enumerate(keys)]


class GCN:
    """3-layer (or N-layer) GCN bound to a graph.

    The propagation operator is built once from the GCN-normalized
    adjacency; ``apply`` is a pure function of (params, features) and is
    safe to jit/grad/shard.

    .. warning:: With ``precompute_first=True``, ``apply`` expects
       *prepared* features — ``prepare_features(X) == A @ X`` — and
       skips layer 1's propagation accordingly. Calling
       ``apply(params, X)`` with **raw** features in that mode returns
       wrong logits with no error. The training helpers
       (``models/train.py``) call ``prepare_features`` for you; do the
       same in custom loops:

           h0 = model.prepare_features(X)   # once, outside the step
           logits = model.apply(params, h0)
    """

    def __init__(self, graph: Graph, dims, dropout: float = 0.5,
                 schedule: str = "auto", remat: bool = False, dtype=None,
                 precompute_first: bool = False, loss_rows=None):
        self.dims = list(dims)
        self.dropout = dropout
        self.remat = remat
        self.precompute_first = precompute_first
        self.propagate = aggregate_operator(graph, op="gcn",
                                            schedule=schedule, dtype=dtype)
        # loss_rows: the training loss only reads logits at these rows
        # (the train mask), so the LAST layer's propagation — forward
        # and backward — restricts to A[rows, :] exactly
        # (message_passing.masked_aggregate_operator). apply(...,
        # masked_output=True) then returns [M, C] logits for those
        # rows; models/train.py uses it automatically. Eval paths keep
        # the full propagation.
        self.loss_rows = None
        self.propagate_masked = None
        if loss_rows is not None:
            from loops_tpu.models.message_passing import (
                masked_aggregate_operator,
            )
            op = masked_aggregate_operator(graph, loss_rows, op="gcn",
                                           schedule=schedule, dtype=dtype)
            self.loss_rows = op.rows
            self.propagate_masked = op

    def init(self, key):
        return init_gcn(key, self.dims)

    def prepare_features(self, features):
        """Optional one-time input transform consumed by the training
        helpers (models/train.py). With ``precompute_first=True`` the
        first layer's propagation is hoisted out of the step entirely:
        ``A(XW1) == (AX)W1`` and X is static across epochs, so AX is
        computed ONCE here and layer 1 becomes a dense matmul — a
        3-layer step drops from 6 sparse aggregations (fwd+bwd) to 4.
        Exact up to float reassociation; our GCN applies no input
        dropout, so semantics are unchanged (the SGC/SIGN-style
        precompute, applied to one layer only).
        """
        if not self.precompute_first:
            return features
        import jax.numpy as jnp
        return self.propagate._fn(jnp.asarray(features))

    def apply(self, params, h, *, train: bool = False, rng=None,
              masked_output: bool = False):
        """Forward pass. With ``precompute_first=True``, ``h`` must be
        the output of :meth:`prepare_features`, NOT the raw feature
        matrix (see the class docstring warning).

        ``masked_output=True`` (requires ``loss_rows``) returns logits
        only at ``self.loss_rows`` ([M, C]) via the masked last-layer
        propagation — the exact training-loss view at ~mask-fraction of
        the final layer's sparse cost.
        """
        import jax
        import jax.numpy as jnp

        prop = self.propagate._fn  # jit-compiled SpMM closure
        if masked_output:
            if self.propagate_masked is None:
                raise ValueError("masked_output requires loss_rows=")
            prop_last = self.propagate_masked._fn
        else:
            prop_last = prop

        def layer_fn(layer, h, skip_prop=False, last=False):
            hw = h @ layer["w"]
            if skip_prop:
                return hw + layer["b"]
            return (prop_last(hw) if last else prop(hw)) + layer["b"]

        if self.remat:
            # trade recompute for activation memory (HBM is the usual
            # bottleneck when N x hidden no longer fits alongside grads)
            layer_fn = jax.checkpoint(layer_fn, static_argnums=(2, 3))

        for i, layer in enumerate(params):
            h = layer_fn(layer, h, i == 0 and self.precompute_first,
                         i == len(params) - 1)
            if i + 1 < len(params):
                h = jax.nn.relu(h)
                if train and self.dropout > 0:
                    rng, sub = jax.random.split(rng)
                    keep = jax.random.bernoulli(
                        sub, 1.0 - self.dropout, h.shape)
                    h = jnp.where(keep, h / (1.0 - self.dropout), 0.0)
        return h
