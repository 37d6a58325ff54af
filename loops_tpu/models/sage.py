"""GraphSAGE — mean-aggregator, full-graph and sampled-minibatch forms.

Layer: h' = relu(W_self h + W_neigh mean_{j in N(i)} h_j + b). The
full-graph path aggregates with one row-normalized SpMM; the minibatch
path consumes the static-shape [b, k] samples from models/sampling.py —
the mean over the fanout axis is a dense reduction, the static-shape
replacement for the reference-style variable-length frontier walk.
"""
from __future__ import annotations

import numpy as np

from loops_tpu.models.gcn import _glorot
from loops_tpu.models.graph import Graph
from loops_tpu.models.message_passing import aggregate_operator
from loops_tpu.models.sampling import sample_neighbors


def init_sage(key, dims):
    import jax

    keys = jax.random.split(key, 2 * (len(dims) - 1))
    return [{"w_self": _glorot(keys[2 * i], dims[i], dims[i + 1]),
             "w_neigh": _glorot(keys[2 * i + 1], dims[i], dims[i + 1]),
             "b": np.zeros(dims[i + 1], np.float32)}
            for i in range(len(dims) - 1)]


class GraphSAGE:
    def __init__(self, graph: Graph, dims,
                 schedule: str = "auto", dtype=None):
        """``dtype="bfloat16"`` selects the throughput aggregation mode
        (bf16 operand rounding, f32 accumulation) — the same contract
        as GCN's ``dtype``."""
        self.graph = graph
        self.dims = list(dims)
        self.aggregate = aggregate_operator(graph, op="mean",
                                            schedule=schedule, dtype=dtype)

    def init(self, key):
        return init_sage(key, self.dims)

    def apply(self, params, h, *, train: bool = False, rng=None):
        """Full-graph forward. ``train``/``rng`` are accepted for the
        shared train-step interface (models/train.py); SAGE has no
        dropout so they are no-ops."""
        import jax

        del train, rng

        agg_fn = self.aggregate._fn
        for i, layer in enumerate(params):
            neigh = agg_fn(h)
            h = h @ layer["w_self"] + neigh @ layer["w_neigh"] + layer["b"]
            if i + 1 < len(params):
                h = jax.nn.relu(h)
        return h

    def apply_sampled(self, params, features, seeds, fanouts, key):
        """Minibatch forward over sampled fanouts (one fanout per layer).

        ``features`` is the full [N, F] node matrix. Frontier d+1 expands
        frontier d by fanout[d], so grouping hop-(d+1) representations by
        their parent is a static reshape [len(frontier_d), fanout_d, F] —
        the static-shape replacement for variable-length frontier walks.
        Layer l transforms depth-d representations for all remaining
        depths (the standard minibatch-SAGE recursion).
        """
        import jax
        import jax.numpy as jnp

        L = len(params)
        if len(fanouts) != L:
            raise ValueError("need one fanout per layer")
        features = jnp.asarray(features)

        frontiers = [jnp.asarray(seeds)]
        keys = jax.random.split(key, L)
        for f, k in zip(fanouts, keys):
            nbr = sample_neighbors(self.graph, frontiers[-1], f, k)
            frontiers.append(nbr.reshape(-1))

        reps = [features[fr] for fr in frontiers]      # depth 0..L
        for l, layer in enumerate(params):
            new_reps = []
            for d in range(L - l):
                b = frontiers[d].shape[0]
                neigh = reps[d + 1].reshape(b, fanouts[d], -1).mean(axis=1)
                h = (reps[d] @ layer["w_self"] + neigh @ layer["w_neigh"]
                     + layer["b"])
                if l + 1 < L:
                    h = jax.nn.relu(h)
                new_reps.append(h)
            reps = new_reps
        return reps[0]


def make_sampled_train_step(model: "GraphSAGE", optimizer, features,
                            labels, fanouts, batch_size: int):
    """Minibatch training step with neighbor sampling.

    Returns ``step(params, opt_state, rng) -> (params, opt_state, rng,
    loss)``; each call draws a fresh seed batch and fanout sample —
    everything static-shape, so one compilation serves all steps.
    """
    import jax
    import jax.numpy as jnp
    import optax

    from loops_tpu.models.train import cross_entropy

    features = jnp.asarray(features)
    labels = jnp.asarray(labels)
    n = features.shape[0]

    def loss_fn(params, seeds, key):
        logits = model.apply_sampled(params, features, seeds, fanouts, key)
        return cross_entropy(logits, labels[seeds])

    @jax.jit
    def step(params, opt_state, rng):
        rng, k_seed, k_sample = jax.random.split(rng, 3)
        seeds = jax.random.randint(k_seed, (batch_size,), 0, n)
        loss, grads = jax.value_and_grad(loss_fn)(params, seeds, k_sample)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, rng, loss

    return step
