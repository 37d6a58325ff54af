"""Distributed sparse ops over a device mesh (shard_map + collectives).

The multi-chip tier the single-GPU reference never had (SURVEY.md §2
scope statement; north star BASELINE.json): adjacency rows are
edge-balance-partitioned across the ``graph`` mesh axis
(parallel/graph_partition.py); features live sharded as stacked
[P, rows_per_dev, F]. The **default exchange is the overlapped targeted
halo** (parallel/halo.py): per layer each chip ships only the boundary
features its neighbors actually reference (O(P*H*F)) via all_to_all,
overlapped with the interior reduction — the protocol that scales to
papers100M-size graphs. ``exchange="all_gather"`` keeps the simple
O(N*F)-per-chip mode as the oracle/debug path. All collectives ride
named mesh axes, so the same code runs on an 8-device CPU test mesh and
on the cards of one NVLink host.

Differentiable end-to-end: ``all_gather``'s transpose is
``psum_scatter`` and ``all_to_all`` transposes to the reverse
``all_to_all``, so ``jax.grad`` works through both exchanges.
"""
from __future__ import annotations

import numpy as np

from loops_tpu.parallel.graph_partition import EdgePartition

__all__ = ["DistSpMM", "DistGCN", "DistGraphSAGE"]


class DistSpMM:
    """Distributed SpMM: stacked padded features -> stacked padded rows.

    ``op(h) : [P, rows_pd, F] -> [P, rows_pd, F_out-like]`` with both
    sides sharded P("graph"). Construction stages the partition's arrays
    onto the mesh.
    """

    def __init__(self, plan: EdgePartition, mesh,
                 feature_axis: str | None = None):
        """``feature_axis`` names a second mesh axis (e.g. ``"model"``
        from ``make_mesh_2d``) sharding the feature dimension: SpMM is
        embarrassingly parallel over F, so each model rank reduces its
        own F-slice with zero feature-axis communication — the wide-F
        mode (F >= 512) where one chip's F-slice of the gathered table
        halves/quarters per rank."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        self.plan = plan
        self.mesh = mesh
        self.feature_axis = feature_axis
        if feature_axis is not None and feature_axis not in mesh.axis_names:
            raise ValueError(
                f"feature_axis {feature_axis!r} not in mesh axes "
                f"{mesh.axis_names}")
        shard = NamedSharding(mesh, P("graph"))
        self.offsets = jax.device_put(jnp.asarray(plan.offsets), shard)
        self.indices = jax.device_put(jnp.asarray(plan.indices_padded),
                                      shard)
        self.vals = jax.device_put(jnp.asarray(plan.vals), shard)
        # uniform distributed-op interface: _fn(*buffers, h)
        self.buffers = (self.offsets, self.indices, self.vals)
        self._fn = jax.jit(self._build())

    def _build(self):
        import jax
        import jax.numpy as jnp
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        E = self.plan.nnz_per_dev
        R = self.plan.rows_per_dev

        def local(offs, idx, vals, h):
            # offs [1, R+1], idx/vals [1, E], h [1, R, F-slice]
            h_full = jax.lax.all_gather(h[0], "graph", axis=0,
                                        tiled=True)          # [P*R, F]
            atoms = jnp.arange(E, dtype=jnp.int32)
            rid = jnp.searchsorted(offs[0, 1:-1], atoms,
                                   side="right").astype(jnp.int32)
            prod = vals[0][:, None] * h_full[idx[0]]
            out = jax.ops.segment_sum(prod, rid, num_segments=R,
                                      indices_are_sorted=True)
            return out[None]

        h_spec = (P("graph", None, self.feature_axis)
                  if self.feature_axis else P("graph"))
        # buffers ride as jit arguments, not closure constants (closure
        # capture bakes them into the HLO — see ops/spmv.py docstring)
        return shard_map(
            local, mesh=self.mesh,
            in_specs=(P("graph"), P("graph"), P("graph"), h_spec),
            out_specs=h_spec,
            check_vma=False,
        )

    def __call__(self, h_stacked):
        import jax.numpy as jnp
        return self._fn(*self.buffers, jnp.asarray(h_stacked))


def _build_propagate(plan, mesh, exchange: str, overlap: bool):
    """Shared exchange-mode dispatch for the distributed models.

    ``halo`` + ``overlap`` is the default and the scalable path: per
    layer it moves only the boundary features (O(P*H*F), not O(N*F))
    and overlaps the all_to_all with the interior reduction — the
    pipeline the >=80% edges/s scaling target needs (BASELINE.json:5).
    ``all_gather`` remains as the oracle/debug mode.
    """
    if exchange == "halo":
        from loops_tpu.parallel.halo import DistSpMMHalo, HaloPlan
        return DistSpMMHalo(HaloPlan.build(plan), mesh, overlap=overlap)
    if exchange == "all_gather":
        return DistSpMM(plan, mesh)
    raise ValueError(f"unknown exchange {exchange!r}")


def make_dist_loss(model, features, labels, train_mask):
    """The distributed training loss (masked softmax cross-entropy over
    stacked shards) for DistGCN / DistGraphSAGE: ``(loss_fn, bufs)``
    with ``loss_fn(params, bufs)``. ``bufs`` holds the stacked features,
    labels, mask and the exchange's graph buffers, so they ride through
    a jit as arguments (never HLO constants)."""
    import jax
    import jax.numpy as jnp

    plan = model.plan
    h0 = jnp.asarray(plan.pad_features(np.asarray(features)))
    lab, msk = _stack_labels(plan, labels, train_mask)
    bufs = dict(h0=h0, lab=lab, msk=msk, adj=model.propagate.buffers)

    def loss_fn(params, b):
        logits = model.apply(params, b["h0"], adj=b["adj"])  # [P, R, C]
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(
            logp, b["lab"][..., None], axis=-1)[..., 0]
        return (nll * b["msk"]).sum() / jnp.maximum(b["msk"].sum(), 1.0)

    return loss_fn, bufs


def _make_dist_train_step(model, optimizer, features, labels, train_mask):
    """Shared distributed train-step factory for DistGCN /
    DistGraphSAGE — the models differ only in ``apply``.

    Returns ``step(params, opt_state) -> (params, opt_state, loss)``."""
    import jax
    import optax

    loss_fn, bufs = make_dist_loss(model, features, labels, train_mask)

    @jax.jit
    def _step(params, opt_state, b):
        loss, grads = jax.value_and_grad(loss_fn)(params, b)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def step(params, opt_state):
        return _step(params, opt_state, bufs)

    return step


def _stack_labels(plan, labels, train_mask):
    """[N] labels/mask -> padded stacked [P, rows_per_dev] (vectorized —
    no per-device Python loop)."""
    import jax.numpy as jnp

    labels = np.asarray(labels)
    train_mask = np.asarray(train_mask)
    starts = plan.row_starts[:-1].astype(np.int64)
    counts = np.diff(plan.row_starts.astype(np.int64))
    pos = np.arange(plan.rows_per_dev)[None, :]          # [1, R]
    valid = pos < counts[:, None]                        # [P, R]
    idx = np.minimum(starts[:, None] + pos, len(labels) - 1)
    lab = np.where(valid, labels[idx], 0).astype(np.int32)
    msk = np.where(valid, train_mask[idx], 0).astype(np.float32)
    return jnp.asarray(lab), jnp.asarray(msk)


class DistGCN:
    """Distributed GCN: per-layer ``A_hat (H W) + b`` with H row-sharded
    and W replicated. The GCN-normalized adjacency is partitioned once at
    construction. Default exchange is the overlapped targeted halo."""

    def __init__(self, graph, dims, mesh, num_devices: int | None = None,
                 exchange: str = "halo", overlap: bool = True,
                 plan: EdgePartition | None = None):
        if plan is not None:
            # prebuilt partition (e.g. EdgePartition.from_shards over an
            # out-of-core store) — the caller stages the GCN-normalized
            # adjacency; ``graph`` is ignored
            self.plan = plan
        else:
            from loops_tpu.models.graph import Graph

            g = graph if isinstance(graph, Graph) else Graph(graph)
            norm = g.gcn_normalized()
            P_ = num_devices or int(np.prod([mesh.shape[a] for a in
                                             mesh.axis_names]))
            self.plan = EdgePartition.build(norm.adj, P_)
        self.mesh = mesh
        self.dims = list(dims)
        self.propagate = _build_propagate(self.plan, mesh, exchange,
                                          overlap)

    def init(self, key):
        from loops_tpu.models.gcn import init_gcn
        return init_gcn(key, self.dims)

    def apply(self, params, h_stacked, adj=None):
        """Forward over stacked shards. ``adj`` = the propagate op's
        buffer tuple when called inside an outer jit so the graph rides
        as traced arguments; defaults to the staged buffers."""
        import jax

        prop = self.propagate
        bufs = adj if adj is not None else prop.buffers
        h = h_stacked
        for i, layer in enumerate(params):
            h = prop._fn(*bufs, h @ layer["w"]) + layer["b"]
            if i + 1 < len(params):
                h = jax.nn.relu(h)
        return h

    # kept as a method for API compatibility; shared implementation
    _stack_labels = staticmethod(_stack_labels)

    def make_train_step(self, optimizer, features, labels, train_mask):
        """Distributed full-graph training step over stacked shards
        (shared factory — see ``_make_dist_train_step``)."""
        return _make_dist_train_step(self, optimizer, features, labels,
                                     train_mask)


class DistGraphSAGE:
    """Distributed GraphSAGE: h' = act(h W_self + meanagg(h) W_neigh + b)
    with the mean-normalized adjacency partitioned like DistGCN."""

    def __init__(self, graph, dims, mesh, num_devices: int | None = None,
                 exchange: str = "halo", overlap: bool = True):
        from loops_tpu.models.graph import Graph

        g = graph if isinstance(graph, Graph) else Graph(graph)
        norm = g.mean_normalized()
        P_ = num_devices or int(np.prod([mesh.shape[a] for a in
                                         mesh.axis_names]))
        self.plan = EdgePartition.build(norm.adj, P_)
        self.mesh = mesh
        self.dims = list(dims)
        self.propagate = _build_propagate(self.plan, mesh, exchange,
                                          overlap)

    def init(self, key):
        from loops_tpu.models.sage import init_sage
        return init_sage(key, self.dims)

    def apply(self, params, h_stacked, adj=None):
        import jax

        prop = self.propagate
        bufs = adj if adj is not None else prop.buffers
        h = h_stacked
        for i, layer in enumerate(params):
            neigh = prop._fn(*bufs, h)
            h = (h @ layer["w_self"] + neigh @ layer["w_neigh"]
                 + layer["b"])
            if i + 1 < len(params):
                h = jax.nn.relu(h)
        return h

    def make_train_step(self, optimizer, features, labels, train_mask):
        """Shared factory — see ``_make_dist_train_step``."""
        return _make_dist_train_step(self, optimizer, features, labels,
                                     train_mask)
