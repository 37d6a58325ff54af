"""Message passing: gather -> edge transform -> segment aggregate.

The GNN layer primitive (BASELINE.json north star): built directly on
the framework's sparse ops so every aggregation is a scheduled,
deterministic segmented reduction — never an atomic scatter.

``aggregate(graph, h)`` with sum/mean semantics lowers to one SpMM over
the (optionally normalized) adjacency — the whole message-passing layer
is a single balanced sparse kernel. Max/min and explicit edge functions
use the gather/segment form.
"""
from __future__ import annotations

import numpy as np

from loops_tpu.models.graph import Graph
from loops_tpu.ops.spmm import SpMMOperator


def _transpose_csr(csr):
    from loops_tpu.formats import CSC, CSR

    csc = CSC.from_csr(csr)
    return CSR((csr.shape[1], csr.shape[0]), csc.offsets, csc.indices,
               csc.vals)


# ``schedule="auto"`` aggregation: XLA's fused gather + sorted segment
# sum. On an H100 80GB HBM3 (700 W) it beat the degree-class planes and a
# merge-path Triton kernel in the arxiv-sized GCN train step (2.79 vs
# 3.47 vs 4.13 ms f32, 2.42 vs 4.85 vs 2.90 ms bf16; scripts/kernel_ab.py).
AGGREGATION_SCHEDULE = "row_mapped"


def aggregate_operator(graph: Graph, op: str = "sum",
                       schedule: str = "auto", custom_vjp: bool = True,
                       dtype=None):
    """Build ``h -> aggregated`` for sum/mean aggregation (one SpMM).

    Default ``schedule="auto"`` means ``AGGREGATION_SCHEDULE``.

    ``custom_vjp=True`` replaces autodiff's transposed gather (a
    scatter) with the mathematically equal forward-style SpMM over A^T,
    planned with the same schedule — training backward then costs the
    same as forward.
    """
    if op == "sum":
        adj = graph.adj
    elif op == "mean":
        adj = graph.mean_normalized().adj
    elif op == "gcn":
        adj = graph.gcn_normalized().adj
    else:
        raise ValueError(f"aggregate_operator: unsupported op {op!r}")
    if schedule == "auto":
        schedule = AGGREGATION_SCHEDULE
    fwd_op = SpMMOperator(adj, schedule=schedule, dtype=dtype)
    if not custom_vjp:
        return fwd_op

    import jax

    # GCN-normalized undirected adjacencies are symmetric: A^T == A, so
    # the backward propagation reuses the forward operator (and its
    # compiled executable) instead of planning + compiling a transpose
    adj_t = _transpose_csr(adj)
    symmetric = (
        adj.nnz == adj_t.nnz
        and np.array_equal(adj.offsets, adj_t.offsets)
        and np.array_equal(adj.indices, adj_t.indices)
        and np.allclose(adj.vals, adj_t.vals))
    bwd_op = fwd_op if symmetric else SpMMOperator(
        adj_t, schedule=schedule, dtype=dtype)

    @jax.custom_vjp
    def prop(h):
        # operator buffers ride as closure state here: acceptable for
        # model-bound adjacencies (they are true constants of the model)
        return fwd_op._jit(fwd_op._bufs, h)

    def fwd(h):
        return prop(h), None

    def bwd(_, g):
        return (bwd_op._jit(bwd_op._bufs, g),)

    prop.defvjp(fwd, bwd)
    fwd_op._fn = prop  # models call through ._fn
    fwd_op._vjp_op = bwd_op
    return fwd_op


def _take_rows_csr(csr, idx: np.ndarray):
    """CSR row selection: rows ``idx`` of A, compacted to [M, N]."""
    from loops_tpu.formats import CSR

    idx = np.asarray(idx, np.int64)
    sizes = np.diff(csr.offsets)[idx]
    offs = np.zeros(len(idx) + 1, np.int64)
    np.cumsum(sizes, out=offs[1:])
    total = int(offs[-1])
    pos = (np.repeat(csr.offsets[idx], sizes)
           + (np.arange(total, dtype=np.int64)
              - np.repeat(offs[:-1], sizes)))
    return CSR((len(idx), csr.shape[1]), offs, csr.indices[pos],
               csr.vals[pos])


def _mask_to_rows(rows, num_nodes: int) -> np.ndarray:
    """Row indices from either explicit indices or a node mask.

    A bool or float array, or any 0/1 array of length ``num_nodes``
    (integer masks included), is a mask; anything else is taken as row
    indices.
    """
    rows = np.asarray(rows)
    is_mask = rows.dtype == bool or rows.dtype.kind == "f" or (
        rows.ndim == 1 and len(rows) == num_nodes
        and bool(np.isin(rows, (0, 1)).all()))
    return np.nonzero(rows > 0)[0] if is_mask else rows


def masked_aggregate_operator(graph: Graph, rows, op: str = "gcn",
                              schedule: str = "auto", dtype=None):
    """Aggregation restricted to the output rows the loss reads.

    Full-graph training only consumes logits at the labeled rows (the
    train mask); everything the last layer propagates to other rows is
    dead work — forward AND backward, since the incoming gradient is
    zero off-mask. This operator materializes that algebra exactly:

        fwd:  y_m = A[rows, :] @ z          [M, F]   (~mask-fraction
              of the edges)
        bwd:  dz  = A[rows, :]^T @ dy_m     [N, F]   (same submatrix)

    Normalization (op="gcn"/"mean") uses the FULL graph's degrees —
    the submatrix is taken from the already-normalized adjacency, so
    the selected outputs are bit-comparable to the full propagation's.
    Returns an operator whose ``._fn`` maps [N, F] -> [M, F].
    """
    if op == "sum":
        adj = graph.adj
    elif op == "mean":
        adj = graph.mean_normalized().adj
    elif op == "gcn":
        adj = graph.gcn_normalized().adj
    else:
        raise ValueError(f"masked_aggregate_operator: unsupported {op!r}")
    rows = _mask_to_rows(rows, graph.num_nodes)
    sub = _take_rows_csr(adj, rows)
    if schedule == "auto":
        schedule = AGGREGATION_SCHEDULE
    fwd_op = SpMMOperator(sub, schedule=schedule, dtype=dtype)
    sub_t = _transpose_csr(sub)
    bwd_op = SpMMOperator(sub_t, schedule=schedule, dtype=dtype)

    import jax

    @jax.custom_vjp
    def prop(h):
        return fwd_op._jit(fwd_op._bufs, h)

    def fwd(h):
        return prop(h), None

    def bwd(_, g):
        return (bwd_op._jit(bwd_op._bufs, g),)

    prop.defvjp(fwd, bwd)
    fwd_op._fn = prop
    fwd_op._vjp_op = bwd_op
    fwd_op.rows = rows
    return fwd_op


def edge_aggregate(graph: Graph, h, edge_fn=None, op: str = "sum"):
    """General form: messages = edge_fn(h[src], edge_weight) aggregated at
    destinations. ``op`` in {sum, mean, max, min}."""
    import jax
    import jax.numpy as jnp

    adj = graph.adj
    dst = jnp.asarray(adj.row_ids())
    src = jnp.asarray(adj.indices)
    w = jnp.asarray(adj.vals)
    n = graph.num_nodes

    msgs = h[src]
    if edge_fn is not None:
        msgs = edge_fn(msgs, w)
    if op == "sum":
        return jax.ops.segment_sum(msgs, dst, n, indices_are_sorted=True)
    if op == "mean":
        s = jax.ops.segment_sum(msgs, dst, n, indices_are_sorted=True)
        deg = jax.ops.segment_sum(jnp.ones_like(w), dst, n,
                                  indices_are_sorted=True)
        return s / jnp.maximum(deg, 1.0)[:, None]
    if op == "max":
        return jax.ops.segment_max(msgs, dst, n, indices_are_sorted=True)
    if op == "min":
        return jax.ops.segment_min(msgs, dst, n, indices_are_sorted=True)
    raise ValueError(f"edge_aggregate: unsupported op {op!r}")
