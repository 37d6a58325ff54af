"""GAT (graph attention network) — the SDDMM -> segment-softmax -> SpMM
composition.

Beyond-reference model family: attention edge scoring is exactly the
framework's primitive pair (BASELINE.json config 3 calls SpMM+SDDMM "the
fused GNN primitive pair"); GAT is their natural consumer. Per head:

    e_ij    = LeakyReLU(a_src . (W h_j) + a_dst . (W h_i))   (edge score)
    alpha   = segment_softmax(e, by destination row)          (normalize)
    h'_i    = sum_j alpha_ij (W h_j)                          (one SpMM)

All three stages are balanced segmented/dense ops — no scatter beyond
the segmented reductions, no atomics.
"""
from __future__ import annotations

import numpy as np

from loops_tpu.models.gcn import _glorot
from loops_tpu.models.graph import Graph
from loops_tpu.ops.segment import segment_softmax, segment_sum


def init_gat(key, dims, heads: int = 4):
    import jax

    layers = []
    keys = jax.random.split(key, 3 * (len(dims) - 1))
    for i in range(len(dims) - 1):
        # hidden layers consume the concatenation of all heads
        d_in = dims[i] * (heads if i > 0 else 1)
        d_out = dims[i + 1]
        layers.append({
            "w": _glorot(keys[3 * i], d_in, heads * d_out),
            "a_src": _glorot(keys[3 * i + 1], heads, d_out),
            "a_dst": _glorot(keys[3 * i + 2], heads, d_out),
            "b": np.zeros(d_out, np.float32),
        })
    return layers


class GAT:
    """Multi-head GAT; heads are averaged on the last layer and
    concatenated elsewhere (standard GAT head handling).

    ``fused=True`` (default) runs the whole score->softmax->aggregate
    pipeline through the group_mapped schedule in one pass
    (ops/attention.py) — no per-edge arrays, no segment scatters.
    ``fused=False`` keeps the textbook per-edge composition.
    """

    def __init__(self, graph: Graph, dims, heads: int = 4,
                 negative_slope: float = 0.2, fused: bool = True,
                 dtype=None, vjp: bool = True):
        self.graph = graph.add_self_loops()
        self.dims = list(dims)
        self.heads = heads
        self.negative_slope = negative_slope
        self.fused = fused
        adj = self.graph.adj
        import jax.numpy as jnp

        self._dst = jnp.asarray(adj.row_ids())
        self._src = jnp.asarray(adj.indices)
        self._n = self.graph.num_nodes
        if fused:
            from loops_tpu.ops.attention import GroupedAttentionAggregate
            self._fused_op = GroupedAttentionAggregate(adj, negative_slope,
                                                       dtype=dtype, grad=vjp)

    def init(self, key):
        return init_gat(key, self.dims, self.heads)

    def apply(self, params, h):
        import jax
        import jax.numpy as jnp

        H = self.heads
        src, dst, n = self._src, self._dst, self._n
        for li, layer in enumerate(params):
            d_out = layer["a_src"].shape[1]
            d_in = layer["w"].shape[0]
            hw = (h @ layer["w"]).reshape(-1, H, d_out)     # [N, H, D]
            # per-node attention logits (factorized SDDMM: the edge dot
            # <a, [Wh_i || Wh_j]> splits into src/dst halves). Folded
            # param-side: s_src[n,h] = sum_d (hW)[n,h,d] a_src[h,d]
            #           = h @ V_src with V_src[:,h] = W_h @ a_src[h] —
            # one [N,d_in]x[d_in,H] matmul instead of an [N,H,D] einsum
            # (and its VJP broadcasts) in the train step's autodiff glue
            w3 = layer["w"].reshape(d_in, H, d_out)
            v_src = jnp.einsum("ihd,hd->ih", w3, layer["a_src"])
            v_dst = jnp.einsum("ihd,hd->ih", w3, layer["a_dst"])
            s_src = h @ v_src
            s_dst = h @ v_dst
            if self.fused:
                # custom-VJP apply: backward runs forward-style over
                # the transposed plan (ops/attention.py _bwd_fn)
                out = self._fused_op.apply(s_src, s_dst, hw)  # [N, H, D]
            else:
                e = s_src[src] + s_dst[dst]                 # [E, H]
                e = jax.nn.leaky_relu(e, self.negative_slope)
                alpha = segment_softmax(e, dst, n, sorted_ids=True)
                # gather/scatter via flat [., H*D] views (3-D operands
                # hit XLA's per-element slow paths; ops/attention.py)
                hws = hw.reshape(n, -1)[src].reshape(-1, H, d_out)
                msgs = (alpha[..., None] * hws).reshape(-1, H * d_out)
                out = segment_sum(msgs, dst, n, sorted_ids=True)
                out = out.reshape(n, H, d_out)
            if li + 1 < len(params):
                h = jax.nn.elu(out.reshape(n, H * d_out))
            else:
                h = out.mean(axis=1) + layer["b"]
        return h
