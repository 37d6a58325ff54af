"""Schedule-driven attention aggregation (the fused GAT layer core).

The textbook GAT pipeline materializes per-edge arrays and scatters:

    e     = leaky_relu(s_src[src] + s_dst[dst])        [E, H]
    alpha = segment_softmax(e, dst)                    [E, H]  (2 segment
                                                       ops + 2 gathers)
    out   = segment_sum(alpha[..,None] * hw[src], dst) [N, H, D] (scatter)

Every per-edge segment op is a scatter. But under the group_mapped
schedule a destination row is one contiguous
window of a degree-class plane — the softmax normalization domain *is*
the window. So the entire layer fuses into the bucketed-ELL pass
(ops/spmm.py group_mapped), flash-attention style:

    per bucket (rows of one degree class, plane [tiles, pitch]):
        E   = leaky_relu(s_src[idx] + s_dst[tiles, None])   in-plane
        Z   = exp(E - max_pitch(E)) masked                  in-plane
        out = einsum("tph,tphd->thd", Z, hw[idx]) / sum(Z)

No per-edge arrays exist at all; the only scatter is one unique-index
row set per bucket. The schedule abstraction (reference: group_mapped,
schedule/group_mapped.hxx:104-143) is doing the same job it does for
SpMV/SpMM — this is the framework's thesis applied to attention.
"""
from __future__ import annotations

import functools

import numpy as np

from loops_tpu.formats import CSR
from loops_tpu.layout import CsrLayout
from loops_tpu.schedule.plans import make_plan

__all__ = ["GroupedAttentionAggregate", "GroupedAttentionV2"]


class GroupedAttentionAggregate:
    """Fused masked-softmax attention aggregation over a fixed graph.

    ``op(s_src, s_dst, hw) -> [N, H, D]`` where ``s_src``/``s_dst`` are
    per-node per-head logit halves ([N, H]) and ``hw`` the transformed
    features ([N, H, D]); semantics match segment_softmax over incoming
    edges of each destination followed by the weighted segment_sum.

    ``grad=True`` (default) installs a custom VJP that runs the whole
    backward as one forward-style bucketed pass over the *transposed*
    plan (see ``_bwd_fn``) instead of autodiff's scatter-of-gathers.
    """

    def __init__(self, adj: CSR, negative_slope: float = 0.2,
                 dtype=None, grad: bool = True):
        import jax

        self.adj = adj
        self.n = adj.shape[0]
        self.negative_slope = float(negative_slope)
        self.dtype = dtype  # "bfloat16" halves feature-gather traffic;
        #                     scores, softmax and accumulation stay f32
        plan = make_plan(CsrLayout.from_csr(adj), "group_mapped")
        import jax.numpy as jnp

        self._bufs = dict(buckets=[
            (jnp.asarray(b["tiles"]),
             jnp.asarray(adj.indices[b["atom_slots"]]),
             jnp.asarray(b["valid"]))
            for b in plan.buckets])
        self._jit = jax.jit(functools.partial(self._fn, with_res=False))
        if grad:
            self._build_grad(adj, plan)
            self._jit_res = jax.jit(
                functools.partial(self._fn, with_res=True))
            self._jit_bwd = jax.jit(self._bwd_fn)

            @jax.custom_vjp
            def apply(s_src, s_dst, hw):
                return self._jit(self._bufs, s_src, s_dst, hw)

            def fwd(s_src, s_dst, hw):
                out, m_arr, den_arr = self._jit_res(
                    self._bufs, s_src, s_dst, hw)
                return out, (s_src, s_dst, hw, out, m_arr, den_arr)

            def bwd(res, g):
                return self._jit_bwd(self._bufs, *res, g)

            apply.defvjp(fwd, bwd)
            self.apply = apply
        else:
            self.apply = (lambda s_src, s_dst, hw:
                          self._jit(self._bufs, s_src, s_dst, hw))

    def _build_grad(self, adj: CSR, plan) -> None:
        """Stage the transposed (src-grouped) plan + the fwd<->bwd edge
        permutation the custom VJP needs.

        The transposed adjacency A^T groups edges by *source* node; its
        group_mapped plan drives the backward pass the same way the
        forward plan drives the forward. ``perm`` tracks each transposed
        edge's original edge id so per-edge quantities computed in
        backward-plane layout can be re-read in forward-plane layout
        (one flat-gather through ``fwd_maps``).
        """
        import jax.numpy as jnp

        n_rows, n_cols = adj.shape
        E = adj.nnz
        dst = adj.row_ids()
        src = np.asarray(adj.indices)
        perm = np.argsort(src, kind="stable")
        offsets_t = np.zeros(n_cols + 1, np.int64)
        np.cumsum(np.bincount(src, minlength=n_cols), out=offsets_t[1:])
        adj_t = CSR((n_cols, n_rows), offsets_t, dst[perm],
                    np.asarray(adj.vals)[perm])
        plan_t = make_plan(CsrLayout.from_csr(adj_t), "group_mapped")

        inv = np.zeros(E, np.int64)   # orig edge id -> bwd flat slot
        bwd_bufs, off = [], 0
        for b in plan_t.buckets:
            slots, valid = b["atom_slots"], b["valid"]
            t, p = slots.shape
            eid = perm[slots]
            pos = off + np.arange(t * p).reshape(t, p)
            inv[eid[valid]] = pos[valid]
            off += t * p
            bwd_bufs.append((jnp.asarray(b["tiles"]),
                             jnp.asarray(adj_t.indices[slots]),
                             jnp.asarray(valid)))
        # invalid fwd slots point at an appended all-zero row (index off)
        fwd_maps = [
            jnp.asarray(np.where(b["valid"], inv[b["atom_slots"]], off)
                        .astype(np.int32))
            for b in plan.buckets]
        # int32 flat-index limit: (padded_edges+1)*H must stay < 2^31
        self._bwd_flat = off
        self._bufs["bwd"] = bwd_bufs
        self._bufs["fwd_maps"] = fwd_maps

    def _fn(self, bufs, s_src, s_dst, hw, *, with_res: bool):
        import jax
        import jax.numpy as jnp

        n, slope = self.n, self.negative_slope
        H, D = hw.shape[1], hw.shape[2]
        # gather from the flattened [N, H*D] view: one H*D-wide row per
        # index rather than a 3-D gather
        hw2 = hw.reshape(n, H * D)
        fused_scores = self.dtype is not None
        if fused_scores:
            # a separate s_src[idx] gather is a narrow H-wide row
            # gather; concatenating the score halves onto the feature
            # rows makes it ride the one wide gather below. Scores round
            # through bf16 with the features (the backward rounds
            # identically, so fwd/bwd stay consistent).
            cat = jnp.concatenate(
                [hw2, s_src.astype(hw2.dtype)],
                axis=1).astype(self.dtype)
        else:
            hw2c = hw2
        # out stays flat [N, H*D]: one wide row per scatter index
        # instead of a 3-D scatter
        out = jnp.zeros((n, H * D), hw.dtype)
        neg = jnp.asarray(-jnp.inf, s_src.dtype)
        if with_res:
            # residual row-softmax stats; init 0/1 (not -inf) so padded
            # backward lanes reading untouched rows stay finite
            m_arr = jnp.zeros((n, H), s_src.dtype)
            den_arr = jnp.ones((n, H), s_src.dtype)
        for tiles, idx, valid in bufs["buckets"]:
            t, p = idx.shape
            if fused_scores:
                gat = cat[idx]                            # [t,p,HD+H]
                f = gat[..., :H * D].reshape(t, p, H, D)
                sg = gat[..., H * D:].astype(jnp.float32)
            else:
                sg = s_src[idx]                           # [t, p, H]
                f = hw2c[idx].reshape(t, p, H, D)
            # score elementwise ops in a flattened [t, p*H] layout, so
            # the tiny H axis is not the minor dimension on its own
            sdt = jnp.broadcast_to(s_dst[tiles][:, None, :], (t, p, H))
            vmask = jnp.broadcast_to(valid[..., None], (t, p, H))
            e2 = (sg + sdt).reshape(t, p * H)
            v2 = vmask.reshape(t, p * H)
            e2 = jax.nn.leaky_relu(e2, slope)
            e2 = jnp.where(v2, e2, neg)
            m = e2.reshape(t, p, H).max(axis=1, keepdims=True)
            z = jnp.where(v2, jnp.exp(
                (e2.reshape(t, p, H) - m).reshape(t, p * H)),
                0.0).reshape(t, p, H)
            denom = z.sum(axis=1)                         # [t, H]
            # broadcast-mul + sum(axis=1) mirrors the group_mapped SpMM
            # plane reduce (ops/spmm.py) instead of a dot_general
            agg = (z.astype(f.dtype)[..., None] * f).astype(
                jnp.float32).sum(axis=1)                  # [t, H, D]
            agg = agg / jnp.maximum(denom, 1e-30)[..., None]
            out = out.at[tiles].set(agg.reshape(t, H * D),
                                    unique_indices=True)
            if with_res:
                m_arr = m_arr.at[tiles].set(m[:, 0, :],
                                            unique_indices=True)
                den_arr = den_arr.at[tiles].set(denom,
                                                unique_indices=True)
        out = out.reshape(n, H, D)
        return (out, m_arr, den_arr) if with_res else out

    def _bwd_fn(self, bufs, s_src, s_dst, hw, out, m_arr, den_arr, g):
        """Backward as a forward-style pass over the transposed plan.

        Key identities that keep it scatter-free and gather-light:

        * the softmax correction ``c_r = sum_j alpha_j u_j`` (with
          ``u_j = <g_r, f_j>``) collapses to ``c_r = <g_r, out_r>`` —
          no per-edge work;
        * in the transposed plane a row is one *source* node, so the
          expensive feature operand ``hw[src]`` is row-constant (a
          cheap unique-row gather) and the only wide gather is
          ``g[dst]`` — exactly the forward's cost structure;
        * ``dhw[src] = sum alpha*g[dst]`` and ``ds_src[src] = sum dpre``
          are row-sums of the transposed plane (unique-row sets), while
          ``ds_dst[dst] = sum dpre`` re-reads ``dpre`` through the edge
          permutation into forward planes (one flat-gather per bucket).
        """
        import jax.numpy as jnp

        n, slope = self.n, self.negative_slope
        H, D = hw.shape[1], hw.shape[2]
        hw2 = hw.reshape(n, H * D)
        g2 = g.reshape(n, H * D)
        if self.dtype is not None:
            hw2 = hw2.astype(self.dtype)
            g2 = g2.astype(self.dtype)
            # match the forward's bf16-rounded score halves exactly
            # (the fused-gather forward rounds s_src with the features)
            s_src = s_src.astype(self.dtype).astype(s_dst.dtype)
        c = jnp.einsum("nhd,nhd->nh", g, out)             # [N, H]
        # one packed gather per plane row for all dst-indexed stats
        R = jnp.concatenate([s_dst, m_arr, den_arr, c], axis=1)
        # round-5 lever: in bf16 mode, concatenate the stats onto the
        # cotangent rows so the transposed planes pay ONE wide gather
        # per slot instead of two (same fused-gather trick as the
        # forward; m/den/c round through bf16 with everything else)
        fuse_R = self.dtype is not None
        if fuse_R:
            gcat = jnp.concatenate(
                [g2.astype(jnp.float32)
                 if g2.dtype != jnp.float32 else g2,
                 R], axis=1).astype(self.dtype)

        dhw2 = jnp.zeros((n, H * D), hw.dtype)
        ds_src = jnp.zeros_like(s_src)
        parts = []
        for tiles2, idx2, valid2 in bufs["bwd"]:
            t2, p2 = idx2.shape
            if fuse_R:
                gat2 = gcat[idx2]                         # [t,p,HD+4H]
                G = gat2[..., :H * D].reshape(t2, p2, H, D)
                Rg = gat2[..., H * D:].astype(jnp.float32)
            else:
                G = g2[idx2].reshape(t2, p2, H, D)
                Rg = R[idx2]
            # plane math runs in [t, H, p] layout, keeping the tiny H
            # axis off the minor dimension; the big [.., H, D] reduces
            # mirror the group_mapped SpMM's broadcast-mul + axis-sum
            # (ops/spmm.py) instead of dot_general
            RgT = Rg.transpose(0, 2, 1)                   # [t, 4H, p]
            sdst2, m2 = RgT[:, :H], RgT[:, H:2 * H]
            den2, c2 = RgT[:, 2 * H:3 * H], RgT[:, 3 * H:]
            pre2 = s_src[tiles2][:, :, None] + sdst2      # [t, H, p]
            e2 = jnp.where(pre2 >= 0, pre2, slope * pre2)
            alpha2 = jnp.exp(e2 - m2) / jnp.maximum(den2, 1e-30)
            alpha2 = jnp.where(valid2[:, None, :], alpha2, 0.0)
            f_t = hw2[tiles2].reshape(t2, H, D)
            u2 = (G * f_t[:, None, :, :]).astype(
                jnp.float32).sum(axis=3)                  # [t, p, H]
            u2 = u2.transpose(0, 2, 1)                    # [t, H, p]
            de2 = alpha2 * (u2 - c2)
            dpre2 = de2 * jnp.where(pre2 >= 0, 1.0, slope)
            dpre2 = jnp.where(valid2[:, None, :], dpre2, 0.0)
            a_ph = alpha2.transpose(0, 2, 1)              # [t, p, H]
            agg = (a_ph.astype(G.dtype)[..., None] * G).astype(
                jnp.float32).sum(axis=1)                  # [t, H, D]
            dhw2 = dhw2.at[tiles2].set(
                agg.reshape(t2, H * D).astype(hw.dtype),
                unique_indices=True)
            ds_src = ds_src.at[tiles2].set(dpre2.sum(axis=2),
                                           unique_indices=True)
            parts.append(dpre2.transpose(0, 2, 1).reshape(t2 * p2, H))
        parts.append(jnp.zeros((1, H), jnp.float32))      # pad-slot row
        dpre_flat = jnp.concatenate(parts, axis=0)        # [S_b+1, H]

        ds_dst = jnp.zeros_like(s_dst)
        for (tiles, _, _), mp in zip(bufs["buckets"], bufs["fwd_maps"]):
            # one width-H row gather per slot
            vals = dpre_flat[mp]                          # [t, p, H]
            ds_dst = ds_dst.at[tiles].set(vals.sum(axis=1),
                                          unique_indices=True)
        return (ds_src.astype(s_src.dtype), ds_dst.astype(s_dst.dtype),
                dhw2.reshape(n, H, D))

    def __call__(self, s_src, s_dst, hw):
        return self.apply(s_src, s_dst, hw)


def reference_attention_aggregate(adj: CSR, s_src, s_dst, hw,
                                  negative_slope: float = 0.2):
    """Per-edge numpy oracle for tests (segment_softmax semantics)."""
    n = adj.shape[0]
    dst = adj.row_ids()
    src = adj.indices
    e = s_src[src] + s_dst[dst]                          # [E, H]
    e = np.where(e >= 0, e, negative_slope * e)
    out = np.zeros((n,) + hw.shape[1:], np.float64)
    for r in range(n):
        a0, a1 = adj.offsets[r], adj.offsets[r + 1]
        if a0 == a1:
            continue
        er = e[a0:a1].astype(np.float64)
        z = np.exp(er - er.max(axis=0, keepdims=True))
        alpha = z / z.sum(axis=0, keepdims=True)
        out[r] = np.einsum("ph,phd->hd", alpha,
                           hw[src[a0:a1]].astype(np.float64))
    return out.astype(np.float32)


class GroupedAttentionV2:
    """Fused GATv2 attention aggregation over a fixed graph.

    GATv2 (Brody et al. 2022) scores are *not* factorizable into node
    halves: ``e_ij = a_h . leaky_relu(u_j + v_i)`` applies the
    nonlinearity to the per-edge sum of vector pre-activations, which
    is exactly the "static attention" limitation of GATv1 the paper
    fixes. The per-edge vector work is therefore irreducible — but it
    still runs as the same bucketed group_mapped pass as
    :class:`GroupedAttentionAggregate` (a destination row is one plane
    window, so score + masked softmax + weighted aggregation stay
    fused, with zero per-edge scatters).

    ``op(u, v, a, vals) -> [N, H, D]``: ``u``/``vals`` are per-source
    transforms ([N, H, D]; GATv2 standard uses vals == u), ``v`` the
    per-destination transform, ``a`` the attention vectors [H, D].
    Backward runs via autodiff through the fused forward (the v1
    transposed-plan custom VJP does not port: its score backward
    assumes scalar logit halves).
    """

    def __init__(self, adj: CSR, negative_slope: float = 0.2,
                 dtype=None):
        import jax
        import jax.numpy as jnp

        self.adj = adj
        self.n = adj.shape[0]
        self.negative_slope = float(negative_slope)
        self.dtype = dtype
        plan = make_plan(CsrLayout.from_csr(adj), "group_mapped")
        self._bufs = dict(buckets=[
            (jnp.asarray(b["tiles"]),
             jnp.asarray(adj.indices[b["atom_slots"]]),
             jnp.asarray(b["valid"]))
            for b in plan.buckets])
        self._jit = jax.jit(self._fn)
        self.apply = (lambda u, v, a, vals:
                      self._jit(self._bufs, u, v, a, vals))

    def _fn(self, bufs, u, v, a, vals):
        import jax
        import jax.numpy as jnp

        n, slope = self.n, self.negative_slope
        H, D = u.shape[1], u.shape[2]
        # flat [N, H*D] views for every gather: one wide row per index
        u2 = u.reshape(n, H * D)
        vals2 = vals.reshape(n, H * D)
        if self.dtype is not None:
            u2 = u2.astype(self.dtype)
            vals2 = vals2.astype(self.dtype)
        out = jnp.zeros((n, H * D), u.dtype)
        neg = jnp.asarray(-jnp.inf, u.dtype)
        for tiles, idx, valid in bufs["buckets"]:
            t, p = idx.shape
            pre = (u2[idx].reshape(t, p, H, D).astype(jnp.float32)
                   + v[tiles][:, None])                    # [t, p, H, D]
            e = jnp.einsum("tphd,hd->tph",
                           jax.nn.leaky_relu(pre, slope), a)
            e = jnp.where(valid[..., None], e, neg)
            m = e.max(axis=1, keepdims=True)
            z = jnp.where(valid[..., None], jnp.exp(e - m), 0.0)
            denom = z.sum(axis=1)                          # [t, H]
            f = vals2[idx].reshape(t, p, H, D)
            agg = (z.astype(f.dtype)[..., None] * f).astype(
                jnp.float32).sum(axis=1)                   # [t, H, D]
            agg = agg / jnp.maximum(denom, 1e-30)[..., None]
            out = out.at[tiles].set(agg.reshape(t, H * D).astype(
                out.dtype), unique_indices=True)
        return out.reshape(n, H, D)
