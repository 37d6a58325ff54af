#!/usr/bin/env python
"""Smoke run of the main path on one GPU, checked against host references.

    python chip_smoke.py               # one card: sparse ops, kernels,
                                       # cost constants, GCN/GAT training
    python chip_smoke.py --four-cards  # only DistGCN on four cards,
                                       # against its oracles

Every phase prints its own lines: shapes, compile seconds, steady
milliseconds, and the error against the host float64 reference
(``loops_tpu/utils/reference.py``) beside its tolerance. A phase that
misses its tolerance raises, and the run exits non-zero. The last line of
standard output is one JSON object naming the device.

The phase functions take their sizes as arguments so the tests run them
at tiny sizes on the CPU; ``main()`` refuses any platform but ``gpu``.

Tolerances:
* f32 ops: max |y - y64| / max |y64| <= 1e-5. Every f32 dot asks for
  ``Precision.HIGHEST``, since TF32 is the card's default.
* bf16 modes round the values, the dense operand and the product to
  bf16 (unit roundoff u = 2**-8 each) and accumulate in f32, so each
  entry obeys |y - y64| <= (3u + 1e-5) * sum |a_ij * b_j|.
* Models: first-step logits, loss and every gradient leaf, each as
  max |x - x64| / max |x64| against a float64 host forward and backward
  that shares no code with the model (GAT's gradients through a
  finite-difference probe per leaf). The GCN is checked twice. With its
  dense layers held at ``Precision.HIGHEST`` only the aggregation
  differs from the reference: f32 aggregation to 2e-4, bf16 aggregation
  to 3e-2 (readings on an H100 with f32 aggregation: logits 1.6e-6,
  gradients 4.0e-5, the worst leaf a sum over 169k rows; bf16
  aggregation ~1e-3 and more), so a bf16 path fails the f32 tolerance. At the card's default
  (TF32 dense layers, what training runs) to 1e-2, or bf16's 3e-2:
  readings on an H100 were 3.9e-4 logits and 2.6e-3 gradients (f32),
  8.9e-4 and 4.1e-3 (bf16). GAT (bf16 gathers, TF32
  dense layers): logits 1e-2, gradients 5e-2 (readings 3.3e-3 and
  6.7e-3 on an H100, 3.7e-3 and 2.4e-2 at tiny sizes on the CPU).
* Four cards: DistGCN's first-step logits, loss and gradients against
  the one-card GCN, dense layers at ``Precision.HIGHEST``, to the f32
  GCN tolerance (2e-4): the exchanges differ from one card only in
  summation order.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

F32_TOL = 1e-5
BF16_U = 2.0 ** -8
# model checks (see the module docstring): GCN with IEEE f32 dense
# layers, by aggregation dtype; any model with TF32 dense layers; GAT;
# DistGCN against the one-card GCN
GCN_TOL = {None: 2e-4, "bfloat16": 3e-2}
TF32_TOL = 1e-2
GAT_TOL = {"logits": 1e-2, "grads": 5e-2}
FOUR_CARD_TOL = GCN_TOL[None]


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseFailed(AssertionError):
    pass


def check(name: str, err: float, tol: float) -> None:
    ok = bool(np.isfinite(err)) and err <= tol
    log(f"  {name}: err {err:.3e} tol {tol:.1e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise PhaseFailed(f"{name}: error {err} exceeds {tol}")


def rel_err(y, ref) -> float:
    y = np.asarray(y, np.float64)
    return float(np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-30))


def bf16_ratio(y, ref, l1) -> float:
    """Largest |y - ref| over its bf16 bound; <= 1 passes."""
    bound = (3 * BF16_U + F32_TOL) * l1 + 1e-30
    return float((np.abs(np.asarray(y, np.float64) - ref) / bound).max())


def timed(fn, *args, iters: int = 20):
    """(compile+first-run seconds, steady ms per call). Calls are
    queued back to back and the clock stops when the last finishes."""
    import jax

    args = [jax.device_put(a) for a in args]
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters * 1e3)
    return out, first_s, best


def gpu_name_and_power() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


# ----------------------------------------------------------- phase 0
def phase_device() -> dict:
    import jax

    d = jax.devices()[0]
    info = dict(platform=d.platform, kind=d.device_kind,
                count=len(jax.devices()))
    log(f"phase 0 device: {info}")
    return info


# ----------------------------------------------------------- phase 1
def phase_spmv(n: int = 32768, density: float = 4e-6 * 1024,
               seed: int = 3) -> dict:
    """CSR SpMV through ``auto`` and every XLA schedule."""
    from loops_tpu.ops.spmv import SCHEDULES, SpMVOperator
    from loops_tpu.utils import reference
    from loops_tpu.utils.generate import random_csr

    csr = random_csr(n, n, density, seed=seed)
    x = np.random.default_rng(seed + 1).normal(size=n).astype(np.float32)
    y64 = reference.spmv_f64(csr, x)
    log(f"phase 1 spmv: {n}x{n}, nnz {csr.nnz}")
    ms = {}
    for sched in ("auto",) + SCHEDULES:
        op = SpMVOperator(csr, sched)
        y, first_s, ms[sched] = timed(op, x)
        log(f"  schedule {sched} -> {op.schedule}: first {first_s:.2f} s, "
            f"steady {ms[sched]:.4f} ms")
        check(f"spmv {sched}", rel_err(y, y64), F32_TOL)
        rep = reference.rigorously_validate_spmv(csr, x, np.asarray(y))
        if rep.verdict != "NOT_A_BUG":
            raise PhaseFailed(f"spmv {sched}: Wilkinson check {rep}")
    return dict(nnz=csr.nnz, ms=ms)


def _abs_csr(csr):
    from loops_tpu.formats import CSR
    return CSR(csr.shape, csr.offsets, csr.indices, np.abs(csr.vals))


def _spmm_cases(name, ops, B, ref, l1, rows=None):
    """Run each (label, operator, dtype) and check it (on ``rows`` only,
    when given); returns ms."""
    ms = {}
    for label, op, dtype in ops:
        y, first_s, ms[label] = timed(op, B)
        y = np.asarray(y)
        if rows is not None:
            y = y[rows]
        log(f"  {label}: out {y.shape}, first {first_s:.2f} s, "
            f"steady {ms[label]:.4f} ms")
        if dtype is None:
            check(f"{name} {label}", rel_err(y, ref), F32_TOL)
        else:
            check(f"{name} {label} (err/bf16 bound)",
                  bf16_ratio(y, ref, l1), 1.0)
    return ms


def phase_csr_spmm(scale: float = 1.0, F: int = 128, seed: int = 10
                   ) -> dict:
    """SpMM over the GCN-normalised ogbn-arxiv-sized adjacency: the
    schedule router's pick and each XLA schedule (``row_mapped`` is what
    GNN aggregation runs)."""
    from loops_tpu.io import ogb
    from loops_tpu.ops.spmm import SpMMOperator
    from loops_tpu.utils import reference

    adj = ogb.load("ogbn-arxiv", scale=scale).graph.gcn_normalized().adj
    B = np.random.default_rng(seed).normal(
        size=(adj.shape[1], F)).astype(np.float32)
    ref = reference.spmm(adj, B, dtype=np.float64)
    l1 = reference.spmm(_abs_csr(adj), np.abs(B), dtype=np.float64)
    log(f"phase 1 csr spmm: {adj.shape}, nnz {adj.nnz}, F {F}")
    ops = []
    for dtype in (None, "bfloat16"):
        tag = "f32" if dtype is None else "bf16"
        for sched in ("auto", "row_mapped", "group_mapped"):
            op = SpMMOperator(adj, sched, dtype=dtype)
            ops.append((f"{tag} {sched}->{op.schedule}", op, dtype))
    return dict(nnz=adj.nnz, ms=_spmm_cases("csr spmm", ops, B, ref, l1))


def phase_bcsr_spmm(N: int = 16384, F: int = 512, density: float = 0.06,
                    check_rows: int = 2048, seed: int = 1) -> dict:
    """Block-sparse SpMM: the einsum path and the Triton kernel (f32
    through an IEEE f32 dot), checked on ``check_rows`` sampled rows at
    full width."""
    from loops_tpu.ops.spmm import SpMMOperator
    from loops_tpu.utils import reference
    from loops_tpu.utils.generate import block_sparse

    csr, bcsr = block_sparse(N=N, R=8, C=128, block_density=density)
    B = np.random.default_rng(seed).normal(size=(N, F)).astype(np.float32)
    rows = np.sort(np.random.default_rng(seed + 1).choice(
        N, min(check_rows, N), replace=False))
    sub = _take_rows(csr, rows)
    ref = reference.spmm(sub, B, dtype=np.float64)
    l1 = reference.spmm(_abs_csr(sub), np.abs(B), dtype=np.float64)
    log(f"phase 1 bcsr spmm: {N}x{N}, {bcsr.num_blocks} blocks 8x128, "
        f"nnz {csr.nnz}, F {F}, checked rows {len(rows)}")
    ops = []
    for dtype in (None, "bfloat16"):
        tag = "f32" if dtype is None else "bf16"
        for impl in ("xla", "pallas"):
            op = SpMMOperator(bcsr, impl=impl, dtype=dtype)
            ops.append((f"{tag} {impl}", op, dtype))
    return dict(nnz=csr.nnz, blocks=bcsr.num_blocks,
                ms=_spmm_cases("bcsr spmm", ops, B, ref, l1, rows))


def _take_rows(csr, rows):
    from loops_tpu.models.message_passing import _take_rows_csr
    return _take_rows_csr(csr, rows)


def phase_sddmm(n: int = 65536, nnz: float = 2.47e6, F: int = 128,
                seed: int = 6) -> dict:
    from loops_tpu.ops.sddmm import SDDMMOperator
    from loops_tpu.utils import reference
    from loops_tpu.utils.generate import random_csr

    csr = random_csr(n, n, nnz / n ** 2, seed=seed)
    rng = np.random.default_rng(seed + 2)
    A = rng.normal(size=(n, F)).astype(np.float32)
    Bm = rng.normal(size=(n, F)).astype(np.float32)
    ref = reference.sddmm(csr, A, Bm)
    l1 = reference.sddmm(_abs_csr(csr), np.abs(A), np.abs(Bm))
    log(f"phase 1 sddmm: {n}x{n}, nnz {csr.nnz}, F {F}")
    ms = {}
    for dtype in (None, "bfloat16"):
        tag = "f32" if dtype is None else "bf16"
        op = SDDMMOperator(csr, dtype=dtype)
        y, first_s, ms[tag] = timed(op, A, Bm)
        log(f"  {tag}: out {np.shape(y)}, first {first_s:.2f} s, "
            f"steady {ms[tag]:.4f} ms")
        if dtype is None:
            check(f"sddmm {tag}", rel_err(y, ref), F32_TOL)
        else:
            # two roundings (A, B) per product
            check(f"sddmm {tag} (err/bf16 bound)",
                  bf16_ratio(y, ref, l1), 1.0)
    return dict(nnz=csr.nnz, ms=ms)


def phase_advisor_costs(spmv: dict, n: int = 32768, seed: int = 5,
                        bcsr_density: float = 0.015,
                        dia_diagonals: int = 64) -> dict:
    """The format advisor's cost constants on this card: ns per CSR
    nonzero (row_mapped SpMV), ns per stored BCSR and DIA cell, and the
    fills at which the dense formats break even with CSR."""
    from loops_tpu.formats import DIA
    from loops_tpu.ops.spmv import SpMVOperator
    from loops_tpu.utils import reference
    from loops_tpu.utils.generate import banded_csr, block_sparse

    gather_ns = spmv["ms"]["row_mapped"] * 1e6 / spmv["nnz"]
    csr_b, bcsr = block_sparse(N=n, R=8, C=128, block_density=bcsr_density,
                               seed=seed)
    band = banded_csr(n, n, band=dia_diagonals // 2, seed=seed)
    dia = DIA.from_csr(band)
    out = dict(gather_ns=gather_ns)
    x = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    for name, mat, csr, cells in (
            ("bcsr", bcsr, csr_b, bcsr.num_blocks * 8 * 128),
            ("dia", dia, band, dia.vals.size)):
        op = SpMVOperator(mat)
        y, first_s, ms = timed(op, x)
        check(f"advisor {name} spmv", rel_err(y, reference.spmv_f64(csr, x)),
              F32_TOL)
        out[f"{name}_ns_per_cell"] = ms * 1e6 / cells
        out[f"{name}_break_even_fill"] = out[f"{name}_ns_per_cell"] / gather_ns
    log("phase 1 advisor costs: " + ", ".join(
        f"{k} {v:.4g}" for k, v in out.items()))
    return out


# ----------------------------------------------------------- phase 2
def tree_err(tree, ref) -> float:
    """Worst leaf's max |x - ref| / max |ref| over two pytrees of the
    same structure."""
    import jax

    leaves, ref_leaves = (jax.tree_util.tree_leaves(t) for t in (tree, ref))
    assert len(leaves) == len(ref_leaves)
    return max(rel_err(a, b) for a, b in zip(leaves, ref_leaves))


def _scipy_csr(csr):
    import scipy.sparse as sp

    return sp.csr_matrix((np.asarray(csr.vals, np.float64), csr.indices,
                          csr.offsets), shape=csr.shape)


def _masked_ce(logits, labels, mask):
    """Masked mean cross-entropy and its gradient w.r.t. the logits."""
    m = np.asarray(mask, np.float64)
    denom = max(m.sum(), 1.0)
    z = logits - logits.max(axis=1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    rows = np.arange(len(labels))
    loss = float(-(logp[rows, labels] * m).sum() / denom)
    g = np.exp(logp)
    g[rows, labels] -= 1.0
    return loss, g * (m / denom)[:, None]


def host_gcn(adj, feats, labels, mask, params):
    """Float64 host forward and backward of the GCN's masked mean
    cross-entropy: ``(logits, loss, grads)``, grads shaped like params."""
    A = _scipy_csr(adj)
    At = A.T.tocsr()
    W = [np.asarray(p["w"], np.float64) for p in params]
    h = np.asarray(feats, np.float64)
    inputs, pre = [], []
    for i, layer in enumerate(params):
        inputs.append(h)
        a = A @ (h @ W[i]) + np.asarray(layer["b"], np.float64)
        pre.append(a)
        h = np.maximum(a, 0.0) if i + 1 < len(params) else a
    loss, g = _masked_ce(h, np.asarray(labels), mask)
    grads = [None] * len(params)
    for i in reversed(range(len(params))):
        dz = At @ g
        grads[i] = {"b": g.sum(axis=0), "w": inputs[i].T @ dz}
        if i:
            g = (dz @ W[i].T) * (pre[i - 1] > 0)
    return h, loss, grads


def check_gcn(model, data, p0, tol: float, name: str,
              precision: str | None = None) -> dict:
    """First-step logits, loss and gradients of ``model`` (through the
    training loss of ``models/train.py``) against ``host_gcn``, with the
    dense layers at ``precision`` (None: the backend's default)."""
    import jax

    from loops_tpu.models import train as T

    loss_fn = T.make_loss_fn(model, data.features, data.labels,
                             data.train_mask)
    with jax.default_matmul_precision(precision):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            p0, jax.random.PRNGKey(1))
        logits = jax.jit(model.apply)(p0, jax.numpy.asarray(data.features))
    adj = data.graph.gcn_normalized().adj
    ref_logits, ref_loss, ref_grads = host_gcn(
        adj, data.features, data.labels, data.train_mask, p0)
    errs = dict(logits=rel_err(logits, ref_logits),
                loss=abs(float(loss) - ref_loss) / abs(ref_loss),
                grads=tree_err(grads, ref_grads))
    for k, v in errs.items():
        check(f"{name} first-step {k} vs host f64", v, tol)
    return dict(errs, host_loss=ref_loss)


def _train_losses(step, state, steps: int):
    """Run ``steps`` calls of ``step(*state) -> (*state, loss)``: first
    call seconds, steady ms per call, losses."""
    import jax

    t0 = time.perf_counter()
    *state, loss = jax.block_until_ready(step(*state))
    first_s = time.perf_counter() - t0
    losses = [loss]
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        *state, loss = step(*state)
        losses.append(loss)
    jax.block_until_ready(loss)
    ms = (time.perf_counter() - t0) / max(steps - 1, 1) * 1e3
    losses = [float(v) for v in losses]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise PhaseFailed(f"loss not finite and falling {losses}")
    return first_s, ms, losses


def phase_gcn(scale: float = 1.0, hidden: int = 128, steps: int = 6,
              dtypes=(None, "bfloat16")) -> dict:
    """3-layer GCN: first-step logits, loss and gradients against the
    host float64 forward and backward (dense layers in IEEE f32, then at
    the card's default), then training through ``make_train_epochs``
    with a finite, falling loss."""
    import jax
    import optax

    from loops_tpu.io import ogb
    from loops_tpu.models import GCN
    from loops_tpu.models import train as T

    data = ogb.load("ogbn-arxiv", scale=scale)
    g = data.graph
    dims = [data.features.shape[1], hidden, hidden, data.num_classes]
    log(f"phase 2 gcn: nodes {g.num_nodes}, nnz "
        f"{g.gcn_normalized().adj.nnz}, dims {dims}")
    out = {}
    for dtype in dtypes:
        tag = "f32" if dtype is None else "bf16"
        model = GCN(g, dims, dropout=0.0, dtype=dtype,
                    loss_rows=data.train_mask)
        p0 = model.init(jax.random.PRNGKey(0))
        errs = check_gcn(model, data, p0, GCN_TOL[dtype],
                         f"gcn {tag} (f32 dense)", precision="highest")
        check_gcn(model, data, p0, max(TF32_TOL, GCN_TOL[dtype]),
                  f"gcn {tag} (default dense)")
        opt = optax.adam(1e-2)
        epochs = jax.jit(T.make_train_epochs(
            model, opt, data.features, data.labels, data.train_mask,
            steps_per_call=1))
        first_s, ms, losses = _train_losses(
            epochs, (p0, opt.init(p0), jax.random.PRNGKey(1)), steps)
        log(f"  {tag}: first {first_s:.2f} s, steady {ms:.3f} ms/step, "
            f"losses {[round(v, 5) for v in losses]}, host f64 "
            f"{errs['host_loss']:.6f}")
        out[tag] = dict(errs, ms_per_step=ms, losses=losses)
    return out


def host_gat_logits(adj, feats, params, heads: int,
                    negative_slope: float = 0.2) -> np.ndarray:
    """Plain float64 GAT forward over ``adj`` (rows are destinations,
    self loops included, every row non-empty): per head, leaky-ReLU
    scores ``a_src . Wh_j + a_dst . Wh_i``, a softmax over each row's
    edges, and the weighted sum of the sources' ``Wh_j``. Heads are
    concatenated through ELU between layers and averaged at the end."""
    import scipy.sparse as sp

    n = adj.shape[0]
    starts = np.asarray(adj.offsets[:-1], np.int64)
    src = np.asarray(adj.indices, np.int64)
    dst = np.repeat(np.arange(n), np.diff(adj.offsets))
    h = np.asarray(feats, np.float64)
    for li, layer in enumerate(params):
        a_src = np.asarray(layer["a_src"], np.float64)
        a_dst = np.asarray(layer["a_dst"], np.float64)
        D = a_src.shape[1]
        hw = (h @ np.asarray(layer["w"], np.float64)).reshape(n, heads, D)
        out = np.empty_like(hw)
        for k in range(heads):
            hk = np.ascontiguousarray(hw[:, k])
            e = (hk @ a_src[k])[src] + (hk @ a_dst[k])[dst]
            e = np.where(e > 0, e, negative_slope * e)
            e = np.exp(e - np.maximum.reduceat(e, starts)[dst])
            alpha = e / np.add.reduceat(e, starts)[dst]
            # out_i = sum_j alpha_ij Wh_j, as one sparse product
            out[:, k] = sp.csr_matrix((alpha, src, adj.offsets),
                                      shape=(n, n)) @ hk
        if li + 1 < len(params):
            h = out.reshape(n, heads * D)
            h = np.where(h > 0, h, np.expm1(np.minimum(h, 0.0)))
        else:
            h = out.mean(axis=1) + np.asarray(layer["b"], np.float64)
    return h


def check_gat(gat, data, p0, logits, grads, name: str = "gat",
              eps: float = 1e-6) -> dict:
    """GAT's first-step logits against ``host_gat_logits``, and each
    gradient leaf against a float64 finite difference of the host loss
    along that leaf's own direction: ``<g, u>`` with ``u = g/|g|`` must
    match ``(L(p + eps u) - L(p)) / eps``."""
    import jax

    adj = gat.graph.adj
    labels = np.asarray(data.labels)

    def host_loss(params):
        return _masked_ce(host_gat_logits(adj, data.features, params,
                                          gat.heads, gat.negative_slope),
                          labels, data.train_mask)[0]

    p64 = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), p0)
    ref_logits = host_gat_logits(adj, data.features, p64, gat.heads,
                                 gat.negative_slope)
    base = _masked_ce(ref_logits, labels, data.train_mask)[0]
    errs = dict(logits=rel_err(logits, ref_logits))
    check(f"{name} first-step logits vs host f64", errs["logits"],
          GAT_TOL["logits"])
    leaves, tdef = jax.tree_util.tree_flatten(p64)
    g_leaves = [np.asarray(x, np.float64)
                for x in jax.tree_util.tree_leaves(grads)]
    total = float(np.sqrt(sum((x ** 2).sum() for x in g_leaves)))
    worst = 0.0
    for i, g in enumerate(g_leaves):
        norm = float(np.linalg.norm(g))
        # a zero leaf (layer 0's b, which the loss does not read) is
        # probed along ones: the host slope must be zero too
        u = g / norm if norm else np.ones_like(g) / np.sqrt(g.size)
        moved = list(leaves)
        moved[i] = leaves[i] + eps * u
        fd = (host_loss(tdef.unflatten(moved)) - base) / eps
        worst = max(worst, abs(norm - fd) / max(abs(fd), norm,
                                                1e-3 * total))
    errs["grads"] = worst
    check(f"{name} first-step gradients vs host f64 (directional)",
          worst, GAT_TOL["grads"])
    return errs


def phase_gat(scale: float = 1.0, hidden: int = 64, heads: int = 4,
              steps: int = 5) -> dict:
    """GAT (fused grouped attention, bf16 gathers): first-step logits and
    gradients against the host float64 forward, then training steps
    with a finite, falling loss."""
    import jax
    import jax.numpy as jnp
    import optax

    from loops_tpu.io import ogb
    from loops_tpu.models import GAT
    from loops_tpu.models.train import cross_entropy

    data = ogb.load("ogbn-arxiv", scale=scale)
    g = data.graph
    dims = [data.features.shape[1], hidden, data.num_classes]
    gat = GAT(g, dims, heads=heads, fused=True, vjp=True, dtype="bfloat16")
    X = jnp.asarray(data.features)
    y = jnp.asarray(data.labels)
    m = jnp.asarray(data.train_mask)
    opt = optax.adam(1e-2)

    @jax.jit
    def step(p, s):
        loss, grads = jax.value_and_grad(
            lambda q: cross_entropy(gat.apply(q, X), y, m))(p)
        upd, s = opt.update(grads, s, p)
        return optax.apply_updates(p, upd), s, loss, grads

    p0 = gat.init(jax.random.PRNGKey(0))
    log(f"phase 2 gat: nodes {g.num_nodes}, edges {gat.graph.adj.nnz} "
        f"(with self loops), dims {dims}, heads {heads}")
    first = {}

    def one(p, s):
        p, s, loss, grads = step(p, s)
        first.setdefault("grads", grads)
        return p, s, loss

    first_s, ms, losses = _train_losses(one, (p0, opt.init(p0)), steps)
    log(f"  first {first_s:.2f} s, steady {ms:.3f} ms/step, losses "
        f"{[round(v, 5) for v in losses]}")
    logits = jax.jit(gat.apply)(p0, X)
    errs = check_gat(gat, data, p0, logits, first["grads"])
    return dict(errs, ms_per_step=ms, losses=losses)


# ----------------------------------------------------------- phase 3
def phase_four_cards(scale: float = 1.0, hidden: int = 128,
                     steps: int = 3, n_dev: int = 4,
                     tol: float = FOUR_CARD_TOL) -> dict:
    """DistGCN over ``n_dev`` devices with the overlapped halo
    ``all_to_all`` and with the ``all_gather`` oracle: first-step
    logits, loss and gradients of each against the one-card GCN from the
    same init (dense layers in IEEE f32, so the exchanges differ from it
    only in summation order), then a few training steps whose losses
    must agree between the two exchanges."""
    import jax
    import optax

    from loops_tpu.io import ogb
    from loops_tpu.models import GCN
    from loops_tpu.models import train as T
    from loops_tpu.parallel import DistGCN, make_mesh
    from loops_tpu.parallel.dist_ops import make_dist_loss
    from loops_tpu.parallel.halo import DistSpMMHalo

    devs = jax.devices()
    if len(devs) < n_dev:
        raise PhaseFailed(f"need {n_dev} devices, have {len(devs)}")
    data = ogb.load("ogbn-arxiv", scale=scale)
    g = data.graph
    dims = [data.features.shape[1], hidden, hidden, data.num_classes]
    mesh = make_mesh(n_dev)
    log(f"phase 3 four cards: mesh {dict(mesh.shape)}, nodes "
        f"{g.num_nodes}, dims {dims}")

    one = GCN(g, dims, dropout=0.0)
    p0 = one.init(jax.random.PRNGKey(0))
    loss_fn = T.make_loss_fn(one, data.features, data.labels,
                             data.train_mask)
    with jax.default_matmul_precision("highest"):
        ref = dict(zip(("loss", "grads"), jax.jit(jax.value_and_grad(
            loss_fn))(p0, jax.random.PRNGKey(1))))
        ref["logits"] = np.asarray(jax.jit(one.apply)(
            p0, jax.numpy.asarray(data.features)))

    opt = optax.adam(1e-2)
    runs = {}
    for exchange in ("halo", "all_gather"):
        model = DistGCN(g, dims, mesh, exchange=exchange)
        if exchange == "halo":
            prop = model.propagate
            if not (isinstance(prop, DistSpMMHalo) and prop.overlap):
                raise PhaseFailed("default exchange is not halo+overlap")
            for buf in prop.buffers:
                placed = {s.device for s in buf.addressable_shards}
                if placed != set(devs[:n_dev]):
                    raise PhaseFailed(f"shards on {placed}, not on "
                                      f"{n_dev} distinct devices")
            log(f"  halo buffers sharded over "
                f"{sorted(d.id for d in placed)}")
        dist_loss, bufs = make_dist_loss(model, data.features, data.labels,
                                         data.train_mask)
        with jax.default_matmul_precision("highest"):
            loss, grads = jax.jit(jax.value_and_grad(dist_loss))(p0, bufs)
            logits = model.plan.unpad_output(np.asarray(jax.jit(
                lambda p, b: model.apply(p, b["h0"], adj=b["adj"]))(
                    p0, bufs)))
        errs = dict(logits=rel_err(logits, ref["logits"]),
                    loss=abs(float(loss) - float(ref["loss"]))
                    / abs(float(ref["loss"])),
                    grads=tree_err(grads, ref["grads"]))
        for k, v in errs.items():
            check(f"{exchange} vs one card, first-step {k}", v, tol)
        step = model.make_train_step(opt, data.features, data.labels,
                                     data.train_mask)
        first_s, ms, losses = _train_losses(step, (p0, opt.init(p0)), steps)
        runs[exchange] = dict(errs, losses=losses, ms_per_step=ms)
        log(f"  {exchange}: first {first_s:.2f} s, steady {ms:.3f} "
            f"ms/step, losses {[round(v, 5) for v in losses]}")
    err = max(abs(a - b) / abs(b) for a, b in
              zip(runs["halo"]["losses"], runs["all_gather"]["losses"]))
    check("halo vs all_gather training losses", err, tol)
    return runs


# -------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only DistGCN on four cards vs its oracles")
    args = ap.parse_args(argv)

    from loops_tpu.utils.platform import (
        enable_compilation_cache,
        ensure_platform,
    )

    backend = ensure_platform()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found {backend!r}")
    enable_compilation_cache()
    log(f"card: {gpu_name_and_power()}")
    info = phase_device()
    if info["platform"] != "gpu":
        raise SystemExit(f"platform {info['platform']!r} is not 'gpu'")
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        spmv = phase_spmv()
        phase_csr_spmm()
        phase_bcsr_spmm()
        phase_sddmm()
        phase_advisor_costs(spmv)
        phase_gcn()
        phase_gat()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(f"card: {gpu_name_and_power()}")
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
