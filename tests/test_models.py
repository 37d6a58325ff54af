"""GNN model tests: graph preprocessing, message passing semantics,
GCN/GraphSAGE forward + a real overfit-training check, sampling shapes."""
import numpy as np
import pytest

from loops_tpu.models import (
    GCN,
    Graph,
    GraphSAGE,
    aggregate_operator,
    edge_aggregate,
    sample_neighbors,
)
from loops_tpu.models import train as train_mod
from loops_tpu.utils import generate


def _toy_graph(n=30, seed=0):
    rng = np.random.default_rng(seed)
    m = 3 * n
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    return Graph.from_edges(src, dst, n, make_undirected=True)


def test_graph_construction_and_degrees():
    g = Graph.from_edges([0, 1, 2], [1, 2, 0], 4, make_undirected=True)
    assert g.num_nodes == 4
    assert g.num_edges == 6
    assert g.in_degrees().sum() == 6
    assert g.out_degrees().sum() == 6
    g2 = g.add_self_loops()
    assert g2.num_edges == 10  # +4 loops
    # idempotent on existing loops
    assert g2.add_self_loops().num_edges == 10


def test_gcn_normalization_rows():
    g = _toy_graph()
    gn = g.gcn_normalized()
    a = gn.adj.to_dense().astype(np.float64)
    # symmetric normalization of a symmetric matrix stays symmetric
    np.testing.assert_allclose(a, a.T, atol=1e-6)
    # eigenvalues of D^-1/2 (A+I) D^-1/2 are in [-1, 1+eps]
    w = np.linalg.eigvalsh(a)
    assert w.max() <= 1.0 + 1e-5


def test_aggregate_matches_manual():
    g = _toy_graph(12, seed=2)
    h = np.random.default_rng(1).normal(size=(12, 5)).astype(np.float32)
    dense = g.adj.to_dense()
    out = np.asarray(aggregate_operator(g, "sum")(h))
    np.testing.assert_allclose(out, dense @ h, rtol=1e-4, atol=1e-4)
    out = np.asarray(aggregate_operator(g, "mean")(h))
    deg = np.maximum(dense.sum(1, keepdims=True), 1)
    np.testing.assert_allclose(out, dense @ h / deg, rtol=1e-4, atol=1e-4)


def test_edge_aggregate_ops():
    import jax.numpy as jnp

    g = _toy_graph(10, seed=3)
    h = jnp.asarray(
        np.random.default_rng(2).normal(size=(10, 4)).astype(np.float32))
    s = np.asarray(edge_aggregate(g, h, op="sum"))
    np.testing.assert_allclose(s, g.adj.to_dense() @ np.asarray(h),
                               rtol=1e-4, atol=1e-4)
    mx = np.asarray(edge_aggregate(g, h, op="max"))
    dense = g.adj.to_dense()
    for i in range(10):
        nbrs = np.nonzero(dense[i])[0]
        if len(nbrs):
            np.testing.assert_allclose(mx[i], np.asarray(h)[nbrs].max(0),
                                       rtol=1e-5)


def test_gcn_forward_and_overfit():
    import jax
    import optax

    g = _toy_graph(24, seed=5)
    n, f, c = 24, 8, 3
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(n, f)).astype(np.float32)
    labels = rng.integers(0, c, n)
    mask = np.ones(n, np.float32)

    model = GCN(g, [f, 16, c], dropout=0.0)
    params = model.init(jax.random.PRNGKey(0))
    logits = model.apply(params, feats)
    assert logits.shape == (n, c)

    opt = optax.adam(5e-2)
    step = jax.jit(train_mod.make_train_step(model, opt, feats, labels, mask))
    opt_state = opt.init(params)
    key = jax.random.PRNGKey(1)
    losses = []
    for _ in range(60):
        params, opt_state, key, loss = step(params, opt_state, key)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, losses[::20]
    acc = train_mod.evaluate(model, params, feats, labels, mask)
    assert acc > 0.6  # overfits a tiny graph


def test_sampling_shapes_and_membership():
    import jax

    g = _toy_graph(20, seed=7)
    seeds = np.array([0, 3, 7, 19])
    nbr = np.asarray(sample_neighbors(g, seeds, 5, jax.random.PRNGKey(0)))
    assert nbr.shape == (4, 5)
    dense = g.adj.to_dense()
    for i, s in enumerate(seeds):
        nbrs = set(np.nonzero(dense[s])[0].tolist()) | {s}
        assert set(nbr[i].tolist()) <= nbrs


def test_isolated_node_samples_itself():
    import jax

    g = Graph.from_edges([0], [1], 3)
    nbr = np.asarray(sample_neighbors(g, np.array([2]), 4,
                                      jax.random.PRNGKey(0)))
    assert (nbr == 2).all()


def test_graphsage_full_and_sampled():
    import jax

    g = _toy_graph(18, seed=9)
    feats = np.random.default_rng(5).normal(size=(18, 6)).astype(np.float32)
    model = GraphSAGE(g, [6, 12, 4])
    params = model.init(jax.random.PRNGKey(2))
    out = model.apply(params, feats)
    assert out.shape == (18, 4)

    seeds = np.array([1, 5, 9])
    mb = model.apply_sampled(params, feats, seeds, fanouts=[3, 4],
                             key=jax.random.PRNGKey(3))
    assert mb.shape == (3, 4)
    assert np.isfinite(np.asarray(mb)).all()


def test_segment_softmax_normalizes():
    import jax.numpy as jnp

    from loops_tpu.ops.segment import segment_softmax

    scores = jnp.asarray(np.array([1.0, 2.0, 3.0, -1.0, 500.0, 499.0],
                                  np.float32))
    seg = jnp.asarray(np.array([0, 0, 0, 2, 3, 3], np.int32))
    w = np.asarray(segment_softmax(scores, seg, 4, sorted_ids=True))
    np.testing.assert_allclose(w[:3].sum(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(w[3], 1.0, rtol=1e-5)       # singleton
    np.testing.assert_allclose(w[4:].sum(), 1.0, rtol=1e-5)  # stable @500
    assert np.isfinite(w).all()


def test_gat_forward_and_overfit():
    import jax
    import optax

    from loops_tpu.models import GAT
    from loops_tpu.models.train import accuracy, cross_entropy

    g = _toy_graph(20, seed=11)
    n, f, c = 20, 6, 3
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(n, f)).astype(np.float32)
    labels = rng.integers(0, c, n)

    model = GAT(g, [f, 8, c], heads=2)
    params = model.init(jax.random.PRNGKey(0))
    logits = model.apply(params, feats)
    assert logits.shape == (n, c)
    assert np.isfinite(np.asarray(logits)).all()

    import jax.numpy as jnp

    fx = jnp.asarray(feats)
    lb = jnp.asarray(labels)
    opt = optax.adam(2e-2)

    @jax.jit
    def step(prm, st):
        loss, grads = jax.value_and_grad(
            lambda p: cross_entropy(model.apply(p, fx), lb))(prm)
        up, st = opt.update(grads, st, prm)
        return optax.apply_updates(prm, up), st, loss

    st = opt.init(params)
    losses = []
    for _ in range(80):
        params, st, loss = step(params, st)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.6, losses[::20]


def test_checkpoint_roundtrip(tmp_path):
    import jax

    from loops_tpu.models import GCN, checkpoint

    g = _toy_graph(10, seed=12)
    model = GCN(g, [4, 6, 2], dropout=0.0)
    params = model.init(jax.random.PRNGKey(5))
    path = str(tmp_path / "ckpt")
    checkpoint.save(path, {"params": params, "step": 7})
    state = checkpoint.restore(path, like={"params": params, "step": 7})
    assert int(np.asarray(state["step"])) == 7
    np.testing.assert_allclose(np.asarray(state["params"][0]["w"]),
                               np.asarray(params[0]["w"]), rtol=1e-6)


def test_sampled_minibatch_training_descends():
    import jax
    import optax

    from loops_tpu.models import GraphSAGE
    from loops_tpu.models.sage import make_sampled_train_step

    g = _toy_graph(40, seed=13)
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(40, 6)).astype(np.float32)
    # labels correlated with features so sampling can learn
    w_true = rng.normal(size=(6, 3))
    labels = (feats @ w_true).argmax(1).astype(np.int32)

    model = GraphSAGE(g, [6, 12, 3])
    params = model.init(jax.random.PRNGKey(0))
    opt = optax.adam(1e-2)
    step = make_sampled_train_step(model, opt, feats, labels,
                                   fanouts=[4, 4], batch_size=16)
    st = opt.init(params)
    key = jax.random.PRNGKey(1)
    losses = []
    for _ in range(120):
        params, st, key, loss = step(params, st, key)
        losses.append(float(loss))
    first = np.mean(losses[:10])
    last = np.mean(losses[-10:])
    assert last < first * 0.9, (first, last)


def test_aggregation_custom_vjp_matches_dense_grad():
    import jax
    import jax.numpy as jnp

    g = _toy_graph(14, seed=15)
    op = aggregate_operator(g, "gcn")           # custom vjp on
    dense = jnp.asarray(g.gcn_normalized().adj.to_dense())
    X = jnp.asarray(
        np.random.default_rng(3).normal(size=(14, 5)).astype(np.float32))
    W = jnp.asarray(
        np.random.default_rng(4).normal(size=(5, 4)).astype(np.float32))

    def loss_sparse(X):
        return (op._fn(X @ W) ** 2).sum()

    def loss_dense(X):
        return ((dense @ (X @ W)) ** 2).sum()

    np.testing.assert_allclose(float(loss_sparse(X)), float(loss_dense(X)),
                               rtol=1e-4)
    gs = np.asarray(jax.grad(loss_sparse)(X))
    gd = np.asarray(jax.grad(loss_dense)(X))
    np.testing.assert_allclose(gs, gd, rtol=1e-3, atol=1e-4)


def test_aggregation_custom_vjp_mean_asymmetric():
    import jax
    import jax.numpy as jnp

    # mean normalization is NOT symmetric -> exercises the A^T plan
    g = _toy_graph(12, seed=16)
    op = aggregate_operator(g, "mean")
    dense = jnp.asarray(g.mean_normalized().adj.to_dense())
    X = jnp.asarray(
        np.random.default_rng(5).normal(size=(12, 3)).astype(np.float32))
    gs = np.asarray(jax.grad(lambda X: (op._fn(X) ** 3).sum())(X))
    gd = np.asarray(jax.grad(lambda X: ((dense @ X) ** 3).sum())(X))
    np.testing.assert_allclose(gs, gd, rtol=1e-3, atol=1e-4)


def test_make_train_epochs_matches_manual_loop():
    """Batched fori_loop epochs == the same steps dispatched one by one."""
    import jax
    import numpy as np
    import optax

    from loops_tpu.models import GCN
    from loops_tpu.models import train as T
    from loops_tpu.models.graph import Graph
    from loops_tpu.utils import generate

    csr = generate.random_csr(30, 30, 0.15, seed=21)
    g = Graph(csr)
    model = GCN(g, [6, 8, 4], dropout=0.0)
    params = model.init(jax.random.PRNGKey(0))
    rng0 = jax.random.PRNGKey(7)
    feats = np.random.default_rng(0).normal(size=(30, 6)).astype(np.float32)
    labels = np.random.default_rng(1).integers(0, 4, 30).astype(np.int32)
    mask = np.ones(30, np.float32)
    opt = optax.sgd(1e-2)

    step = jax.jit(T.make_train_step(model, opt, feats, labels, mask))
    p1, s1, r1 = params, opt.init(params), rng0
    for _ in range(5):
        p1, s1, r1, loss1 = step(p1, s1, r1)

    epochs = jax.jit(T.make_train_epochs(model, opt, feats, labels, mask,
                                         steps_per_call=5))
    p2, s2, r2, loss2 = epochs(params, opt.init(params), rng0)

    assert np.allclose(float(loss1), float(loss2), atol=1e-5)
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_aggregate_operator_row_mapped_matches_group_mapped(dtype):
    """The auto route (row_mapped) and the degree-class planes
    (group_mapped) give the same aggregation."""
    import numpy as np

    from loops_tpu.models.graph import Graph
    from loops_tpu.models.message_passing import aggregate_operator
    from loops_tpu.utils import generate

    csr = generate.random_csr(50, 50, 0.12, seed=13)
    g = Graph(csr)
    h = np.random.default_rng(0).normal(size=(50, 16)).astype(np.float32)
    base = np.asarray(aggregate_operator(
        g, schedule="group_mapped", custom_vjp=False, dtype=dtype)(h))
    rows = np.asarray(aggregate_operator(g, custom_vjp=False,
                                         dtype=dtype)(h))
    tol = 1e-4 if dtype is None else 3e-2
    assert np.allclose(rows, base, atol=tol, rtol=tol)


@pytest.mark.parametrize("masked", [False, True])
def test_auto_aggregation_is_row_mapped(masked):
    """``schedule="auto"`` aggregation runs row_mapped on every backend,
    forward and backward."""
    import numpy as np

    from loops_tpu.models.graph import Graph
    from loops_tpu.models.message_passing import (
        aggregate_operator,
        masked_aggregate_operator,
    )
    from loops_tpu.utils import generate

    g = Graph(generate.random_csr(20, 20, 0.2, seed=1))
    op = (masked_aggregate_operator(g, np.arange(0, 20, 3)) if masked
          else aggregate_operator(g, op="sum"))
    assert op.schedule == "row_mapped"
    assert op._vjp_op.schedule == "row_mapped"


@pytest.mark.parametrize("kind", ["bool", "float", "int", "indices"])
def test_masked_aggregate_accepts_any_mask_form(kind):
    """A 0/1 mask of the node count's length is a mask whatever its
    dtype; anything else is row indices."""
    import numpy as np

    from loops_tpu.models.graph import Graph
    from loops_tpu.models.message_passing import masked_aggregate_operator
    from loops_tpu.utils import generate

    n = 40
    g = Graph(generate.random_csr(n, n, 0.15, seed=3))
    mask = np.zeros(n, bool)
    mask[[1, 2, 7, 30]] = True
    rows = {"bool": mask, "float": mask.astype(np.float32),
            "int": mask.astype(np.int32),
            "indices": np.array([1, 2, 7, 30])}[kind]
    op = masked_aggregate_operator(g, rows)
    assert np.array_equal(op.rows, [1, 2, 7, 30])
    h = np.random.default_rng(0).normal(size=(n, 5)).astype(np.float32)
    full = np.asarray(masked_aggregate_operator(g, np.ones(n, bool))._fn(h))
    np.testing.assert_allclose(np.asarray(op._fn(h)), full[[1, 2, 7, 30]],
                               rtol=1e-5, atol=1e-6)


def test_gcn_precompute_first_matches():
    """precompute_first hoists layer-1 propagation: (AX)W1 == A(XW1);
    forward and loss must match the plain model exactly (float-reassoc
    tolerance)."""
    import jax
    import numpy as np

    from loops_tpu.models import GCN
    from loops_tpu.models.graph import Graph

    rng = np.random.default_rng(3)
    n = 120
    g = Graph.from_edges(rng.integers(0, n, 600), rng.integers(0, n, 600),
                         n, make_undirected=True)
    feats = rng.normal(size=(n, 16)).astype(np.float32)

    base = GCN(g, [16, 24, 8], dropout=0.0)
    fast = GCN(g, [16, 24, 8], dropout=0.0, precompute_first=True)
    params = base.init(jax.random.PRNGKey(0))

    out_base = np.asarray(base.apply(params, feats))
    out_fast = np.asarray(fast.apply(params, fast.prepare_features(feats)))
    err = np.abs(out_base - out_fast).max() / max(np.abs(out_base).max(),
                                                  1e-9)
    assert err < 1e-5, err

    # through the training helpers (prepare_features is picked up)
    import optax

    from loops_tpu.models import train as T

    labels = rng.integers(0, 8, n)
    mask = np.ones(n, np.float32)
    opt = optax.adam(1e-2)
    step = jax.jit(T.make_train_step(fast, opt, feats, labels, mask))
    st = opt.init(params)
    p2, st2, r2, loss = step(params, st, jax.random.PRNGKey(1))
    step_b = jax.jit(T.make_train_step(base, opt, feats, labels, mask))
    _, _, _, loss_b = step_b(params, st, jax.random.PRNGKey(1))
    assert abs(float(loss) - float(loss_b)) < 1e-5
    acc = T.evaluate(fast, params, feats, labels, mask)
    acc_b = T.evaluate(base, params, feats, labels, mask)
    assert abs(acc - acc_b) < 1e-9


def test_gatv2_fused_matches_textbook_and_trains():
    """GATv2: the fused bucketed pass == the textbook per-edge oracle,
    and a few autodiff train steps reduce the loss."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from loops_tpu.models import GATv2
    from loops_tpu.models.train import cross_entropy

    g = _toy_graph(48, seed=21)
    dims = [6, 5, 3]
    fused = GATv2(g, dims, heads=2)
    text = GATv2(g, dims, heads=2, fused=False)
    params = fused.init(jax.random.PRNGKey(0))
    X = jnp.asarray(np.random.default_rng(1).normal(
        size=(48, 6)).astype(np.float32))
    yf = np.asarray(fused.apply(params, X))
    yt = np.asarray(text.apply(params, X))
    np.testing.assert_allclose(yf, yt, rtol=2e-4, atol=2e-5)

    y = jnp.asarray(np.random.default_rng(2).integers(0, 3, 48)
                    .astype(np.int32))
    mask = jnp.ones(48, jnp.float32)
    opt = optax.adam(5e-2)

    def loss_fn(p):
        return cross_entropy(fused.apply(p, X), y, mask)

    @jax.jit
    def step(p, st):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        upd, st = opt.update(grads, st, p)
        return optax.apply_updates(p, upd), st, loss

    st = opt.init(params)
    losses = []
    for _ in range(25):
        params, st, loss = step(params, st)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses[::6]

def test_gcn_masked_last_layer_matches():
    """loss_rows= restricts the last layer's propagation to the rows
    the loss reads (fwd AND bwd via the masked custom VJP); loss and
    gradients must match the full model up to float reassociation."""
    import jax
    import numpy as np
    import optax

    from loops_tpu.models import GCN
    from loops_tpu.models import train as T
    from loops_tpu.models.graph import Graph

    rng = np.random.default_rng(9)
    n = 200
    g = Graph.from_edges(rng.integers(0, n, 1200),
                         rng.integers(0, n, 1200), n,
                         make_undirected=True)
    feats = rng.normal(size=(n, 16)).astype(np.float32)
    labels = rng.integers(0, 6, n)
    mask = (rng.random(n) < 0.55).astype(np.float32)

    base = GCN(g, [16, 24, 6], dropout=0.5)
    fast = GCN(g, [16, 24, 6], dropout=0.5, loss_rows=mask)
    params = base.init(jax.random.PRNGKey(0))

    # masked logits == full logits at the mask rows (same params)
    full = np.asarray(base.apply(params, feats))
    sub = np.asarray(fast.apply(params, feats, masked_output=True))
    idx = np.nonzero(mask > 0)[0]
    np.testing.assert_allclose(sub, full[idx], rtol=1e-5, atol=1e-5)

    # identical loss + identical updated params through the train step
    # (same dropout rng stream: the mask is drawn on the SAME shapes)
    opt = optax.adam(1e-2)
    st = opt.init(params)
    step_b = jax.jit(T.make_train_step(base, opt, feats, labels, mask))
    step_f = jax.jit(T.make_train_step(fast, opt, feats, labels, mask))
    pb, _, _, loss_b = step_b(params, st, jax.random.PRNGKey(1))
    pf, _, _, loss_f = step_f(params, st, jax.random.PRNGKey(1))
    assert abs(float(loss_b) - float(loss_f)) < 1e-5
    for lb, lf in zip(pb, pf):
        np.testing.assert_allclose(np.asarray(lb["w"]),
                                   np.asarray(lf["w"]),
                                   rtol=1e-4, atol=1e-5)

    # wrong rows must be rejected by the train helper
    bad = GCN(g, [16, 24, 6], loss_rows=(mask == 0))
    import pytest as _pytest
    with _pytest.raises(AssertionError):
        T.make_train_step(bad, opt, feats, labels, mask)
