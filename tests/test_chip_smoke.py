"""chip_smoke.py: its phases at tiny sizes on the CPU, and its refusal to
report anything without a GPU."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def test_main_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)


def test_alone_in_a_directory_fails_without_result(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_check_raises_past_tolerance():
    cs.check("within", 1e-6, 1e-5)
    with pytest.raises(cs.PhaseFailed):
        cs.check("past", 2e-5, 1e-5)
    with pytest.raises(cs.PhaseFailed):
        cs.check("nan", float("nan"), 1.0)


PHASES = {
    "spmv": lambda: cs.phase_spmv(n=256, density=0.03),
    "csr_spmm": lambda: cs.phase_csr_spmm(scale=0.004, F=24),
    "bcsr_spmm": lambda: cs.phase_bcsr_spmm(N=256, F=40, density=0.2,
                                            check_rows=64),
    "sddmm": lambda: cs.phase_sddmm(n=256, nnz=3000, F=8),
    "advisor": lambda: cs.phase_advisor_costs(
        cs.phase_spmv(n=256, density=0.03), n=256, bcsr_density=0.3,
        dia_diagonals=4),
    "gcn": lambda: cs.phase_gcn(scale=0.004, hidden=8, steps=3),
    "gat": lambda: cs.phase_gat(scale=0.004, hidden=8, heads=2, steps=3),
    "four_cards": lambda: cs.phase_four_cards(scale=0.004, hidden=8,
                                              steps=2),
}


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_phase_tiny(phase):
    assert PHASES[phase]()


def _tiny_gcn(dtype=None):
    import jax

    from loops_tpu.io import ogb
    from loops_tpu.models import GCN

    data = ogb.load("ogbn-arxiv", scale=0.004)
    dims = [data.features.shape[1], 8, 8, data.num_classes]
    model = GCN(data.graph, dims, dropout=0.0, dtype=dtype,
                loss_rows=data.train_mask)
    return model, data, model.init(jax.random.PRNGKey(0))


def test_host_gcn_gradient_matches_finite_differences():
    """The float64 reference's hand-written backward is the derivative
    of its own forward."""
    model, data, p0 = _tiny_gcn()
    adj = data.graph.gcn_normalized().adj
    p = [{k: np.asarray(v, np.float64) for k, v in layer.items()}
         for layer in p0]
    grads = cs.host_gcn(adj, data.features, data.labels,
                        data.train_mask, p)[2]
    rng = np.random.default_rng(0)

    def loss_at(i, k, delta):
        moved = [dict(layer) for layer in p]
        moved[i][k] = p[i][k] + delta
        return cs.host_gcn(adj, data.features, data.labels,
                           data.train_mask, moved)[1]

    eps = 1e-7
    for i in range(len(p)):
        for k in ("w", "b"):
            u = rng.normal(size=p[i][k].shape)
            fd = (loss_at(i, k, eps * u) - loss_at(i, k, -eps * u)) / (2 * eps)
            assert abs(fd - (grads[i][k] * u).sum()) <= 1e-4 * abs(fd) + 1e-9


@pytest.mark.parametrize("fault", ["forward", "backward"])
def test_gcn_check_catches_a_wrong_model(fault):
    """A GCN whose aggregation returns zeros, or whose last layer's
    backward is off by a factor, fails the first-step comparison."""
    model, data, p0 = _tiny_gcn()
    cs.check_gcn(model, data, p0, cs.GCN_TOL[None], "sound")
    if fault == "forward":
        bufs = model.propagate._bufs
        bufs["vals"] = bufs["vals"] * 0
    else:
        bufs = model.propagate_masked._vjp_op._bufs
        bufs["vals"] = bufs["vals"] * 0.5
    with pytest.raises(cs.PhaseFailed):
        cs.check_gcn(model, data, p0, cs.GCN_TOL[None], fault)


def test_gcn_check_separates_bf16_from_f32():
    """bf16 aggregation stays inside its own tolerance and outside the
    f32 one, so the f32 check would notice a silent bf16 path."""
    model, data, p0 = _tiny_gcn("bfloat16")
    errs = cs.check_gcn(model, data, p0, cs.GCN_TOL["bfloat16"], "bf16")
    assert max(errs["logits"], errs["grads"]) > cs.GCN_TOL[None]


@pytest.mark.parametrize("fault", ["none", "scaled", "zeroed"])
def test_gat_check_catches_wrong_gradients(fault):
    """The plain float64 GAT forward agrees with the model, and the
    directional probe refuses gradients that are scaled or missing."""
    import jax

    from loops_tpu.io import ogb
    from loops_tpu.models import GAT
    from loops_tpu.models.train import cross_entropy

    data = ogb.load("ogbn-arxiv", scale=0.004)
    gat = GAT(data.graph, [data.features.shape[1], 8, data.num_classes],
              heads=2)
    p0 = gat.init(jax.random.PRNGKey(0))
    X = jax.numpy.asarray(data.features)
    grads = jax.grad(lambda p: cross_entropy(
        gat.apply(p, X), jax.numpy.asarray(data.labels),
        jax.numpy.asarray(data.train_mask)))(p0)
    if fault == "scaled":
        grads[1]["w"] = grads[1]["w"] * 1.5
    elif fault == "zeroed":
        grads[0]["a_src"] = grads[0]["a_src"] * 0
    logits = gat.apply(p0, X)
    if fault == "none":
        cs.check_gat(gat, data, p0, logits, grads)
    else:
        with pytest.raises(cs.PhaseFailed):
            cs.check_gat(gat, data, p0, logits, grads)
