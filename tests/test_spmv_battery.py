"""SpMV end-to-end battery: every schedule x every format against the
host reference on 9 labeled synthetic matrices.

Mirrors the reference battery (reference: unittests/test_spmv_battery.hxx:
52-94 + test_spmv_{csr,coo,csc,ell,bcsr,dia,partitioned}.cu) with the same
matrix recipes and tolerance.
"""
import numpy as np
import pytest

from loops_tpu.formats import BCSR, CSC, DIA, ELL
from loops_tpu.ops import flat_partitioned_spmv, spmv
from loops_tpu.utils import generate, reference
from loops_tpu.utils.equal import count_mismatches

BATTERY = {
    "identity": lambda: generate.identity_csr(16),
    "diag": lambda: generate.diag_csr(11),
    "tridiag": lambda: generate.tridiag_csr(17),
    "band_asym": lambda: generate.banded_csr(12, 20, band=2),
    "block_diag_2x2": lambda: generate.block_diag_csr(5, 2),
    "block_diag_3x3": lambda: generate.block_diag_csr(4, 3),
    "skewed": lambda: generate.skewed_csr(14, 24, heavy_rows=2),
    "empty_rows": lambda: generate.empty_row_csr(15, 9),
    "random": lambda: generate.random_csr(21, 18, 0.2, seed=11),
}

SCHEDULES = ["row_mapped", "group_mapped", "work_oriented", "merge_path"]


def _check(y, csr, x, label):
    y_ref = reference.spmv(csr, x)
    n = count_mismatches(np.asarray(y), y_ref, atol=1e-3, rtol=1e-4)
    assert n == 0, f"{label}: {n} mismatches"
    rep = reference.rigorously_validate_spmv(csr, x, np.asarray(y))
    assert rep.verdict == "NOT_A_BUG", f"{label}: {rep}"


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name", sorted(BATTERY))
def test_csr(name, schedule):
    csr = BATTERY[name]()
    x = generate.make_input_vector(csr.shape[1])
    # small blocks so multi-block paths are exercised on tiny matrices
    y = spmv(csr, x, schedule=schedule, block=8)
    _check(y, csr, x, f"csr/{schedule}/{name}")


# structure families from utils/battery.py, at the smallest sizes
FAMILIES = ("uni_n2048_d8_s0", "pl_n4096_d4_a1.6", "band_n2048_b16",
            "empty_n2048_e16", "heavy_n4096_r16_k512")


@pytest.mark.parametrize("schedule", SCHEDULES + ["auto"])
@pytest.mark.parametrize("name", FAMILIES)
def test_csr_structure_families(name, schedule):
    """Every XLA schedule over the battery's structure families (the
    matrices the sweep and the heuristic fit use)."""
    from loops_tpu.utils import battery

    csr = battery.build(name, max_rows=4096)
    x = generate.make_input_vector(csr.shape[1])
    _check(spmv(csr, x, schedule=schedule), csr, x, f"{name}/{schedule}")


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name", ["random", "empty_rows", "skewed"])
def test_coo(name, schedule):
    csr = BATTERY[name]()
    coo = csr.to_coo()
    x = generate.make_input_vector(csr.shape[1])
    y = spmv(coo, x, schedule=schedule, block=8)
    _check(y, csr, x, f"coo/{schedule}/{name}")


@pytest.mark.parametrize("name", ["random", "empty_rows", "band_asym"])
def test_csc(name):
    csr = BATTERY[name]()
    csc = CSC.from_csr(csr)
    x = generate.make_input_vector(csr.shape[1])
    y = spmv(csc, x, schedule="row_mapped")
    _check(y, csr, x, f"csc/{name}")


@pytest.mark.parametrize("schedule", ["row_mapped", "merge_path"])
@pytest.mark.parametrize("name", ["random", "empty_rows", "skewed"])
def test_ell(name, schedule):
    csr = BATTERY[name]()
    ell = ELL.from_csr(csr)
    x = generate.make_input_vector(csr.shape[1])
    y = spmv(ell, x, schedule=schedule, block=8)
    _check(y, csr, x, f"ell/{schedule}/{name}")


@pytest.mark.parametrize("bs", [(2, 2), (3, 2)])
@pytest.mark.parametrize("name", ["random", "block_diag_2x2", "empty_rows"])
def test_bcsr(name, bs):
    csr = BATTERY[name]()
    bcsr = BCSR.from_csr(csr, *bs)
    x = generate.make_input_vector(csr.shape[1])
    y = spmv(bcsr, x)
    _check(y, csr, x, f"bcsr{bs}/{name}")


@pytest.mark.parametrize("name", ["tridiag", "band_asym", "random"])
def test_dia(name):
    csr = BATTERY[name]()
    dia = DIA.from_csr(csr)
    x = generate.make_input_vector(csr.shape[1])
    y = spmv(dia, x)
    _check(y, csr, x, f"dia/{name}")


@pytest.mark.parametrize("name", ["random", "empty_rows"])
def test_flat_partitioned(name):
    csr = BATTERY[name]()
    x = generate.make_input_vector(csr.shape[1])
    y = flat_partitioned_spmv(csr, x, atoms_per_tile=8)
    _check(y, csr, x, f"flat_partitioned/{name}")


def test_unknown_schedule_rejected():
    csr = BATTERY["random"]()
    with pytest.raises(ValueError):
        spmv(csr, generate.make_input_vector(18), schedule="bucketing")


def test_csr_f64_precision():
    """Value-type genericity (reference builds each example x {float,
    double} via LOOPS_VALUE_T, examples/spmv/CMakeLists.txt:28-56).
    f64 runs through the same executors; it is slower but
    correct — tests run on CPU."""
    import jax

    csr64 = generate.random_csr(20, 18, 0.25, seed=13, dtype=np.float64)
    assert csr64.vals.dtype == np.float64
    x = generate.make_input_vector(18, dtype=np.float64)
    y_ref = reference.spmv(csr64, x, dtype=np.float64)
    jax.config.update("jax_enable_x64", True)
    try:
        for sched in ["row_mapped", "work_oriented"]:
            y = np.asarray(spmv(csr64, x, schedule=sched, block=8))
            np.testing.assert_allclose(y, y_ref, rtol=1e-12, atol=1e-12)
    finally:
        jax.config.update("jax_enable_x64", False)


def test_auto_schedule_selection():
    from loops_tpu.layout import CsrLayout
    from loops_tpu.schedule.plans import choose_schedule

    from loops_tpu.schedule.plans import HEURISTIC_THRESHOLDS_XLA

    # the default table routes skewed tiles to the degree-class planes
    # and uniform ones to the flat schedule
    skewed = generate.skewed_csr(20, 40, heavy_rows=1, heavy_nnz=30)
    medium = generate.banded_csr(40, 40, band=8)
    assert choose_schedule(CsrLayout.from_csr(skewed)) == \
        HEURISTIC_THRESHOLDS_XLA["group"]
    flat_mat = generate.tridiag_csr(30)
    assert choose_schedule(CsrLayout.from_csr(flat_mat)) == \
        HEURISTIC_THRESHOLDS_XLA["flat"]
    # the pre-fit structural branches stay exercisable via explicit
    # thresholds (the reference-analog defaults)
    legacy = dict(ratio=2.0, cv=0.5, small=4.0, flat="work_oriented")
    assert choose_schedule(CsrLayout.from_csr(skewed),
                           legacy) == "group_mapped"
    uniform = generate.tridiag_csr(30)
    assert choose_schedule(CsrLayout.from_csr(uniform),
                           legacy) == "row_mapped"
    assert choose_schedule(CsrLayout.from_csr(medium),
                           legacy) == "work_oriented"

    # end-to-end through the operator
    x = generate.make_input_vector(40)
    y = spmv(skewed, x, schedule="auto")
    _check(y, skewed, x, "auto/skewed")
    y2 = spmv(skewed.to_coo(), x, schedule="auto")
    _check(y2, skewed, x, "auto/coo")
