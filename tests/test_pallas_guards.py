"""Kernel entry-point hardening: f64 inputs to the BCSR kernel fall back
to the XLA path with a warning (never silently downcast), formats reject
schedules they do not honor, and only BCSR SpMM takes a kernel impl."""
import numpy as np
import pytest

from loops_tpu.formats import BCSR, DIA, ELL
from loops_tpu.ops import spmm, spmv
from loops_tpu.ops.spmm import SpMMOperator
from loops_tpu.utils import generate, reference


def _csr64(seed=5):
    return generate.random_csr(40, 36, 0.15, seed=seed, dtype=np.float64)


class _x64:
    def __enter__(self):
        import jax
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *a):
        import jax
        jax.config.update("jax_enable_x64", False)


def test_spmm_bcsr_pallas_f64_falls_back_with_warning():
    csr64 = _csr64()
    bcsr = BCSR.from_csr(csr64, 8, 128)
    B = np.random.default_rng(1).normal(size=(csr64.shape[1], 8))
    with _x64():
        with pytest.warns(UserWarning, match="float64"):
            op = SpMMOperator(bcsr, "row_mapped", impl="pallas")
        C = np.asarray(op(B))
    np.testing.assert_allclose(C, reference.spmm(csr64, B,
                                                 dtype=np.float64),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fmt,kw", [
    ("csc", dict(schedule="merge_path")),
    ("csc", dict(schedule="group_mapped")),
    ("dia", dict(schedule="work_oriented")),
    ("bcsr", dict(schedule="group_mapped")),
    ("bcsr", dict(schedule="merge_path")),
    ("coo", dict(schedule="thread_mapped")),
    ("ell", dict(schedule="thread_mapped")),
])
def test_spmv_rejects_unhonored_knobs(fmt, kw):
    csr = generate.random_csr(24, 30, 0.2, seed=7)
    mat = {"csc": csr.to_csc, "dia": lambda: DIA.from_csr(csr),
           "bcsr": lambda: BCSR.from_csr(csr, 8, 128),
           "coo": csr.to_coo, "ell": lambda: ELL.from_csr(csr)}[fmt]()
    x = generate.make_input_vector(csr.shape[1])
    with pytest.raises(ValueError):
        spmv(mat, x, **kw)


def test_spmm_rejects_unhonored_knobs():
    csr = generate.random_csr(24, 30, 0.2, seed=7)
    B = np.random.default_rng(2).normal(
        size=(csr.shape[1], 8)).astype(np.float32)
    with pytest.raises(ValueError):
        spmm(csr, B, schedule="row_mapped", impl="pallas")
    with pytest.raises(ValueError):
        spmm(csr.to_coo(), B, schedule="merge_path")
    with pytest.raises(ValueError):
        spmm(ELL.from_csr(csr), B, schedule="group_mapped")
    with pytest.raises(ValueError):
        spmm(BCSR.from_csr(csr, 8, 128), B, impl="mosaic")


@pytest.mark.parametrize("schedule", ["merge_path", "group_mapped",
                                      "auto"])
def test_spmm_csr_rejects_kernel_impl(schedule):
    csr = generate.random_csr(24, 30, 0.2, seed=7)
    with pytest.raises(ValueError):
        SpMMOperator(csr, schedule, impl="pallas")


@pytest.mark.parametrize("fmt", ["coo", "ell"])
def test_spmm_kernel_impl_is_bcsr_only(fmt):
    """impl='pallas' names the BCSR kernel; other formats refuse it
    instead of silently running XLA."""
    csr = generate.random_csr(24, 30, 0.2, seed=7)
    mat = {"coo": csr.to_coo, "ell": lambda: ELL.from_csr(csr)}[fmt]()
    with pytest.raises(ValueError, match="BCSR"):
        SpMMOperator(mat, impl="pallas")
