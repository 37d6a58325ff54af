"""Checks that only a GPU can make: the BCSR kernel compiled through
Triton, at a real width, against the host reference. Skipped elsewhere
(the ``gpu`` fixture decides, at run time)."""
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_kernels_run_compiled(gpu):
    from loops_tpu.utils.platform import pallas_interpret

    assert gpu.platform == "gpu"
    assert pallas_interpret() is False


@pytest.mark.parametrize("dtype,tol", [(None, 1e-5), ("bfloat16", 2e-2)])
def test_bcsr_kernel_compiled_matches_reference(gpu, dtype, tol):
    from loops_tpu.models.message_passing import _take_rows_csr
    from loops_tpu.ops.spmm import SpMMOperator
    from loops_tpu.utils import reference
    from loops_tpu.utils.generate import block_sparse

    csr, bcsr = block_sparse(N=4096, R=8, C=128, block_density=0.06)
    B = np.random.default_rng(0).normal(size=(4096, 512)).astype(np.float32)
    C = np.asarray(SpMMOperator(bcsr, impl="pallas", dtype=dtype)(B))
    rows = np.arange(0, 4096, 7)
    ref = reference.spmm(_take_rows_csr(csr, rows), B, dtype=np.float64)
    rel = np.abs(C[rows] - ref).max() / np.abs(ref).max()
    assert rel <= tol
