"""SpMM + SDDMM battery: XLA paths and the Pallas BCSR kernels
(interpret mode on CPU) against the host references."""
import numpy as np
import pytest

from loops_tpu.formats import BCSR, ELL
from loops_tpu.ops import sddmm, spmm
from loops_tpu.utils import generate, reference
from loops_tpu.utils.equal import count_mismatches

CASES = {
    "random": lambda: generate.random_csr(40, 36, 0.15, seed=11),
    "skewed": lambda: generate.skewed_csr(24, 30, heavy_rows=3),
    "empty_rows": lambda: generate.empty_row_csr(21, 18),
    "block_diag": lambda: generate.block_diag_csr(5, 4),
}


def _B(cols, f, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(cols, f)).astype(np.float32)


@pytest.mark.parametrize("schedule", ["row_mapped", "group_mapped"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_spmm_csr(name, schedule):
    csr = CASES[name]()
    B = _B(csr.shape[1], 16)
    C = np.asarray(spmm(csr, B, schedule=schedule))
    C_ref = reference.spmm(csr, B)
    assert count_mismatches(C, C_ref, atol=1e-3, rtol=1e-4) == 0


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("schedule", ["row_mapped", "group_mapped"])
@pytest.mark.parametrize("name", ["uni_n2048_d8_s0", "pl_n4096_d4_a1.6",
                                  "empty_n2048_e16", "heavy_n4096_r16_k512"])
def test_spmm_csr_structure_families(name, schedule, dtype):
    """The two GNN aggregation routes (row_mapped on the GPU,
    group_mapped elsewhere) over battery structure families; bf16
    within three roundings (value, operand, product) of the reference."""
    from loops_tpu.utils import battery

    csr = battery.build(name, max_rows=4096)
    B = _B(csr.shape[1], 16)
    C = np.asarray(spmm(csr, B, schedule=schedule, dtype=dtype))
    ref = reference.spmm(csr, B, dtype=np.float64)
    from loops_tpu.formats import CSR
    l1 = reference.spmm(CSR(csr.shape, csr.offsets, csr.indices,
                            np.abs(csr.vals)), np.abs(B), dtype=np.float64)
    u = 1e-5 if dtype is None else 3 * 2.0 ** -8 + 1e-5
    assert (np.abs(C - ref) <= u * l1 + 1e-5).all(), (name, schedule)


@pytest.mark.parametrize("name", ["random", "empty_rows"])
def test_spmm_coo_ell(name):
    csr = CASES[name]()
    B = _B(csr.shape[1], 8)
    C_ref = reference.spmm(csr, B)
    assert count_mismatches(
        np.asarray(spmm(csr.to_coo(), B)), C_ref, 1e-3, 1e-4) == 0
    assert count_mismatches(
        np.asarray(spmm(ELL.from_csr(csr), B)), C_ref, 1e-3, 1e-4) == 0


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_spmm_bcsr(name, impl):
    csr = CASES[name]()
    bcsr = BCSR.from_csr(csr, 8, 128)
    B = _B(csr.shape[1], 20)
    C = np.asarray(spmm(bcsr, B, impl=impl))
    C_ref = reference.spmm(csr, B)
    assert count_mismatches(C, C_ref, atol=1e-3, rtol=1e-4) == 0, \
        f"bcsr/{impl}/{name}"


def test_spmm_bcsr_pallas_multi_ftile():
    csr = CASES["random"]()
    bcsr = BCSR.from_csr(csr, 8, 128)
    B = _B(csr.shape[1], 300)  # forces Fp=384 > FT=128 accumulation
    C = np.asarray(spmm(bcsr, B, impl="pallas", block_f=128))
    assert count_mismatches(C, reference.spmm(csr, B), 1e-3, 1e-4) == 0


def test_spmm_bcsr_rejects_misaligned():
    # the kernel takes any R (masked to a 16-row tile) but needs a
    # power-of-two C of at least 16
    csr = CASES["random"]()
    bcsr = BCSR.from_csr(csr, 3, 48)
    with pytest.raises(ValueError):
        spmm(bcsr, _B(csr.shape[1], 8), impl="pallas")


# ------------------------------------------------------------------ SDDMM
@pytest.mark.parametrize("name", sorted(CASES))
def test_sddmm_csr(name):
    csr = CASES[name]()
    A = _B(csr.shape[0], 12, seed=5)
    B = _B(csr.shape[1], 12, seed=6)
    out = np.asarray(sddmm(csr, A, B))
    ref = reference.sddmm(csr, A, B)
    assert count_mismatches(out, ref, atol=1e-3, rtol=1e-4) == 0


def test_sddmm_coo_matches_csr_order():
    csr = CASES["random"]()
    coo = csr.to_coo()  # row-sorted: same nz order as CSR
    A = _B(csr.shape[0], 12, seed=5)
    B = _B(csr.shape[1], 12, seed=6)
    np.testing.assert_allclose(
        np.asarray(sddmm(coo, A, B)), np.asarray(sddmm(csr, A, B)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("f", [12, 300])
def test_sddmm_bcsr(f):
    csr = CASES["block_diag"]()
    bcsr = BCSR.from_csr(csr, 8, 128)
    A = _B(csr.shape[0], f, seed=5)
    B = _B(csr.shape[1], f, seed=6)
    out = np.asarray(sddmm(bcsr, A, B))
    # oracle: dense sampled product at the *stored block* pattern
    dense_dots = A @ B.T
    R, Ccol = 8, 128
    brid = bcsr.block_row_ids()
    expect = np.zeros_like(out)
    for k in range(bcsr.num_blocks):
        r0, c0 = brid[k] * R, bcsr.block_cols[k] * Ccol
        patch = np.zeros((R, Ccol), np.float32)
        rr = min(R, csr.shape[0] - r0)
        cc = min(Ccol, csr.shape[1] - c0)
        patch[:rr, :cc] = dense_dots[r0:r0 + rr, c0:c0 + cc]
        expect[k] = bcsr.vals[k] * patch
    assert count_mismatches(out, expect, atol=1e-3, rtol=1e-4) == 0


def test_spmm_csr_bf16_gather():
    from loops_tpu.ops.spmm import SpMMOperator

    csr = CASES["random"]()
    B = _B(csr.shape[1], 16)
    op = SpMMOperator(csr, dtype="bfloat16")
    C = np.asarray(op(B))
    ref = reference.spmm(csr, B)
    rel = np.abs(C - ref).max() / max(np.abs(ref).max(), 1e-9)
    assert rel < 5e-2, rel


def test_spmm_group_mapped_hub_dense():
    from loops_tpu.ops.spmm import SpMMOperator

    # one extreme hub row + light tail: force the hub-dense split
    csr = generate.skewed_csr(30, 40, heavy_rows=2, heavy_nnz=35,
                              light_nnz=2, seed=21)
    B = _B(csr.shape[1], 12)
    op = SpMMOperator(csr, "group_mapped", hub_dense_min=16)
    assert "hub_rows" in op._bufs          # the split actually fired
    C = np.asarray(op(B))
    assert count_mismatches(C, reference.spmm(csr, B), 1e-3, 1e-4) == 0


def test_sddmm_bf16_close_to_f32():
    """dtype="bfloat16" rounds operands; scores must stay within bf16
    rounding of the f32 path."""
    import numpy as np

    from loops_tpu.ops.sddmm import sddmm
    from loops_tpu.utils import generate

    csr = generate.random_csr(60, 50, 0.1, seed=5)
    rng = np.random.default_rng(0)
    A = rng.normal(size=(60, 32)).astype(np.float32)
    B = rng.normal(size=(50, 32)).astype(np.float32)
    ref = np.asarray(sddmm(csr, A, B))
    got = np.asarray(sddmm(csr, A, B, dtype="bfloat16"))
    # bf16 has ~3 decimal digits; dot length 32
    assert np.allclose(got, ref, atol=0.2, rtol=0.05)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("name", ["uni_n2048_d8_s0", "pl_n4096_d4_a1.2",
                                  "empty_n2048_e4"])
def test_sddmm_battery(name, dtype):
    """The fused XLA gather -> multiply -> reduce over battery matrices:
    f32 to the reference, bf16 within two operand roundings."""
    from loops_tpu.utils import battery

    csr = battery.build(name, max_rows=4096)
    rng = np.random.default_rng(5)
    A = rng.normal(size=(csr.shape[0], 32)).astype(np.float32)
    B = rng.normal(size=(csr.shape[1], 32)).astype(np.float32)
    out = np.asarray(sddmm(csr, A, B, dtype=dtype))
    ref = reference.sddmm(csr, A, B)
    absref = reference.sddmm(generate_abs(csr), np.abs(A), np.abs(B))
    tol = 1e-5 if dtype is None else 2 * 2.0 ** -8 + 1e-5
    assert out.shape == ref.shape
    assert (np.abs(out - ref) <= tol * absref + 1e-6).all(), name


def generate_abs(csr):
    from loops_tpu.formats import CSR
    return CSR(csr.shape, csr.offsets, csr.indices, np.abs(csr.vals))
