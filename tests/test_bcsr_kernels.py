"""The BCSR SpMM Triton kernel (ops/kernels/spmm_bcsr.py) in interpret
mode on the CPU — the same kernel body that compiles for the GPU — and
the plain einsum path it replaces, against the host reference."""
import numpy as np
import pytest

from loops_tpu.formats import BCSR
from loops_tpu.ops import spmm
from loops_tpu.ops.kernels.spmm_bcsr import bcsr_spmm_pallas
from loops_tpu.utils import battery, generate, reference
from loops_tpu.utils.equal import count_mismatches

CASES = {
    "random": lambda: generate.random_csr(40, 36, 0.15, seed=11),
    "skewed": lambda: generate.skewed_csr(24, 30, heavy_rows=3),
    "empty_rows": lambda: generate.empty_row_csr(21, 18),
    "block_diag": lambda: generate.block_diag_csr(5, 4),
    "tall": lambda: generate.random_csr(600, 300, 0.02, seed=2),
}

# battery matrices small enough for the interpreter
BATTERY = ("uni_n2048_d2_s0", "band_n2048_b4", "empty_n2048_e16",
           "dia_n2048_k3", "bdiag_32x16")

# bf16 streams: values and B rounded once (u = 2**-8 each), f32 sums
BF16_REL = 2e-2


def _B(n, F, seed=3):
    return np.random.default_rng(seed).normal(size=(n, F)).astype(
        np.float32)


def _check(C, csr, B, dtype, tag):
    ref = reference.spmm(csr, B, dtype=np.float64)
    if dtype is None:
        assert count_mismatches(C, ref, atol=1e-3, rtol=1e-4) == 0, tag
    else:
        rel = np.abs(C - ref).max() / max(np.abs(ref).max(), 1e-9)
        assert rel < BF16_REL, (tag, rel)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_bcsr_spmm_kernel(name, dtype):
    csr = CASES[name]()
    bcsr = BCSR.from_csr(csr, 8, 128)
    B = _B(csr.shape[1], 20)
    C = np.asarray(spmm(bcsr, B, impl="pallas", dtype=dtype))
    _check(C, csr, B, dtype, f"kernel/{name}/{dtype}")


@pytest.mark.parametrize("name", BATTERY)
def test_bcsr_spmm_kernel_battery(name):
    csr = battery.build(name, max_rows=4096)
    bcsr = BCSR.from_csr(csr, 8, 128)
    B = _B(csr.shape[1], 16)
    C = np.asarray(spmm(bcsr, B, impl="pallas", block_f=16))
    _check(C, csr, B, None, f"kernel/{name}")


@pytest.mark.parametrize("block_f,F", [(16, 40), (32, 100), (64, 64),
                                       (128, 20)])
def test_bcsr_spmm_kernel_feature_tiles(block_f, F):
    """Several feature tiles, and F padded up to a whole tile."""
    csr = generate.random_csr(200, 280, 0.05, seed=9)
    bcsr = BCSR.from_csr(csr, 8, 128)
    B = _B(csr.shape[1], F, seed=4)
    bufs, fn = bcsr_spmm_pallas(bcsr, block_f=block_f)
    C = np.asarray(fn(bufs, B))
    assert C.shape == (200, F)
    _check(C, csr, B, None, f"ftile {block_f}/F {F}")


@pytest.mark.parametrize("R,C", [(4, 128), (8, 64), (16, 128), (32, 32)])
def test_bcsr_spmm_kernel_block_shapes(R, C):
    """Rows below 16 ride a masked 16-row tile; wider blocks use their
    own height."""
    csr = generate.random_csr(150, 170, 0.06, seed=5)
    bcsr = BCSR.from_csr(csr, R, C)
    B = _B(csr.shape[1], 24, seed=6)
    C_out = np.asarray(spmm(bcsr, B, impl="pallas", block_f=32))
    _check(C_out, csr, B, None, f"block {R}x{C}")


def test_bcsr_spmm_kernel_rejects_bad_blocks():
    csr = CASES["random"]()
    with pytest.raises(ValueError, match="power-of-two C"):
        bcsr_spmm_pallas(BCSR.from_csr(csr, 8, 96))
    with pytest.raises(ValueError, match="power-of-two C"):
        bcsr_spmm_pallas(BCSR.from_csr(csr, 8, 8))


def test_bcsr_spmm_kernel_empty_block_rows():
    """Block rows with no stored block produce zero rows."""
    csr = generate.empty_row_csr(64, 130, every=2)
    bcsr = BCSR.from_csr(csr, 8, 128)
    B = _B(csr.shape[1], 16)
    C = np.asarray(spmm(bcsr, B, impl="pallas", block_f=16))
    _check(C, csr, B, None, "empty block rows")
    empty = np.diff(csr.offsets) == 0
    assert np.all(C[empty] == 0)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("name", BATTERY)
def test_bcsr_spmm_einsum_battery(name, dtype):
    """The plain path the kernel replaces, f32 and bf16 streams."""
    csr = battery.build(name, max_rows=4096)
    bcsr = BCSR.from_csr(csr, 8, 128)
    B = _B(csr.shape[1], 12)
    C = np.asarray(spmm(bcsr, B, impl="xla", dtype=dtype))
    _check(C, csr, B, dtype, f"einsum/{name}/{dtype}")
