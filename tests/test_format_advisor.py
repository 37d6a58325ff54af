"""Format advisor: probes are exact, recommendations land in the
measured regimes (formats/advisor.py).

The reference leaves format choice to the user and only guards against
blow-up (ell.hxx:91-102, dia.hxx:98-116); the advisor automates the
choice from the same probes plus a per-cell cost table measured on the
card. The decision tests pass their own table, so they do not move when
the card's numbers are re-measured.
"""
import numpy as np
import pytest

from loops_tpu.formats import BCSR, CSR, advise, choose_format
from loops_tpu.formats.advisor import probe_bcsr_fill
from loops_tpu.utils.generate import (
    banded_csr,
    block_diag_csr,
    identity_csr,
    random_csr,
    skewed_csr,
    tridiag_csr,
)

# a card where dense formats stream 50-100x cheaper per cell than a CSR
# gather
COSTS = {"csr": 1.0, "dia": 0.02, "bcsr": 0.015}


def test_block_fill_probe_exact():
    # one dense 8x128 block => fill 1.0; two half-filled => 0.5
    rng = np.random.default_rng(0)
    dense = np.zeros((16, 256), np.float32)
    dense[:8, :128] = 1.0
    dense[8:, 128:] = rng.random((8, 128)) > 0.5
    offsets = np.zeros(17, np.int64)
    rows, cols = np.nonzero(dense)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    np.add.at(offsets, rows + 1, 1)
    offsets = np.cumsum(offsets)
    csr = CSR((16, 256), offsets, cols, dense[rows, cols])
    nnz_b2 = int((dense[8:, 128:] != 0).sum())
    expect = csr.nnz / (2 * 8 * 128)
    assert probe_bcsr_fill(csr, 8, 128) == pytest.approx(expect)
    assert nnz_b2 + 8 * 128 == csr.nnz


def test_probe_matches_bcsr_container():
    csr = random_csr(256, 256, sparsity=0.05, seed=3)
    b = BCSR.from_csr(csr, 8, 128)
    assert probe_bcsr_fill(csr, 8, 128) == pytest.approx(
        csr.nnz / (b.num_blocks * 8 * 128))


def test_banded_matrix_prefers_dia():
    adv = advise(tridiag_csr(512), costs=COSTS)
    assert adv.num_diagonals == 3
    assert adv.recommended == "dia"
    assert adv.est_ms["dia"] < adv.est_ms["csr"]


def test_identity_prefers_dense_regular_format():
    # 1 diagonal, pitch 1: both DIA and ELL are padding-free; the
    # cost table makes DIA cheapest.
    adv = advise(identity_csr(256), costs=COSTS)
    assert adv.recommended == "dia"
    assert adv.ell_waste == pytest.approx(1.0)


def test_uniform_rows_take_ell():
    # exactly 8 scattered cols per row: DIA blow-up guard rejects the
    # ~all-diagonals layout; ELL is padding-free and gathers at CSR's
    # per-cell cost, so its plan-free layout wins
    rng = np.random.default_rng(1)
    n, k = 4096, 8
    cols = np.concatenate([np.sort(rng.choice(n, k, replace=False))
                           for _ in range(n)])
    offsets = np.arange(n + 1, dtype=np.int64) * k
    csr = CSR((n, n), offsets, cols,
              rng.normal(size=n * k).astype(np.float32))
    adv = advise(csr, costs=COSTS)
    assert adv.ell_waste == pytest.approx(1.0)
    assert adv.dia_fill < 0.05
    assert adv.recommended == "ell"
    assert adv.est_ms["csr"] == pytest.approx(adv.est_ms["ell"])


def test_dense_blocks_prefer_bcsr():
    csr = block_diag_csr(num_blocks=8, block=128, seed=2)
    adv = advise(csr, costs=COSTS, bcsr_block=(8, 128))
    assert adv.bcsr_fill > 0.5
    assert adv.recommended == "bcsr"


def test_powerlaw_stays_csr():
    # skewed scatter-free power-law: block fill way under 1.5%, many
    # diagonals, heavy max row -> ELL waste huge => CSR
    csr = skewed_csr(2048, 2048, heavy_rows=4, seed=4)
    adv = advise(csr, costs=COSTS)
    assert adv.bcsr_fill < 0.015
    assert adv.ell_waste > 1.25
    assert adv.recommended == "csr"
    assert "gather floor" in adv.why


def test_empty_matrix():
    csr = CSR((4, 4), np.zeros(5, np.int64), np.zeros(0, np.int64),
              np.zeros(0, np.float32))
    assert choose_format(csr, costs=COSTS) == "csr"


def test_spmv_agrees_across_recommended_format():
    # end-to-end: converting to the recommended format preserves SpMV
    from loops_tpu.formats import DIA, ELL
    from loops_tpu.utils.reference import spmv as ref_spmv

    for csr in (tridiag_csr(64), banded_csr(64, 64, band=2),
                block_diag_csr(4, 16)):
        x = np.random.default_rng(0).normal(size=csr.cols).astype(
            np.float32)
        y = ref_spmv(csr, x)
        name = choose_format(csr, costs=COSTS, bcsr_block=(8, 8))
        conv = {"csr": lambda c: c,
                "ell": ELL.from_csr,
                "dia": DIA.from_csr,
                "bcsr": lambda c: BCSR.from_csr(c, 8, 8)}[name](csr)
        back = conv.to_csr() if name != "csr" else conv
        np.testing.assert_allclose(ref_spmv(back, x), y, rtol=1e-5)


def test_default_costs_are_the_card_measurements():
    """With the measured table DIA's per-cell gather never beats CSR,
    and dense 8x128 blocks still do."""
    from loops_tpu.formats.advisor import COSTS_NS

    assert COSTS_NS["dia"] > COSTS_NS["csr"] > COSTS_NS["bcsr"]
    adv = advise(tridiag_csr(512))
    assert adv.recommended != "dia"
    assert adv.est_ms["dia"] > adv.est_ms["csr"]
    dense = advise(block_diag_csr(num_blocks=8, block=128, seed=2))
    assert dense.recommended == "bcsr"
