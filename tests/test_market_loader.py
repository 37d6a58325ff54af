"""Matrix Market loader tests (reference: unittests/test_market_loader.cu:
1-124): general/integer/pattern/symmetric coverage, comment tolerance,
fail-fast on unsupported typecodes and 0-indexed entries.
"""
import numpy as np
import pytest

from loops_tpu.io import binary, filepath, market

GENERAL = b"""%%MatrixMarket matrix coordinate real general
% a comment
3 4 4
1 1 1.5
2 3 -2.0
3 2 0.25
3 4 7.0
"""

SYMMETRIC = b"""%%MatrixMarket matrix coordinate real symmetric
3 3 4
1 1 2.0
2 1 -1.0
3 1 0.5
3 3 4.0
"""

PATTERN = b"""%%MatrixMarket matrix coordinate pattern general
2 2 2
1 2
2 1
"""

SYM_PATTERN = b"""%%MatrixMarket matrix coordinate pattern symmetric
3 3 2
2 1
3 3
"""

INTEGER = b"""%%MatrixMarket matrix coordinate integer general
2 2 2
1 1 3
2 2 -4
"""


def test_general():
    coo = market.load(GENERAL)
    assert coo.shape == (3, 4)
    dense = coo.to_dense()
    assert dense[0, 0] == 1.5 and dense[1, 2] == -2.0
    assert dense[2, 1] == 0.25 and dense[2, 3] == 7.0
    assert coo.nnz == 4


def test_symmetric_expansion():
    dense = market.load(SYMMETRIC).to_dense()
    np.testing.assert_allclose(dense, dense.T)
    assert market.load(SYMMETRIC).nnz == 6  # 4 + 2 mirrored off-diagonals
    assert dense[0, 1] == -1.0 and dense[1, 0] == -1.0


def test_pattern_ones():
    dense = market.load(PATTERN).to_dense()
    np.testing.assert_allclose(dense, [[0, 1], [1, 0]])


def test_symmetric_pattern():
    dense = market.load(SYM_PATTERN).to_dense()
    np.testing.assert_allclose(dense, dense.T)
    assert dense[1, 0] == 1 and dense[0, 1] == 1 and dense[2, 2] == 1


def test_integer_field():
    dense = market.load(INTEGER).to_dense()
    np.testing.assert_allclose(dense, [[3, 0], [0, -4]])


@pytest.mark.parametrize("banner,err", [
    (b"%%MatrixMarket matrix coordinate complex general", "complex"),
    (b"%%MatrixMarket matrix coordinate real hermitian", "hermitian"),
    (b"%%MatrixMarket matrix coordinate real skew-symmetric", "skew"),
    (b"%%MatrixMarket matrix array real general", "array"),
])
def test_rejects_unsupported(banner, err):
    with pytest.raises(market.MatrixMarketError):
        market.load(banner + b"\n2 2 1\n1 1 1.0\n")


def test_rejects_zero_indexed():
    bad = b"%%MatrixMarket matrix coordinate real general\n2 2 1\n0 1 1.0\n"
    with pytest.raises(market.MatrixMarketError):
        market.load(bad)


def test_rejects_out_of_bounds():
    bad = b"%%MatrixMarket matrix coordinate real general\n2 2 1\n3 1 1.0\n"
    with pytest.raises(market.MatrixMarketError):
        market.load(bad)


def test_file_round_trip(tmp_path):
    p = tmp_path / "m.mtx"
    p.write_bytes(GENERAL)
    coo = market.load(str(p))
    assert coo.nnz == 4
    # binary cache round-trip
    csr = coo.to_csr()
    cache = tmp_path / "m.csr.npz"
    binary.save_csr(cache, csr)
    back = binary.load_csr(cache)
    np.testing.assert_allclose(back.to_dense(), csr.to_dense())


def test_filepath_utils():
    assert filepath.extract_dataset("/a/b/chesapeake.mtx") == "chesapeake"
    assert filepath.is_market("x.mtx") and not filepath.is_market("x.csr")
    assert filepath.is_binary_csr("x.csr.npz")


def test_native_parser_matches_python():
    """If the native tokenizer built, it must agree with the fallback."""
    from loops_tpu.native import mtx_parse
    body = b"1 2 3.5\n4 5 -6.25e2\n% comment\n7 8 9\n"
    arr = mtx_parse(body, 3, 3)
    if arr is None:
        pytest.skip("native library unavailable")
    np.testing.assert_allclose(
        arr, [[1, 2, 3.5], [4, 5, -625.0], [7, 8, 9]])


def test_native_coo_to_csr_matches_numpy():
    from loops_tpu.formats import COO
    from loops_tpu.formats.convert import indices_to_offsets
    from loops_tpu.native.convert import coo_to_csr

    rng = np.random.default_rng(3)
    n, nnz = 500, 20000
    rows = rng.integers(0, n, nnz).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    vals = rng.normal(size=nnz).astype(np.float32)
    res = coo_to_csr(rows, cols, vals, n)
    if res is None:
        pytest.skip("native library unavailable")
    offsets, oc, ov = res
    coo = COO((n, n), rows, cols, vals)
    c = coo.sort_by_row()
    np.testing.assert_array_equal(
        offsets, indices_to_offsets(c.rows, n))
    np.testing.assert_array_equal(oc, c.cols)
    np.testing.assert_allclose(ov, c.vals)


def test_native_coo_to_csr_fast_path_in_from_coo():
    from loops_tpu.formats import COO

    rng = np.random.default_rng(4)
    n, nnz = 1000, 150_000  # above the native threshold
    coo = COO((n, n), rng.integers(0, n, nnz), rng.integers(0, n, nnz),
              rng.normal(size=nnz).astype(np.float32))
    csr = coo.to_csr()
    assert csr.nnz == nnz
    # spot check a row against a numpy oracle
    r = 17
    m = np.asarray(coo.rows) == r
    np.testing.assert_array_equal(
        np.sort(np.asarray(coo.cols)[m]),
        csr.indices[csr.offsets[r]:csr.offsets[r + 1]])


def test_save_load_round_trip(tmp_path):
    """market.save output re-loads to the identical matrix (the writer is
    beyond reference scope — the reference is loader-only)."""
    from loops_tpu.io import market
    from loops_tpu.utils.generate import random_csr

    csr = random_csr(64, 48, sparsity=0.05, seed=7)
    p = tmp_path / "rt.mtx"
    market.save(p, csr, comment="round trip\ntwo lines")
    back = market.load_csr(p)
    assert back.shape == csr.shape and back.nnz == csr.nnz
    np.testing.assert_array_equal(back.offsets, csr.offsets)
    np.testing.assert_array_equal(back.indices, csr.indices)
    np.testing.assert_allclose(back.vals, csr.vals, rtol=1e-6)


def test_save_accepts_coo(tmp_path):
    from loops_tpu.io import market
    from loops_tpu.formats import COO

    coo = COO((3, 3), [0, 2], [1, 0], [2.5, -1.0])
    p = tmp_path / "coo.mtx"
    market.save(p, coo)
    got = market.load(p)
    dense = got.to_dense()
    assert dense[0, 1] == 2.5 and dense[2, 0] == -1.0


@pytest.mark.parametrize("text", [GENERAL, SYMMETRIC, PATTERN, INTEGER])
def test_numpy_parser_without_native(monkeypatch, text):
    """With no native tokenizer, the numpy path loads the same matrix."""
    import loops_tpu.native as native

    want = market.load(text).to_csr().to_dense()
    monkeypatch.setattr(native, "mtx_parse", lambda *a: None)
    got = market.load(text).to_csr().to_dense()
    np.testing.assert_array_equal(got, want)
