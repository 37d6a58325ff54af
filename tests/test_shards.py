"""Out-of-core sharded CSR: partition-then-plan + streaming SpMM."""
import shutil
import tempfile

import numpy as np
import pytest

from loops_tpu.io.shards import ShardedCSR, StreamedSpMM
from loops_tpu.utils import generate


@pytest.fixture
def store(tmp_path):
    csr = generate.random_csr(200, 180, 0.05, seed=9)
    sharded = ShardedCSR.build(csr, 4, str(tmp_path / "shards"))
    return csr, sharded


def test_shard_roundtrip(store, tmp_path):
    csr, sharded = store
    re = ShardedCSR.open(str(tmp_path / "shards"))
    assert re.num_shards == 4
    assert tuple(re.shape) == csr.shape
    # every edge present exactly once, with global cols recoverable
    total = 0
    for p in range(4):
        s = re.shard(p)
        nnz = len(s["indices"])
        total += nnz
        gcols = np.asarray(s["gather"])[np.asarray(s["indices"])]
        r0 = s["row0"]
        a0 = csr.offsets[r0]
        assert np.array_equal(gcols, csr.indices[a0:a0 + nnz])
        assert np.array_equal(np.asarray(s["vals"]),
                              csr.vals[a0:a0 + nnz])
    assert total == csr.nnz


def test_edge_balance(store):
    csr, sharded = store
    nnzs = np.asarray(sharded.meta["nnzs"], dtype=np.float64)
    rows = np.diff(sharded.row_starts)
    work = nnzs + rows
    # merge-path cut: every shard within ~2x of the mean work share
    assert work.max() <= 2.0 * work.mean() + 1


def test_partition_then_plan(store):
    csr, sharded = store
    for p in range(4):
        plan = sharded.plan(p, "merge_path", block_work=64)
        s = sharded.shard(p)
        assert plan.num_atoms == len(s["indices"])
        assert plan.num_tiles == s["rows"]


def test_streamed_spmm_matches_dense(store):
    csr, sharded = store
    rng = np.random.default_rng(3)
    X = rng.normal(size=(csr.shape[1], 16)).astype(np.float32)
    got = StreamedSpMM(sharded)(X)
    want = csr.to_dense() @ X
    assert np.allclose(got, want, atol=1e-4, rtol=1e-4)


def test_streamed_spmm_memmap_out(store, tmp_path):
    csr, sharded = store
    rng = np.random.default_rng(4)
    X = rng.normal(size=(csr.shape[1], 8)).astype(np.float32)
    out = np.lib.format.open_memmap(
        str(tmp_path / "y.npy"), mode="w+",
        dtype=np.float32, shape=(csr.shape[0], 8))
    got = StreamedSpMM(sharded)(X, out=out)
    out.flush()
    want = csr.to_dense() @ X
    assert np.allclose(np.load(str(tmp_path / "y.npy")), want,
                       atol=1e-4, rtol=1e-4)


def test_empty_rows_and_tiny_shards(tmp_path):
    csr = generate.empty_row_csr(17, 5)
    sharded = ShardedCSR.build(csr, 6, str(tmp_path / "s2"))
    X = np.ones((csr.shape[1], 4), np.float32)
    got = StreamedSpMM(sharded)(X)
    want = csr.to_dense() @ X
    assert np.allclose(got, want, atol=1e-5)


def test_native_unique_remap_matches_numpy():
    from loops_tpu.native.convert import unique_remap

    rng = np.random.default_rng(11)
    cols = rng.integers(0, 5000, size=200_000).astype(np.int32)
    got = unique_remap(cols, 5000)
    if got is None:
        import pytest
        pytest.skip("native library unavailable")
    uniq, local = got
    ref_u, ref_l = np.unique(cols, return_inverse=True)
    assert np.array_equal(uniq, ref_u)
    assert np.array_equal(local, ref_l)
    # round-trip: uniq[local] reconstructs the input
    assert np.array_equal(uniq[local], cols)


def test_native_unique_remap_rejects_out_of_range():
    from loops_tpu.native.convert import unique_remap

    cols = np.array([1, 2, 99], np.int32)
    assert unique_remap(cols, 10) is None


@pytest.mark.parametrize("shards", [1, 5])
def test_streamed_spmm_shares_one_executable(shards):
    """Every shard is padded to the store-wide maxima, so the jitted
    local SpMM compiles once for all of them."""
    csr = generate.random_csr(300, 300, 0.03, seed=6)
    d = tempfile.mkdtemp()
    try:
        st = ShardedCSR.build(csr, shards, d)
        X = np.random.default_rng(1).normal(
            size=(300, 48)).astype(np.float32)
        sp = StreamedSpMM(st)
        out = sp(X)
        assert sp._jit._cache_size() == 1
        ref = csr.to_dense() @ X
        assert np.allclose(out, ref, atol=1e-4, rtol=1e-4), (
            np.abs(out - ref).max())
    finally:
        shutil.rmtree(d)


def test_streamed_spmm_skewed_and_unknown_schedule():
    csr = generate.skewed_csr(200, 200, heavy_rows=4)
    d = tempfile.mkdtemp()
    try:
        st = ShardedCSR.build(csr, 3, d)
        X = np.random.default_rng(2).normal(
            size=(200, 16)).astype(np.float32)
        out = StreamedSpMM(st)(X)
        ref = csr.to_dense() @ X
        assert np.allclose(out, ref, atol=1e-4, rtol=1e-4)
        # one execution shape: a schedule argument is refused, not
        # silently ignored
        with pytest.raises(TypeError):
            StreamedSpMM(st, schedule="merge_path")
    finally:
        shutil.rmtree(d)


def test_edge_partition_from_shards_matches_global(tmp_path):
    """Out-of-core glue: EdgePartition.from_shards (per-shard memmaps,
    chips subdivide each shard) produces a partition whose distributed
    halo SpMM matches the single-device oracle."""
    import numpy as np

    from loops_tpu.io.shards import ShardedCSR
    from loops_tpu.parallel import EdgePartition, make_mesh
    from loops_tpu.parallel.halo import DistSpMMHalo, HaloPlan
    from loops_tpu.utils import generate, reference

    csr = generate.random_csr(96, 96, 0.08, seed=13)
    store = ShardedCSR.build(csr, 2, str(tmp_path / "st"))
    part = EdgePartition.from_shards(store, chips_per_shard=4)
    assert part.num_devices == 8
    assert part.row_starts[0] == 0 and part.row_starts[-1] == 96
    total = sum(int(part.offsets[p, -1]) for p in range(8))
    assert total == csr.nnz
    # devices 0-3 cover shard 0's row range exactly
    assert part.row_starts[4] == store.row_starts[1]

    op = DistSpMMHalo(HaloPlan.build(part), make_mesh(8), overlap=True)
    X = np.random.default_rng(5).normal(size=(96, 6)).astype(np.float32)
    got = part.unpad_output(np.asarray(op(part.pad_features(X))))
    np.testing.assert_allclose(got, reference.spmm(csr, X),
                               rtol=1e-4, atol=1e-4)
