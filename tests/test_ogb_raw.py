"""Raw-OGB reader fixture test: stage a tiny fake OGB directory (the
real raw CSV(.gz) schema) and drive io/ogb.py's real-data path
end-to-end — so the loader is proven before real data exists in the
offline environment."""
import gzip
import os

import numpy as np
import pytest

from loops_tpu.io import ogb


def _stage_raw(root, name="ogbn_tiny", gz_edges=True):
    d = os.path.join(root, name)
    os.makedirs(os.path.join(d, "raw"))
    os.makedirs(os.path.join(d, "split", "time"))
    rng = np.random.default_rng(0)
    n, f, m, c = 6, 4, 10, 3
    edges = rng.integers(0, n, (m, 2))
    feats = rng.normal(size=(n, f)).astype(np.float32)
    labels = rng.integers(0, c, n)

    def w(fname, arr, fmt):
        p = os.path.join(d, "raw", fname)
        if fname.endswith(".gz"):
            with gzip.open(p, "wt") as fh:
                np.savetxt(fh, arr, delimiter=",", fmt=fmt)
        else:
            np.savetxt(p, arr, delimiter=",", fmt=fmt)

    w("edge.csv.gz" if gz_edges else "edge.csv", edges, "%d")
    w("node-feat.csv", feats, "%.6f")
    w("node-label.csv", labels[:, None], "%d")
    splits = {"train": np.arange(0, 4), "valid": np.array([4]),
              "test": np.array([5])}
    for s, idx in splits.items():
        with gzip.open(os.path.join(d, "split", "time", f"{s}.csv.gz"),
                       "wt") as fh:
            np.savetxt(fh, idx[:, None], fmt="%d")
    return d, edges, feats, labels


@pytest.mark.parametrize("gz_edges", [True, False])
def test_load_ogb_raw_end_to_end(tmp_path, monkeypatch, gz_edges):
    root = str(tmp_path)
    d, edges, feats, labels = _stage_raw(root, gz_edges=gz_edges)
    monkeypatch.setattr(ogb, "KNOWN_DIRS", (root,))

    data = ogb.load("ogbn-tiny", allow_synthetic=False)
    assert not data.synthetic
    assert data.features.shape == feats.shape
    np.testing.assert_allclose(data.features, feats, atol=1e-5)
    np.testing.assert_array_equal(data.labels, labels.astype(np.int32))
    # undirected graph over the staged edges, dedup'd
    und = {(int(a), int(b)) for a, b in edges} | {
        (int(b), int(a)) for a, b in edges}
    assert data.graph.adj.nnz == len(und)
    # split masks: disjoint, cover the staged indices
    assert data.train_mask.sum() == 4
    assert data.val_mask.sum() == 1 and data.test_mask.sum() == 1
    assert (data.train_mask * data.val_mask).sum() == 0

    # the loaded dataset drives a real model forward
    import jax

    from loops_tpu.models import GCN
    model = GCN(data.graph, [feats.shape[1], 8, data.num_classes],
                dropout=0.0)
    params = model.init(jax.random.PRNGKey(0))
    out = np.asarray(model.apply(params, data.features))
    assert out.shape == (len(feats), data.num_classes)
    assert np.isfinite(out).all()


def test_load_raises_without_local_copy_when_synthetic_disabled(
        tmp_path, monkeypatch):
    monkeypatch.setattr(ogb, "KNOWN_DIRS", (str(tmp_path),))
    with pytest.raises(FileNotFoundError):
        ogb.load("ogbn-arxiv", allow_synthetic=False)


def test_missing_split_yields_empty_masks(tmp_path, monkeypatch):
    import shutil

    root = str(tmp_path)
    d, *_ = _stage_raw(root)
    shutil.rmtree(os.path.join(d, "split"))
    monkeypatch.setattr(ogb, "KNOWN_DIRS", (root,))
    data = ogb.load("ogbn-tiny", allow_synthetic=False)
    assert data.train_mask.sum() == 0
