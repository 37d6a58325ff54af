"""Edge-list loaders (.tsv/.csv/.txt src dst [weight]) — the format most
graph datasets actually ship in. Comment-tolerant, pandas C-engine fast
path with numpy fallback, same overflow guards as the .mtx loader."""
from __future__ import annotations

import os

import numpy as np

from loops_tpu.formats.base import INDEX_DTYPE
from loops_tpu.models.graph import Graph


def load_edges(path_or_bytes, num_nodes: int | None = None,
               make_undirected: bool = False, comment: str = "#") -> Graph:
    """Load an edge list into a :class:`Graph`.

    Columns: src dst [weight]; whitespace or comma separated; lines
    starting with ``comment`` are skipped; node ids are 0-indexed.
    ``num_nodes`` defaults to max id + 1.
    """
    if isinstance(path_or_bytes, (str, os.PathLike)):
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    else:
        data = bytes(path_or_bytes)

    rows = [ln.replace(b",", b" ").split() for ln in data.splitlines()
            if ln.strip() and not ln.lstrip().startswith(comment.encode())]
    # a row without the weight column gets weight 1
    width = max((len(r) for r in rows), default=2)
    arr = np.ones((len(rows), width), np.float64)
    for i, r in enumerate(rows):
        arr[i, :len(r)] = np.asarray(r, np.float64)
    if arr.ndim != 2 or arr.shape[1] < 2:
        raise ValueError("edge list needs at least src and dst columns")

    src = arr[:, 0].astype(np.int64)
    dst = arr[:, 1].astype(np.int64)
    if src.min(initial=0) < 0 or dst.min(initial=0) < 0:
        raise ValueError("negative node id in edge list")
    w = (arr[:, 2].astype(np.float32) if arr.shape[1] >= 3
         else np.ones(len(src), np.float32))
    n = int(num_nodes if num_nodes is not None
            else max(src.max(initial=-1), dst.max(initial=-1)) + 1)
    if n > np.iinfo(INDEX_DTYPE).max:
        raise OverflowError("node count exceeds int32 index range")
    return Graph.from_edges(src, dst, n, weights=w,
                            make_undirected=make_undirected)
