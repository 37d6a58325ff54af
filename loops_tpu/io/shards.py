"""Out-of-core sharded CSR — the papers100M-scale staging tier.

``EdgePartition`` (parallel/graph_partition.py) materializes stacked
[P, max] arrays for a mesh of devices; at ogbn-papers100M scale
(111M nodes, 1.6B edges, 57 GB of f32 features at F=128) neither the
stacked copies nor the feature table fit in HBM — and planning arrays
([B, K] per flat block) must never be built globally. The out-of-core
answer is **partition-then-plan**:

1. ``ShardedCSR.build`` cuts the graph into P row shards balanced by
   rows+edges (the same merge-path diagonal cut used inside kernels and
   across device meshes — one load-balancing abstraction at every level
   of the machine), and writes each shard as memmappable ``.npy`` files:
   local offsets, *locally remapped* column ids, the shard's unique
   global column list (its gather/halo set), and values.
2. Each shard is loaded lazily (``np.load(mmap_mode="r")``) and planned
   independently (``plan(p, schedule)``) — plan arrays exist only for
   the shard currently in flight.
3. ``StreamedSpMM`` pads every shard to the common maxima so ONE jitted
   executable serves all P shards, then streams: host gathers the
   shard's feature rows from a (possibly memmapped) table, the device
   runs the balanced local SpMM, the result lands in the output slice.

Single-chip streaming here and multi-chip ``DistSpMM``/``DistSpMMHalo``
(parallel/) are the same partitioning — a ShardedCSR's shards are
exactly what each host of a multi-host mesh feeds its devices.
"""
from __future__ import annotations

import json
import os

import numpy as np

from loops_tpu.formats import CSR
from loops_tpu.formats.base import INDEX_DTYPE
from loops_tpu.layout.merge_path import merge_path_partition

__all__ = ["ShardedCSR", "StreamedSpMM"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class ShardedCSR:
    """Directory-backed row-sharded CSR with per-shard gather sets."""

    META = "meta.json"

    def __init__(self, path: str, meta: dict):
        self.path = path
        self.meta = meta
        self.num_shards = int(meta["num_shards"])
        self.shape = tuple(meta["shape"])
        self.row_starts = np.asarray(meta["row_starts"], dtype=np.int64)
        self._cache = {}

    # ------------------------------------------------------------ build
    @classmethod
    def build(cls, csr: CSR, num_shards: int, path: str) -> "ShardedCSR":
        """Cut ``csr`` into edge-balanced row shards under ``path``.

        Peak memory is one shard's arrays, not P of them (the input CSR
        itself may be memmap-backed).
        """
        os.makedirs(path, exist_ok=True)
        P = int(num_shards)
        t, _ = merge_path_partition(csr.offsets, P)
        row_starts = t.astype(np.int64)
        row_starts[0], row_starts[-1] = 0, csr.shape[0]
        nnzs = []
        for p in range(P):
            r0, r1 = row_starts[p], row_starts[p + 1]
            a0, a1 = int(csr.offsets[r0]), int(csr.offsets[r1])
            nnzs.append(a1 - a0)
            cols = np.asarray(csr.indices[a0:a1])
            # native O(nnz + n_cols) rank-array remap (~10x np.unique's
            # sort at papers100M scale); numpy fallback keeps semantics
            from loops_tpu.native.convert import unique_remap
            nat = unique_remap(np.ascontiguousarray(cols, np.int32),
                               csr.shape[1])
            if nat is not None:
                uniq, local = nat
            else:
                uniq, local = np.unique(cols, return_inverse=True)
            np.save(f"{path}/offsets_{p}.npy",
                    (np.asarray(csr.offsets[r0:r1 + 1]) - a0
                     ).astype(INDEX_DTYPE))
            np.save(f"{path}/indices_{p}.npy", local.astype(INDEX_DTYPE))
            np.save(f"{path}/gather_{p}.npy", uniq.astype(INDEX_DTYPE))
            np.save(f"{path}/vals_{p}.npy", np.asarray(csr.vals[a0:a1]))
        meta = dict(num_shards=P, shape=list(csr.shape),
                    row_starts=row_starts.tolist(), nnzs=nnzs,
                    val_dtype=str(csr.vals.dtype))
        with open(f"{path}/{cls.META}", "w") as f:
            json.dump(meta, f)
        return cls(path, meta)

    @classmethod
    def open(cls, path: str) -> "ShardedCSR":
        with open(f"{path}/{cls.META}") as f:
            return cls(path, json.load(f))

    # ------------------------------------------------------------ access
    def _load(self, name: str, p: int):
        return np.load(f"{self.path}/{name}_{p}.npy", mmap_mode="r")

    def shard(self, p: int) -> dict:
        """Lazy shard view: local CSR arrays + its gather (halo) set."""
        if p not in self._cache:
            r0, r1 = self.row_starts[p], self.row_starts[p + 1]
            self._cache[p] = dict(
                rows=int(r1 - r0), row0=int(r0),
                offsets=self._load("offsets", p),
                indices=self._load("indices", p),
                gather=self._load("gather", p),
                vals=self._load("vals", p),
            )
        return self._cache[p]

    def shard_csr(self, p: int) -> CSR:
        """Shard p as a CSR over its *local* column space."""
        s = self.shard(p)
        return CSR((s["rows"], len(s["gather"])),
                   np.asarray(s["offsets"]), np.asarray(s["indices"]),
                   np.asarray(s["vals"]))

    def plan(self, p: int, schedule: str = "group_mapped", **kw):
        """Partition-then-plan: plan arrays for one shard only."""
        from loops_tpu.layout import CsrLayout
        from loops_tpu.schedule.plans import make_plan

        return make_plan(CsrLayout.from_csr(self.shard_csr(p)),
                         schedule, **kw)

    @property
    def max_rows(self) -> int:
        return int(np.diff(self.row_starts).max(initial=1))

    @property
    def max_nnz(self) -> int:
        return max(int(n) for n in self.meta["nnzs"]) or 1

    @property
    def max_gather(self) -> int:
        return max((len(self.shard(p)["gather"])
                    for p in range(self.num_shards)), default=1) or 1


class StreamedSpMM:
    """Single-executable streaming SpMM over a ShardedCSR.

    Every shard is padded to the store-wide maxima so the jitted local
    SpMM compiles once; shards then stream through it. The host gathers
    each shard's feature rows from ``X`` (ndarray or memmap) — the
    out-of-core analog of the device-side halo exchange.
    """

    def __init__(self, sharded: ShardedCSR):
        import jax
        import jax.numpy as jnp

        self.sharded = sharded
        self.rows_pd = _round_up(sharded.max_rows, 8)
        self.nnz_pd = _round_up(sharded.max_nnz, 128)
        self.gat_pd = _round_up(sharded.max_gather, 8)

        rows_pd = self.rows_pd

        def fn(b, xg):
            prod = b["vals"][:, None] * xg[b["indices"]]
            return jax.ops.segment_sum(prod, b["rid"], num_segments=rows_pd,
                                       indices_are_sorted=True)
        self._jit = jax.jit(fn)
        self._jnp = jnp

    def _shard_bufs(self, p: int):
        jnp = self._jnp
        s = self.sharded.shard(p)
        nnz = len(s["indices"])
        idx = np.zeros(self.nnz_pd, INDEX_DTYPE)
        idx[:nnz] = s["indices"]
        vals = np.zeros(self.nnz_pd, np.float32)
        vals[:nnz] = s["vals"]
        rid = np.full(self.nnz_pd, self.rows_pd - 1, INDEX_DTYPE)
        rid[:nnz] = np.repeat(
            np.arange(s["rows"], dtype=INDEX_DTYPE),
            np.diff(np.asarray(s["offsets"])))
        # padded atoms have zero vals; park them on the last row
        return dict(indices=jnp.asarray(idx), vals=jnp.asarray(vals),
                    rid=jnp.asarray(rid)), s

    def __call__(self, X, out=None):
        """``adj @ X`` streamed shard-by-shard; ``out`` may be a memmap."""
        jnp = self._jnp
        F = X.shape[1]
        if out is None:
            out = np.empty((self.sharded.shape[0], F), np.float32)
        for p in range(self.sharded.num_shards):
            bufs, s = self._shard_bufs(p)
            xg = np.zeros((self.gat_pd, F), np.float32)
            xg[: len(s["gather"])] = X[np.asarray(s["gather"])]
            y = np.asarray(self._jit(bufs, jnp.asarray(xg)))
            out[s["row0"]: s["row0"] + s["rows"]] = y[: s["rows"]]
        return out
