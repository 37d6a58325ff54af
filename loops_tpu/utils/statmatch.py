"""Size/structure-matched replicas of the reference's SuiteSparse sweep
population.

The reference's performance evidence is 4,831 real SuiteSparse matrices
(reference: plots/data/heuristics.csv; scripts/run.sh:15-30).  This
environment has zero egress (per-round fetch attempts recorded in
sweep_logs/fetch_attempts.log), so the matrices themselves cannot be
staged.  What CAN be matched honestly from the shipped artifact is, per
matrix: the exact (rows, cols, nnz) — the CSV carries nothing else —
plus a *structure prior* keyed on the well-known SuiteSparse naming
conventions (bus/shell/elt/... are FEM meshes -> banded; soc-/web-/
cit-/as-/com- are scale-free networks -> power-law; rajat/dcop/fpga/
circuit are circuit matrices -> heavy-tailed lognormal; lp_ are
rectangular LP bases -> uniform rectangular).  Matrices no keyword
matches fall back to a density/aspect rule.

Every replica records which prior produced it (``FAMILY_OF``) so the
sweep output can be cut by assumed family.  This is explicitly a
size+prior match, NOT real data: the replica of ``144`` has 144's exact
dimensions and nnz and a mesh-like structure, not 144's true sparsity
pattern.  Claims derived from this population are labeled accordingly
(README "evidence" section).
"""
from __future__ import annotations

import csv
import os
from dataclasses import dataclass

import numpy as np

from loops_tpu.formats import CSR

REFERENCE_CSV = "/root/reference/plots/data/heuristics.csv"

# keyword -> structure family, first match wins (lowercased substring)
_KEYWORDS = (
    # scale-free networks: social / web / citation / autonomous systems
    ("powerlaw", ("soc", "web-", "wiki", "com-", "cit-", "ca-", "as-",
                  "email", "p2p", "amazon", "youtube", "flickr",
                  "hollywood", "ljournal", "twitter", "graph500", "kron",
                  "uk-200", "arabic", "indochina", "dblp", "patents",
                  "roadnet", "astro", "cond-mat", "hep", "pgp", "gnutella",
                  "slashdot", "epinions", "orkut", "friendster")),
    # circuits & device simulation: hub rows, heavy tails
    ("lognormal", ("rajat", "dcop", "adder", "fpga", "bips", "case39",
                   "zeros", "hcircuit", "scircuit", "memplus", "coupled",
                   "onetone", "twotone", "ckt", "asic", "freescale",
                   "circuit", "trans4", "trans5", "dc1", "dc2", "dc3",
                   "ibm_matrix", "barrier", "igbt", "bjtcai", "highk",
                   "mosfet", "power", "init_adder")),
    # finite-element / structural / PDE meshes: banded after ordering
    ("banded", ("bus", "shell", "cavity", "cube", "sphere", "tube", "elt",
                "mesh", "bcsstk", "bcsstm", "crystk", "ct20", "pwtk",
                "ship", "hood", "benelechi", "af_", "audik", "bone",
                "emilia", "fault", "flan", "geo_", "hook", "ml_",
                "msdoor", "nasa", "olafu", "raefsky", "s3dkq", "dubcova",
                "ecology", "thermal", "apache", "parabolic", "g3_circuit",
                "offshore", "tmt_", "t2d", "t3d", "venkat", "wang", "2d_",
                "3d_", "dtube", "plat", "gridgena", "wathen", "nos",
                "delaunay", "rgg_", "hugetrace", "road", "nd3k", "nd6k",
                "nd12k", "nd24k", "pkustk", "oilpan", "vanbody", "x104",
                "cant", "consph", "cop20k", "mac_econ", "mc2depi",
                "pdb1hys", "rma10", "abacus", "spectralwave")),
    # linear programming: rectangular, near-uniform columns
    ("uniform", ("lp_", "lpi_", "ken-", "pds-", "cre-", "osa-", "nug",
                 "dfl", "qap", "rail", "stat96", "watson", "karted",
                 "degme", "tp-6", "stormg2", "cont11", "neos", "sgpf")),
)

FAMILIES = ("banded", "powerlaw", "lognormal", "uniform")


@dataclass(frozen=True)
class RefMatrix:
    name: str
    rows: int
    cols: int
    nnz: int

    @property
    def family(self) -> str:
        return family_of(self.name, self.rows, self.cols, self.nnz)


def family_of(name: str, rows: int, cols: int, nnz: int) -> str:
    low = name.lower()
    for fam, keys in _KEYWORDS:
        if any(k in low for k in keys):
            return fam
    # fallback: density/aspect rule
    if rows != cols:
        return "uniform"
    avg = nnz / max(rows, 1)
    if avg <= 3.0:
        return "banded"
    if nnz / (float(rows) * cols) > 0.02:
        return "uniform"
    # deterministic mix for the rest (hash of the name): meshes dominate
    # the unlabeled SuiteSparse middle, heavy tails are next
    h = sum(name.encode()) % 10
    return ("banded" if h < 4 else
            "lognormal" if h < 7 else
            "powerlaw" if h < 9 else "uniform")


def load_population(csv_path: str = REFERENCE_CSV) -> list[RefMatrix]:
    pop = []
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            try:
                pop.append(RefMatrix(row["dataset"], int(row["rows"]),
                                     int(row["cols"]), int(row["nnzs"])))
            except (KeyError, ValueError):
                continue
    return pop


def sample_population(pop, k: int, seed: int = 0, max_nnz: int = 4_000_000,
                      max_dim: int = 1_000_000) -> list[RefMatrix]:
    """Stratified sample: k matrices spread over log-nnz deciles of the
    *eligible* population (single-chip envelope caps recorded by the
    caller)."""
    rng = np.random.default_rng(seed)
    elig = [m for m in pop if m.nnz <= max_nnz and m.rows <= max_dim
            and m.cols <= max_dim and m.nnz > 0]
    elig.sort(key=lambda m: m.nnz)
    out, n = [], len(elig)
    for i in range(k):
        lo, hi = (i * n) // k, ((i + 1) * n) // k
        if hi > lo:
            out.append(elig[int(rng.integers(lo, hi))])
    # dedupe by name (as-735_G_* style near-duplicates can repeat)
    seen, uniq = set(), []
    for m in out:
        if m.name not in seen:
            seen.add(m.name)
            uniq.append(m)
    return uniq


def _name_seed(name: str, seed: int = 0) -> int:
    import zlib
    return (zlib.crc32(name.encode()) ^ seed) & 0x7FFFFFFF


def build_replica_by_name(nm: str, seed: int = 0,
                          csv_path: str = REFERENCE_CSV):
    """Rebuild the replica for a ``sm_<dataset>`` sweep name — the
    deterministic-recipe contract the synthetic battery has
    (utils/battery.build), for the stat-matched population."""
    if not nm.startswith("sm_"):
        raise KeyError(nm)
    target = nm[3:]
    for m in load_population(csv_path):
        if m.name == target:
            return replica(m, _name_seed(target, seed))
    raise KeyError(nm)


# ---------------------------------------------------------------- coo
def _exact_unique_coo(draw, n_target: int, seed: int, max_iter: int = 64):
    """Draw batches of (r, c) until n_target unique pairs exist, then
    keep exactly n_target (uniform thinning preserves the marginal)."""
    rng = np.random.default_rng(seed)
    rs = np.empty(0, np.int64)
    cs = np.empty(0, np.int64)
    need = n_target
    for _ in range(max_iter):
        r, c = draw(rng, int(need * 1.3) + 16)
        rs = np.concatenate([rs, r])
        cs = np.concatenate([cs, c])
        key = rs * (cs.max() + 1 if len(cs) else 1) + cs
        _, idx = np.unique(key, return_index=True)
        if len(idx) >= n_target:
            idx = np.sort(rng.permutation(idx)[:n_target])
            return rs[idx], cs[idx]
        need = n_target - len(idx)
    # pathological (target close to the full support): return what we have
    key = rs * (cs.max() + 1 if len(cs) else 1) + cs
    _, idx = np.unique(key, return_index=True)
    return rs[idx], cs[idx]


def _coo_to_csr(rows_i, cols_i, shape, seed) -> CSR:
    order = np.lexsort((cols_i, rows_i))
    rows_i, cols_i = rows_i[order], cols_i[order]
    offs = np.searchsorted(rows_i, np.arange(shape[0] + 1)).astype(np.int64)
    vals = np.random.default_rng(seed + 7).uniform(
        -1, 1, len(rows_i)).astype(np.float32)
    return CSR(shape, offs, cols_i.astype(np.int64), vals)


def replica(m: RefMatrix, seed: int = 0) -> CSR:
    """Generate the (rows, cols, nnz)-matched replica under m's family
    prior. nnz is matched exactly unless the target exceeds ~the
    family's support (then best-effort, recorded by the caller)."""
    fam = m.family
    R, C, N = m.rows, m.cols, m.nnz
    N = min(N, R * C)

    # dense-support shortcut: at fill > 30% (RHS-vector "_b" matrices,
    # tiny dense blocks) rejection sampling degenerates into coupon
    # collecting; sample cells without replacement instead (structure
    # is immaterial at that density)
    if R * C <= 1 << 24 and N > 0.3 * R * C:
        rngd = np.random.default_rng(seed)
        flat = rngd.permutation(R * C)[:N]
        return _coo_to_csr(flat // C, flat % C, (R, C), seed)

    if fam == "banded":
        halfw = max(int(np.ceil(N / max(R, 1) / 2)), 1)

        def draw(rng, k):
            r = rng.integers(0, R, k)
            c = r * C // R + rng.integers(-halfw, halfw + 1, k)
            return r, np.clip(c, 0, C - 1)
    elif fam == "powerlaw":
        ranks = np.arange(1, C + 1, dtype=np.float64)
        p = 1.0 / ranks
        p /= p.sum()
        cdf = np.cumsum(p)

        def draw(rng, k):
            r = rng.integers(0, R, k)
            c = np.searchsorted(cdf, rng.random(k))
            return r, np.minimum(c, C - 1)
    elif fam == "lognormal":
        # heavy-tailed row degrees (circuit hubs): rows weighted by a
        # lognormal, columns near-uniform
        rngw = np.random.default_rng(seed + 3)
        w = rngw.lognormal(0.0, 1.5, R)
        w /= w.sum()
        cdf = np.cumsum(w)

        def draw(rng, k):
            r = np.searchsorted(cdf, rng.random(k))
            return np.minimum(r, R - 1), rng.integers(0, C, k)
    else:  # uniform
        def draw(rng, k):
            return rng.integers(0, R, k), rng.integers(0, C, k)

    rr, cc = _exact_unique_coo(draw, N, seed)
    return _coo_to_csr(rr, cc, (R, C), seed)


def statmatched_battery(k: int = 250, seed: int = 0,
                        max_nnz: int = 4_000_000,
                        max_dim: int = 1_000_000,
                        csv_path: str = REFERENCE_CSV):
    """name -> builder dict (sweep_battery-compatible) + coverage info.

    Returns ``(mats, info)`` where info records the eligible fraction of
    the reference population under the single-chip caps and each
    replica's assumed family.
    """
    pop = load_population(csv_path)
    elig = [m for m in pop if m.nnz <= max_nnz and m.rows <= max_dim
            and m.cols <= max_dim and m.nnz > 0]
    sample = sample_population(pop, k, seed, max_nnz, max_dim)
    mats = {}
    fams = {}
    for m in sample:
        nm = f"sm_{m.name}"
        # seed keyed on the NAME (not the sample position) so a single
        # replica can be rebuilt later (fit_heuristic features) without
        # re-deriving the whole sample
        mats[nm] = (lambda mm=m, s=_name_seed(m.name, seed):
                    replica(mm, s))
        fams[nm] = m.family
    info = dict(population=len(pop), eligible=len(elig),
                eligible_frac=round(len(elig) / max(len(pop), 1), 4),
                sampled=len(sample), families=fams,
                family_counts={f: sum(1 for v in fams.values() if v == f)
                               for f in FAMILIES})
    return mats, info
