"""Format advisor — preflight structure probes -> recommended container.

The reference ships per-format *guard* probes (``ell_t::max_nnz_per_row``,
reference: container/ell.hxx:91-102; ``dia_t::count_diagonals``,
container/dia.hxx:98-116) that protect against memory blow-up, but the
format choice itself is left to the user. Here the choice is a measured
cost decision: each format's SpMV costs about a fixed time per stored
cell on the card, so a dense format (DIA diagonals, BCSR blocks) wins
exactly when its fill stays above the ratio of its per-cell cost to
CSR's per-nonzero cost.

``advise(csr)`` runs all probes (each O(nnz), vectorized) and returns
per-format cost estimates plus a gated recommendation;
``choose_format(csr)`` returns just the format name. This is the
format-axis companion of ``schedule.choose_schedule`` (the reference's
best-of-3 oracle study, plots/data/heuristics.csv).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# ns per stored cell of one SpMV: the median of four runs of
# chip_smoke.py's advisor phase on an NVIDIA H100 80GB HBM3 (three at
# its 700 W limit, one capped at 400 W; 32768 rows), range in brackets:
# csr  — per nonzero, row_mapped SpMV over 4.39M uniform nonzeros
#        [0.0538, 0.0575];
# bcsr — per stored cell of 8x128 blocks at 1.5% block fill (einsum)
#        [0.0075, 0.0123];
# dia  — per stored cell of 65 diagonals, a gather per cell
#        [0.0486, 0.0931].
# These are sub-0.3 ms ops timed from the host, hence the spread. With
# the medians DIA breaks even with CSR only at a fill of 1.16, so the
# default table never recommends DIA; single runs put that fill between
# 0.90 and 1.71, so the DIA candidate stays for re-measured or
# caller-supplied tables.
COSTS_NS = {"csr": 0.0542, "bcsr": 0.00956, "dia": 0.0628}

# ELL executes the same per-cell gathers as CSR *including padding*, so
# it only ever helps by removing plan overhead; cap the waste. The cap
# doubles as the plan-overhead budget (not measured on the GPU):
# recommending ELL over CSR is only coherent while the extra padded
# gathers stay under the plan build/dispatch cost they save.
ELL_MAX_WASTE = 1.25

# DIA memory blow-up guard (the purpose of the reference's
# count_diagonals probe, dia.hxx:98-116): a 20x storage expansion also
# means a 20x conversion/build cost the cost model does not carry, so
# require at least 5% dense-diagonal occupancy.
DIA_MIN_FILL = 0.05


@dataclass
class FormatAdvice:
    """Probe results + cost-model estimates for one input matrix."""

    rows: int
    cols: int
    nnz: int
    # probes
    bcsr_fill: float            # nnz / stored block cells at bcsr_block
    bcsr_block: tuple           # (R, C) probed
    dia_fill: float             # nnz / (num_diagonals * rows)
    num_diagonals: int
    ell_waste: float            # rows * pitch / nnz
    ell_pitch: int
    # estimated single-pass SpMV cost per format, milliseconds
    est_ms: dict = field(default_factory=dict)
    recommended: str = "csr"
    why: str = ""


def probe_bcsr_fill(csr, block_rows: int = 8, block_cols: int = 128) -> float:
    """Fraction of stored-block cells that hold a nonzero (O(nnz log nnz)
    — np.unique sorts; the BCSR analog of the reference's preflight
    probes, which call out exactly this sort-vs-hash cost on power-law
    graphs, reference: container/dia.hxx:103-105)."""
    if csr.nnz == 0:
        return 0.0
    nbc = -(-csr.cols // block_cols)
    keys = (csr.row_ids().astype(np.int64) // block_rows) * nbc + (
        csr.indices.astype(np.int64) // block_cols)
    nblocks = len(np.unique(keys))
    return csr.nnz / float(nblocks * block_rows * block_cols)


def advise(csr, costs: dict | None = None,
           bcsr_block: tuple | None = None) -> FormatAdvice:
    """Probe ``csr`` and estimate per-format SpMV cost.

    Cost model (``costs`` in ns per stored cell, default ``COSTS_NS``):
      csr  ≈ nnz · costs["csr"]
      ell  ≈ rows · pitch · costs["csr"]      (pads the gathers)
      dia  ≈ ndiag · rows · costs["dia"]
      bcsr ≈ nblocks · R · C · costs["bcsr"]
    """
    from loops_tpu.formats.dia import DIA
    from loops_tpu.formats.ell import ELL

    c = dict(COSTS_NS, **(costs or {}))
    R, C = bcsr_block or (8, 128)

    nnz = max(csr.nnz, 1)
    bcsr_fill = probe_bcsr_fill(csr, R, C)
    nblocks = nnz / max(bcsr_fill * R * C, 1e-12) if csr.nnz else 0.0
    ndiag = DIA.count_diagonals(csr)
    dia_cells = ndiag * max(csr.rows, 1)
    dia_fill = csr.nnz / max(dia_cells, 1)
    pitch = ELL.max_nnz_per_row(csr)
    ell_cells = max(csr.rows, 1) * pitch
    ell_waste = ell_cells / nnz

    est_ms = {
        "csr": nnz * c["csr"] * 1e-6,
        "ell": ell_cells * c["csr"] * 1e-6,
        "dia": dia_cells * c["dia"] * 1e-6,
        "bcsr": nblocks * R * C * c["bcsr"] * 1e-6,
    }

    adv = FormatAdvice(csr.rows, csr.cols, csr.nnz, bcsr_fill,
                       (R, C), dia_fill, ndiag, ell_waste, pitch, est_ms)
    if csr.nnz == 0:
        adv.recommended, adv.why = "csr", "empty matrix"
        return adv

    # the DIA memory guard first, then the cheapest estimate
    candidates = {"csr": est_ms["csr"], "bcsr": est_ms["bcsr"]}
    if dia_fill >= DIA_MIN_FILL:
        candidates["dia"] = est_ms["dia"]
    best = min(candidates, key=candidates.get)
    if (best == "csr" and ell_waste <= ELL_MAX_WASTE
            and est_ms["ell"] <= est_ms["csr"] * 1.25):
        # plan-free static layout, within the 25% overhead budget
        best = "ell"
    adv.recommended = best
    adv.why = {
        "csr": f"gather floor {est_ms['csr']:.3g} ms beats every dense "
               f"candidate (bcsr fill {bcsr_fill:.2%}, dia {ndiag} "
               "diagonals)",
        "ell": f"near-uniform rows (waste {ell_waste:.2f}x): est_ms is "
               f"{ell_waste:.2f}x CSR's, but the plan-free static layout "
               "saves per-pass schedule build/dispatch overhead the cost "
               "model does not carry (budgeted at <=25% of a pass)",
        "dia": f"{ndiag} diagonals stream at {est_ms['dia']:.3g} ms vs "
               f"{est_ms['csr']:.3g} ms of gathers",
        "bcsr": f"block fill {bcsr_fill:.2%}: block stream "
                f"{est_ms['bcsr']:.3g} ms vs {est_ms['csr']:.3g} ms of "
                "gathers",
    }[best]
    return adv


def choose_format(csr, **kw) -> str:
    """Recommended container name for ``csr`` ('csr'/'ell'/'dia'/'bcsr')."""
    return advise(csr, **kw).recommended
