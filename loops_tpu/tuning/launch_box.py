"""Launch box: per-device kernel knobs and published peaks, one table.

The analog of the reference's arch-keyed ``launch_box_t`` (reference:
include/loops/util/launch_box.hxx:159-214): where the reference selects
block size and items per thread by SM architecture at C++ compile time,
``launch_params()`` resolves them from ``jax.devices()[0].device_kind``.

A device kind that is not in the table is an error, not a default: a
roofline divided by another device's peaks is a wrong number that looks
right.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LaunchParams:
    # XLA flat SpMV schedules (merge_path / work_oriented): work items
    # per block
    spmv_block: int
    # BCSR SpMM Triton kernel: feature tile (columns per program), a
    # power of two
    spmm_block_f: int
    # published peaks, for roofline shares (None: no device peak)
    hbm_gbps: float | None
    peak_bf16_tflops: float | None
    source: str


# substring of the lower-cased device_kind -> row; first match wins
_TABLE = (
    # H100 SXM (JAX reports "NVIDIA H100 80GB HBM3"). Peaks: NVIDIA H100
    # Tensor Core GPU data sheet, SXM column, dense (no sparsity), at
    # the 700 W limit. spmm_block_f: feature tile 64 beat 128 for the
    # BCSR kernel in f32 (0.881 vs 1.130 ms at 16384^2, F=512; H100
    # 80GB HBM3 at 700 W, scripts/kernel_ab.py). spmv_block is unfitted:
    # a placeholder, not measured on this card (ROADMAP 1.4).
    ("h100 80gb hbm3", LaunchParams(
        spmv_block=1024, spmm_block_f=64,
        hbm_gbps=3350.0, peak_bf16_tflops=989.0,
        source="NVIDIA H100 data sheet (SXM, dense)")),
    # CPU test backend: tiny blocks so multi-block paths are exercised
    ("cpu", LaunchParams(
        spmv_block=64, spmm_block_f=64,
        hbm_gbps=None, peak_bf16_tflops=None,
        source="CPU test row: no device peaks")),
)


def device_kind(device=None) -> str:
    """Lower-cased ``device_kind``; every CPU device is ``"cpu"``."""
    import jax

    if device is None:
        device = jax.devices()[0]
    if getattr(device, "platform", "") == "cpu":
        return "cpu"
    return str(getattr(device, "device_kind", "")).lower()


def launch_params(device=None) -> LaunchParams:
    """The table row for ``device`` (default: the first JAX device)."""
    kind = device_kind(device)
    for key, params in _TABLE:
        if key in kind:
            return params
    raise LookupError(
        f"no launch-box row for device kind {kind!r}; add one to "
        "loops_tpu/tuning/launch_box.py with its published peaks")
