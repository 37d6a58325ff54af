"""Per-executable counter collection — the analog of the reference's
CUPTI metrics integration.

The reference's NVBench harness optionally samples hardware counters
(DRAM throughput, cache hit rates) per kernel
(reference: benchmarks/spmv/work_oriented.cu:37-44, behind
``LOOPS_CUPTI_SUPPORTED``). JAX exposes no hardware counter API, but
XLA publishes its *compiled cost model* per
executable — FLOPs, bytes accessed (split per operand), and
transcendentals — which is the quantity the CUPTI DRAM counters are
used to derive in the reference's plots. Pairing it with measured wall
time gives achieved GB/s and FLOP/s utilization per kernel without any
driver hooks.

``compiled_counters(fn, *args)`` lowers + compiles ``fn`` and returns
the cost analysis; ``achieved(counters, ms)`` derives utilization
against the launch box's published peaks.
"""
from __future__ import annotations

__all__ = ["compiled_counters", "achieved"]


def compiled_counters(fn, *args, **kwargs) -> dict:
    """XLA cost analysis for ``fn(*args)``: flops, bytes_accessed (and
    per-operand splits), plus anything else the backend publishes.
    Returns {} when the backend does not expose an analysis."""
    import jax

    try:
        compiled = jax.jit(fn).lower(*args, **kwargs).compile()
        ca = compiled.cost_analysis()
        if ca is None:
            return {}
        # backends may return a list (one dict per computation)
        if isinstance(ca, (list, tuple)):
            ca = ca[0] if ca else {}
        return dict(ca)
    except Exception:
        return {}


def achieved(counters: dict, ms: float, hbm_gbps: float | None = None,
             peak_tflops: float | None = None) -> dict:
    """Derive achieved rates/utilization from cost counters + wall ms.

    Uses the launch box's published HBM and bf16 peaks when not given
    — the same normalization the reference's plots apply to CUPTI DRAM
    throughput. A device without peaks (the CPU) gets rates only.
    """
    out = {}
    secs = ms * 1e-3
    if secs <= 0 or not counters:
        return out
    flops = float(counters.get("flops", 0.0))
    byts = float(counters.get("bytes accessed", 0.0))
    if hbm_gbps is None or peak_tflops is None:
        from loops_tpu.tuning.launch_box import launch_params
        p = launch_params()
        hbm_gbps = hbm_gbps or p.hbm_gbps
        peak_tflops = peak_tflops or p.peak_bf16_tflops
    if byts:
        out["achieved_gbps"] = byts / secs / 1e9
        if hbm_gbps:
            out["hbm_utilization"] = out["achieved_gbps"] / hbm_gbps
    if flops:
        out["achieved_gflops"] = flops / secs / 1e9
        if peak_tflops:
            out["flops_utilization"] = (out["achieved_gflops"]
                                      / (peak_tflops * 1e3))
    return out
