"""Tracing / profiling helpers.

The reference's observability is device-event timers + NVBench/CUPTI
counters (SURVEY.md §5). Here: the JAX profiler for device traces, chained timers for wall numbers, and the CSV row
contract the examples print (``kernel,dataset,rows,cols,nnzs,elapsed``).
"""
from __future__ import annotations

import contextlib
import os

_DEFAULT_LOGDIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "traces")


@contextlib.contextmanager
def profile(logdir: str = _DEFAULT_LOGDIR):
    """Capture a JAX profiler trace viewable in TensorBoard/XProf."""
    import jax

    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span visible in profiler traces (decorator/context)."""
    import jax

    return jax.profiler.TraceAnnotation(name)


def csv_row(kernel: str, dataset: str, rows: int, cols: int, nnz: int,
            elapsed_ms: float, **extra) -> str:
    """The sweep-log CSV contract (reference:
    examples/spmv/thread_mapped.cu:42-44)."""
    base = f"{kernel},{dataset},{rows},{cols},{nnz},{elapsed_ms:.5f}"
    if extra:
        base += "," + ",".join(str(v) for v in extra.values())
    return base


def busy_ns(intervals) -> int:
    """Length of the union of ``(start_ns, end_ns)`` intervals — the
    time a device was running at least one operation."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return int(total)


def device_breakdown(xplane_path: str, prefix: str = "/device:GPU"):
    """Reduce a profiler ``.xplane.pb`` to per-device numbers.

    Returns ``{plane: dict(window_ns, busy_ns, idle_share, kernels)}``
    where ``kernels`` maps event name -> summed device ns, over every
    line of each plane whose name starts with ``prefix``.
    """
    from jax.profiler import ProfileData

    out = {}
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith(prefix):
            continue
        spans, kernels = [], {}
        for line in plane.lines:
            for ev in line.events:
                spans.append((ev.start_ns, ev.end_ns))
                kernels[ev.name] = kernels.get(ev.name, 0) + ev.duration_ns
        if not spans:
            continue
        window = max(e for _, e in spans) - min(s for s, _ in spans)
        busy = busy_ns(spans)
        out[plane.name] = dict(window_ns=int(window), busy_ns=busy,
                               idle_share=1 - busy / max(window, 1),
                               kernels=kernels)
    return out
