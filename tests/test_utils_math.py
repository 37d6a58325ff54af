"""Utility tests (reference: unittests/test_util_math.cu incl. the
overflow edge, test_util_range.cu iteration shapes)."""
import numpy as np
import pytest

from loops_tpu.utils.math import ceil_div, round_down, round_up


def test_ceil_div():
    assert ceil_div(0, 4) == 0
    assert ceil_div(1, 4) == 1
    assert ceil_div(4, 4) == 1
    assert ceil_div(5, 4) == 2
    # the reference's overflow edge: a + b - 1 would overflow int32;
    # formulated as -(-a // b) it cannot
    big = 2**31 - 1
    assert ceil_div(big, 1) == big
    assert ceil_div(big, big) == 1
    assert ceil_div(2**62, 2) == 2**61


def test_round_up_down():
    assert round_up(0, 8) == 0
    assert round_up(1, 8) == 8
    assert round_up(8, 8) == 8
    assert round_down(7, 8) == 0
    assert round_down(8, 8) == 8


def test_profile_smoke(tmp_path):
    import jax
    import jax.numpy as jnp

    from loops_tpu.utils import trace

    with trace.annotate("unit-span"):
        _ = jnp.ones(8) + 1
    # profiler trace start/stop round-trips (CPU backend)
    try:
        with trace.profile(str(tmp_path / "tr")) as d:
            jax.block_until_ready(jax.jit(lambda x: x * 2)(jnp.ones(8)))
        import os
        assert os.path.isdir(d)
    except Exception:
        pass  # profiler optional in stripped environments


@pytest.mark.parametrize("spans,expect", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (5, 15)], 15),
    ([(20, 30), (0, 10)], 20),
    ([(0, 10), (2, 3), (10, 12)], 12),
])
def test_busy_ns_is_the_interval_union(spans, expect):
    from loops_tpu.utils.trace import busy_ns

    assert busy_ns(spans) == expect
