"""Launch-box resolution + timer/bench utilities."""
import pytest

from loops_tpu.tuning import LaunchParams, launch_params
from loops_tpu.utils.bench import chained_ms, chained_ms_pair
from loops_tpu.utils.timer import Timer, time_fn


class FakeDevice:
    def __init__(self, kind, platform="gpu"):
        self.device_kind = kind
        self.platform = platform


def test_launch_params_first_match_wins():
    p = launch_params(FakeDevice("NVIDIA H100 80GB HBM3"))
    assert p.hbm_gbps == 3350.0
    assert p.peak_bf16_tflops == 989.0
    assert "data sheet" in p.source


@pytest.mark.parametrize("kind", ["NVIDIA A100-SXM4-80GB", "Unknown Accelerator 9000",
                                  "", "NVIDIA H200"])
def test_launch_params_fallback(kind):
    """A device the table does not know is an error, not a default."""
    with pytest.raises(LookupError):
        launch_params(FakeDevice(kind))


def test_launch_params_cpu_backend():
    p = launch_params(FakeDevice("anything", platform="cpu"))
    assert p.spmv_block == 64  # tiny blocks exercise multi-block paths
    assert p.hbm_gbps is None and p.peak_bf16_tflops is None


def test_launch_params_resolves_current_device():
    assert isinstance(launch_params(), LaunchParams)


def test_launch_params_knobs_fit_the_kernels():
    """Every row's kernel knobs satisfy the BCSR kernel's static
    contract: a power-of-two feature tile of at least 16."""
    from loops_tpu.tuning.launch_box import _TABLE

    for _, p in _TABLE:
        assert p.spmm_block_f >= 16
        assert p.spmm_block_f & (p.spmm_block_f - 1) == 0


def test_timer_and_chained():
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: x * 1.5 + 1.0)
    x = jnp.ones((8, 128))
    t = Timer().start()
    y = f(x)
    assert t.stop(y) >= 0.0
    assert time_fn(f, x, iters=3) >= 0.0
    assert chained_ms(f, x, iters=4) >= 0.0

    g = jax.jit(lambda x: jnp.sum(x, axis=0))  # shape-changing
    assert chained_ms_pair(g, x, iters=4) >= 0.0


def test_compiled_counters_and_achieved():
    """XLA cost-analysis counters + achieved-rate derivation (the
    CUPTI-metrics analog, reference benchmarks/spmv/work_oriented.cu:
    37-44)."""
    import jax.numpy as jnp

    from loops_tpu.utils.counters import achieved, compiled_counters

    x = jnp.ones((256, 256))
    c = compiled_counters(lambda a, b: a @ b, x, x)
    if not c:  # backend without cost analysis: utility degrades to {}
        assert achieved(c, 1.0) == {}
        return
    assert c.get("flops", 0) >= 2 * 256**3 * 0.9
    a = achieved(c, 1.0, hbm_gbps=3350.0, peak_tflops=989.0)
    assert 0 < a["hbm_utilization"] < 1
    assert 0 < a["flops_utilization"] < 1
