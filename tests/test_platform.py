"""Backend selection, the interpret-mode helper and the compile cache
(loops_tpu/utils/platform.py)."""
import os

import pytest

from loops_tpu.utils import platform


@pytest.mark.parametrize("backend,interpret", [("cpu", True),
                                               ("gpu", False)])
def test_pallas_interpret_by_backend(backend, interpret):
    assert platform.pallas_interpret(backend) is interpret


@pytest.mark.parametrize("backend", ["tpu", "rocm", "metal"])
def test_pallas_interpret_refuses_other_backends(backend):
    with pytest.raises(RuntimeError):
        platform.pallas_interpret(backend)


def test_pallas_interpret_default_follows_jax():
    # the test session runs on the CPU
    assert platform.pallas_interpret() is True


class _Recorder:
    def __init__(self, backend):
        self.calls, self.backend = [], backend

    def install(self, monkeypatch):
        import jax

        monkeypatch.setattr(jax.config, "update",
                            lambda k, v: self.calls.append((k, v)))
        monkeypatch.setattr(jax, "default_backend", lambda: self.backend)
        return self


@pytest.mark.parametrize("env,want,backend", [
    ({"LOOPS_PLATFORM": "cpu"}, "cpu", "cpu"),
    ({"JAX_PLATFORMS": "cpu"}, "cpu", "cpu"),
    ({"JAX_PLATFORMS": "cuda,cpu"}, "cuda", "gpu"),
    ({}, "cuda", "gpu"),
])
def test_ensure_platform_selects(monkeypatch, env, want, backend):
    for k in ("LOOPS_PLATFORM", "JAX_PLATFORMS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rec = _Recorder(backend).install(monkeypatch)
    assert platform.ensure_platform() == backend
    assert rec.calls == [("jax_platforms", want)]


def test_ensure_platform_fails_loudly_without_gpu(monkeypatch):
    """Asked for the card, got the CPU: an error, not a silent run."""
    for k in ("LOOPS_PLATFORM", "JAX_PLATFORMS"):
        monkeypatch.delenv(k, raising=False)
    _Recorder("cpu").install(monkeypatch)
    with pytest.raises(RuntimeError, match="gpu"):
        platform.ensure_platform()


def test_ensure_platform_names_a_missing_backend(monkeypatch):
    import jax

    for k in ("LOOPS_PLATFORM", "JAX_PLATFORMS"):
        monkeypatch.delenv(k, raising=False)
    _Recorder("gpu").install(monkeypatch)

    def no_backend():
        raise AssertionError("no backend initialised")
    monkeypatch.setattr(jax, "default_backend", no_backend)
    with pytest.raises(RuntimeError, match="no 'gpu' device"):
        platform.ensure_platform()


def test_ensure_platform_rejects_unknown(monkeypatch):
    monkeypatch.setenv("LOOPS_PLATFORM", "tpu")
    _Recorder("cpu").install(monkeypatch)
    with pytest.raises(RuntimeError):
        platform.ensure_platform()


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    rec = _Recorder("cpu").install(monkeypatch)
    assert platform.enable_compilation_cache() == str(tmp_path / "c")
    assert os.path.isdir(tmp_path / "c")
    # JAX reads the variable itself; no other directory is set
    assert all(k != "jax_compilation_cache_dir" for k, _ in rec.calls)


def test_compile_cache_off_on_cpu_without_env(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    rec = _Recorder("cpu").install(monkeypatch)
    assert platform.enable_compilation_cache() == ""
    assert rec.calls == []


def test_compile_cache_default_is_fixed_and_ignored(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    rec = _Recorder("gpu").install(monkeypatch)
    path = platform.enable_compilation_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in rec.calls
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
