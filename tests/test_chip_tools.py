"""The measurement tooling on the CPU: the compile-cache location, the GPU
smoke script's refusal of a CPU backend, and its comparison logic (the
four-device mesh path on virtual CPU devices, the TAMOLS GPU-vs-CPU phase)."""
import importlib.util
import os
import tempfile
from pathlib import Path

import pytest

from quadruped_pympc_tamols.utils import compile_cache

REPO = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_compile_cache_honours_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.compile_cache_dir() == str(tmp_path)
    env = compile_cache.compile_cache_env({"PATH": "/bin"})
    assert env["JAX_COMPILATION_CACHE_DIR"] == str(tmp_path)
    assert env["PATH"] == "/bin"


def test_compile_cache_default_is_fixed_repo_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.compile_cache_dir()
    assert path == str(REPO / ".jax_cache") == compile_cache.compile_cache_dir()
    assert not path.startswith(tempfile.gettempdir())
    assert str(os.getpid()) not in path
    env = compile_cache.compile_cache_env({})
    assert env["JAX_COMPILATION_CACHE_DIR"] == path
    assert float(env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"]) > 0


def test_chip_smoke_exits_nonzero_without_gpu(capsys):
    smoke = _chip_smoke()
    with pytest.raises(SystemExit) as e:
        smoke.main([])
    assert e.value.code not in (0, None)
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "needs an NVIDIA GPU" in out.err


def test_chip_smoke_four_device_comparison_on_cpu_mesh():
    """The --four phase's logic on 4 of the virtual CPU devices: sharded fleet
    and sharded solver against one device, shards on distinct devices."""
    lines = _chip_smoke().phase_four(4, num_samples=48, scenarios_per_device=1)
    assert any("shards on 4 devices" in line for line in lines)
    assert any("zero noise: GRFs match one device" in line for line in lines)


def test_chip_smoke_tamols_phase_on_cpu():
    lines = _chip_smoke().phase_tamols(n_cases=2)
    assert "2 perlin cases, 13x7 window" in lines[0]
