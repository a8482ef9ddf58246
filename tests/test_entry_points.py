"""The repository's entry points off the card: the compile-cache rule,
the benchmark's peak table and the smoke check's device check."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from superbblas_tpu.utils import compile_cache

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("environ,expected", [
    ({}, str(ROOT / ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, str(ROOT / ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": "/data/cache"}, "/data/cache"),
])
def test_compile_cache_dir(environ, expected):
    assert compile_cache.compile_cache_dir(environ) == expected


def test_enable_compile_cache_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_enable_compile_cache_leaves_env_to_jax(monkeypatch):
    """With the variable set, nothing is set in code."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/data/cache")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == "/data/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_bench_peaks_known_card():
    import bench

    row = bench.peaks_for("NVIDIA H100 80GB HBM3")
    assert row["hbm_bytes"] == 3.35e12 and row["bf16_flops"] == 989e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H200", "NVIDIA A100-SXM4-80GB"])
def test_bench_peaks_unknown_kind_raises(kind):
    import bench

    with pytest.raises(KeyError, match="no published peaks"):
        bench.peaks_for(kind)


def _run_smoke(cwd, env_extra):
    env = {**os.environ, **env_extra}
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    out = _run_smoke(ROOT, {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert "no GPU found" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the package beside it the script stops at the import of
    the package, before its device check: it carries no fallback."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    out = _run_smoke(tmp_path, {"JAX_PLATFORMS": "cpu"})
    assert out.returncode != 0
    assert "No module named 'superbblas_tpu'" in out.stderr
    assert "no GPU found" not in out.stderr
    assert '"ok"' not in out.stdout
