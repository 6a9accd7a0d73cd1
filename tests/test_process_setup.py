"""Process-level setup: the one compile-cache setting, and entry points that
fail instead of falling back to another device."""

import os
import subprocess
import sys

import jax
import pytest

import zkstark_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_honours_jax_compilation_cache_dir(monkeypatch, tmp_path):
    updates = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update", lambda *a: updates.append(a))
    assert zkstark_tpu.compilation_cache_dir() == str(tmp_path)
    assert updates == []  # JAX reads the variable itself; no second setting


def test_cache_default_is_repo_dot_jax_cache(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(REPO, ".jax_cache")
    assert zkstark_tpu.DEFAULT_CACHE_DIR == want
    assert zkstark_tpu.compilation_cache_dir() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_chip_smoke_fails_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout  # no result line


def test_dryrun_multichip_raises_when_devices_are_missing():
    import __graft_entry__ as g

    with pytest.raises(ValueError, match="need 64 devices"):
        g.dryrun_multichip(64)
