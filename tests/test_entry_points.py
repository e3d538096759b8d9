"""Entry points around the matcher: the compile-cache location, the
workload generators, and the scripts that must refuse to run without a
GPU."""
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from pfac_tpu.runtime import compile_cache
from pfac_tpu.tools import workloads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path, restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", "unchanged")
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == "unchanged"


def test_compile_cache_default_is_in_the_checkout(monkeypatch,
                                                  restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    path = compile_cache.enable()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def _run(args, cwd, **env):
    e = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    e.update(env)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_scripts_refuse_the_cpu(script):
    r = _run([script], REPO, JAX_PLATFORMS="cpu")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path), JAX_PLATFORMS="cpu")
    assert r.returncode != 0
    assert r.stdout == ""


def test_planted_text_share():
    pats = [b"alpha", b"beta\x00", b"g"]
    rng = np.random.default_rng(0)
    buf = workloads.planted_text(rng, pats, 20000, share=0.1)
    assert buf.dtype == np.uint8 and buf.shape == (20000,)
    assert bytes(buf).count(b"alpha") > 50


def test_generators_are_reproducible():
    pats = workloads.snort_like_patterns()
    assert pats == workloads.snort_like_patterns()
    assert 1900 < len(pats) <= 2000 and max(map(len, pats)) <= 243
    a = workloads.virus_dense(np.random.default_rng(1), pats, 5000)
    b = workloads.virus_dense(np.random.default_rng(1), pats, 5000)
    assert a.shape == (5000,) and np.array_equal(a, b)
