"""Run-time plumbing: compile-cache placement, the GPU check of
chip_smoke.py, and multi-host initialization failures."""

import logging
import os
import subprocess
import sys

import jax
import pytest

from climt_tpu.parallel import distributed
from climt_tpu.utils.compile_cache import (
    ENV_VAR, compile_cache_dir, enable_compile_cache)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update('jax_compilation_cache_dir', saved)


def test_compile_cache_honours_env(monkeypatch, tmp_path,
                                   restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set, no directory is set in code."""
    env_dir = str(tmp_path / 'from_env')
    assert compile_cache_dir(REPO, {ENV_VAR: env_dir}) is None
    monkeypatch.setenv(ENV_VAR, env_dir)
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache(str(tmp_path)) == env_dir
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / '.jax_cache').exists()


def test_compile_cache_fixed_path(monkeypatch, tmp_path, restore_cache_dir):
    """Without the variable the cache is <root>/.jax_cache, every time."""
    monkeypatch.delenv(ENV_VAR, raising=False)
    expected = os.path.join(str(tmp_path), '.jax_cache')
    assert compile_cache_dir(str(tmp_path), {}) == expected
    assert enable_compile_cache(str(tmp_path)) == expected
    assert enable_compile_cache(str(tmp_path)) == expected
    assert jax.config.jax_compilation_cache_dir == expected
    assert os.path.isdir(expected)


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke run exits non-zero and prints no result."""
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    proc = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert 'no GPU found' in proc.stderr
    assert '"ok"' not in proc.stdout


def _failing_initialize(**kwargs):
    raise RuntimeError('coordinator unreachable')


def test_distributed_with_coordinator_raises(monkeypatch):
    monkeypatch.setattr(jax.distributed, 'initialize', _failing_initialize)
    monkeypatch.setattr(distributed, '_initialized', False)
    with pytest.raises(RuntimeError, match='unreachable'):
        distributed.initialize_distributed(
            'localhost:1', num_processes=2, process_id=0)


def test_distributed_without_arguments_warns(monkeypatch, caplog):
    monkeypatch.setattr(jax.distributed, 'initialize', _failing_initialize)
    monkeypatch.setattr(distributed, '_initialized', False)
    with caplog.at_level(logging.WARNING, logger=distributed.__name__):
        assert distributed.initialize_distributed() == jax.process_count()
    assert 'single-process' in caplog.text
    assert not distributed._initialized
