"""Compile-cache placement (core/compile_cache.use_compile_cache)."""

import jax
import pytest

from mundy_tpu.core import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_is_left_to_jax(monkeypatch, restore_cache_dir, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.use_compile_cache() == str(tmp_path)
    # nothing set in code: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir is None


def test_default_is_repo_local(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.use_compile_cache()
    assert path == compile_cache.DEFAULT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == path
    assert path.endswith("/.jax_cache")
    assert compile_cache.REPO_ROOT.rstrip("/") == path[:-len("/.jax_cache")]
