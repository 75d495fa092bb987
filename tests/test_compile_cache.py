"""The persistent compile cache rule (utils.enable_compile_cache): an
explicit $JAX_COMPILATION_CACHE_DIR is used as is and nothing else is
set; otherwise the cache lives at a fixed path inside the checkout."""

import jax

from nerf_rs_tpu.utils import REPO_ROOT, enable_compile_cache


def test_env_var_wins_and_nothing_else_is_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_inside_the_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = enable_compile_cache()
        assert path == str(REPO_ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert (REPO_ROOT / "nerf_rs_tpu").is_dir()
        assert ".jax_cache/" in (REPO_ROOT / ".gitignore").read_text().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
