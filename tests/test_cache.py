"""utils/cache.py: where the persistent compilation cache goes."""

import jax

from archon_tpu.utils import cache


def test_cache_dir_from_environment(tmp_path):
    assert cache.cache_dir({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) == str(tmp_path)


def test_cache_dir_default_is_repo_jax_cache():
    want = cache.DEFAULT_DIR
    assert cache.cache_dir({}) == str(want)
    assert want.name == ".jax_cache"
    assert (want.parent / "archon_tpu" / "utils" / "cache.py").is_file()


def test_enable_sets_only_the_chosen_dir(tmp_path, monkeypatch):
    """With the cache on, JAX's cache directory becomes the variable's and
    nothing else; the suite's switched-off cache stays off."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert not jax.config.jax_enable_compilation_cache  # conftest
    assert cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before
    try:
        jax.config.update("jax_enable_compilation_cache", True)
        assert cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_enable_compilation_cache", False)
        jax.config.update("jax_compilation_cache_dir", before)
    assert list(tmp_path.iterdir()) == []
