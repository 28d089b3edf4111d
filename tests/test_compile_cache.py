"""The persistent compile cache's location."""

import pytest

from pbf_sph_tpu.utils import compile_cache


@pytest.mark.parametrize("env", ["/somewhere/else", None])
def test_compile_cache_dir(monkeypatch, env):
    if env is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        repo = compile_cache.DEFAULT_DIR.parent
        assert (repo / "pbf_sph_tpu").is_dir()
        assert compile_cache.compile_cache_dir() == str(repo / ".jax_cache")
        assert compile_cache.compile_cache_dir("tests") == str(
            repo / ".jax_cache" / "tests")
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, env)
        assert compile_cache.compile_cache_dir() == env
        assert compile_cache.compile_cache_dir("tests") == env
