"""One compile-cache rule for cli.py, bench.py and chip_smoke.py."""

import os

import jax

from hercules_tpu.utils import compile_cache


def test_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    assert calls == []          # nothing set in code


def test_default_is_repo_jax_cache(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    path = compile_cache.setup_compile_cache()
    assert path == os.path.join(compile_cache.REPO_ROOT, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(compile_cache.REPO_ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_repo_root_holds_the_package():
    assert os.path.isdir(os.path.join(compile_cache.REPO_ROOT,
                                      "hercules_tpu"))
