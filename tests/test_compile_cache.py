"""utils/compile_cache.py: JAX_COMPILATION_CACHE_DIR wins with no dir set
in code; otherwise one fixed, git-ignored directory inside the checkout."""

import os

import jax

from raytracer_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _record_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_env_var_is_honoured_with_no_dir_set_in_code(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert compile_cache.enable_persistent_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 0.0


def test_default_is_a_fixed_path_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_updates(monkeypatch)
    path = compile_cache.enable_persistent_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert calls["jax_compilation_cache_dir"] == path
    assert os.path.isdir(path)


def test_default_cache_dir_is_git_ignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = f.read().split()
    assert ".jax_cache/" in ignored
    assert compile_cache.DEFAULT_CACHE_DIR == os.path.join(REPO,
                                                           ".jax_cache")
