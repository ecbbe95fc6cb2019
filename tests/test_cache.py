"""Placement of the persistent compilation cache.

With ``JAX_COMPILATION_CACHE_DIR`` set, the code sets nothing and JAX uses
that directory; without it, the cache goes to a fixed, git-ignored path in
the checkout — never a temp dir, pid or time, which would never hit again.
"""

import os
import subprocess
import sys

import jax
import pytest

from tpulbm.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def restore_cache_dir():
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_env_var_wins_and_code_sets_nothing(monkeypatch, tmp_path,
                                            restore_cache_dir):
    monkeypatch.setenv(cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compilation_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_path_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    got = cache.enable_compilation_cache()
    assert got == cache.DEFAULT_DIR == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    # the same path on every call: part of the cache key
    assert cache.enable_compilation_cache() == got


def test_default_dir_is_git_ignored():
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


@pytest.mark.parametrize("env_dir", [True, False], ids=["env", "default"])
def test_cli_process_uses_the_placement(tmp_path, env_dir):
    """A fresh process through the CLI's cache set-up ends with JAX pointed
    at the env var's directory, or at the in-checkout default."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop(cache.ENV_VAR, None)
    if env_dir:
        env[cache.ENV_VAR] = str(tmp_path / "cc")
    code = ("import jax\n"
            "from tpulbm.utils.cache import enable_compilation_cache\n"
            "enable_compilation_cache()\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    want = str(tmp_path / "cc") if env_dir else os.path.join(REPO, ".jax_cache")
    assert proc.stdout.strip() == want
