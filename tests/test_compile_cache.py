"""The compile-cache rule: JAX_COMPILATION_CACHE_DIR wins when set (the
package then sets no directory); otherwise one fixed directory inside the
checkout — whatever JAX_PLATFORMS says."""
import os
import subprocess
import sys

import jax
import pytest

import sdflib_tpu

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fixed_directory_inside_the_checkout():
    assert sdflib_tpu.COMPILE_CACHE_DIR == os.path.join(CHECKOUT, ".jax_cache")
    assert sdflib_tpu.compile_cache_dir({}) == sdflib_tpu.COMPILE_CACHE_DIR
    # the platform plays no part
    assert (sdflib_tpu.compile_cache_dir({"JAX_PLATFORMS": "cuda"})
            == sdflib_tpu.COMPILE_CACHE_DIR)


def test_env_var_and_opt_out_set_no_directory():
    assert sdflib_tpu.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}) is None
    assert sdflib_tpu.compile_cache_dir(
        {"SDFLIB_NO_COMPILE_CACHE": "1"}) is None


def test_this_process_follows_the_rule():
    want = os.environ.get("JAX_COMPILATION_CACHE_DIR") or (
        None if os.environ.get("SDFLIB_NO_COMPILE_CACHE")
        else sdflib_tpu.COMPILE_CACHE_DIR)
    assert jax.config.jax_compilation_cache_dir == want


@pytest.mark.parametrize("env_dir", [None, "cache_from_env"])
def test_import_applies_the_rule(tmp_path, env_dir):
    """A fresh process with JAX_PLATFORMS unset: the cache turns on at the
    checkout directory, or stays where the variable points."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR",
                        "SDFLIB_NO_COMPILE_CACHE")}
    env["PYTHONPATH"] = CHECKOUT
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    out = subprocess.run(
        [sys.executable, "-c",
         "import sdflib_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        env=env, capture_output=True, text=True, check=True, cwd=tmp_path,
    ).stdout.strip().splitlines()[-1]
    want = (sdflib_tpu.COMPILE_CACHE_DIR if env_dir is None
            else str(tmp_path / env_dir))
    assert out == want
