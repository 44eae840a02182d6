"""Placement of the persistent compilation cache (pysdr_tpu/utils.py)."""

import os
import subprocess
import sys

from pysdr_tpu import utils

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import jax, jax.numpy as jnp
from pysdr_tpu.utils import enable_compilation_cache
print(enable_compilation_cache())
print(jax.config.jax_compilation_cache_dir)
jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(8)).block_until_ready()
"""


def _run(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    p = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    return p.stdout.split()[:2]


def test_default_cache_dir_is_fixed_in_checkout():
    assert utils.DEFAULT_CACHE_DIR == os.path.join(ROOT, ".jax_cache")


def test_env_var_places_the_cache(tmp_path):
    d = str(tmp_path / "cc")
    ret, cfg = _run(d)
    assert ret == cfg == d
    assert os.listdir(d), "nothing cached in JAX_COMPILATION_CACHE_DIR"


def test_without_env_var_cache_is_in_checkout():
    ret, cfg = _run(None)
    assert ret == cfg == utils.DEFAULT_CACHE_DIR
    assert os.listdir(utils.DEFAULT_CACHE_DIR)
