"""Where compiled programs land: JAX_COMPILATION_CACHE_DIR when it is
set, else the fixed in-checkout directory. Each case runs in a fresh
process (JAX's cache settings are process-global)."""

import os
import subprocess
import sys

from ranklib_tpu.utils import compile_cache

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import jax, jax.numpy as jnp
from ranklib_tpu.utils.compile_cache import enable_compilation_cache
enable_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
print(jax.config.jax_compilation_cache_dir)
jax.jit(lambda x: jnp.sin(x) * {salt})(jnp.ones(3)).block_until_ready()
"""


def _run(env_extra, salt):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "RANKLIB_TPU_NO_CACHE")}
    env.update(env_extra, JAX_PLATFORMS="cpu", PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE.format(salt=salt)],
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    return out.stdout.strip().splitlines()[-1]


def test_env_dir_wins_and_receives_programs(tmp_path):
    d = tmp_path / "xla_cache"
    assert _run({"JAX_COMPILATION_CACHE_DIR": str(d)}, salt=3.0) == str(d)
    assert d.is_dir() and any(d.iterdir())


def test_default_dir_is_in_checkout(tmp_path):
    assert compile_cache.DEFAULT_DIR == os.path.join(_REPO, ".jax_cache")
    before = set(os.listdir(compile_cache.DEFAULT_DIR)) if os.path.isdir(
        compile_cache.DEFAULT_DIR) else set()
    assert _run({}, salt=float(os.getpid())) == compile_cache.DEFAULT_DIR
    after = set(os.listdir(compile_cache.DEFAULT_DIR))
    assert after - before                     # a new program landed there


def test_no_cache_switch_sets_nothing():
    assert _run({"RANKLIB_TPU_NO_CACHE": "1"}, salt=5.0) in ("", "None")
