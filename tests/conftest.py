"""Test config: the CPU with 8 virtual devices, set BEFORE jax import.

This is the standard trick for testing multi-device sharding without
several accelerators (SURVEY.md §4); ``chip_smoke.py --chips 4`` runs the
multi-card path on GPUs. A platform already named in JAX_PLATFORMS is
kept, so ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs the
``gpu``-marked tests on the card; elsewhere they skip.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)


@pytest.fixture(autouse=True)
def _reset_silent():
    """CLI tests that pass -silent set a process-global flag; training
    behavior must not depend on which test ran last (silent mode batches
    host syncs), so reset it around every test."""
    from ranklib_tpu.utils.logging import set_silent

    set_silent(False)
    yield
    set_silent(False)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` run compiled kernels: skip without a GPU
    (decided here, at run time — never while modules are imported)."""
    if request.node.get_closest_marker("gpu"):
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip("needs an NVIDIA GPU (compiled Triton kernel)")

