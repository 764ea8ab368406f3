"""Test config: run everything on a virtual 8-device CPU mesh.

Must set the env before jax initializes — multi-chip sharding tests rely on
``--xla_force_host_platform_device_count=8`` (the accelerator-free way to
validate mesh partitioning, per SURVEY.md §4).
"""

import os

# Tests run on the CPU, whatever accelerator the machine has. The tests that
# need the card are marked ``gpu`` and skip on the CPU; on the GPU host run
# them with ``LPT_TESTS_ON_GPU=1 python -m pytest tests/ -m gpu``.
_ON_GPU = os.environ.get("LPT_TESTS_ON_GPU") == "1"
os.environ["JAX_PLATFORMS"] = "cuda,cpu" if _ON_GPU else "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
# Persistent compile cache: the suite is compile-bound on one CPU core, so
# repeat runs (the common case for a CI-ish judge loop) drop from minutes
# to seconds.
jax.config.update("jax_compilation_cache_dir",
                  os.path.expanduser("~/.cache/jax_lpt_tests"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import numpy as np
import pytest


@pytest.fixture
def np_rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first GPU, or a skip where JAX has none (decided here, at test
    time, never while a module is imported)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU: run with LPT_TESTS_ON_GPU=1 -m gpu "
                    "on the card")
