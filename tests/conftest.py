"""Test environment: CPU backend with 8 virtual devices, float64 enabled.

Mirrors SURVEY.md section 4's port strategy: parity math runs in f64 on CPU
(the 1e-6 bar realistically needs f64); multi-device sharding tests run on
the virtual CPU mesh, so no accelerator is needed.  The backend is the CPU
unless ``JAX_PLATFORMS`` names another: tests that need the GPU carry the
``gpu`` marker and skip on the CPU (see tests/test_chip_smoke.py); run them
on a GPU machine with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Persistent XLA compile cache: the suite's wall-clock is dominated by
# shard_map compiles, and the graphs are identical across runs, so warm
# re-runs collapse.  The cache lives where JAX_COMPILATION_CACHE_DIR says,
# else in <checkout>/.jax_cache (gpr_tpu.utils.use_compile_cache).  The AOT
# loader logs a benign per-load E-line about the XLA-internal
# `prefer-no-scatter/gather` pseudo-features (compile-time tuning flags the
# host-feature probe never reports; the real ISA feature sets match) —
# silence C++ logs unless the caller already chose a level.  Opt out with
# GPR_TPU_TEST_CACHE=0.
_use_cache = os.environ.get("GPR_TPU_TEST_CACHE", "1") != "0"
if _use_cache:
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

import jax  # noqa: E402

# In case jax was imported before this file set JAX_PLATFORMS.
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)
if _use_cache:
    from gpr_tpu.utils import use_compile_cache  # noqa: E402

    use_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)
