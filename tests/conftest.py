"""Test configuration.

By default the suite runs on the CPU: an 8-device virtual CPU mesh
validates the sharding paths, and Pallas kernels run in interpret mode.

Tests marked ``gpu`` need an NVIDIA card. They take the ``gpu_device``
fixture, which skips them where JAX finds none; nothing here decides at
import time which tests exist, so every xdist worker collects the same
tests. On the card, run them with

    BAYESSSM_GPU_TESTS=1 python -m pytest tests/ -m gpu -n 0

(``chip_smoke.py`` runs them in its last phase). That switch leaves JAX's
default backend attached instead of pinning the CPU; the rest of the
suite assumes the CPU mesh and is not meant to run in that mode.

Compilation cache: ``JAX_COMPILATION_CACHE_DIR`` when it is set,
otherwise ``<repo>/.jax_cache``.
"""

import os
import pathlib

import pytest

GPU_MODE = os.environ.get("BAYESSSM_GPU_TESTS") == "1"

if not GPU_MODE:
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not GPU_MODE:
    jax.config.update("jax_platforms", "cpu")

if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        str(pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"),
    )
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

if not GPU_MODE:
    assert jax.devices()[0].platform == "cpu"
    assert len(jax.devices()) == 8


@pytest.fixture
def gpu_device():
    """The first NVIDIA device; skips the test where JAX has none."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU: run with BAYESSSM_GPU_TESTS=1 on the card"
        )
    return device
