"""The accelerator a measurement runs on, and the compile cache.

``bench.py`` and ``chip_smoke.py`` time and check the system on an
NVIDIA GPU only: a run that finds no GPU stops instead of measuring the
CPU. Every result they print names the device it came from.
"""

from __future__ import annotations

import os
import pathlib
import subprocess

__all__ = ["require_gpu", "card_name_and_power_limit", "use_compile_cache"]


def require_gpu():
    """JAX's first device, which must be an NVIDIA GPU.

    Raises SystemExit (non-zero) when JAX has no GPU backend.
    """
    import jax

    try:
        device = jax.devices()[0]
    except RuntimeError as err:  # no backend could be initialised
        raise SystemExit(f"no accelerator: {err}") from None
    if device.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default device is {device.platform} "
            f"({device.device_kind}); this measures the GPU only"
        )
    return device


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card, one
    line each. A child process reads it, so no second JAX client opens
    the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def use_compile_cache(root) -> None:
    """Keep JAX's persistent compile cache in ``JAX_COMPILATION_CACHE_DIR``
    when it is set (JAX reads it itself), otherwise in ``<root>/.jax_cache``.
    """
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update(
            "jax_compilation_cache_dir",
            str(pathlib.Path(root).resolve() / ".jax_cache"),
        )
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
