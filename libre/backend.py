"""The one module that decides how the program runs on the device it finds.

* ``gpu`` (an NVIDIA card): compiled kernels where one beat plain XLA on
  the card (the bricked plane march, ops/shearwarp_bricked.py).
* ``cpu``: plain XLA everywhere.  Tests may still ask a kernel wrapper
  for interpret mode explicitly.
* anything else: ``ValueError``.  There is no interpreter fallback and no
  silent switch to the CPU.

It also owns JAX's persistent compilation cache: the directory named by
``JAX_COMPILATION_CACHE_DIR`` when that is set, else a fixed directory
inside the checkout (listed in ``.gitignore``).  A fixed path matters:
the cache key includes it, so a directory that moves never hits.
"""

from __future__ import annotations

import os
import pathlib

import jax

SUPPORTED_PLATFORMS = ("gpu", "cpu")
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / ".jax_cache"


def platform() -> str:
    """The platform of the default device: "gpu" or "cpu"."""
    p = jax.devices()[0].platform
    if p not in SUPPORTED_PLATFORMS:
        raise ValueError(
            f"unsupported JAX platform {p!r}; libre runs on "
            f"{' or '.join(SUPPORTED_PLATFORMS)}"
        )
    return p


def use_gpu_kernels() -> bool:
    """True when hand-written GPU kernels run compiled (a card is present)."""
    return platform() == "gpu"


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    and return that directory.  Call before the first compilation."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
