"""The accelerator switch and the persistent compile cache.

Every dispatch that depends on the device asks ``platform()``: "gpu" runs
the Pallas kernels compiled for the card (ops/fec/turbo_decoder_pallas2.py,
ops/fec/viterbi_pallas.py), "cpu" runs their plain-JAX formulations.
Any other JAX platform is refused rather than silently given a fallback.
"""

from __future__ import annotations

import os

#: JAX platform names this program runs on.
PLATFORMS = ("gpu", "cpu")

#: The persistent compile cache used when JAX_COMPILATION_CACHE_DIR is not
#: set: one fixed path inside the checkout (gitignored), so that every
#: entry point of one checkout shares it.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def platform() -> str:
    """The default JAX backend: "gpu" or "cpu"; anything else raises."""
    import jax

    name = jax.default_backend()
    if name not in PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {name!r}: this program runs on an "
            f"NVIDIA GPU or on the CPU (JAX_PLATFORMS=cpu)")
    return name


def configure_compile_cache() -> str:
    """Enable JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    directory is set here; otherwise the cache sits at DEFAULT_CACHE_DIR.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not env:
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return env or DEFAULT_CACHE_DIR
