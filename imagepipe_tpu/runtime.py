"""Process set-up shared by the entry points that drive the card
(chip_smoke.py, bench.py): the persistent compile cache and the device
check.

The compile cache rule: where `JAX_COMPILATION_CACHE_DIR` is set, JAX reads
it itself and nothing here sets another directory; otherwise the cache goes
to one fixed, git-ignored path inside the checkout (`.jax_cache/`). The path
is part of the cache key, so a directory that moved would never hit.
"""

from __future__ import annotations

import os

__all__ = ["CHECKOUT_CACHE_DIR", "compile_cache_dir", "enable_compile_cache",
           "device_info", "require_gpu"]

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def compile_cache_dir(environ=None) -> tuple[str, bool]:
    """(directory, set_in_code): the env var's directory when it is set
    (JAX honours it without help), else the checkout's fixed path."""
    environ = os.environ if environ is None else environ
    env_dir = environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir, False
    return CHECKOUT_CACHE_DIR, True


def enable_compile_cache() -> str:
    """Apply the compile cache rule to this process; returns the directory."""
    import jax

    path, set_in_code = compile_cache_dir()
    if set_in_code:
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_info() -> dict:
    """The first device as JAX reports it, plus the device count."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """device_info(), or SystemExit when the default backend is not a GPU:
    a measurement taken elsewhere must not pass for a card number."""
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(f"no GPU found: JAX reports {info}")
    return info

