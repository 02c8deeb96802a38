"""Test configuration.

With no platform asked for (JAX_PLATFORMS unset or "cpu"), the suite runs on
a virtual 8-device CPU mesh: sharding correctness is validated on XLA's
host-platform virtual devices. With another platform asked for (for example
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` on the card), JAX is
left alone so the card-marked tests reach the card.
"""

import os

import pytest

if os.environ.get("JAX_PLATFORMS", "cpu") in ("", "cpu"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

    import jax

    jax.config.update("jax_platforms", "cpu")
    assert jax.default_backend() == "cpu"
    assert len(jax.devices()) == 8, jax.devices()


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none. Decided
    here, at run time, never while a module is imported."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX default device is {dev.platform})")
    return dev
