"""Test harness: JAX on a virtual 8-device CPU mesh.

The host-device-count flag must be in XLA_FLAGS before jax is imported,
and the platform is forced through jax.config before any computation:
the CPU, unless JAX_PLATFORMS names another (``JAX_PLATFORMS=cuda`` runs
the ``gpu``-marked tests on the card, README.md).  The persistent compile
cache stays off, so test runs write nothing into the checkout.
"""

import os

import pytest

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def gpu():
    """The first GPU device.  Tests marked ``gpu`` take this fixture, so
    whether a card is present is decided when the test runs, never at
    import or collection."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "tests/ -m gpu")
