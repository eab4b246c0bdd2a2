"""Test harness configuration.

The suite runs on the CPU with 8 virtual devices, so multi-device sharding
is exercised without several cards (SURVEY.md §4: "Multi-chip without
hardware").  ``JAX_PLATFORMS`` defaults to ``cpu``; a run that sets it
itself (``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` on a
machine with a card) keeps its choice.

Tests that need the card carry the ``gpu`` marker; the ``gpu`` fixture
below skips them when JAX finds no GPU.  The decision is made inside the
fixture, never at import, so every xdist worker collects the same tests.
"""

import os
import sys

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402  (after the environment above)

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(autouse=True)
def gpu(request):
    """Skips a ``gpu``-marked test when JAX's default backend is no GPU."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip("needs an NVIDIA GPU (JAX found none)")
