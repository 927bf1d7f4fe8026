"""Test bootstrap: force a virtual 8-device CPU platform before JAX imports.

Multi-device behavior is tested without several cards via JAX's standard fake:
``--xla_force_host_platform_device_count=8`` (SURVEY.md §4.4). The GPU runs
are ``chip_smoke.py`` and ``bench.py``, which do not import this file. Tests
marked ``gpu`` take the ``gpu_device`` fixture, which skips them where JAX has
no GPU — decided when the test runs, never at import.
"""

import os
import sys

# The CPU is always the tests' default backend (8 virtual devices). A GPU
# platform the environment names stays reachable beside it, for the tests
# marked ``gpu`` (``jax.devices("gpu")``).
_extra = [p for p in os.environ.get("JAX_PLATFORMS", "").split(",")
          if p and p != "cpu"]
_PLATFORMS = ",".join(["cpu"] + _extra)
os.environ["JAX_PLATFORMS"] = _PLATFORMS
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", _PLATFORMS)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip where JAX has none."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run on the card: python "
                    "chip_smoke.py)")
    return devs[0]
