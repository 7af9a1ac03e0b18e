"""Test harness config: run everything on a virtual 8-device CPU mesh.

Multi-chip code paths are exercised without several cards via
``--xla_force_host_platform_device_count`` (SURVEY.md §4 item 5).  The
exception is ``pytest -m gpu``: the tests marked ``gpu`` run on JAX's
default backend, a GPU (``python chip_smoke.py`` runs them there).  The
platform is fixed in pytest_configure, before any test module imports jax.
"""

import os

import numpy as np
import pytest


def pytest_configure(config):
    if (config.getoption("markexpr") or "").strip() == "gpu":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Tests marked ``gpu`` need a GPU; decided here, at run time, so every
    worker collects the same tests."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU (JAX backend is {platform})")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def synthetic_video(t, h, w, seed=0):
    """Deterministic moving-gradient + noise test clip, uint8 (T, H, W)."""
    rng = np.random.default_rng(seed)
    tt = np.arange(t)[:, None, None]
    yy = np.arange(h)[None, :, None]
    xx = np.arange(w)[None, None, :]
    base = (
        96.0
        + 64.0 * np.sin(2 * np.pi * (xx + 3 * tt) / 32.0)
        + 48.0 * np.cos(2 * np.pi * (yy + 2 * tt) / 24.0)
    )
    noise = rng.normal(0, 6.0, size=(t, h, w))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


@pytest.fixture
def clip():
    return synthetic_video(16, 64, 64)
