"""Test harness: by default the tests run on the CPU with 8 virtual devices,
so sharding logic is exercised without several cards (SURVEY §4 — the
analog of the reference's parallel-equivalence test).

Tests marked ``gpu`` need the card and skip elsewhere; they run on the GPU
with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` or inside
``python chip_smoke.py``.
"""

import os

# XLA_FLAGS must be set before the CPU client initializes. A platform set
# by the caller (or a process that already holds the card) is kept.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided here, at run time,
    never while the test modules are imported)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card by chip_smoke.py)")


@pytest.fixture(scope="session")
def sift_like():
    """Small synthetic siftsmall-shaped dataset with exact groundtruth."""
    from vaq_tpu.data import make_sift_like

    base, queries, gt = make_sift_like(n=4000, n_queries=64, d=128, seed=42)
    return base, queries, gt


@pytest.fixture(scope="session")
def tiny_data():
    rng = np.random.default_rng(7)
    base = rng.standard_normal((512, 32)).astype(np.float32)
    queries = rng.standard_normal((16, 32)).astype(np.float32)
    return base, queries
