"""The one place that chooses an implementation from the platform.

Every op has a plain implementation that runs on any platform. Where a
hand-written kernel or another algorithm measured faster on the GPU
(PERF.md), the GPU takes it; every other platform takes the plain choice.
Pallas interpret mode is never chosen here: only tests ask for it.
"""

from __future__ import annotations

from typing import Optional

import jax

#: op -> (plain choice, {platform: choice})
_CHOICES = {
    # codes-tier window scan: the fused Triton kernel on the GPU
    "codes_window_scan": ("xla", {"gpu": "triton"}),
    # backend="lut" on an index with <= 8-bit codes: the windowed codes
    # tier on the GPU; the exact gather scan elsewhere
    "lut_scan": ("gather", {"gpu": "codes"}),
}


def choose(op: str, platform: Optional[str] = None) -> str:
    """The implementation of ``op`` for ``platform`` (default: JAX's
    default backend, e.g. "cpu" or "gpu")."""
    plain, by_platform = _CHOICES[op]
    return by_platform.get(platform or jax.default_backend(), plain)
