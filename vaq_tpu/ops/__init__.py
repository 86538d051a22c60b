"""Device compute: distance matmuls, ADC scans, top-k reductions."""

from vaq_tpu.ops.distances import exact_search, pairwise_sq_dists
from vaq_tpu.ops.scan_jax import adc_scan_topk, build_luts

__all__ = [
    "exact_search",
    "pairwise_sq_dists",
    "adc_scan_topk",
    "build_luts",
]
