"""vaq_tpu — variance-aware quantization (VAQ) similarity-search engine in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of TheDatumOrg/VAQ
("Fast Adaptive Similarity Search through Variance-Aware Quantization"):

* PCA-rotated product quantization with ILP-driven non-uniform bit allocation
  across subspaces (`vaq_tpu.bitalloc`, `vaq_tpu.pca`).
* Per-subspace k-means codebooks trained with batched Lloyd iterations as
  matmuls (`vaq_tpu.kmeans`).
* ADC search: a decoded-matmul scan, an int8 tier, a codes-resident tier
  (a fused Triton kernel on the GPU) and the LUT gather scan, each fused
  with a top-k (`vaq_tpu.ops`).
* Exact-distance refinement, LUT u8 quantization, IVF-style cluster probing
  (the batched analog of the reference's triangle-inequality pruning).
* A binary/Hamming bit-vector engine (`vaq_tpu.binary`).
* FP-Growth frequent-pattern mining over codebooks (`vaq_tpu.fpgrowth`).
* Database sharding over a `jax.sharding.Mesh` with per-shard top-k merged via
  all-gather (`vaq_tpu.parallel`).

Everything data-proportional is jitted with static shapes; host Python only
orchestrates training-time control flow (the ILP, the k-means loop driver).
"""

import os as _os

import jax as _jax

# f32 matmuls MUST be f32: on the GPU, JAX's default precision lets XLA run
# f32-input matmuls in TF32 (about three decimal digits), which would corrupt
# the brute-force groundtruth most of all (chip_smoke.py's groundtruth phase
# checks exact_search against float64) and quietly degrade PCA, k-means,
# encode argmin and LUT builds, which all assume f32 math. The serving hot
# paths pass explicitly-bf16 operands with pinned precision, which this
# setting does not affect. VAQ_TPU_MATMUL_PRECISION=default turns it off
# for A/B measurements.
if _os.environ.get("VAQ_TPU_MATMUL_PRECISION", "highest") == "highest":
    _jax.config.update("jax_default_matmul_precision", "highest")

from vaq_tpu.config import SearchMethod, VAQConfig, parse_method_string
from vaq_tpu.errors import (ConfigError, FormatError, NotReadyError,
                            ShapeError, VAQError)
from vaq_tpu.vaq import VAQIndex

__version__ = "0.2.0"

__all__ = [
    "SearchMethod",
    "VAQConfig",
    "parse_method_string",
    "VAQIndex",
    "VAQError",
    "ConfigError",
    "NotReadyError",
    "ShapeError",
    "FormatError",
]
