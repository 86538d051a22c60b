"""Multi-device / multi-host execution: mesh, sharded scan, distributed train.

The reference's only parallelism is OpenMP threads and a disk-resident
chunk-scan with per-chunk top-k merge (``BitVecEngine.cpp:1441-1624``); SURVEY
§2.5/§3.5 identifies that merge pattern as the blueprint for the device build:
code rows sharded over the mesh, LUTs replicated, per-shard top-k merged via
all-gather — the partial-answer "ordered section" becomes an XLA collective.
"""

from vaq_tpu.parallel.mesh import make_mesh
from vaq_tpu.parallel.sharded import (shard_codes, sharded_adc_search,
                                      sharded_codes_search,
                                      sharded_decoded8_search,
                                      sharded_decoded_search,
                                      sharded_exact_search,
                                      sharded_ivf_search)

__all__ = [
    "make_mesh",
    "shard_codes",
    "sharded_adc_search",
    "sharded_codes_search",
    "sharded_decoded8_search",
    "sharded_decoded_search",
    "sharded_exact_search",
    "sharded_ivf_search",
]
