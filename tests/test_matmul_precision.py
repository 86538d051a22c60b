"""Pin the package-level matmul-precision contract.

Without it, XLA may run f32-input matmuls at reduced precision (TF32 on the
GPU), which corrupts the brute-force groundtruth and quietly degrades
PCA/k-means/encode. ``import vaq_tpu`` must therefore force
``jax_default_matmul_precision`` to ``highest`` unless explicitly
overridden via VAQ_TPU_MATMUL_PRECISION.
"""

import jax
import numpy as np

import vaq_tpu  # noqa: F401 — the import applies the config


def test_default_matmul_precision_is_highest():
    assert jax.config.jax_default_matmul_precision == "highest"


def test_exact_search_matches_f64_reference():
    """The groundtruth generator must agree with an f64 host reference
    (on CPU this is near-vacuous — f32 matmuls are f32 — but the assertion
    documents the contract the GPU run depends on; chip_smoke.py's
    groundtruth phase checks it on the card)."""
    import jax.numpy as jnp

    from vaq_tpu.ops.distances import exact_search

    rng = np.random.default_rng(0)
    base = rng.standard_normal((4096, 64)).astype(np.float32)
    queries = rng.standard_normal((32, 64)).astype(np.float32)
    _, lab = exact_search(jnp.asarray(queries), jnp.asarray(base), 10)
    lab = np.asarray(lab)

    b64 = base.astype(np.float64)
    q64 = queries.astype(np.float64)
    d2 = ((q64 ** 2).sum(1)[:, None] - 2.0 * q64 @ b64.T
          + (b64 ** 2).sum(1)[None, :])
    ref = np.argsort(d2, axis=1)[:, :10]
    overlap = np.mean([len(set(lab[i]) & set(ref[i])) / 10
                       for i in range(32)])
    assert overlap == 1.0, overlap
