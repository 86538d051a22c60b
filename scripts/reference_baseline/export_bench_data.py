#!/usr/bin/env python
"""Export the bench datasets in the C++ reference's file formats.

Writes base/queries fvecs + exact groundtruth ivecs for the exact data
bench.py uses (same generator, same seed), so a GLPK/Armadillo-capable host
can run the reference `demo_vaq` on IDENTICAL inputs and produce
`baseline_measured.json` for a real `vs_baseline`.

Usage:
  python export_bench_data.py --n 1000000 --d 128 --queries 1024 \
      --out /data/vaq_bench
Then on the reference host: see README.md next to this script.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--d", type=int, default=128)
    p.add_argument("--queries", type=int, default=1024)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--out", required=True)
    args = p.parse_args()

    import numpy as np

    from vaq_tpu import io
    from vaq_tpu.data import make_anisotropic_gaussian
    from vaq_tpu.ops.distances import exact_search_host_stream

    os.makedirs(args.out, exist_ok=True)
    base, queries = make_anisotropic_gaussian(args.n, args.d, args.queries,
                                              seed=42)
    io.write_fvecs(os.path.join(args.out, "base.fvecs"), base)
    io.write_fvecs(os.path.join(args.out, "queries.fvecs"), queries)
    _, gt = exact_search_host_stream(queries, base, args.k)
    io.write_ivecs(os.path.join(args.out, "groundtruth.ivecs"),
                   gt.astype(np.int32))
    print(f"wrote base/queries/groundtruth to {args.out}")


if __name__ == "__main__":
    main()
