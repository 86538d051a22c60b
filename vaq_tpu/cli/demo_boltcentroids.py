"""demo_boltcentroids — export per-subspace 16-centroid PQ codebooks in
Bolt's CSV format (reference ``examples/demo_boltcentroids.cpp:13-69`` +
``writeCentroidsExternalBolt``, IO.hpp:574-591), for baseline interop.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="demo_boltcentroids", description=__doc__)
    p.add_argument("--dataset", default="")
    p.add_argument("--file-format-ori", default="fvecs")
    p.add_argument("--save", required=True)
    p.add_argument("--timeseries-size", type=int, default=128)
    p.add_argument("--dataset-size", type=int, default=0)
    p.add_argument("--subspace", type=int, default=32)
    p.add_argument("--bitbudget", type=int, default=256)
    p.add_argument("--synthetic", type=int, default=0, metavar="N")
    args = p.parse_args(argv)

    from vaq_tpu import io, kmeans
    from vaq_tpu.cli.demo_vaq import load_matrix

    if args.synthetic:
        from vaq_tpu.data import make_anisotropic_gaussian
        dataset, _ = make_anisotropic_gaussian(args.synthetic,
                                               args.timeseries_size, 1)
    else:
        dataset = load_matrix(args.dataset, args.file_format_ori,
                              args.timeseries_size, args.dataset_size)
    dataset = io.pad_dims(dataset, args.subspace)
    sub_len = dataset.shape[1] // args.subspace

    t0 = time.perf_counter()
    centroids = []
    for s in range(args.subspace):
        print(f"Training slice {s + 1}/{args.subspace} "
              f"({dataset.shape[0]} points, {sub_len}D, 16 clusters)")
        c, _ = kmeans.fit(dataset[:, s * sub_len:(s + 1) * sub_len], 16,
                          iters=25, seed=13517106 + s)
        centroids.append(c)
    print(f"PQ Training time: {time.perf_counter() - t0:.3f}")
    io.write_centroids_bolt(args.save, centroids)
    print(f"Bolt centroids written to {args.save}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
