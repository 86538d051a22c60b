"""demo_cluster — standalone k-means runner, mirroring
``examples/demo_cluster.cpp:18-245``: fit k-means (flat / mini-batch /
kmeans++ init), report the cluster index + silhouette, export centroids.
"""

from __future__ import annotations

import argparse
import sys
import time



def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="demo_cluster", description=__doc__)
    p.add_argument("--dataset", default="")
    p.add_argument("--file-format-ori", default="fvecs",
                   choices=["fvecs", "bvecs", "bin", "ascii"])
    p.add_argument("--timeseries-size", type=int, default=128)
    p.add_argument("--dataset-size", type=int, default=0)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--iters", type=int, default=25)
    p.add_argument("--version", default="simple",
                   choices=["simple", "fast", "parallel", "kmeanspp"],
                   help="'fast' = mini-batch; simple/parallel = Lloyd "
                        "(parallelism comes from XLA, kept for CLI parity)")
    p.add_argument("--centroids-out", default="")
    p.add_argument("--silhouette", action="store_true")
    p.add_argument("--synthetic", type=int, default=0, metavar="N")
    args = p.parse_args(argv)

    from vaq_tpu import io, kmeans, metrics
    from vaq_tpu.cli.demo_vaq import load_matrix

    if args.synthetic:
        from vaq_tpu.data import make_anisotropic_gaussian
        dataset, _ = make_anisotropic_gaussian(
            args.synthetic, args.timeseries_size, 1)
    else:
        dataset = load_matrix(args.dataset, args.file_format_ori,
                              args.timeseries_size, args.dataset_size)

    t0 = time.perf_counter()
    if args.version == "fast":
        cents, assign = kmeans.fit_minibatch(dataset, args.k,
                                             iters=args.iters)
    else:
        init = "kmeans++" if args.version == "kmeanspp" else "subset"
        cents, assign = kmeans.fit(dataset, args.k, iters=args.iters,
                                   init=init)
    print(f"== Clustering time: {time.perf_counter() - t0:.3f}")
    print(f"cluster index (mean within-cluster sqdist): "
          f"{metrics.cluster_index(assign, dataset, cents):.6f}")
    if args.silhouette:
        print(f"silhouette: "
              f"{metrics.silhouette_score(dataset, assign, cents):.6f}")
    if args.centroids_out:
        io.write_fvecs(args.centroids_out, cents)
        print(f"centroids written to {args.centroids_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
