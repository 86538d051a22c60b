"""demo_vaq_paramsearch — hyperparameter grid search, the working
counterpart of the reference's bit-rotted ``examples/demo_vaq_paramsearch.cpp``
(excluded from its build; grid at cpp:214-231): sweep (subspaces, min_bits,
max_bits) at a fixed bit budget, build + search each config, and emit a CSV
table of recall/time. Groundtruth is computed by brute force when absent
(cpp:144-155's queryNaiveEigen path).
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time



def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="demo_vaq_paramsearch",
                                description=__doc__)
    p.add_argument("--dataset", default="")
    p.add_argument("--queries", default="")
    p.add_argument("--file-format-ori", default="fvecs")
    p.add_argument("--timeseries-size", type=int, default=128)
    p.add_argument("--dataset-size", type=int, default=0)
    p.add_argument("--queries-size", type=int, default=0)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--bit-budget", type=int, default=256)
    p.add_argument("--subspaces", default="16,32,64")
    p.add_argument("--min-bits", default="1,2,4,7")
    p.add_argument("--max-bits", default="8")
    p.add_argument("--out", default="paramsearch.csv")
    p.add_argument("--synthetic", type=int, default=0, metavar="N")
    args = p.parse_args(argv)

    from vaq_tpu import metrics
    from vaq_tpu.config import VAQConfig, SearchMethod
    from vaq_tpu.ops.distances import compute_groundtruth
    from vaq_tpu.vaq import VAQIndex
    from vaq_tpu.cli.demo_vaq import load_matrix

    if args.synthetic:
        from vaq_tpu.data import make_sift_like
        dataset, queries, gt = make_sift_like(
            n=args.synthetic, n_queries=args.queries_size or 100,
            d=args.timeseries_size)
    else:
        dataset = load_matrix(args.dataset, args.file_format_ori,
                              args.timeseries_size, args.dataset_size)
        queries = load_matrix(args.queries, args.file_format_ori,
                              args.timeseries_size, args.queries_size)
        gt = compute_groundtruth(queries, dataset, args.k)

    rows = []
    grid = list(itertools.product(
        [int(v) for v in args.subspaces.split(",")],
        [int(v) for v in args.min_bits.split(",")],
        [int(v) for v in args.max_bits.split(",")]))
    for m, mn, mx in grid:
        if mn > mx or args.bit_budget > m * mx or args.bit_budget < m * mn:
            continue
        cfg = VAQConfig(bit_budget=args.bit_budget, subspace_num=m,
                        min_bits=mn, max_bits=mx,
                        methods=SearchMethod.HEAP)
        t0 = time.perf_counter()
        try:
            idx = VAQIndex(cfg).train(dataset).encode(dataset)
        except ValueError as e:
            print(f"m={m} min={mn} max={mx}: infeasible ({e})")
            continue
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, labels = idx.search(queries, args.k)
        query_s = time.perf_counter() - t0
        rec = metrics.avg_recall(labels, gt, args.k)
        rows.append((m, mn, mx, rec, build_s, query_s))
        print(f"m={m:3d} min={mn} max={mx}: recall={rec:.4f} "
              f"build={build_s:.1f}s query={query_s:.2f}s")

    with open(args.out, "w") as f:
        f.write("subspaces,min_bits,max_bits,avg_recall,build_s,query_s\n")
        for r in rows:
            f.write(",".join(str(v) for v in r) + "\n")
    print(f"results written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
