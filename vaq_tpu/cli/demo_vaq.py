"""demo_vaq — train/encode/search/refine CLI, mirroring
``examples/demo_vaq.cpp:19-369`` flag-for-flag (plus ``--synthetic`` for
running without dataset files, since the reference's siftsmall base fvecs are
missing blobs).

Canonical invocation (scripts/run_demos.sh:11-22 analog):

    python -m vaq_tpu.cli.demo_vaq \
        --dataset siftsmall_base.fvecs --queries siftsmall_query.fvecs \
        --groundtruth siftsmall_groundtruth.ivecs --groundtruth-format ivecs \
        --timeseries-size 128 --dataset-size 10000 --queries-size 100 \
        --method "VAQ256m32min7max8var1,HEAP" --k 100 --refine 100,200
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="demo_vaq", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    # flag names = the reference's long options (demo_vaq.cpp:20-45)
    p.add_argument("--dataset", default="")
    p.add_argument("--queries", default="")
    p.add_argument("--file-format-ori", default="fvecs",
                   choices=["fvecs", "bvecs", "bin", "ascii"])
    p.add_argument("--save", default="", help="index artifact path (.npz)")
    p.add_argument("--save-enc", default="",
                   help="kept for CLI parity; codes are saved inside --save")
    p.add_argument("--groundtruth", default="")
    p.add_argument("--groundtruth-format", default="ascii",
                   choices=["ascii", "ivecs", "bin"])
    p.add_argument("--result", default="")
    p.add_argument("--timeseries-size", type=int, default=1)
    p.add_argument("--dataset-size", type=int, default=0)
    p.add_argument("--queries-size", type=int, default=0)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--method", default="VAQ256m32min7max13var1,EA")
    p.add_argument("--refine", default="")
    p.add_argument("--hc-bitalloc", default="")
    p.add_argument("--learn-ratio", type=float, default=0.05)
    p.add_argument("--visit-cluster", type=float, default=1.0)
    p.add_argument("--kmeans-ver", type=int, default=0,
                   help="0 flat, 1 hierarchical, 2 binary-split (>8-bit subs)")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="generate an N-row synthetic dataset instead of files")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "decoded", "decoded8", "codes", "lut",
                            "lut_gather", "fast4", "ivf"],
                   help="engine scan backend (the full "
                        "engine surface — decoded bf16 / decoded8 int8 / "
                        "codes decode-then-dot / lut / lut_gather / fast4 "
                        "one-hot / ivf cluster probe)")
    p.add_argument("--ivf-rows-dtype", default="int8",
                   choices=["int8", "bf16"],
                   help="bucket-row storage tier for the TI/IVF probe")
    return p


def load_matrix(path: str, fmt: str, dim: int, max_rows: int) -> np.ndarray:
    from vaq_tpu import io
    mr = max_rows if max_rows > 0 else None
    if fmt == "fvecs":
        return io.read_fvecs(path, mr)
    if fmt == "bvecs":
        return io.read_bvecs(path, mr).astype(np.float32)
    if fmt == "bin":
        return io.read_bin(path, dim, max_rows=mr)
    return io.read_ascii(path, ",", mr)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from vaq_tpu import metrics
    from vaq_tpu.config import parse_hardcoded_bits, parse_method_string
    from vaq_tpu.ivf import attach_ivf
    from vaq_tpu.vaq import VAQIndex
    from vaq_tpu.config import SearchMethod
    from vaq_tpu import io

    cfg = parse_method_string(args.method)
    cfg = dataclasses.replace(
        cfg,
        visit=args.visit_cluster,
        hierarchical_kmeans=args.kmeans_ver == 1,
        binary_kmeans=args.kmeans_ver == 2,
        hardcoded_bits=parse_hardcoded_bits(args.hc_bitalloc)
        if args.hc_bitalloc else None,
    )

    gt = None
    if args.synthetic:
        from vaq_tpu.data import make_sift_like
        n = args.synthetic
        d = args.timeseries_size if args.timeseries_size > 1 else 128
        nq = args.queries_size or 100
        print(f"Generating synthetic dataset {n}x{d}, {nq} queries")
        dataset, queries, gt = make_sift_like(n=n, n_queries=nq, d=d)
    else:
        if not os.path.exists(args.dataset) or not os.path.exists(args.queries):
            print("Dataset or queries file doesn't exists", file=sys.stderr)
            return 1
        print("Read dataset")
        dataset = load_matrix(args.dataset, args.file_format_ori,
                              args.timeseries_size, args.dataset_size)
        print("Read queries")
        queries = load_matrix(args.queries, args.file_format_ori,
                              args.timeseries_size, args.queries_size)

    if args.groundtruth:
        print("Read groundtruth")
        if args.groundtruth_format == "ivecs":
            gt = io.read_ivecs(args.groundtruth)
        elif args.groundtruth_format == "bin":
            gt = io.read_bin(args.groundtruth, args.k, dtype=np.int32)
        else:
            gt = np.loadtxt(args.groundtruth, delimiter=",",
                            dtype=np.int64)

    print("Training & encoding phase")
    t0 = time.perf_counter()
    if args.save and os.path.exists(args.save):
        print(f"Reading saved index from {args.save}")
        idx = VAQIndex.load(args.save)
    else:
        idx = VAQIndex(cfg).train(dataset, verbose=True)
        idx.encode(dataset, verbose=True)
        if cfg.methods & (SearchMethod.FAST | SearchMethod.FAST3):
            t1 = time.perf_counter()
            idx.learn_quantization(dataset, args.learn_ratio)
            print(f"== Learn Quantization time: {time.perf_counter() - t1:.3f}")
        if args.save:
            print(f"Saving index to {args.save}")
            idx.save(args.save)
    print(f"== Training+encoding time: {time.perf_counter() - t0:.3f}")

    if cfg.methods & SearchMethod.TI or args.backend == "ivf":
        t1 = time.perf_counter()
        attach_ivf(idx, verbose=True, rows_dtype=args.ivf_rows_dtype)
        print(f"== TI Clustering time: {time.perf_counter() - t1:.3f}")

    print("Querying phase")
    refines = [int(r) for r in args.refine.split(",")] if args.refine else [0]
    for refine in refines:
        t1 = time.perf_counter()
        search_k = refine if refine >= args.k else args.k
        dists, labels = idx.search(queries, search_k, backend=args.backend,
                                   verbose=True)
        if refine >= args.k:
            print(f"Refining the answer with Refine = {refine}")
            dists, labels = idx.refine(queries, labels, dataset, args.k)
        print(f"== Querying time: {time.perf_counter() - t1:.3f}")

        if args.result:
            out = args.result + (f"_R{refine}" if len(refines) > 1 else "")
            print(f"Writing knn results to {out}")
            io.write_knn_results(out, labels, dists)
        if gt is not None:
            print(f"\tprecision(avg_recall): "
                  f"{metrics.avg_recall(labels, gt, args.k):.6f}")
            print(f"\trecall@R: {metrics.recall_at_r(labels, gt, args.k):.6f}")
            print(f"\tMAP: "
                  f"{metrics.mean_average_precision(labels, gt, args.k):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
