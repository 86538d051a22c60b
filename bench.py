"""Benchmark driver: SIFT1M-scale ADC search QPS per device at measured
recall.

Prints ONE JSON line:
  {"metric": ..., "value": QPS, "unit": "qps", "vs_baseline": ...,
   "device": {"platform", "kind", "count", "card"}, "recall_at_10": ..., ...}

Setup mirrors the reference's headline configuration (SIFT1M ADC,
``ExperimentsParameters.txt:51-55`` / BASELINE.md): 1M × 128-d vectors,
256-bit budget over 32 subspaces. The reference repo publishes no measured
numbers (BASELINE.json "published": {}), so ``vs_baseline`` is the ratio
against the measured reference C++ throughput when available in
``baseline_measured.json``, else 1.0.

All progress goes to stderr; stdout carries exactly the one JSON line,
which names the device it ran on (``card`` is nvidia-smi's name and power
limit where there is one). The built index is cached under .bench_cache/ so
repeat runs skip training; compiled programs are cached where
``JAX_COMPILATION_CACHE_DIR`` says, else in .jax_cache/.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


#: Keys allowed on the one stdout JSON line, in priority order (a reader
#: may capture only ~2000 chars of output). Array-valued fields (sweeps,
#: per-run samples) go to the bench_runs/ sidecar only.
_STDOUT_KEYS = (
    "metric", "value", "unit", "vs_baseline", "device",
    "recall_at_10", "recall_at_100", "recall_at_10_refined",
    "batch_latency_ms", "n", "config",
    "value_spread_pct", "value_unstable",
    "oracle_delta_recall",
    "ivf_qps", "ivf_recall_at_k", "ivf_visit",
    "tenm_qps", "tenm_recall_at_k",
    "tenm_ivf_qps", "tenm_ivf_visit", "tenm_ivf_recall_at_k",
    "tenm_ivf_all_beat_exhaustive",
    "tenm_codes_qps", "tenm_codes_recall_at_k",
    "codes_qps", "codes_recall_at_k", "fast4_qps", "fast4_recall_at_k",
    "decoded8_qps", "hamming_qps",
    "serving_knee_qps", "serving_p50_ms", "serving_p95_ms",
    "serving_onchip_batch_ms", "codes_serving_knee_qps",
    "build_s", "tenm_build_s", "tenm_n", "widebits_qps",
    "widebits_recall_at_k",
)
_STDOUT_BUDGET = 1900  # stay under a 2000-char capture window


def slim_line(out: dict) -> str:
    """The stdout JSON line: whitelisted fields + truncated errors, trimmed
    from the tail of the priority list if it would still exceed the capture
    window. The full dict goes to the sidecar file."""
    slim = {k: out[k] for k in _STDOUT_KEYS if k in out}
    for k, v in out.items():
        if k.endswith("_error"):
            slim[k] = str(v)[:80]
    line = json.dumps(slim)
    while len(line) > _STDOUT_BUDGET:
        for k in reversed(_STDOUT_KEYS):
            if k in slim and k not in ("metric", "value", "unit",
                                       "vs_baseline", "device"):
                del slim[k]
                break
        else:
            break
        line = json.dumps(slim)
    return line


def write_sidecar(out: dict) -> None:
    """Full (unslimmed) result dict → bench_runs/last_full.json."""
    try:
        side_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "bench_runs")
        os.makedirs(side_dir, exist_ok=True)
        path = os.path.join(side_dir, "last_full.json")
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        log(f"full bench record written to {path}")
    except OSError as e:
        log(f"sidecar write failed: {e!r}")


def card_line() -> str:
    """nvidia-smi's name and power limit, from a child that stays off JAX
    ("" where there is no nvidia-smi)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def chain_time(step_fn, qb_dev, iters):
    """Chained-dependency timing: each iteration's query batch depends on
    the previous result so the device cannot reorder or elide work; one tiny
    scalar fetch drains the chain, so the host↔device round trip is paid
    once, not per call."""
    import jax.numpy as jnp

    q = qb_dev
    t0 = time.perf_counter()
    for _ in range(iters):
        dd, ii = step_fn(q)
        s = (jnp.sum(dd) + jnp.sum(ii.astype(jnp.float32)))
        q = qb_dev + s.astype(qb_dev.dtype) * 1e-30
    float(jnp.sum(q))
    return time.perf_counter() - t0


def measure_qps(step_fn, qb_dev, batch, iters):
    """(qps, ms_per_batch) via marginal cost (T(iters) − T(1)) / (iters−1)."""
    chain_time(step_fn, qb_dev, 1)  # warm/compile
    t1 = min(chain_time(step_fn, qb_dev, 1) for _ in range(3))
    tn = min(chain_time(step_fn, qb_dev, iters) for _ in range(3))
    ms = (tn - t1) / (iters - 1) * 1000.0
    return batch / (ms / 1000.0), ms


def serving_knee_fields(args, idx, queries, backend="decoded", prefix=""):
    """Offered-load sweep: find the max sustained rate (the knee — achieved
    ≥ 97% of offered), then report p50/p95 at ~80% of it. One warm server
    serves the whole sweep. ``backend`` selects the served engine tier."""
    import threading

    from vaq_tpu.serving import SearchServer

    srv = SearchServer(idx, k=args.k, max_batch=256,
                       max_wait_ms=args.serving_wait_ms,
                       pipeline_depth=args.serving_depth, backend=backend)
    srv.search(queries[0])  # warm the compiled path

    def run_rate(rate, n_off=4096):
        offered = queries[np.arange(n_off) % queries.shape[0]]
        n_threads = 8
        per = n_off // n_threads
        spacing = n_threads / rate
        futs = [None] * n_off
        srv.stats.reset()
        t0 = time.perf_counter()

        def submitter(t):
            for j in range(per):
                i = t * per + j
                target = t0 + j * spacing + t * spacing / n_threads
                while True:
                    dt = target - time.perf_counter()
                    if dt <= 0:
                        break
                    time.sleep(min(dt, 0.0005))
                futs[i] = srv.submit(offered[i])

        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for f in futs:
            f.result(timeout=120)
        wall = time.perf_counter() - t0
        lat = srv.stats.summary()
        return n_off / wall, lat.get("p50_ms"), lat.get("p95_ms")

    # doubling sweep to the first failure, then one midpoint refinement
    rates = [2000.0]
    knee = None
    results = []
    while rates:
        rate = rates.pop(0)
        ach, p50, p95 = run_rate(rate)
        sustained = ach >= 0.97 * rate
        results.append({"offered": rate, "achieved": round(ach, 1),
                        "p50_ms": round(p50, 2), "p95_ms": round(p95, 2),
                        "sustained": sustained})
        log(f"serving sweep: offered {rate:.0f} achieved {ach:.0f} "
            f"p50={p50:.1f}ms p95={p95:.1f}ms"
            f"{' (knee passed)' if sustained else ' (saturated)'}")
        if sustained:
            knee = rate
            if rate >= args.serving_rate_max:
                break
            rates = [min(rate * 2, args.serving_rate_max)]
        elif knee is not None and rate > knee * 1.26:
            rates = [round((knee + rate) / 2, -2)]  # one refinement probe
        else:
            break
    fields = {f"{prefix}serving_sweep": results}
    if knee is not None:
        fields[f"{prefix}serving_knee_qps"] = knee
        ach, p50, p95 = run_rate(round(0.8 * knee, -2))
        fields[f"{prefix}serving_qps"] = round(ach, 1)
        fields[f"{prefix}serving_p50_ms"] = round(p50, 2)
        fields[f"{prefix}serving_p95_ms"] = round(p95, 2)
        log(f"serving @80% of knee ({0.8 * knee:.0f}): achieved {ach:.0f}, "
            f"p50={p50:.1f}ms p95={p95:.1f}ms")
        # Host-vs-device decomposition: the raw device step at the
        # server's batch size, chained — p50 minus this is batching
        # delay, scheduling and the host↔device fetch.
        import jax.numpy as jnp
        qb256 = jnp.asarray(queries[: srv.max_batch])
        _, onchip_ms = measure_qps(
            lambda q: idx.search_device(q, args.k, backend=backend),
            qb256, srv.max_batch, 16)
        fields[f"{prefix}serving_onchip_batch_ms"] = round(onchip_ms, 2)
        log(f"device batch latency at max_batch={srv.max_batch}: "
            f"{onchip_ms:.2f} ms (p50 − this = host/scheduling share)")
    nb = max(srv.batches_served, 1)
    log(f"serving totals: fill={srv.sum_fill / nb:.0f}/{srv.max_batch}, "
        f"fetch={srv.sum_fetch_s / nb * 1000:.1f}ms/batch, {nb} batches")
    srv.close()
    return fields


def oracle_fields(args, base, queries, cache_dir):
    """Engine-vs-oracle Δrecall on a 100k slice: the NumPy
    reference-pipeline oracle (tests/oracle_ref.py — a declared
    transliteration of VAQ.cpp train→encode→searchSort) and the engine run
    the same config on the same data; recall is measured against exact
    groundtruth on the slice. The oracle run is host-NumPy and slow, so its
    result is cached per (n, d, config)."""
    import jax.numpy as jnp

    import vaq_tpu
    from vaq_tpu import metrics
    from vaq_tpu.ops.distances import exact_search

    n_o = min(args.n, args.oracle_n)
    sub = base[:n_o]
    k = args.k
    gt_d, gt = exact_search(jnp.asarray(queries), jnp.asarray(sub), k)
    gt = np.asarray(gt)

    cfg = vaq_tpu.parse_method_string(args.config)
    eng = vaq_tpu.VAQIndex(cfg).train(sub).encode(sub)
    _, lab = eng.search(queries, k)
    eng_rec = metrics.avg_recall(lab, gt, k)

    ocache = os.path.join(cache_dir,
                          f"oracle_n{n_o}_d{args.d}_q{queries.shape[0]}_"
                          f"{args.config.replace(',', '_')}.json")
    if os.path.exists(ocache) and not args.no_cache:
        with open(ocache) as f:
            orec = json.load(f)["oracle_recall"]
        log(f"oracle recall loaded from cache: {orec:.4f}")
    else:
        import sys as _sys
        _sys.path.insert(0, os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "tests"))
        from oracle_ref import OracleVAQ
        t0 = time.perf_counter()
        o = OracleVAQ(cfg.bit_budget, cfg.subspace_num, cfg.min_bits,
                      cfg.max_bits, var=cfg.percent_var_explained,
                      seed=cfg.seed)
        from vaq_tpu.io import pad_dims
        sub_p = pad_dims(sub, cfg.subspace_num)
        q_p = pad_dims(queries, cfg.subspace_num)
        o.train(sub_p).encode(sub_p)
        _, olab = o.search(q_p, k)
        orec = metrics.avg_recall(olab, gt, k)
        with open(ocache, "w") as f:
            json.dump({"oracle_recall": round(orec, 4)}, f)
        log(f"oracle pipeline at n={n_o}: {time.perf_counter() - t0:.0f}s")
    log(f"oracle parity: engine {eng_rec:.4f} vs oracle {orec:.4f} "
        f"(Δ={eng_rec - orec:+.4f}) at n={n_o}")
    return {"oracle_n": n_o,
            "oracle_recall_at_k": round(float(orec), 4),
            "engine_oracle_slice_recall_at_k": round(float(eng_rec), 4),
            "oracle_delta_recall": round(float(eng_rec - orec), 4)}


def second_scale_fields(args, cache_dir):
    """Second-scale section: codes-tier QPS at 10M plus IVF-vs-exhaustive at visit ∈ {25, 10, 5}% (the
    reference's Fig. 11 fractions, ExperimentsParameters.txt:114-124).

    Data comes from DeviceChunkSource (chunk i is a pure function of
    (seed, i)): on-device regeneration keeps host and device transients
    O(chunk) instead of generating and transferring the whole base. Only
    the groundtruth (tiny) is cached.
    """
    import jax.numpy as jnp

    import vaq_tpu
    from vaq_tpu import metrics, pca
    from vaq_tpu.data import DeviceChunkSource
    from vaq_tpu.ivf import IVFSearcher, build_ivf
    from vaq_tpu.ops.distances import exact_search_chunked

    n2, d, chunk = args.second_n, args.d, 2_000_000
    tag = f"{n2 / 1e6:g}M"
    cfg = vaq_tpu.parse_method_string(args.config)
    src = DeviceChunkSource(n2, d, chunk)
    queries = src.queries(args.queries)

    t0 = time.perf_counter()
    idx = vaq_tpu.VAQIndex(cfg).train(src.host_sample(262_144))
    idx.encode_chunks(src.chunk, n2, chunk)
    build_s = time.perf_counter() - t0
    log(f"[{tag}] build (streamed): {build_s:.0f}s")

    gt_cache = os.path.join(cache_dir, f"gt_dev_n{n2}_d{d}_q{args.queries}"
                                       f"_c{chunk}.npy")
    if os.path.exists(gt_cache) and not args.no_cache:
        gt = np.load(gt_cache)
        log(f"[{tag}] groundtruth loaded from cache")
    else:
        t0 = time.perf_counter()
        _, gt = exact_search_chunked(queries, src.chunk, n2, chunk, 100)
        np.save(gt_cache, gt)
        log(f"[{tag}] groundtruth (streamed exact): "
            f"{time.perf_counter() - t0:.0f}s")

    qb = jnp.asarray(queries[: args.batch])
    # Slow steps (codes/IVF) keep a reduced iteration count; the exhaustive
    # step uses the full count so its marginal signal (iters-1)·ms stays
    # well above the host-clock jitter.
    iters_slow = max(2, args.iters // 4)
    fields = {"tenm_n": n2, "tenm_build_s": round(build_s, 1)}

    # codes tier: decode-then-dot window scan over raw codes (32 B/row)
    qps_c, ms_c = measure_qps(
        lambda q: idx.search_device(q, args.k, backend="codes"),
        qb, args.batch, iters_slow)
    _, lab = idx.search(queries, args.k, backend="codes")
    rec_c = metrics.avg_recall(lab, gt, args.k)
    log(f"[{tag}] codes QPS={qps_c:.1f} ({ms_c:.3f}ms/batch) "
        f"recall@{args.k}={rec_c:.4f}")
    fields["tenm_codes_qps"] = round(qps_c, 1)
    fields["tenm_codes_recall_at_k"] = round(rec_c, 4)

    # exhaustive decoded bf16 scan — the IVF comparison point
    idx._ensure_decoded()
    qps_x, ms_x = measure_qps(lambda q: idx.search_device(q, args.k),
                              qb, args.batch, args.iters)
    _, lab = idx.search(queries, args.k)
    rec_x = metrics.avg_recall(lab, gt, args.k)
    log(f"[{tag}] exhaustive QPS={qps_x:.1f} ({ms_x:.3f}ms/batch) "
        f"recall@{args.k}={rec_x:.4f}")
    fields["tenm_qps"] = round(qps_x, 1)
    fields["tenm_recall_at_k"] = round(rec_x, 4)

    # IVF cluster probe: one build, visit-fraction sweep (explicit params —
    # no config mutation). Guarded so an IVF failure
    # cannot lose the codes/exhaustive fields already measured above.
    try:
        visits = [float(v) for v in str(args.ivf_visit_10m).split(",")]
        t0 = time.perf_counter()
        state = build_ivf(idx, ti_cluster_num=args.ivf_clusters,
                          ti_segment_num=16)
        log(f"[{tag}] ivf build ({args.ivf_clusters} clusters): "
            f"{time.perf_counter() - t0:.0f}s")
        qp_b = pca.project(qb, idx.eigvecs, idx.total_dim)
        qp_all = pca.project(queries, idx.eigvecs, idx.total_dim)
        sweep = []
        for visit in visits:
            searcher = IVFSearcher(state, visit)

            def ivf_step(q, s=searcher):
                eps = jnp.sum(q) * 1e-30
                return s.search(idx, qp_b + eps, None, args.k, exact=False)

            v_qps, v_ms = measure_qps(ivf_step, qb, args.batch, iters_slow)
            _, l_iv = searcher.search(idx, qp_all, None, args.k, exact=False)
            v_rec = metrics.avg_recall(np.asarray(l_iv), gt, args.k)
            sweep.append({"visit": visit, "qps": round(v_qps, 1),
                          "ms": round(v_ms, 3),
                          "recall_at_k": round(v_rec, 4)})
            log(f"[{tag}] ivf QPS={v_qps:.1f} ({v_ms:.3f}ms/batch) "
                f"recall@{args.k}={v_rec:.4f} (visit={visit})")
        fields["tenm_ivf_sweep"] = sweep
    except Exception as e:  # noqa: BLE001 — keep the fields measured above
        log(f"[{tag}] ivf subsection failed: {e!r}")
        fields["tenm_ivf_error"] = repr(e)
    return fields


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--d", type=int, default=128)
    p.add_argument("--queries", type=int, default=1024)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--config", default="VAQ256m32min7max8var1,HEAP")
    p.add_argument("--batch", type=int, default=1024,
                   help="query batch size for the timed runs")
    p.add_argument("--iters", type=int, default=32)
    p.add_argument("--no-cache", action="store_true")
    p.add_argument("--no-secondary", action="store_true",
                   help="skip decoded8/hamming measurements (HBM budget at "
                        "10M+ rows)")
    p.add_argument("--no-capacity", action="store_true",
                   help="skip the codes-tier (lut/fast4) measurements")
    p.add_argument("--no-ivf", action="store_true",
                   help="skip the IVF cluster-probe measurement")
    p.add_argument("--no-serving", action="store_true",
                   help="skip the SearchServer latency measurement")
    p.add_argument("--ivf-visit", default="0.10",
                   help="visit fraction(s); comma-separated list sweeps "
                        "several fractions over one IVF build")
    p.add_argument("--ivf-clusters", type=int, default=1000)
    p.add_argument("--serving-rate-max", type=float, default=32000.0,
                   help="upper bound for the serving offered-load sweep")
    p.add_argument("--serving-wait-ms", type=float, default=5.0)
    p.add_argument("--serving-depth", type=int, default=4)
    p.add_argument("--oracle-n", type=int, default=100_000,
                   help="slice size for the engine-vs-oracle recall "
                        "companion (0 disables)")
    p.add_argument("--no-oracle", action="store_true")
    p.add_argument("--second-n", type=int, default=10_000_000,
                   help="row count for the second-scale section (0 disables)")
    p.add_argument("--no-10m", action="store_true",
                   help="skip the second-scale section (codes tier + "
                        "IVF-vs-exhaustive at 10M)")
    p.add_argument("--ivf-visit-10m", default="0.25,0.10,0.05",
                   help="visit-fraction sweep for the second-scale IVF "
                        "section (Fig. 11 fractions)")
    args = p.parse_args()

    os.environ.setdefault(
        "JAX_COMPILATION_CACHE_DIR",
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".jax_cache"))
    import jax
    import jax.numpy as jnp

    import vaq_tpu
    from vaq_tpu import metrics
    from vaq_tpu.data import make_anisotropic_gaussian
    from vaq_tpu.ops.distances import (exact_search,
                                       exact_search_host_stream)

    devices = jax.devices()
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices),
              "card": card_line()}
    log(f"devices: {devices} card: {device['card']}")

    rng_tag = f"n{args.n}_d{args.d}_{args.config.replace(',', '_')}"
    cache_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             ".bench_cache")
    os.makedirs(cache_dir, exist_ok=True)
    cache = os.path.join(cache_dir, rng_tag + ".npz")

    t0 = time.perf_counter()
    data_cache = os.path.join(cache_dir, f"data_n{args.n}_d{args.d}"
                                         f"_q{args.queries}.npz")
    if os.path.exists(data_cache) and not args.no_cache:
        with np.load(data_cache) as z:
            base, queries = z["base"], z["queries"]
        log(f"data loaded from cache: {time.perf_counter() - t0:.1f}s")
    else:
        base, queries = make_anisotropic_gaussian(
            args.n, args.d, args.queries, seed=42)
        # cache every size: this host generates ~1M rows/3min (O(10 MB/s)
        # memory), so even the default 1M regen dominates a bench run
        np.savez(data_cache, base=base, queries=queries)
        log(f"data gen: {time.perf_counter() - t0:.1f}s")

    cfg = vaq_tpu.parse_method_string(args.config)
    build_s = None
    if os.path.exists(cache) and not args.no_cache:
        idx = vaq_tpu.VAQIndex.load(cache)
        log(f"loaded cached index {cache}")
    else:
        t0 = time.perf_counter()
        idx = vaq_tpu.VAQIndex(cfg).build(base, verbose=True)
        build_s = time.perf_counter() - t0
        log(f"build: {build_s:.1f}s")
        idx.save(cache)

    # Groundtruth on the device (exact search over the full base), cached.
    gt_cache = os.path.join(cache_dir, rng_tag + f"_gt{args.queries}.npy")
    t0 = time.perf_counter()
    if os.path.exists(gt_cache) and not args.no_cache:
        gt = np.load(gt_cache)
        log(f"groundtruth loaded from cache")
    else:
        if args.n > 4_000_000:   # keep device memory O(chunk) at scale
            _, gt = exact_search_host_stream(queries, base, 100)
        else:
            gt_d, gt = exact_search(jnp.asarray(queries), jnp.asarray(base),
                                    100)
            gt = np.asarray(gt)
        np.save(gt_cache, gt)
        log(f"groundtruth: {time.perf_counter() - t0:.1f}s")

    # Recall measurement (full query set, one pass) + refined recall
    # (refine 100 → 10, the reference's Fig.10-style configuration).
    d, labels = idx.search(queries, 100, query_batch=args.batch)
    recall10 = metrics.avg_recall(labels[:, :10], gt, 10)
    recall100 = metrics.avg_recall(labels, gt, 100)
    _, refined = idx.refine(queries, labels, base, 10)
    recall10_refined = metrics.avg_recall(refined, gt, 10)
    log(f"recall@10={recall10:.4f} recall@100={recall100:.4f} "
        f"refined@10={recall10_refined:.4f}")

    # Timed steady-state QPS (chained methodology, see chain_time). The
    # headline number is measured FIVE times spread across the run (2 here,
    # 3 after the other sections) and reported as the median with min/max,
    # so run-to-run spread is visible in the record.
    qb_dev = jnp.asarray(queries[: args.batch])

    def headline_once():
        return measure_qps(lambda q: idx.search_device(q, args.k),
                           qb_dev, args.batch, args.iters)

    headline_runs = [headline_once() for _ in range(2)]
    qps, batch_ms = headline_runs[-1]
    log(f"QPS={qps:.1f}  batch latency={batch_ms:.3f}ms (chained marginal)")

    # Every section below is failure-isolated: a section that throws
    # contributes an ``<name>_error`` field instead of killing the JSON
    # line.
    def guarded(name, fn):
        try:
            return fn() or {}
        except Exception as e:  # noqa: BLE001 — headline must survive
            log(f"{name} section failed: {e!r}")
            return {f"{name}_error": repr(e)}

    # Secondary backends at the same scale.
    def measure(step_fn, iters):
        return measure_qps(step_fn, qb_dev, args.batch, iters)

    def secondary_section():
        qps8, ms8 = measure(
            lambda q: idx.search_device(q, args.k, backend="decoded8"),
            args.iters)
        log(f"decoded8 QPS={qps8:.1f} ({ms8:.3f}ms/batch)")

        from vaq_tpu.binary import (BinaryIndex, hamming_topk_matmul,
                                    unpack_bits_01)
        bidx = BinaryIndex(bit_budget=256).train(
            base[: min(args.n, 200000)]).encode(base)
        b01, bpop = bidx.db01, bidx.db_pop
        qpk = jnp.asarray(unpack_bits_01(bidx.encode_queries(
            queries[: args.batch]), bidx.total_bits))

        def ham_step(q):
            # thread the chain dependency through the packed queries (eps is
            # 0 at runtime but the compiler cannot prove it)
            eps = (jnp.sum(q) * 1e-30).astype(jnp.int8)
            return hamming_topk_matmul(b01, bpop, qpk + eps, args.k)

        qps_h, ms_h = measure(ham_step, args.iters)
        log(f"hamming QPS={qps_h:.1f} ({ms_h:.3f}ms/batch)")
        # the binary DB (2.6 GB HBM at 10M rows) dies with this scope; the
        # later sections need the headroom
        return {"decoded8_qps": round(qps8, 1),
                "hamming_qps": round(qps_h, 1)}

    secondary = {} if args.no_secondary else guarded("secondary",
                                                     secondary_section)

    # Codes-resident capacity tier: the decode-then-dot window scan over
    # the raw codes (32 B/row resident at this config) on
    # the headline index, plus the same tier on a <=4-bit FAST-config index
    # (the reference's FAST family constraint, VAQ.cpp:1263-1266).
    def capacity_section():
        def codes_step(q):
            return idx.search_device(q, args.k, backend="codes")

        lut_qps, lut_ms = measure(codes_step, max(2, args.iters // 2))
        _, cl_lab = idx.search(queries, args.k, backend="codes")
        codes_rec = metrics.avg_recall(cl_lab, gt, args.k)
        log(f"codes(decode-dot) QPS={lut_qps:.1f} ({lut_ms:.3f}ms/batch) "
            f"recall@{args.k}={codes_rec:.4f}")

        fast_cfg_s = f"VAQ{args.d * 2}m{args.d // 2}min1max4var1,FAST"
        fast_cache = os.path.join(
            cache_dir, f"n{args.n}_d{args.d}_"
                       f"{fast_cfg_s.replace(',', '_')}.npz")
        if os.path.exists(fast_cache) and not args.no_cache:
            fidx = vaq_tpu.VAQIndex.load(fast_cache)
        else:
            fidx = vaq_tpu.VAQIndex(
                vaq_tpu.parse_method_string(fast_cfg_s)).build(base)
            fidx.save(fast_cache)

        def fast_step(q):
            return fidx.search_device(q, args.k, backend="codes")

        fast4_qps, fast4_ms = measure(fast_step, max(2, args.iters // 2))
        _, fl = fidx.search(queries, args.k, backend="codes")
        fast4_rec = metrics.avg_recall(fl, gt, args.k)
        log(f"fast(codes tier, max4bit) QPS={fast4_qps:.1f} "
            f"({fast4_ms:.3f}ms/batch) recall@{args.k}={fast4_rec:.4f} "
            f"[{fast_cfg_s}]")
        # the FAST index dies with this scope, before the IVF section
        # builds its bucketed copy of the decoded DB
        return {"codes_qps": round(lut_qps, 1),
                "codes_recall_at_k": round(codes_rec, 4),
                "fast4_qps": round(fast4_qps, 1),
                "fast4_recall_at_k": round(fast4_rec, 4)}

    capacity = {} if args.no_capacity else guarded("capacity",
                                                   capacity_section)

    # IVF cluster-probe tier: visit fraction(s) vs
    # exhaustive, one IVF build shared across the sweep.
    def ivf_section():
        from vaq_tpu.ivf import IVFSearcher, build_ivf

        visits = [float(v) for v in str(args.ivf_visit).split(",")]
        # the int8 tier isn't used by the IVF path; reclaim its HBM first
        idx.decoded8 = idx.decoded8_scales = idx.decoded8_norms = None
        t0 = time.perf_counter()
        state = build_ivf(idx, ti_cluster_num=args.ivf_clusters,
                          ti_segment_num=16)
        log(f"ivf build ({args.ivf_clusters} clusters): "
            f"{time.perf_counter() - t0:.1f}s")
        from vaq_tpu import pca
        qp_dev = pca.project(qb_dev, idx.eigvecs, idx.total_dim)
        qp_all = pca.project(queries, idx.eigvecs, idx.total_dim)
        ivf_results = []
        for visit in visits:
            searcher = IVFSearcher(state, visit)

            def ivf_step(q):
                eps = (jnp.sum(q) * 1e-30)
                return searcher.search(idx, qp_dev + eps, None, args.k,
                                       exact=False)

            v_qps, v_ms = measure(ivf_step, max(2, args.iters // 4))
            d_iv, l_iv = searcher.search(idx, qp_all, None, args.k,
                                         exact=False)
            v_rec = metrics.avg_recall(np.asarray(l_iv), gt, args.k)
            ivf_results.append(
                {"visit": visit, "qps": round(v_qps, 1),
                 "ms": round(v_ms, 3), "recall_at_k": round(v_rec, 4)})
            log(f"ivf QPS={v_qps:.1f} ({v_ms:.3f}ms/batch) "
                f"recall@{args.k}={v_rec:.4f} (visit={visit})")
        idx.ivf = None  # the bucketed DB copy dies with this scope
        fields = {"ivf_qps": ivf_results[0]["qps"],
                  "ivf_recall_at_k": ivf_results[0]["recall_at_k"],
                  "ivf_visit": ivf_results[0]["visit"]}
        if len(ivf_results) > 1:
            fields["ivf_sweep"] = ivf_results
        return fields

    ivf_fields = {} if args.no_ivf else guarded("ivf", ivf_section)

    # Serving under continuous batching: offered-load sweep to the knee
    # (max sustained QPS), then p50/p95 at ~80% of it.
    serving = {}
    if not args.no_serving:
        serving = guarded("serving",
                          lambda: serving_knee_fields(args, idx, queries))
        # one codes-tier serving point: the capacity tier
        # under the same continuous-batching server, shorter sweep
        serving.update(guarded(
            "serving_codes",
            lambda: serving_knee_fields(args, idx, queries,
                                        backend="codes",
                                        prefix="codes_")))

    # Engine-vs-oracle recall companion on a 100k slice —
    # local parity evidence while the C++ reference host is unavailable.
    oracle = {}
    if not args.no_oracle and args.oracle_n:
        oracle = guarded("oracle",
                         lambda: oracle_fields(args, base, queries,
                                               cache_dir))

    # Final headline re-measures (see above): median of 5 spread runs.
    headline_runs += [headline_once() for _ in range(3)]
    qps_vals = sorted(r[0] for r in headline_runs)
    ms_vals = sorted(r[1] for r in headline_runs)
    qps = qps_vals[len(qps_vals) // 2]
    batch_ms = ms_vals[len(ms_vals) // 2]
    spread = (qps_vals[-1] - qps_vals[0]) / qps
    log(f"headline runs: median {qps:.0f} QPS, min {qps_vals[0]:.0f}, "
        f"max {qps_vals[-1]:.0f} (spread {spread * 100:.1f}%)")

    vs_baseline = 1.0
    bl_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "baseline_measured.json")
    if os.path.exists(bl_path):
        with open(bl_path) as f:
            bl = json.load(f)
        ref_qps = bl.get("reference_qps")
        if ref_qps:
            vs_baseline = qps / ref_qps

    out = {
        "metric": (f"ADC search QPS/device ({args.n / 1e6:g}M x {args.d}d, "
                   f"{cfg.bit_budget}-bit VAQ)"),
        "value": round(qps, 1),
        "unit": "qps",
        "vs_baseline": round(vs_baseline, 3),
        "device": device,
        "recall_at_10": round(recall10, 4),
        "recall_at_100": round(recall100, 4),
        "recall_at_10_refined": round(recall10_refined, 4),
        "batch_latency_ms": round(batch_ms, 3),
        "n": args.n,
        "config": args.config,
        "value_runs": [round(v, 1) for v in qps_vals],
        "value_spread_pct": round(spread * 100, 1),
    }
    if spread > 0.15:
        # run-to-run spread vs real regression must be distinguishable from
        # the JSON alone
        out["value_unstable"] = True
    out.update(oracle)
    out.update(secondary)
    out.update(capacity)
    out.update(ivf_fields)
    out.update(serving)
    if build_s is not None:
        out["build_s"] = round(build_s, 1)

    # Second-scale section (10M by default): codes tier + IVF-vs-exhaustive.
    # Guarded so a failure at scale cannot lose the headline line.
    # The quick-run recipe (--n 100000) skips it: a run at a reduced
    # primary n would otherwise still trigger the 10M build + groundtruth
    # stream.
    if args.second_n and args.second_n != args.n and not args.no_10m \
            and args.n >= 1_000_000:
        # release the 1M-scale device state first (the 10M section holds
        # the decoded bf16 tier, the codes and the IVF buckets)
        idx = bidx = None
        import gc
        gc.collect()
        try:
            out.update(second_scale_fields(args, cache_dir))
        except Exception as e:  # noqa: BLE001 — headline line must survive
            log(f"second-scale section failed: {e!r}")
            out["tenm_error"] = repr(e)

    # Flatten the 10M IVF sweep to its best point for the stdout line
    # (and record whether every sweep point beats the exhaustive scan; the
    # full sweep stays in the sidecar).
    sweep = out.get("tenm_ivf_sweep")
    if sweep:
        best = max(sweep, key=lambda s: s["qps"])
        out["tenm_ivf_qps"] = best["qps"]
        out["tenm_ivf_visit"] = best["visit"]
        out["tenm_ivf_recall_at_k"] = best["recall_at_k"]
        tx = out.get("tenm_qps")
        if tx:
            out["tenm_ivf_all_beat_exhaustive"] = bool(
                min(s["qps"] for s in sweep if s["visit"] <= 0.1) > tx)

    write_sidecar(out)
    print(slim_line(out))


if __name__ == "__main__":
    main()
