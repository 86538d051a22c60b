"""Time the codes-tier window scan on the GPU: the fused Triton kernel
against the plain XLA formulation, at the headline deployment's shapes
(1M rows, d=128, M=32 subspaces of C=256 centroids, 1024-query batches,
k=10 → 512-row windows).

    python scripts/time_codes_scan.py [--n 1000000] [--nq 1024] [--k 10]

Prints one JSON line per variant (milliseconds per batch, median of
``--reps`` calls that each end in ``block_until_ready``) and a last line
with the card's name and power limit. Each Triton variant is checked
against the XLA scan on the same inputs before it is timed. The exact LUT
gather scan, which ``backend="lut"`` would take instead of the codes tier,
is timed end to end beside it.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e!r})"


def timed(fn, reps):
    import jax
    jax.block_until_ready(fn())           # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=1_000_000)
    p.add_argument("--nq", type=int, default=1024)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    import vaq_tpu  # noqa: F401  (package precision setting)
    from vaq_tpu.ops import scan_codes, scan_jax

    m, c, l = 32, 256, 4
    rng = np.random.default_rng(0)
    cents = rng.standard_normal((m, c, l)).astype(np.float32)
    codes_t = jnp.asarray(rng.integers(0, c, (m, args.n), dtype=np.uint8))
    qp = jnp.asarray(rng.standard_normal((args.nq, m * l)).astype(np.float32))
    table, rows = scan_codes.build_decode_tables(cents)
    br = 1 << (min(args.n // (64 * args.k), 512).bit_length() - 1)
    pad = (-args.n) % br
    codes_p = jnp.pad(codes_t, ((0, 0), (0, pad)))
    dev = jax.devices()[0]
    common = {"device": dev.device_kind, "n": args.n, "nq": args.nq,
              "block_rows": br}

    ref_s, ref_i = jax.block_until_ready(
        scan_codes.window_scan_xla(codes_p, table, qp, br))
    ms = timed(lambda: scan_codes.window_scan_xla(codes_p, table, qp, br),
               args.reps)
    print(json.dumps({**common, "impl": "xla", "scan_ms": ms}), flush=True)

    best = None
    for q_tile, sub, warps, stages in (
            (256, 64, 8, 2), (256, 32, 8, 2), (256, 128, 8, 2),
            (256, 64, 8, 3), (512, 32, 8, 2), (256, 64, 16, 2),
            (128, 64, 4, 2)):
        tag = {"impl": "triton", "q_tile": q_tile, "sub_rows": sub,
               "num_warps": warps, "num_stages": stages}
        try:
            def run():
                return scan_codes.window_scan_triton(
                    codes_p, table, qp, br, q_tile=q_tile, sub_rows=sub,
                    num_warps=warps, num_stages=stages)
            s, i = jax.block_until_ready(run())
            s, i = np.asarray(s), np.asarray(i)
            # same window minima up to the packed low mantissa bits and the
            # f32 accumulation order of the two dots
            rel = np.abs(s - np.asarray(ref_s)) / np.maximum(
                np.abs(np.asarray(ref_s)), 1e-6)
            agree = float(np.mean(i == np.asarray(ref_i)))
            ms = timed(run, args.reps)
            print(json.dumps({**common, **tag, "scan_ms": ms,
                              "max_rel_vs_xla": float(rel.max()),
                              "id_agreement": agree}), flush=True)
            if best is None or ms < best[0]:
                best = (ms, q_tile, sub, warps, stages)
        except Exception as e:  # noqa: BLE001 — report the variant, go on
            print(json.dumps({**common, **tag,
                              "error": repr(e)[:400]}), flush=True)
    # end to end (window scan + 2k-window top-k + exact rescore), both
    # implementations in turns: xla, triton, triton, xla
    for nq in sorted({args.nq, 256, 64}, reverse=True):
        qn = qp[:nq]
        for impl in ("xla", "triton", "triton", "xla"):
            ms = timed(lambda: scan_codes.decode_scan_topk(
                codes_t, table, rows, qn, args.k, block_rows=br, impl=impl),
                args.reps)
            print(json.dumps({**common, "nq": nq, "impl": impl,
                              "topk_ms": ms}), flush=True)
    # backend="lut" (platform.choose("lut_scan")): the exact LUT gather scan
    # from the same projected queries, LUT build included, against the
    # codes tier above
    cents_dev = jnp.asarray(cents)
    codes_rm = codes_t.T
    for nq in sorted({args.nq, 256, 64}, reverse=True):
        qn = qp[:nq]
        ms = timed(lambda: scan_jax.adc_scan_topk(
            codes_rm, scan_jax.build_luts(qn, cents_dev), args.k), args.reps)
        print(json.dumps({**common, "nq": nq, "impl": "lut_gather",
                          "topk_ms": ms}), flush=True)
    print(json.dumps({"card": card(), "best_triton": best}), flush=True)


if __name__ == "__main__":
    main()
