"""serve — HTTP search service over a saved VAQ index.

The reference has no serving surface (its demos are batch CLIs,
``examples/demo_vaq.cpp:19``); this is the deployment entry point for the
build: load an index artifact (or build one from a synthetic dataset
for smoke tests), start the continuous batcher, and expose
``POST /search`` / ``GET /stats`` / ``GET /healthz``.

    python -m vaq_tpu.cli.serve --index index.npz --port 8080 \
        --k 10 --max-batch 256 --max-wait-ms 2

    curl -s localhost:8080/search -d '{"query": [0.1, ...], "k": 10}'
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="serve", description=__doc__)
    p.add_argument("--index", default="", help="saved VAQIndex .npz artifact")
    p.add_argument("--synthetic", type=int, default=0,
                   help="build an n-row synthetic index instead (smoke test)")
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--method", default="VAQ256m32min7max8var1,HEAP")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--max-batch", type=int, default=256)
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--backend", default="decoded")
    args = p.parse_args(argv)

    import vaq_tpu
    from vaq_tpu.serving import SearchServer
    from vaq_tpu.serving_http import SearchHTTPServer

    if args.index:
        idx = vaq_tpu.VAQIndex.load(args.index)
    elif args.synthetic:
        from vaq_tpu.data import make_anisotropic_gaussian

        base, _ = make_anisotropic_gaussian(args.synthetic, args.dim, 1,
                                            seed=7)
        cfg = vaq_tpu.parse_method_string(args.method)
        idx = vaq_tpu.VAQIndex(cfg).build(base, verbose=True)
    else:
        p.error("one of --index / --synthetic is required")

    srv = SearchServer(idx, k=args.k, max_batch=args.max_batch,
                       max_wait_ms=args.max_wait_ms, backend=args.backend)
    # warm the compiled path before accepting traffic
    warm = np.zeros((1, idx.eigvecs.shape[0]), dtype=np.float32)
    srv.search(warm)
    http = SearchHTTPServer(srv, host=args.host, port=args.port).start()
    host, port = http.address[:2]
    print(f"serving on http://{host}:{port}  (k={args.k}, "
          f"max_batch={args.max_batch}, backend={args.backend})",
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        http.close()
        srv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
