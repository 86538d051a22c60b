"""Continuous-batching search server.

The reference serves queries from a CLI loop; the accelerator serving
pattern (BASELINE.md: "continuous query batching, merged top-k") is a server
that coalesces concurrently-arriving queries into fixed-shape device
batches:

* requests are queued and packed into a static ``max_batch`` batch (padded —
  a single compiled program serves every batch size);
* dispatch is decoupled from result fetching: the batching loop launches
  device work and hands the (still device-resident) results to a small
  fetcher pool, so up to ``pipeline_depth`` host↔device transfers overlap
  in-flight compute instead of serializing behind it (SURVEY §5's "overlap
  the collective with the next batch's scan" applied at the host boundary);
* results are delivered per-request via futures; latency statistics are
  end-to-end (submit → result available), not device-time-only.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

# (submitted query rows, caller future, submit timestamp)
_Req = Tuple[np.ndarray, Future, float]


class SearchServer:
    """Continuous-batching wrapper around ``VAQIndex.search_device``."""

    def __init__(self, index, k: int, max_batch: int = 256,
                 max_wait_ms: float = 2.0, backend: str = "decoded",
                 recall_target: float = 0.99, pipeline_depth: int = 4):
        import jax.numpy as jnp

        self._jnp = jnp
        self.index = index
        self.k = k
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.backend = backend
        self.recall_target = recall_target
        self._queue: "queue.Queue" = queue.Queue()
        self._carry: Optional[_Req] = None  # overflow from the previous batch
        self._running = True
        self.batches_served = 0
        self.queries_served = 0
        from vaq_tpu.profiling import LatencyStats

        self.stats = LatencyStats()
        # dispatch-side instrumentation: batch fill + fetch wall time explain
        # where a serving ceiling comes from (device, host fetch, or an
        # under-filled batcher)
        self.sum_fill = 0          # real (unpadded) rows across batches
        self.sum_fetch_s = 0.0     # wall time inside _finish's np.asarray
        self._lock = threading.Lock()
        # Bounds dispatch-ahead: at most pipeline_depth batches in flight
        # between "launched on device" and "results fetched", so one
        # batch's device→host fetch overlaps later batches' compute/fetch
        # instead of gating the dispatch loop.
        self._slots = threading.Semaphore(pipeline_depth)
        self._fetchers = ThreadPoolExecutor(max_workers=pipeline_depth,
                                            thread_name_prefix="vaq-fetch")
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, query: np.ndarray) -> Future:
        """Enqueue one query (d,) or a small group (g, d); returns a Future
        resolving to (distances, labels) numpy arrays."""
        fut: Future = Future()
        q = np.atleast_2d(np.asarray(query, dtype=np.float32))
        if q.shape[0] > self.max_batch:
            fut.set_exception(ValueError(
                f"group of {q.shape[0]} queries exceeds max_batch="
                f"{self.max_batch}; split the request"))
            return fut
        self._queue.put((q, fut, time.perf_counter()))
        return fut

    def search(self, query: np.ndarray, timeout: float = 60.0):
        return self.submit(query).result(timeout)

    def close(self) -> None:
        self._running = False
        self._queue.put(None)
        self._thread.join(timeout=30.0)
        self._fetchers.shutdown(wait=True)

    # ------------------------------------------------------------------
    def _collect_batch(self) -> Optional[List[_Req]]:
        if self._carry is not None:
            first = self._carry
            self._carry = None
        else:
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                return []
            if first is None:
                return None
        items = [first]
        rows = first[0].shape[0]
        deadline = time.perf_counter() + self.max_wait_s
        while rows < self.max_batch:
            # drain any burst without paying a timed get per request
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
            if nxt is None:
                self._queue.put(None)  # re-signal shutdown
                break
            if rows + nxt[0].shape[0] > self.max_batch:
                self._carry = nxt      # doesn't fit — next batch leads with it
                break
            items.append(nxt)
            rows += nxt[0].shape[0]
        return items

    def _dispatch(self, items: List[_Req]):
        jnp = self._jnp
        qs = np.concatenate([q for q, _, _ in items], axis=0)
        nrows = qs.shape[0]
        if nrows < self.max_batch:
            qs = np.pad(qs, ((0, self.max_batch - nrows), (0, 0)))
        else:
            qs = qs[: self.max_batch]
        d, i = self.index.search_device(
            jnp.asarray(qs), self.k, backend=self.backend,
            recall_target=self.recall_target)
        # Fuse distances + labels into ONE device array so _finish pays a
        # single device→host transfer per batch. The fused dtype is INT32,
        # not f32: small int32 row ids bitcast to f32 are denormal bit
        # patterns, which a device may flush to zero in f32 arithmetic,
        # while f32 distance bit patterns pass through int32 unchanged.
        import jax

        fused = jnp.concatenate(
            [jax.lax.bitcast_convert_type(d.astype(jnp.float32), jnp.int32),
             i.astype(jnp.int32)],
            axis=1)
        return fused, nrows

    def _finish(self, items: List[_Req], fused, nrows: int) -> None:
        """Fetcher-pool body: block on the device→host transfer, resolve the
        callers' futures, record end-to-end latency per request."""
        try:
            t_f = time.perf_counter()
            arr = np.asarray(fused)                       # (B, 2k) int32
            t_fetch = time.perf_counter() - t_f
            d_np = np.ascontiguousarray(arr[:, : self.k]).view(np.float32)
            i_np = arr[:, self.k:]
        except Exception as e:
            for _, fut, _ in items:
                if not fut.done():
                    fut.set_exception(e)
            return
        finally:
            self._slots.release()
        now = time.perf_counter()
        row = 0
        with self._lock:
            for q, fut, t_submit in items:
                self.stats.record(now - t_submit, q.shape[0])
            self.batches_served += 1
            self.queries_served += nrows
            self.sum_fill += nrows
            self.sum_fetch_s += t_fetch
        for q, fut, _ in items:
            g = q.shape[0]
            fut.set_result((d_np[row: row + g], i_np[row: row + g]))
            row += g

    def _loop(self) -> None:
        while self._running:
            items = self._collect_batch()
            if items is None:
                break
            if not items:
                continue
            self._slots.acquire()
            try:
                fused, nrows = self._dispatch(items)  # async device launch
            except Exception as e:   # fail the batch, not the server
                self._slots.release()
                for _, fut, _ in items:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            self._fetchers.submit(self._finish, items, fused, nrows)
