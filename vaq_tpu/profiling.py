"""Phase timing + serving statistics + profiler hooks.

The reference instruments every pipeline stage with steady-clock macros
(``START_TIMING``/``END_TIMING``, utils/TimingUtils.hpp:28-33) and prints
per-phase seconds plus prune counters (VAQ.cpp:779/842-844). This build
provides the same as context managers, makes device work observable by
syncing at phase ends, exposes QPS/latency percentile summaries as
first-class outputs (SURVEY §5), and can wrap a region in a
``jax.profiler`` trace for XLA-level analysis.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class PhaseTimer:
    """Accumulating named phase timers (the START/END_TIMING counterpart)."""

    sync: bool = True       # block_until_ready pending device work at exit
    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                try:
                    import jax

                    jax.effects_barrier()
                except Exception:
                    pass
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {total:9.3f}s  (n={n}, "
                         f"avg {total / n * 1000:.1f}ms)")
        return "\n".join(lines)


@dataclass
class LatencyStats:
    """Rolling query-latency statistics → QPS / p50 / p95 / p99.

    Samples may be end-to-end latencies of *overlapping* requests (the
    serving pipeline keeps several batches in flight), so throughput is
    computed from the wall-clock span of record() calls, never from the sum
    of latencies."""

    samples: List[float] = field(default_factory=list)
    queries: int = 0
    _first_t: float = 0.0
    _last_t: float = 0.0

    def reset(self) -> None:
        """Clear samples (e.g. between offered-load sweep points)."""
        self.samples.clear()
        self.queries = 0
        self._first_t = self._last_t = 0.0

    def record(self, seconds: float, n_queries: int = 1) -> None:
        now = time.perf_counter()
        if not self.samples:
            self._first_t = now
        self._last_t = now
        self.samples.append(seconds)
        self.queries += n_queries

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        s = sorted(self.samples)
        span = self._last_t - self._first_t

        def pct(p):
            return s[min(len(s) - 1, int(p * len(s)))] * 1000.0

        return {
            "qps": self.queries / span if span > 0 else float(self.queries),
            "p50_ms": pct(0.50),
            "p95_ms": pct(0.95),
            "p99_ms": pct(0.99),
            "batches": len(s),
            "queries": self.queries,
        }


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace (view in TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
