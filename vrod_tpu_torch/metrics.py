"""Observability: structured query log, counters, profiling hooks.

The reference's only diagnostics are stdout prints in the ingest path
(the reference vRod's ``src/utils/embeddings.rs:34-49``). Here (SURVEY §5):
structured per-query JSON-lines logging (latency, k, metric, batch, shard
fan-out), framework-wide counters for mutations/compaction/WAL traffic, and
``torch.profiler`` trace hooks for device timeline capture.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from pathlib import Path


class Counters:
    """Process-wide monotonic counters (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = defaultdict(int)

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] += n

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts[name]

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


counters = Counters()


class LatencyHistogram:
    """Fixed log2-bucket latency histograms, keyed by event name
    (thread-safe, O(1) record, bounded memory). Buckets are powers of two
    in microseconds from 1 us to ~17 min; quantiles interpolate inside a
    bucket, so p99 is exact to within a 2x bucket edge — plenty for ops
    dashboards, with none of a reservoir's memory churn."""

    N_BUCKETS = 31  # 2^0 .. 2^30 us

    def __init__(self):
        self._lock = threading.Lock()
        self._h: dict[str, list[int]] = {}

    def record(self, event: str, seconds: float) -> None:
        us = seconds * 1e6
        b = 0 if us < 1 else min(int(us).bit_length(), self.N_BUCKETS - 1)
        with self._lock:
            h = self._h.get(event)
            if h is None:
                h = self._h[event] = [0] * self.N_BUCKETS
            h[b] += 1

    def quantiles(self, event: str, qs=(0.5, 0.95, 0.99)) -> dict:
        """{'p50_ms': ..., 'p95_ms': ..., 'p99_ms': ..., 'count': n} or
        {} if the event was never recorded."""
        with self._lock:
            h = list(self._h.get(event, ()))
        total = sum(h)
        if total == 0:
            return {}
        out = {"count": total}
        for q in qs:
            target = q * total
            acc = 0
            for b, c in enumerate(h):
                if acc + c >= target:
                    lo = 0.0 if b == 0 else float(1 << (b - 1))
                    hi = float(1 << b)
                    frac = (target - acc) / c
                    out[f"p{q * 100:g}_ms"] = round(
                        (lo + frac * (hi - lo)) / 1e3, 3)
                    break
                acc += c
        return out

    def snapshot(self) -> dict:
        with self._lock:
            events = list(self._h)
        return {e: self.quantiles(e) for e in events}

    def reset(self) -> None:
        with self._lock:
            self._h.clear()


latencies = LatencyHistogram()


class QueryLog:
    """JSON-lines structured log. A sink is a file path or a callable."""

    def __init__(self, sink=None):
        self._lock = threading.Lock()
        self._file = None
        self._cb = None
        self.configure(sink)

    def configure(self, sink) -> None:
        with self._lock:
            if self._file:
                self._file.close()
                self._file = None
            self._cb = None
            if sink is None:
                return
            if callable(sink):
                self._cb = sink
            else:
                self._file = open(Path(sink), "a")

    def emit(self, event: str, **fields) -> None:
        rec = {"ts": time.time(), "event": event, **fields}
        try:
            with self._lock:
                if self._cb is not None:
                    self._cb(rec)
                elif self._file is not None:
                    self._file.write(json.dumps(rec) + "\n")
                    self._file.flush()
        except Exception as e:
            # Observability must never fail (or mask) the instrumented
            # path: a full disk or a throwing user callback drops the
            # record with a warning, not the search result.
            import warnings
            warnings.warn(f"query_log sink failed; record dropped: {e!r}")


query_log = QueryLog()


@contextlib.contextmanager
def timed(event: str, **fields):
    """Time a block; emit a query-log record and bump counters."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        counters.inc(event)
        latencies.record(event, dt)
        query_log.emit(event, latency_ms=round(dt * 1e3, 3), **fields)


@contextlib.contextmanager
def profile(log_dir: str):
    """Capture a torch.profiler trace of the block (CPU, and CUDA where a
    card is present) as a Chrome trace JSON under ``log_dir``."""
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(
        str(Path(log_dir) / f"trace-{time.strftime('%Y%m%d-%H%M%S')}.json"))
