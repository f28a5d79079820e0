"""Batched query frontend: pack concurrent queries into one device batch.

The reference's command layer as a *query path*: concurrent callers submit
single queries; a worker thread packs everything pending into one padded
(B, dim) batch, runs a single engine search (K3 and K1 on the card), and
fans results back out. Micro-batching trades <= ``max_wait_ms`` of latency
for throughput: the kernels take a query group of 256 per launch, so a
batch of 1 leaves most of the work unused.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future

import numpy as np

from . import metrics


class QueryBatcher:
    # One wait slice inside the batching window: if a slice passes with NO
    # new arrivals, every closed-loop client is already pending (a sync
    # client can't submit again until its in-flight query answers), so
    # waiting out the rest of the window is pure dead time. Measured in
    # the JAX package on the batcher alone (collection stubbed, 2 ms
    # window, host only): 8 sync clients 10k -> 24k q/s, 64 clients 38k ->
    # 42k, and throughput became window-size-invariant; open-loop load
    # still fills batches to max_batch (the backlog grows while the engine
    # runs).
    QUIESCE_SLICE_S = 60e-6

    def __init__(self, collection, *, max_batch: int = 256,
                 max_wait_ms: float = 2.0):
        self.collection = collection
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._lock = threading.Condition()
        # (vector, k, filter-key-or-None, future)
        self._pending: list[tuple[np.ndarray, int, tuple | None, Future]] = []
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, vector, k: int = 10, *, within_ids=None,
               exclude_ids=None) -> Future:
        """Queue one query; the Future resolves to a list of SearchHit.

        Internally the worker produces ``(id, score, payload)`` triples
        (the serving hot path skips per-hit object construction —
        :meth:`submit_triples`); this compat wrapper converts per query.

        Filtered queries batch with queries carrying the *same* filter
        (same ids, same mode); distinct filters execute as separate engine
        calls within the window — a filter is a scan mask, so it is
        per-call, not per-row-of-the-tile."""
        from .collection import SearchHit
        inner = self.submit_triples(vector, k, within_ids=within_ids,
                                    exclude_ids=exclude_ids)
        outer: Future = Future()

        def _convert(f: Future) -> None:
            e = f.exception()
            if e is not None:
                outer.set_exception(e)
            else:
                outer.set_result(
                    [SearchHit(r, s, p) for r, s, p in f.result()])

        inner.add_done_callback(_convert)
        return outer

    def submit_triples(self, vector, k: int = 10, *, within_ids=None,
                       exclude_ids=None) -> Future:
        """Queue one query; the Future resolves to a list of
        ``(record_id, score, payload)`` tuples (no per-hit objects — what
        the network server serializes directly)."""
        vec = np.asarray(vector, dtype=np.float32)
        # Validate per-client input HERE so one malformed query raises to
        # its submitter instead of poisoning a packed batch (np.stack over
        # mixed dims would otherwise kill the worker and hang every Future).
        # Shape must be (dim,) — or the unambiguous (1, dim) row that
        # embedding libraries return for a single text. A (2, dim/2)
        # matrix or a (dim, 1) column would flatten to the right size and
        # silently search wrong, so those stay rejected.
        dim = self.collection.config.dim
        if vec.ndim == 2 and vec.shape == (1, dim):
            vec = vec[0]
        if vec.ndim != 1 or vec.shape[0] != dim:
            raise ValueError(
                f"Query must be a 1-D vector of dim {dim}, "
                f"got shape {vec.shape}")
        if within_ids is not None and exclude_ids is not None:
            raise ValueError("Pass within_ids or exclude_ids, not both")
        fkey = None
        if within_ids is not None:
            fkey = ("within", tuple(sorted(int(i) for i in within_ids)))
        elif exclude_ids is not None:
            fkey = ("exclude", tuple(sorted(int(i) for i in exclude_ids)))
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("QueryBatcher is closed")
            self._pending.append((vec, k, fkey, fut))
            self._lock.notify()
        return fut

    def search(self, vector, k: int = 10, timeout: float | None = 30.0,
               **filter_kw):
        return self.submit(vector, k, **filter_kw).result(timeout=timeout)

    def search_triples(self, vector, k: int = 10,
                       timeout: float | None = 30.0, **filter_kw):
        return self.submit_triples(
            vector, k, **filter_kw).result(timeout=timeout)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify()
        self._worker.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker ------------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._closed:
                    self._lock.wait()
                if self._closed and not self._pending:
                    return
                # Micro-batch window: once the first query arrives, wait up
                # to max_wait for more (until the tile fills) — but
                # dispatch EARLY the moment a wait slice passes with no
                # new arrivals (see QUIESCE_SLICE_S).
                deadline = self._now() + self.max_wait
                while (len(self._pending) < self.max_batch
                       and not self._closed):
                    remaining = deadline - self._now()
                    if remaining <= 0:
                        break
                    before = len(self._pending)
                    self._lock.wait(
                        timeout=min(remaining, self.QUIESCE_SLICE_S))
                    if len(self._pending) == before:
                        break  # quiescent: nothing more is coming
                batch = self._pending[: self.max_batch]
                del self._pending[: self.max_batch]
            try:
                self._execute(batch)
            except Exception as e:  # never let the worker die
                for item in batch:
                    fut = item[-1]
                    if not fut.done():
                        fut.set_exception(e)

    @staticmethod
    def _now() -> float:
        import time
        return time.monotonic()

    def _execute(self, batch) -> None:
        # One engine call per (k, filter) group: k is a static compile
        # parameter; a filter is a per-call scan mask.
        groups: dict[tuple, list[tuple[np.ndarray, Future]]] = {}
        for vec, k, fkey, fut in batch:
            groups.setdefault((k, fkey), []).append((vec, fut))
        for (k, fkey), items in groups.items():
            try:
                vecs = np.stack([v for v, _ in items])
                kw = {}
                if fkey is not None:
                    mode, ids = fkey
                    kw["within_ids" if mode == "within"
                       else "exclude_ids"] = np.array(ids, dtype=np.uint64)
                with metrics.timed("frontend.batch", batch=len(items), k=k,
                                   collection=self.collection.config.name):
                    results = self.collection.search_triples(vecs, k, **kw)
                for (_, fut), triples in zip(items, results):
                    fut.set_result(triples)
            except Exception as e:  # propagate to every waiter
                for _, fut in items:
                    if not fut.done():
                        fut.set_exception(e)
