"""Recall verification harness: engine results vs a NumPy brute-force oracle.

SURVEY §5 (metrics/observability): a recall-checking harness against NumPy
brute force, usable as a CI gate or a production canary after bulk loads.
"""

from __future__ import annotations

import numpy as np


def brute_force_oracle(vectors: np.ndarray, queries: np.ndarray, k: int,
                       metric: str) -> np.ndarray:
    """Row indices (into ``vectors``) of the exact top-k, f64 NumPy."""
    v = np.asarray(vectors, dtype=np.float64)
    q = np.atleast_2d(np.asarray(queries, dtype=np.float64))
    if metric == "cosine":
        v = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-300)
        q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-300)
        s = -(q @ v.T)
    elif metric == "dot":
        s = -(q @ v.T)
    elif metric == "l2":
        # Quadratic expansion: O(Q*N) memory. The naive (Q, N, D) broadcast
        # would allocate ~61 GB for 10 queries over 1M x 768 f64.
        s = (np.sum(q * q, axis=1, keepdims=True)
             - 2.0 * (q @ v.T) + np.sum(v * v, axis=1)[None, :])
    else:
        raise ValueError(f"Unknown metric {metric!r}")
    kk = min(k, v.shape[0])
    return np.argsort(s, axis=1, kind="stable")[:, :kk]


def verify_recall(collection, queries: np.ndarray, k: int = 10,
                  eps: float = 1e-5, quiesce: bool = False) -> float:
    """recall@k of the collection's production search vs the NumPy oracle
    over its live records. Gathers all live vectors to host — intended
    for tests, CI gates and spot checks, not for 10M-row production sets
    (sample those).

    ``quiesce=True`` holds the collection WRITE lock across the capture
    AND the search, so no mutation can interleave — the mode to use as a
    CI gate or production canary asserting exactly 1.0 (mutations block
    for the duration). The default mode captures under a read lock and
    searches under a separate read lock (the RW lock is not
    reader-reentrant), so a mutation BETWEEN the two can yield spurious
    recall < 1.0 — fine for spot checks on quiet collections.

    Tie-aware: items whose f64 oracle score sits within ``eps`` (relative)
    of the rank-k boundary are interchangeable — different float
    accumulation orders legitimately swap them — so only items strictly
    above the band are REQUIRED. Without the band, duplicate vectors or
    f32-epsilon-close boundary scores would fail a gate asserting 1.0
    with no bug present."""
    from ..allocator import NO_ID

    queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
    got_sets = None
    lock = collection._rw.write() if quiesce else collection._rw.read()
    with lock:
        live_slots = collection.alloc.live_slots()
        if live_slots.size == 0:
            return 1.0
        rids = collection.alloc.ids_of(live_slots)
        vecs = collection.engine.gather(live_slots.astype(np.int64))
        if quiesce:
            # Search under the SAME lock (engine direct — search_similar
            # would try to re-acquire the non-reentrant RW lock).
            _, slots = collection.engine.search(queries, k)
            ids = collection.slot_ids(slots)
            got_sets = [
                {int(i) for s, i in zip(slots[b], ids[b])
                 if s >= 0 and i != NO_ID}
                for b in range(slots.shape[0])
            ]
    metric = collection.config.metric
    # Recompute full f64 score rows for the tie band (the oracle helper
    # returns positions only).
    v = np.asarray(vecs, dtype=np.float64)
    qv = np.asarray(queries, dtype=np.float64)
    if metric == "cosine":
        v = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-300)
        qv = qv / np.maximum(np.linalg.norm(qv, axis=1, keepdims=True),
                             1e-300)
        s = qv @ v.T
    elif metric == "dot":
        s = qv @ v.T
    else:  # l2: higher-is-better convention via negation
        s = -(np.sum(qv * qv, axis=1, keepdims=True)
              - 2.0 * (qv @ v.T) + np.sum(v * v, axis=1)[None, :])
    kk = min(k, v.shape[0])
    order = np.argsort(-s, axis=1, kind="stable")
    if got_sets is None:
        results = collection.search_similar(queries, k)
        if queries.shape[0] == 1 and not isinstance(results[0], list):
            results = [results]
        got_sets = [{h.record_id for h in results[b]}
                    for b in range(queries.shape[0])]
    total, hit = 0, 0
    for b in range(queries.shape[0]):
        boundary = s[b, order[b, kk - 1]]
        band = eps * max(abs(boundary), 1.0)
        required_pos = np.nonzero(s[b] > boundary + band)[0]
        want = set(int(r) for r in rids[required_pos].tolist())
        hit += len(got_sets[b] & want)
        total += len(want)
    return hit / total if total else 1.0
