"""Collection: durable, mutable, GPU-resident vector set.

The port's fork of ``vrod_tpu.collection``, bound to the port's engine:

  host   C++ slot allocator (free-list, live bitmap, id<->slot binding)
       + C++ WAL (CRC-framed, fsync'd before device mutation is acked)
       + payload table (id -> string payload)
  device (capacity, dim) embedding tensor + aux + validity on one device
         (see ``vrod_tpu_torch/engine.py``)

The host parts are the port's copies of ``vrod_tpu``'s modules, so the WAL
and snapshot formats are one and the same: a directory written by either
package loads in the other. The JAX collection's multi-process paths (rank fingerprint
allgather, coordination-KV agreement rounds, the replicated snapshot
gather) are not in this fork: one process owns a collection, and a
process-spanning collection is ROADMAP Queue 1 item 7.

Durability: every mutation appends to the collection WAL *before* touching
device state; ``snapshot()`` persists live records + payloads, then truncates
the WAL (its frames are captured). ``load()`` = snapshot restore + WAL tail
replay; replay is idempotent so a crash between snapshot and truncate is
safe. Record model is the reference's ``(f32 embedding, string payload)``
(``src/utils/embeddings.rs:61``).
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np

from . import metrics
from .allocator import NO_ID, SlotAllocator
from .config import (
    CONFIG_FILE, SNAPSHOT_DIR, WAL_FILE, CollectionConfig,
    read_config, write_config,
)
from .errors import (
    DimensionMismatchError, RecordNotFoundError,
)
from .records import Record
from .utils.locks import RWLock
from .wal import GroupCommit, Wal, ops

from .engine import DeviceEngine


# Temp dirs of hardlinks pinning a snapshot (backup/replication reads).
_HOLD_PREFIX = ".snap_hold_"


def _checked_id(rid):
    """Normalize a user-supplied record id to a canonical Python int, or
    None if it cannot name a live record: non-numeric, non-integral
    (2.7 must not truncate to record 2), or outside (0, NO_ID) — ids are
    assigned from ``next_id`` starting at 1. Normalizing BEFORE the
    native ctypes boundary matters twice over: ``c_uint64`` silently
    masks out-of-range Python ints (``c_uint64(2**64).value == 0`` would
    alias record 0), and a float like ``np.float64(2.0)`` would hit the
    pure-Python fallback's dict (2.0 == 2 hashes equal) but raise
    ``ctypes.ArgumentError`` on the native path — the fallbacks must stay
    bit-compatible."""
    try:
        i = int(rid)
    except (TypeError, ValueError):
        return None
    if i != rid or not 0 < i < NO_ID:
        return None
    return i


def _as_id_array(record_ids) -> np.ndarray:
    """Convert user-supplied bulk ids to a flat uint64 array, rejecting
    anything numpy would silently mangle: signed arrays WRAP negatives
    (np.asarray(np.array([-1]), np.uint64) == 2**64-1, no error), float
    arrays TRUNCATE (np.asarray([2.7], np.uint64) == [2] — the wrong
    record), and out-of-range Python ints raise a raw OverflowError
    mid-conversion. The error contract here is a clean ValueError."""
    bad = "record ids must be integers in [1, 2**64-2]"
    try:
        arr = np.asarray(record_ids)
    except (OverflowError, ValueError, TypeError) as e:
        raise ValueError(f"{bad}: {e}")
    flat = arr.reshape(-1)
    if flat.size == 0:
        return np.empty(0, dtype=np.uint64)
    kind = arr.dtype.kind
    if kind == "u":
        return flat.astype(np.uint64)
    if kind == "i":
        mn = int(flat.min())
        if mn < 0:
            raise ValueError(f"{bad}: got {mn}")
        return flat.astype(np.uint64)
    if kind == "f":
        # Mixed lists like [np.uint64(5), 99999] promote to float64 —
        # accept only exactly-integral, finite, in-range values (2.7 or
        # NaN must never truncate onto a record).
        if not np.all(np.isfinite(flat)) or np.any(flat != np.floor(flat)) \
                or np.any(flat < 0) or np.any(flat >= 2.0 ** 64):
            raise ValueError(f"{bad}: non-integral or out-of-range floats")
        return flat.astype(np.uint64)
    if kind == "O":  # mixed / huge Python ints land here
        try:
            return flat.astype(np.uint64)
        except (OverflowError, ValueError, TypeError) as e:
            raise ValueError(f"{bad}: {e}")
    raise ValueError(f"{bad}: got dtype {arr.dtype}")


class SearchHit:
    __slots__ = ("record_id", "score", "payload")

    def __init__(self, record_id: int, score: float, payload: str):
        self.record_id = record_id
        self.score = score
        self.payload = payload

    def __repr__(self):
        return f"SearchHit(id={self.record_id}, score={self.score:.6g}, payload={self.payload!r})"


class Collection:
    def __init__(self, path: Path, config: CollectionConfig, *,
                 device=None, wal_sync: bool = True):
        self.path = Path(path)
        self.config = config
        self.wal_sync = wal_sync
        self.engine = DeviceEngine(config, device=device)
        self.alloc = SlotAllocator(self.engine.capacity)
        self.wal = Wal(self.path / WAL_FILE)
        # Group commit: concurrent mutations share one fsync before ack
        # instead of paying ~10 ms each (SURVEY §5 checkpoint/resume row).
        self._commit = GroupCommit(self.wal)
        from .payload_store import make_payload_store
        self.payloads = make_payload_store(
            config.payload_store, self.path / "payloads.db")
        self.next_id = 1
        # Single-writer / multi-reader: mutations donate device buffers, so
        # a concurrent search must never hold the old arrays (SURVEY §5).
        self._rw = RWLock()
        # Serializes maintenance (snapshot/reindex); ordinary reads/writes
        # proceed concurrently with a running snapshot.
        self._maint = threading.Lock()
        # Auto-snapshot policy state (config.auto_snapshot_wal_bytes).
        self._autosnap_lock = threading.Lock()
        self._autosnap_thread: threading.Thread | None = None
        self._autosnap_pending = False  # budget crossed while worker alive
        self._closing = False
        # Filter-mask cache: repeated searches with the same id filter reuse
        # the device mask. Entries are stamped with the mutation generation
        # (id->slot bindings are stable within one generation), so any
        # mutation or compaction invalidates them implicitly.
        self._mutgen = 0
        self._fcache: dict[tuple, tuple[int, object]] = {}
        self._fcache_lock = threading.Lock()
        # Cap on rows per BULKINSERT WAL frame (~64 MB of vector data): huge
        # ingests write many bounded frames instead of one multi-GB frame.
        self.WAL_FRAME_ROWS_MAX = max(1, (64 << 20) // (config.dim * 4 + 64))
        # Stale snapshot-pin dirs (backup/replication holds) from a crashed
        # process are garbage: the DB advisory lock guarantees no other
        # process holds them, and in-process holds can't predate __init__.
        for stale in self.path.glob(_HOLD_PREFIX + "*"):
            shutil.rmtree(stale, ignore_errors=True)
        # Highest LSN covered by the committed snapshot (frames <= floor may
        # have been truncated from the WAL). Replication uses it to decide
        # whether the WAL can serve a follower's position or the follower
        # must re-bootstrap from the snapshot.
        self._wal_floor = 0

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def create_on_disk(cls, path: Path, config: CollectionConfig, *,
                       exist_ok: bool = False) -> Path:
        """Create just the on-disk artifacts (dir + vr_config + vr_wal) —
        no device engine. With ``exist_ok`` this idempotently COMPLETES a
        half-created directory (crash between mkdir and the config write),
        which is what DB-WAL recovery needs; a plain create refuses an
        existing directory (the reference's AlreadyExists contract)."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=exist_ok)
        cfg_file = path / CONFIG_FILE
        if not cfg_file.exists():
            write_config(cfg_file, config.to_json())
        (path / WAL_FILE).touch()
        return path

    @classmethod
    def create(cls, path: Path, config: CollectionConfig, **kw) -> "Collection":
        cls.create_on_disk(path, config, exist_ok=False)
        return cls(path, config, **kw)

    @classmethod
    def load(cls, path: Path, **kw) -> "Collection":
        path = Path(path)
        config = CollectionConfig.from_json(read_config(path / CONFIG_FILE))
        col = cls(path, config, **kw)
        col._restore()
        return col

    def close(self) -> None:
        # Let an in-flight auto-snapshot finish (its WAL truncate needs the
        # fd); a snapshot that races past this join fails cleanly and is
        # counted in collection.auto_snapshot_failures.
        self._closing = True  # no new maintenance workers from here on
        t = self._autosnap_thread
        if t is not None and t.is_alive():
            t.join(timeout=300)
        with self._maint:
            self.wal.close()
            self.payloads.close()

    # -- invariants --------------------------------------------------------

    def _check_dim(self, vecs: np.ndarray) -> np.ndarray:
        vecs = np.atleast_2d(np.asarray(vecs, dtype=np.float32))
        if vecs.shape[1] != self.config.dim:
            raise DimensionMismatchError(
                f"Vector dim {vecs.shape[1]} != collection dim {self.config.dim}")
        return vecs

    def _ensure_capacity(self, n_new: int) -> None:
        needed = self.alloc.live_count + n_new
        if self.engine.ensure_capacity(needed):
            self.alloc.grow(self.engine.capacity)
        elif self.alloc.capacity < self.engine.capacity:
            self.alloc.grow(self.engine.capacity)

    @property
    def count(self) -> int:
        return self.alloc.live_count


    # -- mutations (WAL first, then device) --------------------------------

    def _log_and_apply(self, op, apply_fn) -> int:
        """Append the op to the WAL, apply it to device/host state, and
        return the op's LSN. The fsync happens AFTER the caller releases
        the write lock (``_commit.sync_upto``) so concurrent mutations
        share one fsync — durability before ack is preserved because device
        state is volatile (rebuilt from the WAL on restart).

        If the apply raises (e.g. device OOM during a grow/scatter) the WAL
        is rewound to its pre-append size: the op was never acked, so it
        must not silently materialize on the next replay."""
        self._mutgen += 1  # under the write lock; invalidates filter masks
        pre = self.wal.valid_size
        lsn = self.wal.append(ops.encode(op), sync=False)
        try:
            apply_fn()
        except BaseException:
            try:
                self.wal.rewind(pre)
            except Exception:
                pass  # rewind is best-effort; the original error matters more
            raise
        return lsn

    def _ack(self, lsn: int) -> None:
        """Block until the op at ``lsn`` is durable (shared group fsync)."""
        if self.wal_sync and lsn:
            self._commit.sync_upto(lsn)
        self._maybe_auto_snapshot()

    def _fragmented(self) -> bool:
        """True only when compaction would ACTUALLY reclaim a segment: the
        live-fraction policy alone would re-trigger forever whenever the
        packed live set still needs the current capacity (e.g. frac=0.75
        with live just over one segment)."""
        frac = self.config.auto_compact_fraction
        live = self.alloc.live_count
        return (frac > 0
                and live < frac * self.engine.capacity
                and self.engine.shrink_target(live) < self.engine.capacity)

    def _maybe_auto_snapshot(self) -> None:
        """Kick background maintenance when a policy budget is crossed:
        a snapshot when the WAL exceeds ``auto_snapshot_wal_bytes`` (bounds
        restart-replay time; non-blocking), or a REINDEX when the live set
        falls under ``auto_compact_fraction`` of capacity (packs rows and
        reclaims capacity — restores post-delete scan QPS; takes the write
        lock briefly for the compaction move + shrink)."""
        budget = self.config.auto_snapshot_wal_bytes
        if self._closing:
            return
        want_snap = budget > 0 and self.wal.valid_size >= budget
        want_compact = self._fragmented()
        if not (want_snap or want_compact):
            return
        with self._autosnap_lock:
            t = self._autosnap_thread
            if t is not None and t.is_alive():
                # A maintenance op is in flight. Mark the crossing so the
                # worker re-evaluates before exiting — otherwise this
                # trigger is lost and an idle collection sits above budget
                # until the next mutation.
                self._autosnap_pending = True
                return
            if self._maint.locked():
                return  # manual snapshot/reindex in flight does the work
            self._autosnap_pending = False

            def run():
                try:
                    with self._maint:
                        # Loop until no budget is crossed: each pass either
                        # truncates the WAL below budget or reclaims the
                        # fragmented capacity, so the loop is bounded by
                        # actual work. The pending flag (checked under the
                        # trigger lock before exit) closes the race where a
                        # mutation crosses a budget between this worker's
                        # last check and its exit.
                        while True:
                            if self._fragmented():
                                self._reindex_impl()
                                metrics.counters.inc(
                                    "collection.auto_compactions")
                            elif (budget > 0
                                    and self.wal.valid_size >= budget):
                                self._snapshot_impl()
                                metrics.counters.inc(
                                    "collection.auto_snapshots")
                            else:
                                with self._autosnap_lock:
                                    if not self._autosnap_pending:
                                        break
                                    self._autosnap_pending = False
                    # _maint is released. A trigger that landed during the
                    # unwind saw this thread alive and marked pending —
                    # hand off by re-evaluating with the thread slot
                    # cleared (a fresh worker spawns if work remains).
                    # Deliberately NOT in a finally: after a failed
                    # snapshot, retrying immediately would spin; the
                    # failure path keeps the retry-on-next-mutation
                    # contract.
                    with self._autosnap_lock:
                        self._autosnap_thread = None
                        pending = self._autosnap_pending
                    if pending:
                        self._maybe_auto_snapshot()
                except Exception as e:
                    metrics.counters.inc("collection.auto_snapshot_failures")
                    import warnings
                    warnings.warn(
                        f"Auto-maintenance of collection "
                        f"{self.config.name!r} failed: {e!r} (durability "
                        f"unaffected; will retry after a later mutation)")

            self._autosnap_thread = threading.Thread(
                target=run, daemon=True,
                name=f"vrod-autosnap-{self.config.name}")
            self._autosnap_thread.start()

    def _check_one(self, vector) -> np.ndarray:
        vecs = self._check_dim(vector)
        if vecs.shape[0] != 1:
            raise DimensionMismatchError(
                f"Expected a single vector, got {vecs.shape[0]} rows "
                f"(use bulk_insert for batches)")
        return vecs

    def insert(self, vector, payload: str = "") -> int:
        vecs = self._check_one(vector)
        with self._rw.write():
            rid = self.next_id
            lsn = self._log_and_apply(
                ops.InsertOp(rid, vecs[0], payload),
                lambda: self._apply_insert(
                    np.array([rid], dtype=np.uint64), vecs, [payload]))
        self._ack(lsn)
        metrics.counters.inc("collection.inserts")
        return rid

    def bulk_insert(self, vectors, payloads=None) -> np.ndarray:
        vecs = self._check_dim(vectors)
        n = vecs.shape[0]
        if n == 0:
            return np.empty((0,), dtype=np.uint64)
        if payloads is None:
            payloads = [""] * n
        if len(payloads) != n:
            raise ValueError("payloads length must match vectors")
        with self._rw.write():
            rids = np.arange(self.next_id, self.next_id + n, dtype=np.uint64)
            # Cap WAL frame size: a 10M-row ingest must not become one
            # multi-GB frame (bounded replay memory, finer torn-tail
            # granularity). Each chunk is its own op; one fsync at the end
            # covers them all (group durability before ack).
            chunk = max(1, self.WAL_FRAME_ROWS_MAX)
            # Same protocol as _log_and_apply (bump generation, append,
            # apply, rewind on failure), inlined to loop over WAL frame
            # chunks. Keep the two in sync.
            self._mutgen += 1
            lsn = 0
            pre = self.wal.valid_size
            try:
                for start in range(0, n, chunk):
                    end = min(start + chunk, n)
                    lsn = self.wal.append(
                        ops.encode(ops.BulkOp(
                            rids[start:end], vecs[start:end],
                            list(payloads[start:end]))),
                        sync=False)
                self._apply_insert(rids, vecs, payloads)
            except BaseException:
                try:
                    self.wal.rewind(pre)
                except Exception:
                    pass
                raise
        self._ack(lsn)
        metrics.counters.inc("collection.inserts", n)
        return rids

    def _apply_insert(self, rids: np.ndarray, vecs: np.ndarray, payloads) -> None:
        self._ensure_capacity(len(rids))
        slots = self.alloc.acquire(rids)
        try:
            self.engine.write(slots, vecs)
            self.payloads.set_many(rids.tolist(), payloads)
        except BaseException:
            # Roll the host state back: the WAL frame is about to be
            # rewound (the op was never acked), so the binding must not
            # survive either — a stale binding would wedge every retry of
            # the same record id, and a bound row without its payload
            # would serve wrong data. Partial effects are undone
            # best-effort (slots return to the free list regardless).
            try:
                self.alloc.release(rids)
                self.engine.erase(slots.astype(np.int64))
                self.payloads.delete_many(rids.tolist())
            except Exception:
                pass
            raise
        self.next_id = max(self.next_id, int(rids.max()) + 1)

    def delete(self, record_id: int) -> None:
        with self._rw.write():
            rid = _checked_id(record_id)
            if rid is None or self.alloc.slot_of(rid) == NO_ID:
                raise RecordNotFoundError(f"No record with id {record_id}")
            lsn = self._log_and_apply(ops.DeleteOp(rid),
                                      lambda: self._apply_delete(rid))
        self._ack(lsn)
        metrics.counters.inc("collection.deletes")

    def delete_many(self, record_ids) -> int:
        """Bulk DELETE: one WAL frame, one device scatter. Unknown ids are
        skipped; returns the number actually deleted."""
        rids = _as_id_array(record_ids)
        with self._rw.write():
            # Dedupe (stable): a duplicated id must not be counted twice
            # or release a slot that a same-batch duplicate already freed.
            _, first = np.unique(rids, return_index=True)
            rids = rids[np.sort(first)]
            known = np.array(
                [r for r in rids.tolist() if self.alloc.slot_of(r) != NO_ID],
                dtype=np.uint64)
            if known.size == 0:
                return 0
            lsn = self._log_and_apply(ops.BulkDeleteOp(known),
                                      lambda: self._apply_bulk_delete(known))
        self._ack(lsn)
        metrics.counters.inc("collection.deletes", int(known.size))
        return int(known.size)

    def _apply_bulk_delete(self, rids: np.ndarray) -> None:
        # Device first, host binding second: if the erase dispatch raises,
        # the WAL is rewound AND the allocator still holds the binding, so
        # live state matches durable state (releasing first would leave a
        # still-valid device row with no binding until restart).
        slots = self.alloc.slots_of(rids)
        live = slots[slots != NO_ID]
        if live.size:
            self.engine.erase(live.astype(np.int64))
        self.alloc.release(rids)
        # Payload-store failures are non-fatal here: the store is a
        # rebuildable cache and a stale entry for a deleted id is never
        # looked up (lookups go through live ids) — whereas failing the
        # delete AFTER release+erase would leave the live view diverged
        # from the durable (rewound) state.
        try:
            self.payloads.delete_many(rids.tolist())
        except Exception as e:
            import warnings
            warnings.warn(f"Payload-store delete failed (stale cache "
                          f"entries remain, harmless): {e!r}")

    def _apply_delete(self, record_id: int) -> None:
        # Same device-first ordering as _apply_bulk_delete.
        slot = self.alloc.slot_of(record_id)
        if slot != NO_ID:
            self.engine.erase(np.array([slot], dtype=np.int64))
        self.alloc.release(np.array([record_id], dtype=np.uint64))
        try:  # non-fatal; see _apply_bulk_delete
            self.payloads.pop(record_id, None)
        except Exception:
            pass

    def update(self, record_id: int, vector, payload: str = "") -> None:
        """UPDATE = delete + insert under the same record id
        (reference: UpdateCommand stub, types.rs:82-93)."""
        vecs = self._check_one(vector)
        with self._rw.write():
            rid = _checked_id(record_id)
            if rid is None or self.alloc.slot_of(rid) == NO_ID:
                raise RecordNotFoundError(f"No record with id {record_id}")
            lsn = self._log_and_apply(
                ops.UpdateOp(rid, vecs[0], payload),
                lambda: self._apply_update(rid, vecs, payload))
        self._ack(lsn)

    def _apply_update(self, record_id: int, vecs: np.ndarray, payload: str) -> None:
        # Capture the stored representation before the delete so a failed
        # re-insert can restore the live view: after the WAL rewind the
        # record durably still exists, and the in-memory state must agree.
        old_slot = self.alloc.slot_of(record_id)
        old_rows, old_aux = self.engine.gather_raw(
            np.array([old_slot], dtype=np.int64))
        old_payload = self.payloads.get(record_id, "")
        self._apply_delete(record_id)
        try:
            self._apply_insert(
                np.array([record_id], dtype=np.uint64), vecs, [payload])
        except BaseException:
            try:
                rid_arr = np.array([record_id], dtype=np.uint64)
                slots = self.alloc.acquire(rid_arr)
                self.engine.write_raw(slots, old_rows, old_aux)
                self.payloads[record_id] = old_payload
            except Exception:
                pass  # device unusable; restart replay restores the record
            raise

    # -- reads -------------------------------------------------------------

    def get(self, record_id: int) -> Record:
        """Exact lookup (the reference's SEARCH verb, types.rs:108-119)."""
        with self._rw.read():
            rid = _checked_id(record_id)
            slot = self.alloc.slot_of(rid) if rid is not None else NO_ID
            if slot == NO_ID:
                raise RecordNotFoundError(f"No record with id {record_id}")
            vec = self.engine.gather(np.array([slot]))[0]
            return Record(vector=vec, payload=self.payloads.get(rid, ""))

    def search_similar(self, queries, k: int = 10, *, within_ids=None,
                       exclude_ids=None, **search_kw):
        """Exact kNN (the reference's SEARCHSIMILAR verb, types.rs:121-132).

        Returns a list (one entry per query) of lists of SearchHit, best
        first. Scores: cosine similarity / inner product (higher = closer)
        or squared L2 distance (lower = closer).

        ``within_ids`` restricts results to the given record ids
        (allowlist); ``exclude_ids`` removes the given ids (denylist).
        Unknown ids are ignored. Filtering is exact: the device scan masks
        filtered-out rows the same way it masks deleted slots, so the
        returned hits are the true top-k of the filtered subset.
        """
        rids_l, vals_l, valid_l, pget, single = self._search_lists(
            queries, k, within_ids, exclude_ids, search_kw)
        results = [
            [SearchHit(r, v, pget(r, ""))
             for r, v, ok in zip(rb, vb, okb) if ok]
            for rb, vb, okb in zip(rids_l, vals_l, valid_l)
        ]
        return results[0] if single else results

    def search_triples(self, queries, k: int = 10, *, within_ids=None,
                       exclude_ids=None, **search_kw):
        """Exact kNN returning per-query lists of ``(record_id, score,
        payload)`` TUPLES — the serving hot path. Identical semantics to
        :meth:`search_similar`; tuples cost ~5x less to build than
        SearchHit objects at batch 256 x k 16, and the network server
        re-serializes them to JSON untouched."""
        rids_l, vals_l, valid_l, pget, single = self._search_lists(
            queries, k, within_ids, exclude_ids, search_kw)
        results = [
            [(r, v, pget(r, ""))
             for r, v, ok in zip(rb, vb, okb) if ok]
            for rb, vb, okb in zip(rids_l, vals_l, valid_l)
        ]
        return results[0] if single else results

    def search_packed(self, queries, k: int = 10, *, within_ids=None,
                      exclude_ids=None, **search_kw):
        """Exact kNN in wire-packable form: ``(ids, scores, counts,
        payloads)`` where ``ids`` (uint64) and ``scores`` (float32) are
        flat row-major arrays of only the valid hits, ``counts`` (uint32)
        gives each query's hit count, and ``payloads`` lists the matching
        payload strings in the same order. The network server base64s the
        arrays directly — a 256 x 100 batch response drops from ~41 ms of
        JSON encode to ~1 ms of packing + the payload list."""
        rids, vals, valid, pmap, _single = self._search_arrays(
            queries, k, within_ids, exclude_ids, search_kw)
        counts = valid.sum(axis=1).astype(np.uint32)
        mask = valid.ravel()
        ids_flat = rids.ravel()[mask].astype(np.uint64, copy=False)
        scores_flat = vals.ravel()[mask].astype(np.float32, copy=False)
        pget = pmap.get
        payloads = [pget(i, "") for i in ids_flat.tolist()]
        return ids_flat, scores_flat, counts, payloads

    def _search_lists(self, queries, k, within_ids, exclude_ids, search_kw):
        rids, vals, valid, pmap, single = self._search_arrays(
            queries, k, within_ids, exclude_ids, search_kw)
        return (rids.tolist(), vals.tolist(), valid.tolist(),
                pmap.get, single)

    def _search_arrays(self, queries, k, within_ids, exclude_ids,
                       search_kw):
        """Shared search body: locks, device scan, slot->id binding,
        payload map — returning numpy arrays + the payload dict (callers
        convert once at the edge; per-element numpy scalar indexing cost
        ~6.7 ms/batch at 256 x 16, more than the device scan itself)."""
        if within_ids is not None and exclude_ids is not None:
            raise ValueError("Pass within_ids or exclude_ids, not both")
        q = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        single = np.asarray(queries).ndim == 1
        if q.shape[1] != self.config.dim:
            raise DimensionMismatchError(
                f"Query dim {q.shape[1]} != collection dim {self.config.dim}")
        with metrics.timed("collection.search", collection=self.config.name,
                           batch=int(q.shape[0]), k=k,
                           metric=self.config.metric,
                           shards=self.engine.shards):
            with self._rw.read():
                if within_ids is not None or exclude_ids is not None:
                    ids = _as_id_array(
                        within_ids if within_ids is not None else exclude_ids)
                    mode = "within" if within_ids is not None else "exclude"
                    search_kw["filter_mask"] = self._filter_mask(mode, ids)
                vals, slots = self.engine.search(q, k, **search_kw)
                # Slot->id binding and payload lookup must happen under the
                # same read lock as the search: a concurrent delete+insert
                # reusing a freed slot (or a compaction) would otherwise
                # rebind slots between the device scan and the id mapping.
                rids = self.slot_ids(slots)
                # .tolist() (one C conversion) beats a genexpr of int(r)
                # over numpy scalars by ~1 ms at batch 256 x k 16 — and
                # payload keys MUST be Python ints (np.uint64 hashes
                # equal but set_many stored int keys).
                payloads = self.payloads.get_many(
                    np.unique(rids[rids != NO_ID]).tolist())
        valid = (slots >= 0) & (rids != NO_ID)
        return rids, np.asarray(vals), valid, payloads, single

    def slot_ids(self, slots: np.ndarray) -> np.ndarray:
        """Bulk slot->record-id mapping for engine search output: rows with
        the -1 'no result' sentinel map through slot 0 and must be filtered
        by callers via ``(slot >= 0) & (id != NO_ID)``. Call under the same
        lock that covered the search (slot bindings are per-generation)."""
        return self.alloc.ids_of(
            np.where(slots >= 0, slots, 0).astype(np.uint64)
        ).reshape(slots.shape)

    def _filter_mask(self, mode: str, ids: np.ndarray):
        """Device filter mask for an id list, cached per mutation
        generation (called under the read lock, so the id->slot bindings
        the mask captures are the ones the search observes)."""
        import hashlib
        key = (mode,
               hashlib.blake2b(ids.tobytes(), digest_size=16).digest())
        gen = self._mutgen
        with self._fcache_lock:
            hit = self._fcache.get(key)
            if hit is not None and hit[0] == gen:
                return hit[1]
        fslots = self.alloc.slots_of(ids)
        fslots = fslots[fslots != NO_ID]
        mask = self.engine.filter_mask_from_slots(
            fslots.astype(np.int64), mode=mode)
        with self._fcache_lock:
            if len(self._fcache) >= 8:  # tiny bound; stale gens evict first
                stale = [k2 for k2, v in self._fcache.items()
                         if v[0] != gen]
                for k2 in stale or [next(iter(self._fcache))]:
                    self._fcache.pop(k2, None)
            self._fcache[key] = (gen, mask)
        return mask

    def export_records(self, dest) -> int:
        """Extension verb EXPORT: stream every live record to ``dest`` (a
        path or text file object) in the reference's ``v0,...,vD;payload``
        line format (``embeddings.rs:61``) — BULKINSERT's exact inverse, so
        a dump re-ingests anywhere the record format is spoken. Returns the
        number of records written.

        Contract: a portable dump, not a snapshot — record ids are NOT
        preserved (BULKINSERT assigns fresh ones; use snapshots for
        id-stable backup), vectors are the dequantized STORED
        representation (what search scores), and payloads round-trip
        exactly (line-safe escaping). Concurrent-mutation semantics: each
        chunk re-resolves ids under a read lock, so records deleted during
        the export may be omitted, updates may export either version, and
        inserts landing after the cut are not included — every record that
        stays live throughout IS exported. Memory is bounded (chunked
        device gathers, streaming writes)."""
        from .records import format_records_block

        with self._rw.read():
            rids = self.alloc.ids_of(
                self.alloc.live_slots().astype(np.uint64))
        # utf-8 regardless of locale: dumps must be portable across hosts
        # (BULKINSERT reads them back as utf-8 too).
        f = open(dest, "w", encoding="utf-8") \
            if isinstance(dest, (str, Path)) else dest
        written = 0
        try:
            for start in range(0, rids.size, self.SNAPSHOT_CHUNK_ROWS):
                rid_chunk = rids[start:start + self.SNAPSHOT_CHUNK_ROWS]
                with self._rw.read():
                    # Re-resolve under the lock: slots captured at the cut
                    # may have been freed/reused by concurrent mutations.
                    slots = self.alloc.slots_of(rid_chunk)
                    live = slots != NO_ID
                    rid_live = rid_chunk[live]
                    vecs = self.engine.gather(slots[live].astype(np.int64))
                    pmap = self.payloads.get_many(
                        int(r) for r in rid_live.tolist())
                if rid_live.size:
                    f.write(format_records_block(
                        vecs, [pmap.get(int(r), "")
                               for r in rid_live.tolist()]))
                    f.write("\n")
                    written += int(rid_live.size)
        finally:
            if f is not dest:
                f.close()
        return written

    # -- maintenance -------------------------------------------------------

    def reindex(self) -> int:
        """REINDEX (reference: types.rs:134-144): compact live rows into
        [0, live_count) — device gather/scatter moves planned by the
        allocator — then reclaim empty tail capacity and snapshot. Returns
        the number of rows moved."""
        with self._maint:
            moved = self._reindex_impl()
        # A budget crossed while this op held _maint was not acted on
        # (the trigger saw the lock and returned): re-evaluate now.
        self._maybe_auto_snapshot()
        return moved

    def _reindex_impl(self) -> int:
        with self._rw.write():
            src, dst = self.alloc.plan_compaction()
            if src.size:
                self.engine.move(src, dst)
                self.alloc.apply_compaction(src, dst)
                self._mutgen += 1  # slots rebound: filter masks stale
            # Live rows are now packed into [0, live): reclaim empty
            # tail segments — search scans CAPACITY (static shapes), so
            # this is what actually restores QPS after mass deletions.
            # Allocator first: it REFUSES if any live slot would fall
            # beyond the new capacity (the engine cut would destroy it).
            live = self.alloc.live_count
            new_cap = self.engine.shrink_target(live)
            if new_cap < self.engine.capacity:
                self.alloc.shrink(new_cap)
                self.engine.shrink_capacity(live)
                # Capacity changed: cached filter masks have the old
                # shape even when no rows moved (src.size == 0).
                self._mutgen += 1
        # Snapshot makes the live set durable and drops the stale WAL
        # prefix. (Compaction itself is not WAL-logged: slots are a
        # device-layout detail, rebuilt from (id, vector) on restore.)
        self._snapshot_impl()
        metrics.counters.inc("collection.compactions")
        return int(src.size)

    def truncate_wal(self) -> None:
        """TRUNCATEWAL for this collection (reference: types.rs:44-54).

        Durability-preserving: the live set is snapshotted first, so
        truncation only drops WAL frames the snapshot already covers — an
        acknowledged record that was never snapshotted can NOT be lost by
        this command (a raw truncate would silently destroy it on the next
        restart)."""
        with self._maint:
            self._snapshot_impl()
        self._maybe_auto_snapshot()  # see reindex(): dropped-trigger race

    # -- persistence -------------------------------------------------------

    # Rows per snapshot gather chunk: bounds peak host memory (~200 MB at
    # dim 768 f32) and the read-lock hold time per chunk.
    SNAPSHOT_CHUNK_ROWS = 65536

    def _pin_snapshot_locked(self) -> Path | None:
        """Hardlink the committed snapshot's files into a fresh hold dir
        (``None`` if the collection has never snapshotted). Caller must
        hold ``_maint`` — that is what excludes a swap between the
        ``is_dir`` check and the links. ``_restore`` normalizes fallback
        dirs (.old/.tmp) to the committed name at load, so checking
        ``snapshot/`` alone sees every snapshot this process can have."""
        import tempfile
        snap = self.path / SNAPSHOT_DIR
        if not snap.is_dir():
            return None
        hold = Path(tempfile.mkdtemp(prefix=_HOLD_PREFIX, dir=self.path))
        from . import snapshot as snapio
        for f in sorted(snap.iterdir()):
            snapio.link_or_copy(f, hold / f.name)
        return hold

    def hold_snapshot(self):
        """Context manager pinning the current committed snapshot: yields a
        directory of hardlinks to its files (or ``None`` if the collection
        has never snapshotted). A concurrent snapshot swap only unlinks
        names — the pinned inodes stay readable for the hold's lifetime, so
        backup/replication can stream multi-GB snapshot files without
        holding any collection lock. The hold dir lives inside the
        collection dir (same filesystem → links always succeed); stale
        holds from a crashed process are swept on the next load."""
        import contextlib

        @contextlib.contextmanager
        def _hold():
            with self._maint:
                hold = self._pin_snapshot_locked()
            try:
                yield hold
            finally:
                if hold is not None:
                    shutil.rmtree(hold, ignore_errors=True)

        return _hold()

    def backup_into(self, dest: Path) -> dict:
        """Copy a point-in-time-consistent image of this collection into
        ``dest`` (created; must not exist): vr_config, the committed
        snapshot, and the durable WAL prefix as of the capture point —
        exactly what ``Collection.load`` restores from. ``payloads.db`` (a
        rebuildable cache) is excluded by design.

        Consistency: the WAL prefix copy and the snapshot pin happen under
        ONE ``_maint`` hold, so a concurrent snapshot cannot truncate WAL
        frames the pinned snapshot does not cover. Mutations — which only
        append past the captured size — proceed throughout; maintenance
        (snapshot/reindex/truncate) blocks only for the WAL copy + link
        pass, after which the multi-GB snapshot byte-copy streams lock-free
        from pinned hardlinks. The capture point is the last mutation ACKED
        before the copy: later mutations may or may not be included."""
        from . import snapshot as snapio
        dest = Path(dest)
        dest.mkdir(parents=True, exist_ok=False)
        shutil.copy2(self.path / CONFIG_FILE, dest / CONFIG_FILE)
        snapio.fsync_file(dest / CONFIG_FILE)  # must survive power loss
        hold = None
        try:
            with self._maint:
                # All indexed WAL frames are acked under the read lock
                # (append and apply share one write-lock hold), and _maint
                # excludes the truncate_until rewrite that would swap the
                # file under us mid-copy.
                with self._rw.read():
                    self.wal.sync()  # ship only durable bytes
                    wal_size = self.wal.valid_size
                wal_bytes = snapio.copy_file_prefix(
                    self.path / WAL_FILE, dest / WAL_FILE, wal_size)
                hold = self._pin_snapshot_locked()
            snap_files = 0
            if hold is not None:
                # Independent bytes (a backup must not share inodes with
                # the live store), streamed outside every lock.
                (dest / SNAPSHOT_DIR).mkdir()
                for f in sorted(hold.iterdir()):
                    shutil.copy2(f, dest / SNAPSHOT_DIR / f.name)
                    snapio.fsync_file(dest / SNAPSHOT_DIR / f.name)
                    snap_files += 1
                snapio.fsync_dir(dest / SNAPSHOT_DIR)
        finally:
            if hold is not None:
                shutil.rmtree(hold, ignore_errors=True)
        snapio.fsync_dir(dest)
        return {"wal_bytes": wal_bytes, "snapshot_files": snap_files}

    # -- replication (pull model; see vrod_tpu/replication.py) --------------

    def repl_position(self) -> int:
        """Highest LSN durably applied here: what a follower resumes from,
        and what a primary reports as its head. Snapshot-covered frames may
        be gone from the WAL, so the floor participates."""
        with self._rw.read():
            return max(self._wal_floor, self.wal.last_lsn)

    def repl_tail(self, after_lsn: int, max_bytes: int = 8 << 20) -> dict:
        """WAL frames a follower at ``after_lsn`` is missing, oldest first,
        bounded by ``max_bytes`` of payload (at least one frame is always
        returned when any is pending, so progress never stalls on a big
        frame). Returns ``{"frames": [(lsn, payload)], "position": head,
        "resync": bool}``; ``resync=True`` means the WAL no longer covers
        the follower's position (frames were truncated by a snapshot, or
        the follower is AHEAD of this primary — a diverged ex-primary) and
        it must re-bootstrap from the snapshot.

        Only acked frames ship: append+apply share one write-lock hold, so
        under the read lock every indexed frame is acked — and an acked
        frame is never rewound. Shipped frames are fsynced here first: a
        follower must never hold bytes the primary could lose in a crash."""
        after_lsn = int(after_lsn)
        with self._rw.read():
            head = max(self._wal_floor, self.wal.last_lsn)
            if after_lsn == head:  # caught up: the idle-poll fast path
                return {"frames": [], "position": head, "resync": False}
            if after_lsn < self._wal_floor or after_lsn > head:
                return {"frames": [], "position": head, "resync": True}
            frames, total = [], 0
            for lsn, payload in self.wal.replay_from(after_lsn):
                if frames and total + len(payload) > max_bytes:
                    break
                frames.append((lsn, payload))
                total += len(payload)
        if frames:
            self._commit.sync_upto(frames[-1][0])
        return {"frames": frames, "position": head, "resync": False}

    def replica_apply(self, lsn: int, frame: bytes, *, sync: bool = True)\
            -> bool:
        """Apply one primary WAL frame to this replica, WAL-first like
        every local mutation (the frame bytes are appended verbatim, so
        the replica's log is a byte-identical suffix of the primary's and
        a restart resumes from its own durable state). Frames at or below
        the local position are duplicate deliveries (pull overlap after a
        reconnect) and return ``False`` untouched. Frames must arrive in
        increasing-LSN order; LSN *gaps* are legal (the primary rewinds
        failed, never-acked ops, leaving holes in the sequence).

        ``sync=False`` defers the fsync so a catch-up batch shares one
        (call :meth:`replica_sync` after the batch)."""
        op = ops.decode(frame)  # validate before touching the WAL
        with self._rw.write():
            if lsn <= max(self._wal_floor, self.wal.last_lsn):
                return False
            self._mutgen += 1
            # Force (not seed) the lsn: a retried frame whose first apply
            # failed-and-rewound must reuse the lsn the monotonic counter
            # already consumed. set_next_lsn refuses duplicates itself.
            self.wal.set_next_lsn(lsn)
            pre = self.wal.valid_size
            self.wal.append(frame, sync=False)
            try:
                self._replay_op(op)
            except BaseException:
                try:
                    self.wal.rewind(pre)
                except Exception:
                    pass
                raise
        if sync:
            self._ack(lsn)
        return True

    def replica_sync(self, lsn: int) -> None:
        """Make every ``replica_apply(..., sync=False)`` up to ``lsn``
        durable (one shared fsync for the whole batch) and let the
        auto-snapshot policy bound the replica's own replay time."""
        self._ack(lsn)

    def snapshot(self) -> Path:
        """Persist live records; the WAL frames they came from become
        redundant and are dropped (``truncate_until`` keeps any tail
        appended concurrently with the snapshot).

        Non-blocking: a brief write lock fixes
        the cut (live slots, ids, last durable LSN), then the device->host
        gather and disk writes run chunk-at-a-time taking only short read
        locks — searches and mutations proceed throughout. The snapshot is
        fuzzy (a concurrently rebound slot may be captured with stale data)
        and the preserved WAL tail re-establishes exactness on restore,
        because replay is idempotent and ordered."""
        with self._maint:
            p = self._snapshot_impl()
        # A compaction budget crossed during this snapshot was deferred
        # (the trigger saw _maint held); a snapshot does NOT compact, so
        # re-evaluate rather than assume the work is done.
        self._maybe_auto_snapshot()
        return p

    def _snapshot_impl(self) -> Path:
        wlock = self._rw.write
        rlock = self._rw.read
        snap_dir = self.path / SNAPSHOT_DIR
        old_dir = self.path / (SNAPSHOT_DIR + ".old")
        tmp_dir = self.path / (SNAPSHOT_DIR + ".tmp")
        if tmp_dir.exists():
            shutil.rmtree(tmp_dir)
        tmp_dir.mkdir(parents=True)

        # Phase 1 — plan the cut under a brief write lock. The cut is the
        # durable LSN HIGH-WATER, not just the last frame in the WAL: with
        # an already-truncated (empty) WAL — e.g. a REINDEX right after a
        # snapshot — wal.last_lsn is 0, and recording 0 would (a) reset
        # LSN assignment after a restore (seed_lsn(0)), breaking
        # cross-restart monotonicity, and (b) hand replication bootstraps
        # a position of 0 below the primary's floor — an infinite resync
        # loop (caught by the replication fuzz).
        with wlock():
            self.wal.sync()  # everything applied so far is durable
            self._commit.mark_synced()
            live_slots = self.alloc.live_slots()
            rids = self.alloc.ids_of(live_slots.astype(np.uint64))
            next_id = self.next_id
            last_lsn = max(self.wal.last_lsn, self._wal_floor)

        # Phase 2 — chunked gather + streaming write, no write lock held.
        # Vectors persist in the STORED representation (f32/bf16/int8 +
        # aux), so restores are bit-exact (no re-quantization drift) and
        # snapshots are 2-4x smaller than an f32 dump.
        n = int(live_slots.size)
        from . import snapshot as snapio
        vw = snapio.RawStreamWriter(tmp_dir / "vectors.bin")
        aw = snapio.RawStreamWriter(tmp_dir / "aux.bin")
        pw = snapio.PayloadStreamWriter(tmp_dir / "payloads.bin", n)
        try:
            chunk = self.SNAPSHOT_CHUNK_ROWS
            for start in range(0, n, chunk):
                sl = live_slots[start:start + chunk].astype(np.int64)
                rid_chunk = rids[start:start + chunk]
                with rlock():
                    rows, auxv = self.engine.gather_raw(sl)
                    pmap = self.payloads.get_many(rid_chunk.tolist())
                pls = [pmap.get(int(r), "") for r in rid_chunk.tolist()]
                vw.write_rows(rows)
                aw.write_rows(auxv.astype(np.float32))
                pw.write_many(pls)
            checksums = {
                "vectors.bin": vw.close(),
                "aux.bin": aw.close(),
                "payloads.bin": pw.close(),
            }
        except BaseException:
            # A failed attempt must not leak fds: the auto-maintenance
            # thread retries after every later mutation.
            for w in (vw, aw, pw):
                w.abort()
            raise
        np.save(tmp_dir / "ids.npy", rids.astype(np.uint64))
        snapio.fsync_file(tmp_dir / "ids.npy")
        checksums["ids.npy"] = snapio.crc32_of_file(tmp_dir / "ids.npy")
        # meta.json self-checksum: the per-file crc32 map protects every
        # OTHER file, but restore keys on meta's own semantic fields
        # (count, last_lsn, storage...) — a flipped byte that keeps the
        # JSON parseable could silently change restore behavior (found by
        # the verify fuzz: "storage" -> "storaQe" verified OK but broke
        # the load). meta_crc covers the canonical serialization of all
        # other fields; _pick_snapshot and verify_image recheck it.
        meta = {
            "next_id": next_id,
            "count": n,
            "last_lsn": last_lsn,
            "storage": {"dtype": self.config.dtype, "dim": self.config.dim},
            "crc32": checksums,
        }
        meta["meta_crc"] = snapio.meta_self_crc(meta)
        (tmp_dir / "meta.json").write_text(json.dumps(meta))
        snapio.fsync_file(tmp_dir / "meta.json")
        snapio.fsync_dir(tmp_dir)

        # Phase 3 — durable swap: keep the previous snapshot as .old until
        # the new one is fully in place (a crash at any point leaves a
        # CRC-valid snapshot plus a WAL that covers everything after it).
        if old_dir.exists():
            shutil.rmtree(old_dir)
        if snap_dir.exists():
            snap_dir.rename(old_dir)
            snapio.fsync_dir(self.path)
        tmp_dir.rename(snap_dir)
        snapio.fsync_dir(self.path)

        # Phase 4 — the WAL prefix up to the cut is now redundant; frames
        # appended during phases 2-3 survive. The rewrite swaps the WAL fd,
        # so appends (write lock) and in-flight group fsyncs (exclusive)
        # are locked out for its brief duration; the rewrite itself fsyncs
        # the surviving tail, which mark_synced records.
        with wlock():
            with self._commit.exclusive():
                self.wal.truncate_until(last_lsn)
            self.wal.sync()  # covers the no-op case (nothing dropped)
            self._commit.mark_synced()
            self._wal_floor = max(self._wal_floor, last_lsn)
        if old_dir.exists():
            shutil.rmtree(old_dir)
            snapio.fsync_dir(self.path)
        return snap_dir

    def _pick_snapshot(self):
        """Newest CRC-valid snapshot directory: the committed one, else the
        previous (.old — swap crashed mid-way; WAL still covers it), else a
        completed-but-unrenamed .tmp."""
        from . import snapshot as snapio
        main_present = False
        for name in (SNAPSHOT_DIR, SNAPSHOT_DIR + ".old",
                     SNAPSHOT_DIR + ".tmp"):
            d = self.path / name
            meta_p = d / "meta.json"
            if not meta_p.exists():
                continue
            if name == SNAPSHOT_DIR:
                main_present = True
            try:
                meta = json.loads(meta_p.read_text())
                # meta's own fields first (absent = legacy, accepted):
                # restore keys on count/last_lsn/storage, which the
                # per-file crc map cannot protect.
                ok = ("meta_crc" not in meta
                      or int(meta["meta_crc"]) == snapio.meta_self_crc(meta))
                ok = ok and all(
                    snapio.crc32_of_file(d / f) == expect
                    for f, expect in meta.get("crc32", {}).items())
            except Exception:
                continue
            if ok:
                if name != SNAPSHOT_DIR and main_present:
                    import warnings
                    warnings.warn(
                        f"Snapshot at {self.path / SNAPSHOT_DIR} is corrupt;"
                        f" restoring from {name} + WAL replay")
                return d, meta
        if main_present:
            from .errors import WalCorruptionError
            raise WalCorruptionError(
                f"Snapshot at {self.path / SNAPSHOT_DIR} is corrupt (crc "
                f"mismatch) and no fallback validates; restore from a backup")
        return None, None

    def _apply_insert_raw(self, rids, rows, aux, payloads) -> None:
        """Insert rows already in the stored representation (restore)."""
        if (self.config.metric == "dot"
                and self.config.dtype not in ("int8", "int4")
                and len(rids) and float(np.max(aux)) == 0.0):
            # Legacy (round <= 2) dot snapshots stored aux = 0; the lane
            # now carries |x|^2 (feeds the sampled floor's norm bound) —
            # recompute for this chunk. New snapshots round-trip as-is.
            aux = (np.asarray(rows, dtype=np.float32) ** 2).sum(axis=1)
        self._ensure_capacity(len(rids))
        slots = self.alloc.acquire(rids)
        self.engine.write_raw(slots, rows, aux)
        self.payloads.set_many(rids.tolist(), payloads)
        self.next_id = max(self.next_id, int(rids.max()) + 1)

    def _restore(self) -> None:
        snap_dir, meta = self._pick_snapshot()
        if snap_dir is not None:
            from . import snapshot as snapio
            rids = np.load(snap_dir / "ids.npy")
            chunk = self.SNAPSHOT_CHUNK_ROWS
            # Streamed/memory-mapped reads: restore memory is bounded by
            # the chunk size, not the collection size.
            if (snap_dir / "payloads.bin").exists():
                payload_chunks = snapio.read_payloads(
                    snap_dir / "payloads.bin", chunk_records=chunk)
            else:  # legacy (round-1) snapshot layout
                pmap = json.loads((snap_dir / "payloads.json").read_text())
                payload_chunks = (
                    [pmap.get(str(r), "") for r in rids[s:s + chunk].tolist()]
                    for s in range(0, rids.size, chunk))
            storage = meta.get("storage")
            if storage is not None:
                # Stored-representation snapshot: bit-exact raw scatter.
                row_chunks = snapio.read_raw_rows(
                    snap_dir / "vectors.bin", storage["dtype"],
                    snapio.storage_row_elems(str(storage["dtype"]),
                                             int(storage["dim"])),
                    chunk_rows=chunk)
                aux_chunks = snapio.read_raw_rows(
                    snap_dir / "aux.bin", "float32", 1, chunk_rows=chunk)
                for start, rows, auxv, pls in zip(
                        range(0, rids.size, chunk), row_chunks, aux_chunks,
                        payload_chunks):
                    self._apply_insert_raw(
                        rids[start:start + chunk], rows, auxv, pls)
            else:  # legacy f32 vectors.npy
                vecs = np.load(snap_dir / "vectors.npy", mmap_mode="r")
                for start, pls in zip(
                        range(0, rids.size, chunk), payload_chunks):
                    self._apply_insert(
                        rids[start:start + chunk],
                        np.asarray(vecs[start:start + chunk],
                                   dtype=np.float32),
                        pls)
            self.next_id = max(self.next_id, int(meta["next_id"]))
            self.wal.seed_lsn(int(meta.get("last_lsn", 0)))
            self._wal_floor = int(meta.get("last_lsn", 0))
        # Crash recovery: drop any torn tail, then replay the durable prefix.
        if self.wal.has_torn_tail:
            self.wal.repair()
        for _lsn, frame in self.wal.replay():
            self._replay_op(ops.decode(frame))
        # Normalize: promote a fallback (.old/.tmp) the restore used to the
        # committed name, so every live-process consumer of the snapshot
        # dir (backup pinning, replication bootstrap, cold stats) sees ONE
        # invariant — "snapshot/ is the newest valid snapshot" — instead of
        # re-implementing the fallback search. Crash-safe: the corrupt/
        # stale main dir is removed first; a crash between the rmtree and
        # the rename just falls back again on the next load.
        if snap_dir is not None and snap_dir.name != SNAPSHOT_DIR:
            main = self.path / SNAPSHOT_DIR
            if main.exists():
                shutil.rmtree(main)
            snap_dir.rename(main)
            from . import snapshot as snapio
            snapio.fsync_dir(self.path)
            snap_dir = main
        # Leftover swap intermediates are garbage once restore succeeded.
        for name in (SNAPSHOT_DIR + ".old", SNAPSHOT_DIR + ".tmp"):
            d = self.path / name
            if d.exists() and d != snap_dir:
                shutil.rmtree(d, ignore_errors=True)

    def _replay_op(self, op) -> None:
        """Idempotent replay: re-applying an already-applied op is a no-op."""
        if isinstance(op, ops.BulkOp):
            mask = np.array([self.alloc.slot_of(int(r)) == NO_ID
                             for r in op.record_ids])
            if mask.any():
                self._apply_insert(op.record_ids[mask], op.vectors[mask],
                                   [p for p, m in zip(op.payloads, mask) if m])
            self.next_id = max(self.next_id, int(op.record_ids.max()) + 1)
        elif isinstance(op, ops.InsertOp):
            if self.alloc.slot_of(op.record_id) == NO_ID:
                self._apply_insert(
                    np.array([op.record_id], dtype=np.uint64),
                    op.vector[None, :], [op.payload])
            self.next_id = max(self.next_id, op.record_id + 1)
        elif isinstance(op, ops.DeleteOp):
            if self.alloc.slot_of(op.record_id) != NO_ID:
                self._apply_delete(op.record_id)
        elif isinstance(op, ops.BulkDeleteOp):
            known = np.array(
                [r for r in op.record_ids.tolist()
                 if self.alloc.slot_of(r) != NO_ID], dtype=np.uint64)
            if known.size:
                self._apply_bulk_delete(known)
        elif isinstance(op, ops.UpdateOp):
            # Liveness guard like the other ops: a record absent at replay
            # time (snapshotted post-delete, or the delete frame survived
            # the truncate cut) makes UPDATE = INSERT of the new value —
            # a later DeleteOp frame then converges the state. Calling
            # _apply_update on a missing id would crash on the NO_ID slot.
            if self.alloc.slot_of(op.record_id) == NO_ID:
                self._apply_insert(
                    np.array([op.record_id], dtype=np.uint64),
                    op.vector[None, :], [op.payload])
            else:
                self._apply_update(op.record_id, op.vector[None, :],
                                   op.payload)
            self.next_id = max(self.next_id, op.record_id + 1)
        else:
            raise TypeError(f"Unexpected op in collection WAL: {op}")

    # -- stats -------------------------------------------------------------

    def stats(self) -> dict:
        return {
            "name": self.config.name,
            "dim": self.config.dim,
            "metric": self.config.metric,
            "dtype": self.config.dtype,
            "count": self.count,
            "capacity": self.engine.capacity,
            "high_water": self.alloc.high_water,
            "shards": self.engine.shards,
            "wal_frames": self.wal.frame_count,
        }
