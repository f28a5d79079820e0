#!/usr/bin/env python3
"""The random-op model stream of ``tests/test_property_model.py`` over the
port: a seeded sequence of insert / bulk_insert / delete / delete_many /
update / reindex / snapshot / crash-reload operations, applied to one or
more collections in lockstep and to an in-memory dict model, with the
model's invariants checked on every collection at every checkpoint
(count, ``get()``, top-1 of a stored vector, a ``within_ids`` and an
``exclude_ids`` search). A crash-reload is a fresh ``Collection.load`` of
the directory without a close, so WAL replay and snapshot restore run
throughout.

    python3 tools/fuzz_model.py [LO HI] [--device cuda:0] [--steps 120]

runs seeds LO..HI-1 on one port collection each (default: seeds 0-1 on
``runtime.default_device()``, the card unless ``VROD_PLATFORM=cpu``).
``tests/test_torch_property_model.py`` drives the same stream through the
port and the JAX package side by side; ``chip_smoke.py`` runs it on the
card.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

DIM = 12

# The stream's collection configurations, by the JAX test's parameters:
# the sqlite payload view with budget-triggered background snapshots
# interleaving is the third.
CONFIGS = [
    (7, {}),
    (42, {}),
    (7, {"payload_store": "disk", "auto_snapshot_wal_bytes": 8 * 1024}),
]


def check_against_model(col, model) -> None:
    """The model's invariants on one collection (the JAX test's check)."""
    assert col.count == len(model)
    if not model:
        return
    # spot-check a few records
    sample = list(model)[:: max(len(model) // 5, 1)]
    for rid in sample:
        rec = col.get(rid)
        np.testing.assert_allclose(rec.vector, model[rid][0], rtol=1e-6)
        assert rec.payload == model[rid][1]
    # exact search: querying a stored vector returns it first
    rid = sample[0]
    hits = col.search_similar(model[rid][0], k=1)
    got_vec = model[hits[0].record_id][0]
    # (a duplicate vector may legitimately win the tie)
    np.testing.assert_allclose(got_vec, model[rid][0], rtol=1e-5)
    # filtered search: within a random live subset, the oracle top-1 by
    # true cosine must match (filters survive slot reuse/compaction)
    subset = list(model)[:: max(len(model) // 7, 1)]
    q = model[rid][0]
    hits = col.search_similar(q, k=1, within_ids=subset)
    qn = q / max(np.linalg.norm(q), 1e-30)

    def cos(r):
        v = model[r][0].astype(np.float64)
        return float(qn @ (v / max(np.linalg.norm(v), 1e-30)))

    assert hits, "within-filter over live ids returned nothing"
    best = max(cos(r) for r in subset)
    assert cos(hits[0].record_id) >= best - 1e-5
    assert hits[0].record_id in set(subset)
    # exclude filter: the excluded winner must vanish
    hits_ex = col.search_similar(q, k=1, exclude_ids=[hits[0].record_id])
    if hits_ex:
        assert hits_ex[0].record_id != hits[0].record_id


def _same(values):
    """The one value every collection returned (they run in lockstep)."""
    first = values[0]
    for v in values[1:]:
        np.testing.assert_array_equal(np.asarray(v), np.asarray(first))
    return first


def run_stream(opens, seed: int, *, steps: int = 120, check_every: int = 15,
               compare=None):
    """Drive the seeded op stream through ``opens``, a list of
    ``(create, load)`` pairs, one per collection: ``create()`` makes the
    collection, ``load()`` reloads it from its directory. Every collection
    must return the same record ids. At each checkpoint the model's
    invariants are checked on each collection, then ``compare(cols,
    model)`` runs if given. Returns (collections, model) after a final
    reload."""
    rng = np.random.default_rng(seed)
    cols = [create() for create, _ in opens]
    model: dict[int, tuple[np.ndarray, str]] = {}

    def checkpoint():
        for col in cols:
            check_against_model(col, model)
        if compare is not None:
            compare(cols, model)

    for step in range(steps):
        op = rng.integers(0, 100)
        if op < 30:  # insert
            v = rng.standard_normal(DIM).astype(np.float32)
            rid = _same([col.insert(v, f"p{step}") for col in cols])
            model[int(rid)] = (v, f"p{step}")
        elif op < 45:  # bulk insert
            n = int(rng.integers(1, 20))
            vs = rng.standard_normal((n, DIM)).astype(np.float32)
            pl = [f"b{step}-{i}" for i in range(n)]
            rids = _same([col.bulk_insert(vs, pl) for col in cols])
            for i, r in enumerate(rids.tolist()):
                model[r] = (vs[i], f"b{step}-{i}")
        elif op < 60 and model:  # delete one
            rid = int(rng.choice(list(model)))
            for col in cols:
                col.delete(rid)
            del model[rid]
        elif op < 70 and model:  # bulk delete
            n = min(len(model), int(rng.integers(1, 10)))
            rids = rng.choice(list(model), size=n, replace=False)
            for col in cols:
                col.delete_many(rids)
            for r in rids.tolist():
                del model[int(r)]
        elif op < 80 and model:  # update
            rid = int(rng.choice(list(model)))
            v = rng.standard_normal(DIM).astype(np.float32)
            for col in cols:
                col.update(rid, v, f"u{step}")
            model[rid] = (v, f"u{step}")
        elif op < 88:  # reindex (compaction + snapshot)
            for col in cols:
                col.reindex()
        elif op < 94:  # snapshot
            for col in cols:
                col.snapshot()
        else:  # crash-reload (no close: simulates process death)
            # In a real crash the auto-snapshot thread dies with the
            # process; in-process it would keep mutating the old fds while
            # the new Collection owns the dir — wait it out first.
            for i, col in enumerate(cols):
                t = col._autosnap_thread
                if t is not None:
                    t.join(timeout=60)
                cols[i] = opens[i][1]()
        if step % check_every == 0:
            checkpoint()

    checkpoint()
    # final reload must converge to the same state
    cols = [load() for _, load in opens]
    checkpoint()
    # every model record reachable; every deleted one is gone
    for col in cols:
        live = {col.alloc.id_of(int(s)) for s in col.alloc.live_slots()}
        assert live == set(model)
    return cols, model


def port_opens(root: Path, cfg_kw: dict, device=None):
    """The ``(create, load)`` pair of one port collection under ``root``."""
    from vrod_tpu_torch.collection import Collection
    from vrod_tpu_torch.config import CollectionConfig
    cfg = CollectionConfig(name="m", dim=DIM, segment_rows=64, **cfg_kw)
    path = Path(root) / "m"
    return (lambda: Collection.create(path, cfg, device=device),
            lambda: Collection.load(path, device=device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("lo", type=int, nargs="?", default=0)
    ap.add_argument("hi", type=int, nargs="?", default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: runtime.default_device())")
    ap.add_argument("--steps", type=int, default=120)
    args = ap.parse_args(argv)
    from vrod_tpu_torch.runtime import resolve_device
    device = resolve_device(args.device)
    for seed in range(args.lo, args.hi):
        cfg_kw = CONFIGS[seed % len(CONFIGS)][1]
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as td:
            cols, model = run_stream([port_opens(td, cfg_kw, device)], seed,
                                     steps=args.steps)
            for col in cols:
                col.close()
        print(f"seed {seed} ok: {len(model)} live records on {device}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
