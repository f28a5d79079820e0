"""BACKUP;verify fuzz: the verifier must never say OK to an image whose
LOAD-RELEVANT bytes were corrupted, and never say CORRUPT about a
pristine image.

Property per seed:
  1. Build a random image (mutations, snapshots, REINDEX, multiple
     collections, then BACKUP).
  2. verify_image(image) must be ok=True, AND the image must load with
     the expected model (pristine sanity).
  3. Corrupt ONE random byte in ONE random file of the image (or delete
     a file / truncate a tail). Then EITHER the verifier flags it
     (ok=False), OR the image still loads with the exact pre-backup
     model (the corruption hit bytes that do not matter — e.g. flipping
     a byte inside a payload string's stored length-prefixed copy DOES
     matter, but flipping one in an .old fallback dir that restore never
     picks does not). A verifier-OK + wrong-load is the failure mode
     this fuzz exists to catch.

The port of ``experiments/fuzz_verify.py``: the same op mix, seeds and
invariants over ``vrod_tpu_torch``, on ``runtime.default_device()`` (the
card, or the CPU under ``VROD_PLATFORM=cpu``).

Usage:
    VROD_PLATFORM=cpu python3 tools/fuzz_verify.py 0 50
"""
import os
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

import pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from vrod_tpu_torch.database import Database
from vrod_tpu_torch.verify_image import verify_image

DIM = 8


def build_image(seed, tmp):
    db = Database.new(tmp, "db")
    rng = np.random.default_rng(seed)
    model = {}  # (col, rid) -> payload
    # Rotate the storage tier by seed (and stagger the two collections) so
    # image verification + corrupted-reload checks cover every dtype,
    # incl. the packed int4 tier's halved row width.
    tiers = ("float32", "bfloat16", "int8", "int4")
    for ci, cname in enumerate(("a", "b")):
        col = db.create_collection(cname, dim=DIM, segment_rows=64,
                                   dtype=tiers[(seed + ci) % 4])
        for step in range(rng.integers(5, 25)):
            roll = rng.random()
            if roll < 0.55 or not model:
                n = int(rng.integers(1, 8))
                vecs = rng.standard_normal((n, DIM)).astype(np.float32)
                rids = col.bulk_insert(
                    vecs, [f"{cname}{step}.{i}" for i in range(n)])
                for i, r in enumerate(rids.tolist()):
                    model[(cname, r)] = f"{cname}{step}.{i}"
            elif roll < 0.7:
                keys = [k for k in model if k[0] == cname]
                if keys:
                    cn, rid = keys[int(rng.integers(len(keys)))]
                    col.delete(rid)
                    del model[(cn, rid)]
            elif roll < 0.85:
                col.snapshot()
            else:
                col.reindex()
    db.backup(tmp / "img")
    db.close()
    return model


def loads_with_model(img, model) -> bool:
    # Load a COPY: opening a database MUTATES its directory (DB-WAL
    # recovery truncation, payload-cache rebuild, lock file), so loading
    # the image in place would make every later verify_image pass see a
    # load-touched tree — the backup manifest check rightly flags files
    # whose sizes moved, misattributing the fuzz's own probe as damage.
    work = Path(tempfile.mkdtemp(prefix="vfuzz_load_"))
    try:
        shutil.rmtree(work)
        shutil.copytree(img, work)
        return _loads_with_model_inplace(work, model)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _loads_with_model_inplace(img, model) -> bool:
    try:
        db = Database.load(img)
    except Exception:
        return False
    try:
        for cname in ("a", "b"):
            col = db.collection(cname)
            want = {r: p for (c, r), p in model.items() if c == cname}
            if col.count != len(want):
                return False
            for rid, payload in want.items():
                if col.get(rid).payload != payload:
                    return False
        return True
    except Exception:
        return False
    finally:
        db.close()


def corrupt_once(img: Path, rng) -> str:
    files = sorted(p for p in img.rglob("*") if p.is_file())
    p = files[int(rng.integers(len(files)))]
    rel = p.relative_to(img)
    mode = rng.random()
    if mode < 0.6 and p.stat().st_size > 0:
        data = bytearray(p.read_bytes())
        i = int(rng.integers(len(data)))
        data[i] ^= int(rng.integers(1, 256))
        p.write_bytes(bytes(data))
        return f"flip {rel}@{i}"
    if mode < 0.8 and p.stat().st_size > 1:
        keep = int(rng.integers(p.stat().st_size))
        with open(p, "r+b") as f:
            f.truncate(keep)
        return f"truncate {rel}->{keep}"
    if mode < 0.9 and p.parent.name.startswith("snapshot"):
        # Delete the WHOLE snapshot dir: indistinguishable from a never-
        # snapshotted collection by per-file checksums alone — only the
        # backup manifest witnesses it.
        shutil.rmtree(p.parent)
        return f"rmdir {rel.parent}"
    p.unlink()
    return f"delete {rel}"


def run_seed(seed) -> str:
    tmp = Path(tempfile.mkdtemp(prefix=f"vfuzz{seed}_"))
    try:
        model = build_image(seed, tmp)
        img = tmp / "img"
        rep = verify_image(img)
        assert rep["ok"], f"pristine image flagged: {rep['errors']}"
        assert loads_with_model(img, model), "pristine image failed load"

        rng = np.random.default_rng(seed + 7)
        what = corrupt_once(img, rng)
        rep = verify_image(img)
        if rep["ok"]:
            # The verifier accepted it: the corruption must have been
            # immaterial — the image must still load the exact model.
            assert loads_with_model(img, model), (
                f"VERIFIER FALSE-OK after {what}: image no longer loads "
                f"the pre-backup model")
            return f"seed {seed}: OK ({what}: immaterial, load verified)"
        return f"seed {seed}: OK ({what}: flagged: {rep['errors'][0][:70]})"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    lo = int(sys.argv[1]) if len(sys.argv) > 1 else 0
    hi = int(sys.argv[2]) if len(sys.argv) > 2 else lo + 25
    flagged = immaterial = 0
    for seed in range(lo, hi):
        msg = run_seed(seed)
        if "immaterial" in msg:
            immaterial += 1
        else:
            flagged += 1
        print(msg, flush=True)
    print(f"PASS seeds {lo}-{hi - 1}: {flagged} corruptions flagged, "
          f"{immaterial} immaterial (load re-verified)")


if __name__ == "__main__":
    main()
