"""Multi-shard dry run of the port: ``dryrun_multichip(n)``.

The counterpart of ``__graft_entry__.dryrun_multichip``: it row-shards
collections over ``[cpu] * n`` and runs search, erase, growth, moves across
shards, filtered search, the kernels' plain versions (``impl="pallas"``)
against the plain scan, shrinking, int8 + l2 and int4, with tiny shapes. It
is hermetic: the body runs in a subprocess with ``VROD_PLATFORM=cpu`` whose
path holds only this repo, and raises on any failure.

    python -m vrod_tpu_torch.parallel.dryrun [n]
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _hermetic_env() -> dict:
    env = dict(os.environ)
    env["VROD_PLATFORM"] = "cpu"
    env["PYTHONPATH"] = _REPO
    for k in ("VROD_COORDINATOR", "VROD_NUM_PROCESSES", "VROD_PROCESS_ID"):
        env.pop(k, None)
    return env


def dryrun_multichip(n_devices: int) -> None:
    """Row-shard collections over ``[cpu] * n_devices`` and run one full
    search + mutation + growth + compaction + shrink step on tiny shapes in
    a hermetic subprocess; raises on any failure."""
    code = (f"from vrod_tpu_torch.parallel import dryrun; "
            f"dryrun._dryrun_impl({int(n_devices)}); print('dryrun ok')")
    res = subprocess.run([sys.executable, "-c", code], env=_hermetic_env(),
                         cwd=_REPO, capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0 or "dryrun ok" not in res.stdout:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) subprocess failed "
            f"(rc={res.returncode})\nstdout:\n{res.stdout[-2000:]}\n"
            f"stderr:\n{res.stderr[-4000:]}")


def _dryrun_impl(n_devices: int) -> None:
    """The dry-run body (runs inside the hermetic subprocess)."""
    import torch
    from ..config import CollectionConfig
    from ..engine import DeviceEngine

    devices = [torch.device("cpu")] * n_devices
    cfg = CollectionConfig(name="dryrun", dim=128, metric="cosine",
                           segment_rows=128, shards=n_devices)
    eng = DeviceEngine(cfg, devices=devices)
    assert eng.shards == n_devices

    rng = np.random.default_rng(0)
    n = 128 * n_devices
    vecs = rng.standard_normal((n, cfg.dim)).astype(np.float32)
    eng.ensure_capacity(n)
    eng.write(np.arange(n, dtype=np.uint64), vecs)          # sharded scatter
    eng.erase(np.arange(0, n, 5))                            # delete bitmap
    vals, idx = eng.search(rng.standard_normal((16, cfg.dim)), k=10)
    assert vals.shape == (16, 10) and idx.shape == (16, 10)
    assert (idx % 5 != 0).all(), "deleted slots leaked into results"
    q = vecs[7:8]
    _, idx1 = eng.search(q, k=1)
    assert idx1[0, 0] == 7, idx1

    # Capacity growth re-lays the rows over the shards.
    grew = eng.ensure_capacity(2 * n)
    assert grew and eng.capacity >= 2 * n
    assert eng.rows_local == eng.capacity // n_devices
    more = rng.standard_normal((n, cfg.dim)).astype(np.float32)
    eng.write(np.arange(n, 2 * n, dtype=np.uint64), more)
    _, idx2 = eng.search(more[3:4], k=1)
    assert idx2[0, 0] == n + 3, idx2
    _, idx0 = eng.search(vecs[8:9], k=1)
    assert idx0[0, 0] == 8, idx0

    # Compaction moves across shards: relocate live rows into freed slots.
    src = np.array([n + 1, n + 2], dtype=np.int64)
    dst = np.array([0, 5], dtype=np.int64)
    eng.erase(np.array([0, 5], dtype=np.int64))
    eng.move(src, dst)
    _, idx3 = eng.search(more[1:2], k=1)
    assert idx3[0, 0] == 0, idx3

    # Filtered search: each shard takes its slice of the mask.
    allow = np.array([3, 8, n + 7], dtype=np.int64)
    mask = eng.filter_mask_from_slots(allow, mode="within")
    _, idxf = eng.search(vecs[3:4], k=3, filter_mask=mask)
    got = set(int(i) for i in idxf[0] if i >= 0)
    assert got == {3, 8, n + 7}, got
    assert idxf[0, 0] == 3, idxf

    # The kernels' path (plain versions on the CPU) agrees with the scan.
    q16 = rng.standard_normal((16, cfg.dim)).astype(np.float32)
    v_p, i_p = eng.search(q16, k=10, impl="pallas")
    v_s, i_s = eng.search(q16, k=10, impl="scan")
    assert (i_p == i_s).all(), (i_p, i_s)
    np.testing.assert_allclose(v_p, v_s, rtol=1e-6)

    # Shrink: keep only the first segment's rows live, cut the tensors.
    eng.erase(np.arange(n, 2 * n, dtype=np.int64))
    shrunk = eng.shrink_capacity(n)
    assert shrunk and eng.capacity == n, (eng.capacity, n)
    _, idx4 = eng.search(vecs[8:9], k=1)
    assert idx4[0, 0] == 8, idx4

    # int8 + l2: the norms lane shards with the rows, grows and moves.
    cfg8 = CollectionConfig(name="dryrun8", dim=128, metric="l2",
                            dtype="int8", segment_rows=128,
                            shards=n_devices)
    e8 = DeviceEngine(cfg8, devices=devices)
    e8.ensure_capacity(n)
    e8.write(np.arange(n, dtype=np.uint64), vecs)
    e8.erase(np.arange(0, n, 7))
    e8.ensure_capacity(n + 128 * n_devices)                  # lane grows
    e8.move(np.array([1, 2], np.int64), np.array([0, 7], np.int64))
    q8 = rng.standard_normal((8, cfg8.dim)).astype(np.float32)
    v_p, i_p = e8.search(q8, k=5, impl="pallas")
    v_s, i_s = e8.search(q8, k=5, impl="scan")
    assert (i_p == i_s).all(), (i_p, i_s)
    np.testing.assert_allclose(v_p, v_s, rtol=1e-6)
    rows, aux = e8.gather_raw(np.arange(e8.capacity))
    want = (rows.astype(np.float32) ** 2).sum(1) * (aux * aux)
    np.testing.assert_array_equal(e8.gather_state()[3].numpy(), want)

    # int4: packed (capacity, dim/2) bytes, row-sharded like any dtype.
    cfg4 = CollectionConfig(name="dryrun4", dim=128, metric="cosine",
                            dtype="int4", segment_rows=128,
                            shards=n_devices)
    e4 = DeviceEngine(cfg4, devices=devices)
    assert e4.packed and e4.gather_state()[0].shape[1] == cfg4.dim // 2
    e4.ensure_capacity(n)
    e4.write(np.arange(n, dtype=np.uint64), vecs)
    e4.erase(np.arange(0, n, 7))
    q4 = rng.standard_normal((8, cfg4.dim)).astype(np.float32)
    v_p4, i_p4 = e4.search(q4, k=5, impl="pallas")
    v_s4, i_s4 = e4.search(q4, k=5, impl="scan")
    assert (i_p4 == i_s4).all(), (i_p4, i_s4)
    np.testing.assert_allclose(v_p4, v_s4, rtol=1e-6)
    _, i_self = e4.search(vecs[8:9], k=1)
    assert i_self[0, 0] == 8, i_self


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
    print("dryrun ok")
