"""Replication quick-start: primary + read replica + pooled client.

Spins up a primary server, a read-only replica pulling from it, and a
VrodPool that writes to the primary and reads from the replica with
read-your-writes. Ends with the zero-loss cutover runbook
(FENCE -> catch up -> PROMOTE). The program of
``examples/replication.py``, over the PyTorch/CUDA port ``vrod_tpu_torch``
(its steps run in ``main()``). Runs on the GPU (``cuda:0``), or on the CPU
with ``VROD_PLATFORM=cpu``:

    python examples/torch_replication.py
"""

import shutil
import tempfile
from pathlib import Path

import numpy as np

from vrod_tpu_torch import Database, VrodPool
from vrod_tpu_torch.client import VrodClient
from vrod_tpu_torch.replication import Replicator
from vrod_tpu_torch.server import VrodServer

DIM = 32


def main():
    tmp = Path(tempfile.mkdtemp(prefix="vrod_repl_demo_"))
    rng = np.random.default_rng(0)

    # --- primary: a served database with one collection -------------------
    primary_db = Database.new(tmp, "primary")
    col = primary_db.create_collection("docs", dim=DIM, segment_rows=4096)
    col.bulk_insert(rng.standard_normal((500, DIM)).astype(np.float32),
                    [f"doc-{i}" for i in range(500)])
    primary = VrodServer(primary_db, f"unix:{tmp}/primary.sock").start()
    print(f"primary serving on {primary.address}")

    # --- replica: fresh database + replicator + read-only server ----------
    replica_db = Database.new(tmp, "replica")
    rep = Replicator(replica_db, primary.address, poll_interval_s=0.2).start()
    replica = VrodServer(replica_db, f"unix:{tmp}/replica.sock",
                         read_only=True).start()
    replica.attach_replicator(rep)
    rep.wait_caught_up()
    print(f"replica caught up on {replica.address} "
          f"(positions: {rep.status()['positions']})")

    # --- pooled client: writes -> primary, reads -> replica, RYW ----------
    with VrodPool(primary.address, [replica.address]) as pool:
        q = rng.standard_normal(DIM).astype(np.float32)
        rid = pool.insert("docs", q, "fresh-write")
        hits = pool.search_similar("docs", q, k=3)  # replica read, sees the write
        assert hits[0].record_id == rid and hits[0].payload == "fresh-write"
        print(f"read-your-writes through the pool: {hits[0]}")

    # --- cutover runbook: FENCE old primary -> catch up -> PROMOTE replica 
    with VrodClient(primary.address) as pc, VrodClient(replica.address) as rc:
        print(pc.execute("FENCE"))
        rep.wait_caught_up()
        print(rc.execute("PROMOTE"))
        new_rid = rc.insert("docs", q * 0.5, "post-cutover")
        print(f"replica promoted; first write on the new primary: id {new_rid}")

    replica.close()
    primary.close()
    replica_db.close()
    primary_db.close()
    shutil.rmtree(tmp, ignore_errors=True)
    print("done")


if __name__ == "__main__":
    main()
