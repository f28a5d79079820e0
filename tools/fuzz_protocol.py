"""Server protocol fuzz: hostile/malformed input never kills the server.

Each seed throws a mix at a live server over raw sockets: random bytes,
truncated/oversized lines, valid JSON of random shapes (random cmds,
random field types, huge ints, nulls, nested junk), and half-valid
requests. Invariants: the server answers every complete line with one
JSON object (or closes that connection), never crashes, and keeps
serving a healthy control client (PING + search return correct results)
after every seed.

The port of ``experiments/fuzz_protocol.py``: the same op mix, seeds and
invariants over ``vrod_tpu_torch``, on ``runtime.default_device()`` (the
card, or the CPU under ``VROD_PLATFORM=cpu``).

Usage:
    VROD_PLATFORM=cpu python3 tools/fuzz_protocol.py 0 30

The JAX harness records 300 seeds passing (~24,000 hostile lines); this
harness's campaigns are in PERF.md.
"""
import json
import shutil
import socket
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

import pathlib
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from vrod_tpu_torch.client import VrodClient  # noqa: E402
from vrod_tpu_torch.database import Database  # noqa: E402
from vrod_tpu_torch.server import VrodServer  # noqa: E402

DIM = 4


def pick(rng, options):
    """rng.choice rejects ragged Python lists; index instead."""
    return options[int(rng.integers(0, len(options)))]


def random_json(rng, depth=0):
    r = rng.random()
    if depth > 2 or r < 0.3:
        return pick(rng, [None, True, False, 0, -1, 2**70, 1e308,
                          "", "x" * int(rng.integers(0, 50)), "PING",
                          float("inf") if rng.random() < 0.1 else 1.5])
    if r < 0.6:
        return {str(pick(rng, ["cmd", "collection", "vector", "k", "id",
                               "arg", "records", "ids", "record_id",
                               "vector_b64", "vectors_b64", "rows",
                               "min_position", "auth", "token", "after",
                               str(rng.integers(0, 99))])):
                random_json(rng, depth + 1)
                for _ in range(int(rng.integers(0, 4)))}
    return [random_json(rng, depth + 1) for _ in range(int(rng.integers(0, 4)))]


def hostile_line(rng):
    r = rng.random()
    if r < 0.25:
        return rng.bytes(int(rng.integers(1, 200)))
    if r < 0.5:
        obj = random_json(rng)
        try:
            return json.dumps(obj).encode()
        except (ValueError, TypeError):
            return b'{"cmd": "PING"'
    if r < 0.7:  # half-valid: right shape, wrong types/values
        return json.dumps({
            "cmd": str(pick(rng, ["SEARCHSIMILAR", "INSERT", "DELETE",
                                  "SEARCH", "UPDATE", "BULKINSERT",
                                  "REPL.TAIL", "REPL.FETCH", "CREATE",
                                  "BACKUP", "EXPORT", "PROMOTE",
                                  "FENCE"])),
            "collection": pick(rng, ["c", "", None, 7, "no_such"]),
            "vector": pick(rng, [[1, 2], "nope", None,
                                 [[1, 2], [3]], [1e308]]),
            "k": pick(rng, [-1, 0, 3, 10**9, "k", None]),
            "record_id": pick(rng, [0, -5, 2**64, "x"]),
            "ids": pick(rng, [[1, -2], "x", [2**65]]),
            "vector_b64": pick(rng, ["%%%", "YWJj", ""]),
            "rows": pick(rng, [-1, 0, 99]),
            "after": pick(rng, [-3, 2**70, "z"]),
        }).encode()
    # valid JSON, truncated mid-line (framing recovers on the newline)
    return json.dumps({"cmd": "SEARCHSIMILAR", "collection": "c",
                       "vector": [0.1] * DIM})[:int(rng.integers(3, 40))
                                               ].encode()


def run_seed(seed, lines=80):
    rng = np.random.default_rng(seed)
    tmp = Path(tempfile.mkdtemp(prefix=f"pfuzz{seed}_"))
    db = Database.new(tmp, "db")
    col = db.create_collection("c", dim=DIM, segment_rows=64)
    col.bulk_insert(np.eye(DIM, dtype=np.float32),
                    [f"e{i}" for i in range(DIM)])
    server = VrodServer(db, f"unix:{tmp}/s.sock").start()
    try:
        addr = str(tmp / "s.sock")
        sock = None
        for i in range(lines):
            if sock is None:
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                sock.settimeout(10)
                sock.connect(addr)
            line = hostile_line(rng)
            try:
                if rng.random() < 0.1:
                    # Blank lines are skipped by the server (no response
                    # by design): send one, then a PING on the same
                    # socket — exactly one response must come back.
                    sock.sendall(b"\n" + json.dumps(
                        {"cmd": "PING"}).encode() + b"\n")
                    resp = b""
                    while not resp.endswith(b"\n"):
                        chunk = sock.recv(65536)
                        if not chunk:
                            raise ConnectionError
                        resp += chunk
                    assert json.loads(resp)["ok"] is True
                    continue
                sock.sendall(line + b"\n")
                resp = b""
                while not resp.endswith(b"\n"):
                    chunk = sock.recv(65536)
                    if not chunk:
                        raise ConnectionError
                    resp += chunk
                obj = json.loads(resp)  # every answer is one JSON object
                assert isinstance(obj, dict) and "ok" in obj, obj
            except (ConnectionError, socket.timeout, OSError):
                sock.close()
                sock = None  # server chose to close: allowed
        if sock is not None:
            sock.close()
        # The server is still healthy for well-formed clients.
        with VrodClient(f"unix:{addr}") as c:
            assert c.ping() == "pong"
            hits = c.search_similar("c", np.eye(DIM, dtype=np.float32)[1],
                                    k=1)
            assert hits[0].payload == "e1"
            assert c.stats()["collections"] == ["c"]
    finally:
        server.close()
        db.close()
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    lo, hi = int(sys.argv[1]), int(sys.argv[2])
    t0 = time.time()
    for seed in range(lo, hi):
        run_seed(seed)
        print(f"seed {seed} OK", flush=True)
    print(f"ALL {hi - lo} SEEDS PASSED in {time.time()-t0:.0f}s", flush=True)
