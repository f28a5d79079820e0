"""Python client for the vrod-tpu network server (``server.py``).

Speaks the newline-delimited-JSON protocol over TCP or a unix socket.
Thread-safe: one socket, requests serialized by an internal lock (open one
client per thread for pipelining — the server batches across connections,
so concurrent clients still share one device batch). The wire protocol is
the JAX package's, byte for byte: this client and ``vrod_tpu.client`` talk
to either package's server.

    with VrodClient("127.0.0.1:7045") as c:
        c.execute("CREATE", arg="docs;dim=384;metric=cosine")
        rid = c.insert("docs", vec, "payload")
        hits = c.search_similar("docs", vec, k=5)
"""

from __future__ import annotations

import json
import socket
import threading

import numpy as np

from .errors import VrodError
from .netaddr import parse_addr  # NOT server.py: keep clients engine-free

# Upper bound on a single raw continuation frame a server may announce
# (mirrors the server's MAX_LINE_BYTES): a hostile/broken peer must not
# make the client allocate unbounded memory.
MAX_RAW_BYTES = 256 * 1024 * 1024


class VrodServerError(VrodError):
    """The server answered ``ok: false``; the message is its error text."""


class VrodConnectionError(VrodServerError):
    """Transport failure (timeout/reset/desync). The client hard-fails every
    subsequent call: after a read timeout the response stream is out of
    sync with requests, so silently continuing could pair responses with
    the wrong requests — and blind retries would re-execute mutations that
    may already have applied server-side. Reconnect with a new client."""


class Hit:
    """One similarity-search result (mirrors collection.SearchHit)."""

    __slots__ = ("record_id", "score", "payload")

    def __init__(self, record_id: int, score: float, payload: str):
        self.record_id = record_id
        self.score = score
        self.payload = payload

    def __repr__(self):
        return f"Hit({self.record_id}, {self.score:.6f}, {self.payload!r})"

    def __iter__(self):  # tuple-unpacking convenience
        return iter((self.record_id, self.score, self.payload))


class VrodClient:
    def __init__(self, addr, *, timeout: float | None = 600.0,
                 auth_token: str | None = None,
                 connect_timeout: float | None = None,
                 binary_vectors: bool = True):
        self._auth_token = auth_token
        # Send vectors as base64 little-endian float32 (vector_b64 /
        # vectors_b64): ~17x cheaper for the server to parse and ~30x
        # cheaper to encode than JSON float lists at dim 768, 3.8x
        # smaller on the wire. False = plain JSON lists (any server that
        # predates the binary fields, or wire-level debugging).
        self._binary = binary_vectors
        spec = parse_addr(addr)
        # Separate connect timeout: the op timeout is sized for slow
        # first-compile searches (minutes), but a dead/blackholed host
        # should fail the CONNECT in seconds (VrodPool failover relies on
        # this). None = use the op timeout.
        cto = timeout if connect_timeout is None else connect_timeout
        if spec[0] == "unix":
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.settimeout(cto)
            self._sock.connect(spec[1])
            self._sock.settimeout(timeout)
        else:
            self._sock = socket.create_connection(
                (spec[1], spec[2]), timeout=cto)
            self._sock.settimeout(timeout)
        self._rfile = self._sock.makefile("rb")
        self._lock = threading.Lock()
        self._next_id = 0
        self._broken: str | None = None  # why the connection is unusable
        # Highest durable position each mutation response reported, per
        # collection — hand it to a replica via min_position= for
        # read-your-writes (see position()).
        self._positions: dict[str, int] = {}

    # -- transport -----------------------------------------------------------

    def _request(self, **req):
        with self._lock:
            if self._broken:
                raise VrodConnectionError(
                    f"Connection is broken ({self._broken}); reconnect "
                    f"with a new VrodClient")
            self._next_id += 1
            req["id"] = self._next_id
            if self._auth_token is not None:
                req["auth"] = self._auth_token
            try:
                self._sock.sendall(json.dumps(req).encode() + b"\n")
                line = self._rfile.readline()
            except OSError as e:
                self._broken = f"transport error: {e}"
                raise VrodConnectionError(self._broken) from e
            if not line:
                self._broken = "server closed the connection"
                raise VrodConnectionError(self._broken)
            try:
                resp = json.loads(line)
            except ValueError as e:
                self._broken = f"unparseable response: {e}"
                raise VrodConnectionError(self._broken) from e
            if resp.get("id") != req["id"]:
                # A stale response (e.g. from before an interrupted call)
                # means request/response pairing is lost for good.
                self._broken = (f"response desync: expected id "
                                f"{req['id']}, got {resp.get('id')!r}")
                raise VrodConnectionError(self._broken)
            result = resp.get("result")
            # Raw continuation: the response line announced raw_bytes — N
            # verbatim bytes follow the newline (replication bulk frames;
            # base64-in-JSON caps at ~40 MB/s of pure codec, measured in
            # the JAX package). Must be
            # consumed under the lock: the bytes are part of THIS
            # response's framing.
            if (resp.get("ok") and isinstance(result, dict)
                    and "raw_bytes" in result):
                n = int(result.pop("raw_bytes"))
                if n < 0 or n > MAX_RAW_BYTES:
                    self._broken = (f"server announced an unreasonable "
                                    f"raw frame of {n} bytes")
                    raise VrodConnectionError(self._broken)
                buf = bytearray()
                while len(buf) < n:
                    try:
                        piece = self._rfile.read(n - len(buf))
                    except OSError as e:
                        self._broken = f"transport error mid raw frame: {e}"
                        raise VrodConnectionError(self._broken) from e
                    if not piece:
                        self._broken = "connection closed mid raw frame"
                        raise VrodConnectionError(self._broken)
                    buf.extend(piece)
                result["raw"] = bytes(buf)
            # Position high-water update stays under the lock: two
            # concurrent mutators doing read-max-store outside it could
            # REGRESS the recorded position (lost update), and a regressed
            # min_position silently under-waits on a replica.
            if (resp.get("ok") and isinstance(result, dict)
                    and "position" in result and req.get("collection")):
                c = str(req["collection"])
                self._positions[c] = max(self._positions.get(c, 0),
                                         int(result["position"]))
        if not resp.get("ok"):
            raise VrodServerError(resp.get("error", "unknown server error"))
        return result

    def close(self) -> None:
        try:
            self._rfile.close()
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- API -----------------------------------------------------------------

    def ping(self) -> str:
        return self._request(cmd="PING")

    def stats(self) -> dict:
        return self._request(cmd="STATS")

    def shutdown_server(self) -> str:
        return self._request(cmd="SHUTDOWN")

    def execute(self, cmd: str, collection: str | None = None,
                arg: str | None = None):
        """Run any reference verb with the CLI's ``-a`` string contract."""
        req = {"cmd": cmd}
        if collection is not None:
            req["collection"] = collection
        if arg is not None:
            req["arg"] = arg
        return self._request(**req)

    def _vec_field(self, vector, key: str = "vector") -> dict:
        arr = np.ascontiguousarray(np.asarray(vector, np.float32))
        if self._binary:
            import base64
            d = {f"{key}_b64":
                 base64.b64encode(
                     arr.astype("<f4", copy=False).tobytes()).decode()}
            if arr.ndim == 2:
                # Packed rows carry no shape: the server infers the row
                # width from the collection dim and cross-checks this
                # count, so a wrong-dim batch errors instead of silently
                # reshaping into the wrong number of queries.
                d["rows"] = int(arr.shape[0])
            return d
        return {key: arr.tolist()}

    def position(self, collection: str) -> int:
        """Highest durable position this client's mutations reached (0 if
        it never mutated the collection). Pass to a REPLICA's search via
        ``min_position=`` to read your own writes despite replication lag."""
        return self._positions.get(str(collection), 0)

    def search_similar(self, collection: str, vector, k: int = 10, *,
                       within_ids=None, exclude_ids=None,
                       min_position: int | None = None) -> list[Hit]:
        req = {"cmd": "SEARCHSIMILAR", "collection": collection, "k": k,
               **self._vec_field(vector)}
        if within_ids is not None:
            req["within"] = [int(i) for i in within_ids]
        if exclude_ids is not None:
            req["exclude"] = [int(i) for i in exclude_ids]
        if min_position is not None:
            req["min_position"] = int(min_position)
        return [Hit(*h) for h in self._request(**req)["hits"]]

    def search_similar_batch(self, collection: str, vectors, k: int = 10, *,
                             within_ids=None, exclude_ids=None,
                             min_position: int | None = None
                             ) -> list[list[Hit]]:
        vecs = np.atleast_2d(np.asarray(vectors, np.float32))
        if vecs.ndim != 2:
            # Both wire forms must agree: the packed form would otherwise
            # flatten a mis-shaped (e.g. 3-D) tensor into silently wrong
            # queries — the exact failure the rows cross-check guards.
            raise ValueError(f"'vectors' must be 2-D, got {vecs.shape}")
        req = {"cmd": "SEARCHSIMILAR", "collection": collection, "k": k,
               **self._vec_field(vecs, "vectors")}
        if self._binary:
            req["binary_hits"] = True  # packed arrays beat JSON triples
            req["raw"] = True  # and raw continuation beats base64 (~1.33x
            #                    wire + codec); older servers ignore this
            #                    and answer hits_b64 — both are handled.
        if within_ids is not None:
            req["within"] = [int(i) for i in within_ids]
        if exclude_ids is not None:
            req["exclude"] = [int(i) for i in exclude_ids]
        if min_position is not None:
            req["min_position"] = int(min_position)
        result = self._request(**req)
        if "hits_raw" in result:
            # counts (b x u4) || ids (n x u8) || scores (n x f4), verbatim
            # after the response line (see VrodServer SEARCHSIMILAR).
            hr, raw = result["hits_raw"], result.get("raw", b"")
            b, n = int(hr["b"]), int(hr["n"])
            if len(raw) != 4 * b + 12 * n:
                self._broken = (f"hits_raw announced b={b} n={n} but the "
                                f"raw frame holds {len(raw)} bytes")
                raise VrodConnectionError(self._broken)
            counts = np.frombuffer(raw, dtype="<u4", count=b).tolist()
            ids = np.frombuffer(raw, dtype="<u8", count=n,
                                offset=4 * b).tolist()
            scores = np.frombuffer(raw, dtype="<f4", count=n,
                                   offset=4 * b + 8 * n).tolist()
            payloads = result["payloads"]
        elif result.get("hits_b64") is None:
            return [[Hit(*h) for h in hits] for hits in result["batches"]]
        else:
            import base64
            packed = result["hits_b64"]
            ids = np.frombuffer(base64.b64decode(packed["ids"]),
                                dtype="<u8").tolist()
            scores = np.frombuffer(base64.b64decode(packed["scores"]),
                                   dtype="<f4").tolist()
            counts = np.frombuffer(base64.b64decode(packed["counts"]),
                                   dtype="<u4").tolist()
            payloads = packed["payloads"]
        out, pos = [], 0
        for n in counts:
            out.append([Hit(ids[i], scores[i], payloads[i])
                        for i in range(pos, pos + n)])
            pos += n
        return out

    def get(self, collection: str, record_id: int, *,
            min_position: int | None = None):
        """Exact lookup → (vector, payload)."""
        req = {"cmd": "SEARCH", "collection": collection,
               "record_id": int(record_id)}
        if min_position is not None:
            req["min_position"] = int(min_position)
        r = self._request(**req)
        return np.asarray(r["vector"], np.float32), r["payload"]

    def insert(self, collection: str, vector, payload: str = "") -> int:
        r = self._request(cmd="INSERT", collection=collection,
                          payload=payload, **self._vec_field(vector))
        return r["record_id"]

    def bulk_insert(self, collection: str, vectors, payloads=None
                    ) -> list[int]:
        arr = np.asarray(vectors, np.float32)
        if arr.size == 0:
            return []  # Collection.bulk_insert([]) is a no-op too
        vecs = np.atleast_2d(arr)
        if vecs.ndim != 2:
            raise ValueError(f"'vectors' must be 2-D, got {vecs.shape}")
        if payloads is None:
            payloads = [""] * len(vecs)
        if self._binary:
            r = self._request(cmd="BULKINSERT", collection=collection,
                              payloads=[str(p) for p in payloads],
                              **self._vec_field(vecs, "vectors"))
        else:
            r = self._request(cmd="BULKINSERT", collection=collection,
                              records=[[v.tolist(), p]
                                       for v, p in zip(vecs, payloads)])
        return r["record_ids"]

    def update(self, collection: str, record_id: int, vector,
               payload: str = "") -> None:
        self._request(cmd="UPDATE", collection=collection,
                      record_id=int(record_id), payload=payload,
                      **self._vec_field(vector))

    def delete(self, collection: str, ids) -> int:
        if np.isscalar(ids) or isinstance(ids, (int, np.integer)):
            ids = [ids]
        r = self._request(cmd="DELETE", collection=collection,
                          ids=[int(i) for i in ids])
        return r["deleted"]
