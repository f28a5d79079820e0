"""The serving slice as a whole against the JAX package, on the CPU.

One seeded database directory (written by ``vrod_tpu``, rows in a snapshot,
deletes in the WAL tail) is copied twice; ``vrod_tpu.server.VrodServer``
serves one copy and ``vrod_tpu_torch.server.VrodServer`` the other. The
same SEARCHSIMILAR requests go to both: single queries (the batcher), a
batch (packed hits), ``within``/``exclude`` filters, and a collection whose
create config sets ``rescore_margin=32`` (the candidate margin, as a
request reaches it over the wire). The ids must be equal. The scores agree
to rtol 1e-5 and atol 1e-5, the tolerance ``tests/test_torch_distances.py``
states for float products summed in another order: both packages search
the same stored bytes, and the JAX engine on the CPU runs its scan while
the port runs its kernels' plain versions. Each package's client also
talks to the other's server (one wire protocol).
"""

import shutil
import threading

import numpy as np
import pytest

import vrod_tpu
import vrod_tpu_torch
from vrod_tpu.client import VrodClient as JaxClient
from vrod_tpu_torch.client import VrodClient as PortClient

DIM, N = 32, 3000


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(JAX server, port server, queries, deleted ids per collection)."""
    root = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(21)
    vecs = rng.standard_normal((N, DIM)).astype(np.float32)
    db = vrod_tpu.Database.new(root / "seed", "db")
    cols = {"docs": {}, "wide": {"rescore_margin": 32}}
    gone = {}
    for name, kw in cols.items():
        col = db.create_collection(name, dim=DIM, metric="cosine",
                                   dtype="int8", segment_rows=1024, **kw)
        ids = col.bulk_insert(vecs, [f"{name}{i}" for i in range(N)])
        col.snapshot()
        col.delete_many(ids[::13])
        gone[name] = set(ids[::13].tolist())
    db.close()
    for copy in ("jax", "port"):
        shutil.copytree(root / "seed" / "db", root / copy / "db")
    jdb = vrod_tpu.Database.load(root / "jax" / "db")
    pdb = vrod_tpu_torch.Database.load(root / "port" / "db", device="cpu")
    js = vrod_tpu.VrodServer(jdb, f"unix:{root}/jax.sock").start()
    ps = vrod_tpu_torch.VrodServer(pdb, f"unix:{root}/port.sock").start()
    queries = rng.standard_normal((40, DIM)).astype(np.float32)
    yield js, ps, queries, gone
    for s, d in ((js, jdb), (ps, pdb)):
        s.close()
        d.close()


def assert_same_hits(want, got):
    assert [h.record_id for h in got] == [h.record_id for h in want]
    assert [h.payload for h in got] == [h.payload for h in want]
    np.testing.assert_allclose([h.score for h in got],
                               [h.score for h in want], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("collection", ["docs", "wide"])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_single_queries_match(servers, collection, k):
    """Concurrent single queries through each server's batcher."""
    js, ps, queries, gone = servers
    out = {}

    def ask(addr, key, client_cls, lo):
        with client_cls(addr) as c:
            for i in range(lo, len(queries), 4):
                out[key, i] = c.search_similar(collection, queries[i], k=k)

    threads = [threading.Thread(target=ask, args=(s.address, tag, cls, lo))
               for s, tag, cls in ((js, "jax", JaxClient),
                                   (ps, "port", PortClient))
               for lo in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(len(queries)):
        assert_same_hits(out["jax", i], out["port", i])
        assert len(out["port", i]) == k
        assert not {h.record_id for h in out["port", i]} & gone[collection]


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("collection", ["docs", "wide"])
def test_batch_matches(servers, collection, binary):
    """One batch request: packed hits (raw continuation) and JSON
    triples."""
    js, ps, queries, _ = servers
    got = []
    for s, cls in ((js, JaxClient), (ps, PortClient)):
        with cls(s.address, binary_vectors=binary) as c:
            got.append(c.search_similar_batch(collection, queries, k=16))
    for want, hits in zip(*got):
        assert_same_hits(want, hits)


@pytest.mark.parametrize("mode", ["within", "exclude"])
def test_filters_match(servers, mode):
    js, ps, queries, _ = servers
    ids = list(range(1, N + 1, 3))
    kw = {f"{mode}_ids": ids}
    got = []
    for s, cls in ((js, JaxClient), (ps, PortClient)):
        with cls(s.address) as c:
            got.append(([c.search_similar("docs", q, k=10, **kw)
                         for q in queries[:8]],
                        c.search_similar_batch("docs", queries, k=10, **kw)))
    (js_single, js_batch), (ps_single, ps_batch) = got
    for want, hits in zip(js_single + js_batch, ps_single + ps_batch):
        assert_same_hits(want, hits)
        rids = {h.record_id for h in hits}
        assert rids <= set(ids) if mode == "within" else not rids & set(ids)


@pytest.mark.parametrize("client_pkg,server_pkg", [("jax", "port"),
                                                   ("port", "jax")])
def test_each_client_talks_to_the_other_server(servers, client_pkg,
                                               server_pkg):
    """A client of one package against the other package's server: PING,
    STATS, single and batch searches, an exact lookup, and the
    command-string path, with the answers of the server's own client."""
    js, ps, queries, _ = servers
    server = ps if server_pkg == "port" else js
    own = PortClient if server_pkg == "port" else JaxClient
    other = JaxClient if client_pkg == "jax" else PortClient
    with own(server.address) as a, other(server.address) as b:
        assert b.ping() == "pong"
        assert b.stats()["collections"] == a.stats()["collections"]
        assert_same_hits(a.search_similar("docs", queries[0], k=7),
                         b.search_similar("docs", queries[0], k=7))
        for want, hits in zip(a.search_similar_batch("docs", queries[:5], 7),
                              b.search_similar_batch("docs", queries[:5],
                                                     7)):
            assert_same_hits(want, hits)
        va, pa = a.get("docs", 2)
        vb, pb = b.get("docs", 2)
        np.testing.assert_array_equal(va, vb)
        assert pa == pb == "docs1"
        assert a.execute("SEARCH", "docs", arg="2") == \
            b.execute("SEARCH", "docs", arg="2")
