"""Command-layer contract tests (reference: src/command/builder.rs).

Covers: verb dispatch incl. case-insensitivity (builder.rs:29), unknown-verb
error (builder.rs:77-80), TRUNCATEWAL's no-target default (builder.rs:41),
and each command's end-to-end execute().

``tests/test_commands.py`` (14 cases) over ``vrod_tpu_torch``, the same
cases and oracles, unchanged but for the package they import.
"""

import numpy as np
import pytest

from vrod_tpu_torch.commands import VERBS, CommandBuilder
from vrod_tpu_torch.commands import types as T
from vrod_tpu_torch.errors import MissingCommandArgError, UnrecognizedCommandError


@pytest.fixture
def tmp_db(tmp_path):
    """The port's database (conftest's ``tmp_db`` is the JAX package's)."""
    from vrod_tpu_torch.database import Database
    db = Database.new(tmp_path, "testdb")
    yield db
    db.close()


@pytest.fixture
def builder(tmp_db):
    return CommandBuilder(tmp_db)


def test_all_verbs_dispatch(builder):
    expected = {
        "CREATE": T.CreateCollectionCommand,
        "DROP": T.DropCollectionCommand,
        "LISTCOLLECTIONS": T.ListCollectionsCommand,
        "TRUNCATEWAL": T.TruncateWalCommand,
        "INSERT": T.InsertCommand,
        "BULKINSERT": T.BulkInsertCommand,
        "UPDATE": T.UpdateCommand,
        "DELETE": T.DeleteCommand,
        "SEARCH": T.SearchCommand,
        "SEARCHSIMILAR": T.SearchSimilarCommand,
        "REINDEX": T.ReindexCommand,
    }
    assert set(VERBS) == set(expected)
    for verb, cls in expected.items():
        assert isinstance(builder.build(None, verb, None), cls)


def test_case_insensitive(builder):
    """builder.rs:29 upper-cases the verb before matching."""
    for verb in ("create", "Create", "CREATE", "sEaRcHsImIlAr"):
        cmd = builder.build(None, verb, None)
        assert isinstance(cmd, (T.CreateCollectionCommand, T.SearchSimilarCommand))


def test_unknown_verb(builder):
    with pytest.raises(UnrecognizedCommandError, match="Unrecognized command: FOO"):
        builder.build(None, "FOO", None)


def test_truncatewal_target_default(builder):
    """No -c target -> database-level WAL (builder.rs:41)."""
    cmd = builder.build(None, "TRUNCATEWAL", None)
    assert cmd.target is None
    cmd = builder.build("mycol", "TRUNCATEWAL", None)
    assert cmd.target == "mycol"


def test_create_drop_execute(builder):
    out = builder.build(None, "CREATE", "c1;dim=8;metric=l2;segment_rows=64").execute()
    assert "c1" in out and "l2" in out
    out = builder.build(None, "LISTCOLLECTIONS", None).execute()
    assert "c1" in out
    out = builder.build(None, "DROP", "c1").execute()
    assert "Dropped" in out


def test_insert_search_flow(builder, tmp_db):
    builder.build(None, "CREATE", "c;dim=4;segment_rows=64").execute()
    out = builder.build("c", "INSERT", "1,0,0,0;first").execute()
    assert "1" in out
    builder.build("c", "INSERT", "0,1,0,0;second").execute()
    out = builder.build("c", "SEARCHSIMILAR", "1,0,0,0;k=1").execute()
    assert "first" in out
    out = builder.build("c", "SEARCH", "2").execute()
    assert out.endswith(";second")
    builder.build("c", "UPDATE", "2;0,0,1,0;second-v2").execute()
    out = builder.build("c", "SEARCH", "2").execute()
    assert out.endswith(";second-v2")
    builder.build("c", "DELETE", "1").execute()
    out = builder.build("c", "SEARCHSIMILAR", "1,0,0,0;k=5").execute()
    assert "first" not in out
    out = builder.build("c", "REINDEX", None).execute()
    assert "Reindexed" in out


def test_bulkinsert_from_file(builder, tmp_path):
    builder.build(None, "CREATE", "c;dim=3;segment_rows=64").execute()
    f = tmp_path / "recs.txt"
    f.write_text("1,0,0;a\n0,1,0;b\n0,0,1;c\n")
    out = builder.build("c", "BULKINSERT", str(f)).execute()
    assert "3 records" in out


def test_missing_args(builder):
    builder.build(None, "CREATE", "c;dim=4;segment_rows=64").execute()
    for verb in ("INSERT", "UPDATE", "DELETE", "SEARCH", "SEARCHSIMILAR"):
        with pytest.raises(MissingCommandArgError):
            builder.build(None, verb, "1,0,0,0").execute()  # no collection
    with pytest.raises(MissingCommandArgError):
        builder.build("c", "INSERT", None).execute()  # no arg
    with pytest.raises(MissingCommandArgError):
        builder.build(None, "CREATE", None).execute()


def test_unrecognized_command_object(tmp_db):
    out = T.UnrecognizedCommand(tmp_db).execute()
    assert "no-op" in out


def test_create_bad_int_option_is_clean_error(tmp_db):
    from vrod_tpu_torch.commands.builder import CommandBuilder
    from vrod_tpu_torch.errors import RecordFormatError
    import pytest
    cb = CommandBuilder(tmp_db)
    with pytest.raises(RecordFormatError, match="dim=.*integer"):
        cb.build(None, "CREATE", "c;dim=abc").execute()


def test_delete_negative_id_clean_error(tmp_db):
    from vrod_tpu_torch.commands.builder import CommandBuilder
    from vrod_tpu_torch.errors import RecordFormatError
    import pytest
    tmp_db.create_collection("neg", dim=4, segment_rows=64)
    cb = CommandBuilder(tmp_db)
    with pytest.raises(RecordFormatError, match="non-negative"):
        cb.build("neg", "DELETE", "-5,3").execute()


def test_export_dispatch(builder):
    from vrod_tpu_torch.commands.builder import EXTENSION_VERBS

    assert "EXPORT" in EXTENSION_VERBS
    assert isinstance(builder.build("c", "export", "/tmp/x"),
                      T.ExportCommand)


@pytest.mark.parametrize("dtype,metric", [
    ("float32", "cosine"),
    # int8 exports the dequantized STORED representation — what search
    # scores — so under dot (rows scored as stored) the re-ingested f32
    # copy scores identically. (Cosine re-NORMALIZES on ingest, so an
    # int8→f32 round-trip there shifts scores by ~quantization error.)
    ("int8", "dot"),
])
def test_export_roundtrip_through_bulkinsert(builder, tmp_db, tmp_path,
                                             dtype, metric):
    """EXPORT is BULKINSERT's exact inverse: a dump re-ingested into a
    fresh f32 collection reproduces search results (scores + payloads;
    ids are freshly assigned) — including line-escaped payloads."""
    import numpy as np

    col = tmp_db.create_collection("src", dim=8, metric=metric,
                                   dtype=dtype, segment_rows=64)
    rng = np.random.default_rng(4)
    vecs = rng.standard_normal((20, 8)).astype(np.float32)
    payloads = [f"p{i}" for i in range(17)] + \
        ["café ☕", "multi\nline\\x", "cr\rend"]  # utf-8 survives
    col.bulk_insert(vecs, payloads)
    col.delete(3)  # deleted rows must not export

    out = builder.build("src", "EXPORT", str(tmp_path / "dump.txt")).execute()
    assert out == f"Exported 19 records to {tmp_path / 'dump.txt'}"

    builder.build(None, "CREATE", f"dst;dim=8;metric={metric}").execute()
    msg = builder.build("dst", "BULKINSERT",
                        str(tmp_path / "dump.txt")).execute()
    assert msg.startswith("Inserted 19 records")

    dst = tmp_db.collection("dst")
    q = rng.standard_normal((4, 8)).astype(np.float32)
    for ha, hb in zip(col.search_similar(q, k=5), dst.search_similar(q, k=5)):
        assert [(h.score, h.payload) for h in ha] == \
               [(pytest.approx(h.score, abs=1e-6), h.payload) for h in hb]
    # the escaped payloads round-tripped exactly
    got = {h.payload for h in dst.search_similar(vecs[18], k=1)}
    assert got == {"multi\nline\\x"}


def test_export_requires_collection_and_path(builder, tmp_db):
    from vrod_tpu_torch.errors import MissingCommandArgError

    tmp_db.create_collection("e", dim=4, segment_rows=64)
    with pytest.raises(MissingCommandArgError):
        builder.build(None, "EXPORT", "/tmp/x").execute()
    with pytest.raises(MissingCommandArgError):
        builder.build("e", "EXPORT", None).execute()
