"""CLI flag-surface tests (reference: src/main.rs:10-34, :42-77).

``tests/test_cli.py`` (23 cases) over ``vrod_tpu_torch.cli``, the same
cases and oracles, unchanged but for the package they import.
"""

import numpy as np
import pytest

from vrod_tpu_torch.cli import main


def test_init_database(tmp_path, capsys):
    rc = main(["--init-database", str(tmp_path), "-n", "db1"])
    assert rc == 0
    assert (tmp_path / "db1" / "vr_config").exists()
    assert (tmp_path / "db1" / "vr_wal").exists()


def test_init_missing_name_errors(tmp_path, capsys):
    """Reference: ArgsError::MissingInitDatabaseNameFlag (main.rs:36-40, :57)."""
    rc = main(["--init-database", str(tmp_path)])
    assert rc == 1
    err = capsys.readouterr().err
    assert "init-database-name" in err


def test_init_refuses_existing(tmp_path, capsys):
    assert main(["--init-database", str(tmp_path), "-n", "db1"]) == 0
    assert main(["--init-database", str(tmp_path), "-n", "db1"]) == 1


def test_no_args_prints_help(capsys):
    """Reference: arg_required_else_help (main.rs:11)."""
    rc = main([])
    assert rc == 2
    assert "usage" in capsys.readouterr().out.lower()


def test_execute_flow(tmp_path, capsys):
    assert main(["--init-database", str(tmp_path), "-n", "db"]) == 0
    db = str(tmp_path / "db")
    assert main(["-d", db, "-e", "create", "-a", "c;dim=4;segment_rows=64"]) == 0
    assert main(["-d", db, "-c", "c", "-e", "insert", "-a", "1,0,0,0;x"]) == 0
    assert main(["-d", db, "-c", "c", "-e", "searchsimilar", "-a", "1,0,0,0;k=1"]) == 0
    out = capsys.readouterr().out
    assert "x" in out


@pytest.mark.parametrize("raise_on", ["write", "flush"])
def test_broken_pipe_exits_like_a_unix_tool(tmp_path, monkeypatch,
                                            raise_on):
    """`vrod ... | head` must exit 141 (128+SIGPIPE), not traceback: the
    downstream closing early is normal shell usage, not an error. The
    'flush' case covers small outputs that fit the stdio buffer — the
    EPIPE then only surfaces at flush time, which main() forces inside
    its guard (at interpreter exit it would be an unhandled 'Exception
    ignored' + exit 120)."""
    import sys
    import tempfile
    assert main(["--init-database", str(tmp_path), "-n", "db"]) == 0
    db = str(tmp_path / "db")
    assert main(["-d", db, "-e", "create",
                 "-a", "c;dim=4;segment_rows=64"]) == 0

    class ClosedPipe:
        def __init__(self, fd):
            self._fd = fd

        def write(self, s):
            if raise_on == "write":
                raise BrokenPipeError(32, "Broken pipe")

        def flush(self):
            if raise_on == "flush":
                raise BrokenPipeError(32, "Broken pipe")

        def fileno(self):
            return self._fd

    with tempfile.TemporaryFile() as f:
        monkeypatch.setattr(sys, "stdout", ClosedPipe(f.fileno()))
        rc = main(["-d", db, "-e", "listcollections"])
    assert rc == 141


def test_execute_unknown_verb(tmp_path, capsys):
    assert main(["--init-database", str(tmp_path), "-n", "db"]) == 0
    rc = main(["-d", str(tmp_path / "db"), "-e", "NOPE"])
    assert rc == 1
    assert "Unrecognized command" in capsys.readouterr().err


def test_generate_embeddings(tmp_path, capsys, monkeypatch):
    """Reference: --generate-embeddings runs ingest then exits (main.rs:46-49)."""
    monkeypatch.chdir(tmp_path)
    rc = main(["--generate-embeddings", "25"])
    assert rc == 0
    out_file = tmp_path / "alice_embeddings.txt"
    assert out_file.exists()
    lines = out_file.read_text().strip().splitlines()
    assert len(lines) == 25
    # reference line format: v0,v1,...;word (embeddings.rs:61)
    from vrod_tpu_torch.records import parse_record
    rec = parse_record(lines[0])
    assert rec.vector.shape == (384,)
    assert rec.payload == "Alice"


def test_delete_id_list(tmp_path, capsys):
    assert main(["--init-database", str(tmp_path), "-n", "db"]) == 0
    db = str(tmp_path / "db")
    assert main(["-d", db, "-e", "create", "-a", "c;dim=4;segment_rows=64"]) == 0
    for i in range(3):
        assert main(["-d", db, "-c", "c", "-e", "insert",
                     "-a", f"{i},0,0,0;p{i}"]) == 0
    assert main(["-d", db, "-c", "c", "-e", "delete", "-a", "1,2"]) == 0
    out = capsys.readouterr().out
    assert "Deleted 2 records" in out
    assert main(["-d", db, "-c", "c", "-e", "searchsimilar", "-a", "1,0,0,0;k=5"]) == 0
    out = capsys.readouterr().out
    assert "p2" in out and "p0" not in out and "p1" not in out


def test_ingest_to_search_pipeline(tmp_path, monkeypatch, capsys):
    """The reference's data path, end to end: text -> embeddings file ->
    BULKINSERT -> SEARCHSIMILAR (embeddings.rs output feeds the store)."""
    monkeypatch.chdir(tmp_path)
    assert main(["--generate-embeddings", "30"]) == 0
    assert main(["--init-database", ".", "-n", "db"]) == 0
    assert main(["-d", "db", "-e", "create", "-a", "words;dim=384;segment_rows=64"]) == 0
    assert main(["-d", "db", "-c", "words", "-e", "bulkinsert",
                 "-a", "alice_embeddings.txt"]) == 0
    capsys.readouterr()
    # query with the embedding of a stored word: top hit is that word
    from vrod_tpu_torch.utils.embeddings import hash_embed
    q = hash_embed(["sister"])[0]
    qv = ",".join(repr(float(x)) for x in q)
    assert main(["-d", "db", "-c", "words", "-e", "searchsimilar",
                 "-a", f"{qv};k=1"]) == 0
    out = capsys.readouterr().out
    assert "sister" in out


def test_generate_embeddings_custom_source(tmp_path, monkeypatch):
    """Ingest reads alice_in_wonderland.txt when present (reference:
    embeddings.rs:8-9 reads exactly that file)."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "alice_in_wonderland.txt").write_text(
        "zebra yak xylophone walrus")
    assert main(["--generate-embeddings", "3"]) == 0
    from vrod_tpu_torch.records import parse_record
    lines = (tmp_path / "alice_embeddings.txt").read_text().splitlines()
    assert [parse_record(l).payload for l in lines] == [
        "zebra", "yak", "xylophone"]


def test_shell_mode(tmp_path):
    """--shell serves many commands over one loaded database."""
    import io
    from vrod_tpu_torch.cli import _shell
    from vrod_tpu_torch.database import Database

    db = Database.new(tmp_path, "sh")
    script = "\n".join([
        'create -a "c;dim=4"',
        '# a comment line',
        '',
        'insert -c c -a "1,0,0,0;alpha"',
        'searchsimilar -c c -a "1,0,0,0;k=1"',
        'badverb',
        'insert -c c',          # missing arg -> in-loop error
        'exit',
        'insert -c c -a "0,1,0,0;never"',  # after exit: not executed
    ])
    out, err = io.StringIO(), io.StringIO()
    rc = _shell(db, stdin=io.StringIO(script), stdout=out, stderr=err)
    db.close()
    # Scripted (non-tty) use: failures surface in the exit code, and error
    # text goes to stderr so it never interleaves with command output.
    assert rc == 1
    text, errtext = out.getvalue(), err.getvalue()
    assert "Created collection 'c'" in text
    assert "Inserted record 1" in text
    assert "1\t1.000000\talpha" in text
    assert "Error:" not in text
    assert "Error: Unrecognized command: badverb" in errtext
    assert errtext.count("Error:") == 2
    assert "never" not in text


def test_shell_clean_script_exits_zero(tmp_path):
    import io
    from vrod_tpu_torch.cli import _shell
    from vrod_tpu_torch.database import Database

    db = Database.new(tmp_path, "sh3")
    out, err = io.StringIO(), io.StringIO()
    rc = _shell(db, stdin=io.StringIO('create -a "c;dim=4"\nexit\n'),
                stdout=out, stderr=err)
    db.close()
    assert rc == 0 and err.getvalue() == ""


def test_shell_default_collection(tmp_path):
    import io
    from vrod_tpu_torch.cli import _shell
    from vrod_tpu_torch.database import Database

    db = Database.new(tmp_path, "sh2")
    db.create_collection("d", dim=4, segment_rows=64)
    out = io.StringIO()
    _shell(db, default_collection="d",
           stdin=io.StringIO('insert -a "1,0,0,0;x"\nexit\n'), stdout=out)
    db.close()
    assert "Inserted record 1" in out.getvalue()


def test_negative_generate_embeddings_is_clean_error(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from vrod_tpu_torch.cli import main
    assert main(["-g", "-3"]) == 1


def test_generate_embeddings_missing_source_errors(tmp_path):
    import pytest
    from vrod_tpu_torch.errors import VrodError
    from vrod_tpu_torch.utils.embeddings import process_embeddings
    with pytest.raises(VrodError, match="not found"):
        process_embeddings(5, source=tmp_path / "nope.txt")


def test_pluggable_embed_fn_roundtrip(tmp_path, monkeypatch):
    """A real embedding model plugs in where the reference's fastembed
    model sat (embeddings.rs:7): inject a non-hash embed_fn, then ingest
    its output file into a collection and search it. The hash embedder is
    only the no-egress default; any callable words -> (n, dim) works."""
    import numpy as np
    monkeypatch.chdir(tmp_path)
    (tmp_path / "alice_in_wonderland.txt").write_text("alpha beta gamma")
    from vrod_tpu_torch.utils.embeddings import process_embeddings

    def toy_model(words):  # deterministic stand-in for an ONNX model
        out = np.zeros((len(words), 6), dtype=np.float32)
        for i, _w in enumerate(words):
            out[i, i % 6] = 1.0
            out[i, (i + 1) % 6] = 0.5
        return out

    out_path = process_embeddings(3, embed_fn=toy_model, dim=6)
    assert main(["-i", str(tmp_path), "-n", "edb"]) == 0
    d = str(tmp_path / "edb")
    assert main(["-d", d, "-e", "create", "-a", "c;dim=6"]) == 0
    assert main(["-d", d, "-e", "bulkinsert", "-c", "c",
                 "-a", str(out_path)]) == 0
    # The nearest neighbor of word 0's own embedding is word 0.
    q = ",".join(str(x) for x in toy_model(["alpha"])[0])
    assert main(["-d", d, "-e", "searchsimilar", "-c", "c",
                 "-a", f"{q};k=1"]) == 0


def test_shell_errors_do_not_stop_loop(tmp_path):
    """After an error the shell keeps serving commands (reference shells
    never die on a bad verb)."""
    import io
    from vrod_tpu_torch.cli import _shell
    from vrod_tpu_torch.database import Database

    db = Database.new(tmp_path, "sh4")
    out, err = io.StringIO(), io.StringIO()
    rc = _shell(db, stdin=io.StringIO(
        'nope\ncreate -a "c;dim=4"\ninsert -c c -a "1,0,0,0;ok"\n'),
        stdout=out, stderr=err)
    db.close()
    assert rc == 1  # the bad verb failed the script
    assert "Inserted record 1" in out.getvalue()


def test_torch_model_embed_fn_roundtrip(tmp_path, monkeypatch, capsys):
    """A real ML-framework embedder (torch, like fastembed's ONNX runtime
    in the reference, embeddings.rs:7) plugs into the ingest path: tensor
    output converts cleanly through the file format into exact search.
    Weights are random (no model egress in this environment) but fully
    deterministic, so nearest-neighbor-of-own-embedding must hold."""
    torch = pytest.importorskip("torch")
    import numpy as np
    monkeypatch.chdir(tmp_path)
    (tmp_path / "alice_in_wonderland.txt").write_text(
        "the quick brown fox jumps over the lazy dog")
    from vrod_tpu_torch.utils.embeddings import process_embeddings

    torch.manual_seed(0)
    vocab_hash, dim = 997, 16
    model = torch.nn.EmbeddingBag(vocab_hash, dim, mode="mean")
    model.eval()

    def torch_embed(words):
        import zlib
        with torch.no_grad():
            idx = torch.tensor(
                [[zlib.crc32(w.encode()) % vocab_hash,
                  zlib.crc32(w[::-1].encode()) % vocab_hash]
                 for w in words])
            return model(idx).numpy().astype(np.float32)

    out_path = process_embeddings(8, embed_fn=torch_embed, dim=dim)
    assert main(["-i", str(tmp_path), "-n", "tdb"]) == 0
    d = str(tmp_path / "tdb")
    assert main(["-d", d, "-e", "create", "-a", f"c;dim={dim}"]) == 0
    assert main(["-d", d, "-e", "bulkinsert", "-c", "c",
                 "-a", str(out_path)]) == 0
    q = ",".join(repr(float(x)) for x in torch_embed(["fox"])[0])
    capsys.readouterr()
    assert main(["-d", d, "-e", "searchsimilar", "-c", "c",
                 "-a", f"{q};k=1"]) == 0
    # The docstring's actual claim: nearest neighbor of "fox"'s own
    # embedding is the record that embedded "fox" (the ingest file's
    # payload is the word itself).
    assert "fox" in capsys.readouterr().out


def _tiny_bert_dir(tmp_path):
    """Build a tiny random-weight transformers checkpoint ON DISK (no
    egress: constructed from config, never downloaded)."""
    torch = pytest.importorskip("torch")
    transformers = pytest.importorskip("transformers")
    from transformers import BertConfig, BertModel, BertTokenizer
    mdir = tmp_path / "tiny_bert"
    mdir.mkdir()
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
             "the", "quick", "brown", "fox", "jumps", "over", "lazy",
             "dog", "a", "##s", "##ing"]
    (mdir / "vocab.txt").write_text("\n".join(vocab))
    tok = BertTokenizer(str(mdir / "vocab.txt"))
    tok.save_pretrained(str(mdir))
    torch.manual_seed(0)
    cfg = BertConfig(vocab_size=len(vocab), hidden_size=16,
                     num_hidden_layers=1, num_attention_heads=2,
                     intermediate_size=32, max_position_embeddings=32)
    BertModel(cfg).save_pretrained(str(mdir))
    return mdir, 16


def test_resolve_embed_fn_transformers_dir(tmp_path, monkeypatch):
    """A local transformers checkpoint auto-detects via VROD_EMBED_MODEL
    and produces L2-normalized, deterministic embeddings (the real-model
    analogue of the reference's fastembed BGESmallENV15)."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    mdir, dim = _tiny_bert_dir(tmp_path)
    from vrod_tpu_torch.utils.embeddings import resolve_embed_fn
    monkeypatch.setenv("VROD_EMBED_MODEL", str(mdir))
    fn, desc = resolve_embed_fn()
    assert fn is not None and "transformers" in desc
    import numpy as np
    e1 = fn(["fox", "dog"])
    e2 = fn(["fox", "dog"])
    assert e1.shape == (2, dim)
    np.testing.assert_array_equal(e1, e2)  # deterministic
    np.testing.assert_allclose(np.linalg.norm(e1, axis=1), 1.0, rtol=1e-5)
    # Empty batch still reports the MODEL's dim (16), not DEFAULT_DIM:
    # `-g 0` against this model must not claim 384-dim output.
    assert fn([]).shape == (0, dim)


def test_cli_generate_with_local_model_end_to_end(tmp_path, monkeypatch,
                                                  capsys):
    """VERDICT r3 item 6: `vrod -g` with a real local nn module — detect,
    embed, write the ingest file, BULKINSERT it, search exactly."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    mdir, dim = _tiny_bert_dir(tmp_path)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "alice_in_wonderland.txt").write_text(
        "the quick brown fox jumps over the lazy dog")
    monkeypatch.setenv("VROD_EMBED_MODEL", str(mdir))
    assert main(["-g", "6"]) == 0
    out = capsys.readouterr().out
    assert "Embedder: transformers model" in out
    assert f"Embedding dimension: {dim}" in out

    assert main(["-i", str(tmp_path), "-n", "hfdb"]) == 0
    d = str(tmp_path / "hfdb")
    assert main(["-d", d, "-e", "create", "-a", f"c;dim={dim}"]) == 0
    assert main(["-d", d, "-e", "bulkinsert", "-c", "c",
                 "-a", "alice_embeddings.txt"]) == 0
    from vrod_tpu_torch.utils.embeddings import resolve_embed_fn
    fn, _ = resolve_embed_fn()
    q = ",".join(repr(float(x)) for x in fn(["fox"])[0])
    capsys.readouterr()
    assert main(["-d", d, "-e", "searchsimilar", "-c", "c",
                 "-a", f"{q};k=1"]) == 0
    assert "fox" in capsys.readouterr().out


def test_resolve_embed_fn_torchscript_file(tmp_path, monkeypatch, capsys):
    """A TorchScript .pt over word_hash_features ids loads and drives the
    -g path; vocab is read off the module's num_embeddings."""
    torch = pytest.importorskip("torch")
    import numpy as np
    torch.manual_seed(1)
    model = torch.nn.EmbeddingBag(101, 8, mode="mean")
    path = tmp_path / "word_model.pt"
    torch.jit.script(model).save(str(path))

    from vrod_tpu_torch.utils.embeddings import resolve_embed_fn, word_hash_features
    fn, desc = resolve_embed_fn(model_path=path)
    assert "torch model" in desc
    got = fn(["fox", "dog"])
    with torch.no_grad():
        want = model(torch.from_numpy(
            word_hash_features(["fox", "dog"], 101))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)

    # Probe in cwd (no env var): the exact name .vrod_embed_model has no
    # suffix of its own, so it points at a model either as a SYMLINK
    # (dispatch on the resolved target) or as a small text file naming
    # the model's path (relative to the file's directory).
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("VROD_EMBED_MODEL", raising=False)
    probe = tmp_path / ".vrod_embed_model"
    probe.symlink_to(path)
    (tmp_path / "alice_in_wonderland.txt").write_text("hello world")
    assert main(["-g", "2"]) == 0
    assert "Embedder: torch model" in capsys.readouterr().out

    probe.unlink()
    probe.write_text("word_model.pt\n")  # indirection file, relative path
    assert main(["-g", "2"]) == 0
    assert "Embedder: torch model" in capsys.readouterr().out


def test_resolve_embed_fn_errors(tmp_path, monkeypatch):
    from vrod_tpu_torch.errors import VrodError
    from vrod_tpu_torch.utils.embeddings import resolve_embed_fn
    monkeypatch.delenv("VROD_EMBED_MODEL", raising=False)
    monkeypatch.chdir(tmp_path)
    fn, desc = resolve_embed_fn()
    assert fn is None and "feature-hash" in desc
    with pytest.raises(VrodError, match="not found"):
        resolve_embed_fn(model_path=tmp_path / "missing.pt")
    bad = tmp_path / "model.tflite"
    bad.write_bytes(b"x")
    with pytest.raises(VrodError, match="Unrecognized"):
        resolve_embed_fn(model_path=bad)
    onnx = tmp_path / "model.onnx"
    onnx.write_bytes(b"x")
    try:
        import onnxruntime  # noqa: F401
    except ImportError:
        with pytest.raises(VrodError, match="onnxruntime"):
            resolve_embed_fn(model_path=onnx)
