"""Record wire-format tests (reference contract: embeddings.rs:61).

``tests/test_records.py`` (16 tests) over ``vrod_tpu_torch.records``: the
same cases and oracles; imports rewritten only.
"""

import numpy as np
import pytest

from vrod_tpu_torch.errors import RecordFormatError
from vrod_tpu_torch.records import (
    format_record, parse_query, parse_record, parse_record_file,
)


def test_roundtrip():
    vec = np.array([0.5, -1.25, 3.0], dtype=np.float32)
    line = format_record(vec, "hello")
    rec = parse_record(line)
    np.testing.assert_array_equal(rec.vector, vec)
    assert rec.payload == "hello"


def test_payload_with_semicolons():
    rec = parse_record("1.0,2.0;a;b;c")
    assert rec.payload == "a;b;c"
    np.testing.assert_array_equal(rec.vector, [1.0, 2.0])


def test_no_payload():
    rec = parse_record("1,2,3")
    assert rec.payload == ""
    assert rec.vector.dtype == np.float32


def test_empty_and_bad():
    with pytest.raises(RecordFormatError):
        parse_record("")
    with pytest.raises(RecordFormatError):
        parse_record("a,b,c;payload")
    with pytest.raises(RecordFormatError):
        parse_record(";payload-only")


def test_exact_float_roundtrip():
    vec = np.array([1/3, 1e-8, -2.5e7], dtype=np.float32)
    rec = parse_record(format_record(vec, ""))
    np.testing.assert_array_equal(rec.vector, vec)


def test_record_file():
    text = "1,0;a\n\n0,1;b\n"
    recs = parse_record_file(text)
    assert len(recs) == 2
    assert recs[1].payload == "b"
    with pytest.raises(RecordFormatError, match="line 2"):
        parse_record_file("1,0;a\nbad;x\n")


def test_parse_query():
    v, k, within, exclude = parse_query("1,2,3")
    assert k == 10 and within is None and exclude is None
    v, k, within, exclude = parse_query("1,2,3;k=25")
    assert k == 25
    np.testing.assert_array_equal(v, [1, 2, 3])
    with pytest.raises(RecordFormatError):
        parse_query("1,2;top=5")
    with pytest.raises(RecordFormatError):
        parse_query("1,2;k=0")


def test_parse_query_filters():
    _, k, within, _ = parse_query("1,2;k=5;within=3,7,11")
    assert k == 5
    np.testing.assert_array_equal(within, [3, 7, 11])
    _, _, within, exclude = parse_query("1,2;exclude=4")
    assert within is None
    np.testing.assert_array_equal(exclude, [4])
    with pytest.raises(RecordFormatError, match="not both"):
        parse_query("1,2;within=1;exclude=2")
    with pytest.raises(RecordFormatError, match="id list"):
        parse_query("1,2;within=abc")


def test_adversarial_payload_roundtrip():
    """Payloads with newlines, CRs, backslashes, semicolons, and unicode
    must round-trip through the line format (VERDICT r1 item 7)."""
    from vrod_tpu_torch.records import format_record, parse_record, parse_record_file
    import numpy as np
    adversarial = [
        "multi\nline\npayload",
        "cr\r\nlf",
        "back\\slash and \\n literal",
        "semi;colons;every;where",
        "mixed\n;\\\;\r\nüñïçødé ☃",
        "",
        "trailing\n",
    ]
    vec = np.array([1.5, -2.25], dtype=np.float32)
    lines = [format_record(vec, p) for p in adversarial]
    for line, p in zip(lines, adversarial):
        assert "\n" not in line and "\r" not in line
        rec = parse_record(line)
        assert rec.payload == p, (rec.payload, p)
    # The whole set as one BULKINSERT file body.
    recs = parse_record_file("\n".join(lines))
    assert [r.payload for r in recs] == adversarial


def test_parse_record_file_rejects_mixed_dims():
    with pytest.raises(RecordFormatError, match="line 2.*dim"):
        parse_record_file("1,2;a\n1,2,3;b\n")


def test_payload_trailing_whitespace_roundtrip():
    line = format_record(np.array([1.0, 2.0]), "pad  \t")
    assert parse_record(line).payload == "pad  \t"
    # direct INSERT-arg form too
    assert parse_record("1,2;spaced  ").payload == "spaced  "


def test_interior_empty_vector_component_rejected():
    with pytest.raises(RecordFormatError, match="Empty vector component"):
        parse_record("1,,2;p")
    # trailing comma stays tolerated
    np.testing.assert_array_equal(parse_record("1,2,;p").vector, [1, 2])


def test_matrix_fast_path_bit_exact_parity(rng):
    """The vectorized parse (np.fromstring over joined vector text) must
    produce BIT-identical float32s to the per-token float() path, and the
    block formatter's %.9g text must parse back bit-identically too."""
    from vrod_tpu_torch.records import (
        _parse_record_file_slow, format_record, format_records_block,
        parse_record_matrix,
    )
    vecs = rng.standard_normal((64, 24)).astype(np.float32)
    vecs[0, 0] = np.float32(0.3)
    vecs[1, 1] = np.float32(1e-38)   # subnormal-ish
    vecs[2, 2] = np.float32(-1e38)
    vecs[3, 3] = 0.0
    payloads = [f"p;{i}\nx\\" for i in range(64)]  # escapes in the mix

    for text in (
        "\n".join(format_record(v, p) for v, p in zip(vecs, payloads)),
        format_records_block(vecs, payloads),
    ):
        m, pls = parse_record_matrix(text + "\n")
        np.testing.assert_array_equal(m, vecs)  # bitwise
        assert pls == payloads
        slow = _parse_record_file_slow(text)
        np.testing.assert_array_equal(
            np.stack([r.vector for r in slow]), m)
        assert [r.payload for r in slow] == pls


def test_matrix_fast_path_fallback_semantics():
    """Irregular files fall back to the strict per-line parser: identical
    errors for malformed input, identical tolerance for messy-but-legal
    forms (trailing commas, token spaces, blank/whitespace lines)."""
    from vrod_tpu_torch.errors import RecordFormatError
    from vrod_tpu_torch.records import parse_record_matrix

    messy = "1,2 ;a\n\n  \n3 ,4;b\n5,6,;c\n"  # spaces + trailing comma
    m, pls = parse_record_matrix(messy)
    assert m.shape == (3, 2) and pls == ["a", "b", "c"]
    assert m[2].tolist() == [5.0, 6.0]

    with pytest.raises(RecordFormatError, match="line 2"):
        parse_record_matrix("1,2;a\n1,x;b\n")
    with pytest.raises(RecordFormatError, match="dim"):
        parse_record_matrix("1,2;a\n1,2,3;b\n")
    with pytest.raises(RecordFormatError, match="Empty vector component"):
        parse_record_matrix("1,,2;a\n")
    m, pls = parse_record_matrix("")
    assert m.size == 0 and pls == []


def test_matrix_fast_path_rejects_silent_divergences(rng):
    """The fast path must NEVER accept input the strict parser rejects or
    reads differently (review findings: last-token garbage slips past a
    size check; split('\\n') disagrees with splitlines() on exotic
    terminators)."""
    from vrod_tpu_torch.errors import RecordFormatError
    from vrod_tpu_torch.records import (
        _parse_matrix_fast, _parse_record_file_slow, parse_record_matrix,
    )

    # Garbage in the FILE'S LAST token: fromstring stops silently there,
    # and total float count still matches — the sentinel catches it.
    for bad in ("1,2;a\n3,3.4.5;b\n", "1,2;a\n3,4x;b\n", "1,2;a\n3,1e;b\n"):
        assert _parse_matrix_fast(bad) is None
        with pytest.raises(RecordFormatError, match="line 2"):
            parse_record_matrix(bad)

    # Exotic line terminators: splitlines() structure differs from
    # split('\n') — every such file must go to the per-line parser.
    for text in ("1,2;a\r3,4;b\n",      # CR-only terminators
                 "1,2;a\r\r\n3,4;b\n",  # multi-\r strip semantics
                 "1,2;a\x853,4;b\n"):   # NEL
        assert _parse_matrix_fast(text) is None
        m, pls = parse_record_matrix(text)
        slow = _parse_record_file_slow(text)
        assert [r.payload for r in slow] == pls
        np.testing.assert_array_equal(np.stack([r.vector for r in slow]), m)

    # The fast path must actually RUN on canonical files (a silently
    # disabled fast path would pass every parity test while the 2x claim
    # rots — e.g. numpy removing the deprecated fromstring).
    vecs = rng.standard_normal((8, 6)).astype(np.float32)
    from vrod_tpu_torch.records import format_records_block
    text = format_records_block(vecs, [f"p{i}" for i in range(8)]) + "\n"
    fast = _parse_matrix_fast(text)
    assert fast is not None
    np.testing.assert_array_equal(fast[0], vecs)

    # parse_record_file Records own their vectors (no shared-matrix views).
    from vrod_tpu_torch.records import parse_record_file
    recs = parse_record_file(text)
    recs[0].vector[0] = 99.0
    assert recs[1].vector[0] == vecs[1, 0]
    assert recs[0].vector.base is None


def test_matrix_fast_path_chunked(rng):
    """Chunked fast parse (bounded memory) agrees across the chunk seam."""
    import vrod_tpu_torch.records as R
    vecs = rng.standard_normal((50, 4)).astype(np.float32)
    text = R.format_records_block(vecs, [f"p{i}" for i in range(50)]) + "\n"
    old = R._FAST_PARSE_CHUNK
    R._FAST_PARSE_CHUNK = 7  # force many chunks incl. a ragged tail
    try:
        out = R._parse_matrix_fast(text)
        assert out is not None
        np.testing.assert_array_equal(out[0], vecs)
        assert out[1] == [f"p{i}" for i in range(50)]
        # Garbage in a LATER chunk's final token still rejects the file.
        bad = text.rstrip("\n").rsplit(";", 1)[0] + "junk;x\n"
        assert R._parse_matrix_fast(bad) is None
    finally:
        R._FAST_PARSE_CHUNK = old
