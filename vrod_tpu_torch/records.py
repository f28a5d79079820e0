"""The vRod record model: ``(f32 embedding, string payload)``.

The reference's only working data path serializes records as one
``v0,v1,...,vD;payload`` line per vector (``src/utils/embeddings.rs:52-71``,
format string at ``:61``). This module parses and formats that wire format,
which is also the argument format for INSERT/UPDATE, the line format for
BULKINSERT files, and the output format for SEARCH.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .errors import RecordFormatError


@dataclasses.dataclass
class Record:
    vector: np.ndarray  # float32, shape (dim,)
    payload: str = ""

    def to_line(self) -> str:
        return format_record(self.vector, self.payload)


def _escape_payload(p: str) -> str:
    """Make a payload line-safe: the record format is one record per line
    (reference: ``embeddings.rs:61``), so literal newlines/CRs are escaped
    (backslash escapes, round-trip exact via ``_unescape_payload``)."""
    return p.replace("\\", "\\\\").replace("\n", "\\n").replace("\r", "\\r")


def _unescape_payload(s: str) -> str:
    if "\\" not in s:
        return s
    out = []
    i = 0
    n = len(s)
    while i < n:
        c = s[i]
        if c == "\\" and i + 1 < n:
            nxt = s[i + 1]
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if nxt == "r":
                out.append("\r")
                i += 2
                continue
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def parse_record(line: str) -> Record:
    """Parse ``v0,v1,...;payload``. The payload may itself contain ';';
    escaped newlines/CRs/backslashes are restored. Only line terminators
    are stripped — payload-internal whitespace (including trailing spaces)
    round-trips exactly, per the escape contract."""
    line = line.strip("\r\n")
    if not line.strip():
        raise RecordFormatError("Empty record string")
    vec_part, sep, payload = line.partition(";")
    if not sep:
        # No payload separator: the whole line is the vector, empty payload.
        payload = ""
    payload = _unescape_payload(payload)
    toks = [t.strip() for t in vec_part.split(",")]
    # A trailing comma is tolerated ('1,2,'); an INTERIOR empty token
    # ('1,,2') is a malformed vector, not a lower-dimension one.
    if toks and toks[-1] == "":
        toks = toks[:-1]
    if any(t == "" for t in toks):
        raise RecordFormatError(
            f"Empty vector component in record {vec_part!r}")
    try:
        vector = np.array([float(tok) for tok in toks], dtype=np.float32)
    except ValueError as e:
        raise RecordFormatError(f"Bad vector component in record: {e}") from e
    if vector.size == 0:
        raise RecordFormatError("Record has an empty vector")
    return Record(vector=vector, payload=payload)


def format_record(vector: np.ndarray, payload: str = "") -> str:
    vec = np.asarray(vector, dtype=np.float32).reshape(-1)
    # repr-style floats round-trip exactly through float(); matches the
    # reference's join-with-comma + ';' + payload layout (embeddings.rs:55-61).
    vec_part = ",".join(np.format_float_positional(v, trim="0") for v in vec)
    return f"{vec_part};{_escape_payload(payload)}"


def format_records_block(vectors: np.ndarray, payloads) -> str:
    """Format many records at once (EXPORT's hot path): one printf-style
    batch per row instead of a per-element formatter call — ~2.4x faster
    (~2 h -> ~50 min at 10M x 768). Floats print as ``%.9g`` (9
    significant digits always round-trip float32 exactly through
    ``float()``), a denser but equivalent spelling of what
    :func:`format_record` writes; both parse back bit-identically."""
    vecs = np.ascontiguousarray(np.asarray(vectors, dtype=np.float32))
    if vecs.ndim != 2:
        vecs = np.atleast_2d(vecs)
    dim = vecs.shape[1]
    fmt = ",".join(["%.9g"] * dim)
    # float32 -> Python float (double) exactly; %g of that double at 9
    # sig digits re-reads to the same float32.
    rows = vecs.astype(np.float64).tolist()
    return "\n".join(
        f"{fmt % tuple(row)};{_escape_payload(p)}"
        for row, p in zip(rows, payloads))


def parse_record_matrix(text: str):
    """Parse a BULKINSERT payload into ``(vectors (n, dim) float32,
    payloads list[str])`` — the bulk-ingest form its consumer actually
    wants (one contiguous matrix, no per-record arrays).

    A vectorized fast path handles well-formed files (one C-level float
    parse over all vector text — ~2.3x the per-token loop, which costs
    ~40 min at 10M x 768); anything irregular (whitespace-only lines,
    trailing commas, malformed tokens, mixed dims) falls back to the
    per-line parser so error messages and tolerant forms are byte-for-
    byte identical to the historical behavior."""
    fast = _parse_matrix_fast(text)
    if fast is not None:
        return fast
    records = _parse_record_file_slow(text)
    if not records:
        return np.empty((0, 0), dtype=np.float32), []
    return (np.stack([r.vector for r in records]),
            [r.payload for r in records])


# Line terminators str.splitlines() honors beyond "\n". A file containing
# any of them has a different line structure under the fast path's
# split("\n"), so it must take the per-line parser (CRLF included: the
# historical parser strips ANY mix of trailing \r\n, e.g. "a\r\r\n").
_EXOTIC_TERMINATORS = ("\r", "\v", "\f", "\x1c", "\x1d", "\x1e",
                       "\x85", "\u2028", "\u2029")

# Rows per fast-parse chunk: bounds the transient joined-text copy (and
# its parsed float block) so a 10M-row ingest never doubles peak memory.
_FAST_PARSE_CHUNK = 65536


def _parse_matrix_fast(text: str):
    """The strict fast path, or ``None`` for anything it cannot prove it
    parses EXACTLY like the per-line parser. Two correctness devices:

    - a per-record comma-count check before the joined parse (an evenly
      dividing total could silently mis-split mixed-dim rows), and
    - a trailing ``,1`` SENTINEL per chunk: ``np.fromstring`` stops
      silently at the first unparseable character, so a parse only
      reaches (and equals) the sentinel if it consumed every byte —
      catching garbage in the final token ("3.4.5", "1e", "4x") that a
      pure size check cannot see."""
    for ch in _EXOTIC_TERMINATORS:
        if ch in text:
            return None
    vec_parts, payloads_raw = [], []
    for line in text.split("\n"):
        if not line:
            continue
        if line[0] in " \t" or line[-1] in " \t":
            return None  # whitespace-skip/strip semantics: slow path
        vp, sep, pl = line.partition(";")
        vec_parts.append(vp)
        payloads_raw.append(pl)
    n = len(vec_parts)
    if n == 0:
        return np.empty((0, 0), dtype=np.float32), []
    commas = vec_parts[0].count(",")
    dim = commas + 1
    import warnings
    # Preallocate once and fill per chunk: keeping per-chunk blocks for a
    # final vstack would hold ~2x the matrix transiently — the exact spike
    # _FAST_PARSE_CHUNK exists to avoid.
    vecs = np.empty((n, dim), dtype=np.float32)
    for start in range(0, n, _FAST_PARSE_CHUNK):
        part = vec_parts[start:start + _FAST_PARSE_CHUNK]
        if any(vp.count(",") != commas for vp in part):
            return None
        joined = ",".join(part) + ",1"  # sentinel (see docstring)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            try:
                flat = np.fromstring(joined, dtype=np.float32, sep=",")
            except Exception:
                return None
        if flat.size != len(part) * dim + 1 or flat[-1] != 1.0:
            return None
        vecs[start:start + len(part)] = flat[:-1].reshape(len(part), dim)
    # Unescape only once the whole file validated (a late bail would
    # discard the work and the slow path redoes it anyway).
    return vecs, [_unescape_payload(p) for p in payloads_raw]


def parse_record_file(text: str) -> list[Record]:
    """Parse a BULKINSERT payload: one record per non-empty line. All
    records must share one vector dimension (the first line sets it).
    Each Record owns an independent vector (historical contract — no
    views into a shared matrix that writes would alias or holds would
    pin)."""
    vecs, payloads = parse_record_matrix(text)
    return [Record(vector=np.array(v), payload=p)
            for v, p in zip(vecs, payloads)]


def _parse_record_file_slow(text: str) -> list[Record]:
    records = []
    dim = None
    for i, line in enumerate(text.splitlines()):
        if not line.strip():
            continue
        try:
            rec = parse_record(line)
        except RecordFormatError as e:
            raise RecordFormatError(f"line {i + 1}: {e}") from e
        if dim is None:
            dim = rec.vector.shape[0]
        elif rec.vector.shape[0] != dim:
            raise RecordFormatError(
                f"line {i + 1}: vector dim {rec.vector.shape[0]} != "
                f"dim {dim} of line 1")
        records.append(rec)
    return records


def parse_query(arg: str, default_k: int = 10):
    """Parse a SEARCHSIMILAR argument:
    ``v0,v1,...[;k=10][;within=id1,id2,...|;exclude=id1,id2,...]``.

    Returns ``(vector, k, within_ids, exclude_ids)`` where the id lists are
    ``None`` or uint64 arrays. The option suffixes are vrod-tpu extensions;
    the reference never defined SEARCHSIMILAR's argument (stub at
    types.rs:121-132). ``within`` restricts the search to the listed record
    ids, ``exclude`` removes them; at most one of the two may appear.
    """
    arg = arg.strip()
    parts = arg.split(";")
    vec_part, opts = parts[0], [p.strip() for p in parts[1:] if p.strip()]
    k = default_k
    within = exclude = None
    for opt in opts:
        key, sep, val = opt.partition("=")
        if not sep:
            raise RecordFormatError(
                f"Bad SEARCHSIMILAR option {opt!r}; expected 'key=value'")
        if key == "k":
            try:
                k = int(val)
            except ValueError as e:
                raise RecordFormatError(f"Bad k value: {e}") from e
            if k < 1:
                raise RecordFormatError("k must be >= 1")
        elif key in ("within", "exclude"):
            try:
                ids = np.array(
                    [int(v) for v in val.split(",") if v.strip()],
                    dtype=np.uint64)
            except (ValueError, OverflowError) as e:
                raise RecordFormatError(f"Bad {key} id list: {e}") from e
            if key == "within":
                within = ids
            else:
                exclude = ids
        else:
            raise RecordFormatError(
                f"Bad SEARCHSIMILAR option {opt!r}; expected "
                "'k=', 'within=' or 'exclude='")
    if within is not None and exclude is not None:
        raise RecordFormatError(
            "SEARCHSIMILAR accepts within= or exclude=, not both")
    rec = parse_record(vec_part)
    return rec.vector, k, within, exclude
