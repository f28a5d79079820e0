"""Text -> embedding ingest utility.

Mirrors the reference's only working data path
(the reference vRod's ``src/utils/embeddings.rs:6-71``): take the first N
whitespace-split words of a source text, embed each word to a 384-dim f32
vector, print count/dim/memory diagnostics, and write ``alice_embeddings.txt``
with one ``v0,v1,...;word`` line per vector (format string at
``embeddings.rs:61``).

The reference uses fastembed's default ONNX model (BGESmallENV15, 384-dim,
``embeddings.rs:7``), which needs a model download. This environment has no
egress, so the default embedder is a deterministic feature-hashed character
n-gram model (384-dim, L2-normalized) — fully offline, stable across runs,
and adequate for exercising the ingest + search pipeline. A LOCAL model is
auto-detected by :func:`resolve_embed_fn` (``VROD_EMBED_MODEL`` env var or
``./.vrod_embed_model``): a ``transformers`` checkpoint directory
(CLS-pooled + L2-normalized, the BGE recipe), a TorchScript/pickled torch
module, or — with a locally installed onnxruntime — the reference's actual
ONNX form. A custom callable can also be passed via ``embed_fn``.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

DEFAULT_DIM = 384  # fastembed BGESmallENV15 output dim (embeddings.rs:7)
DEFAULT_SOURCE = "alice_in_wonderland.txt"
DEFAULT_OUTPUT = "alice_embeddings.txt"

# A public-domain fallback excerpt (Lewis Carroll, 1865) used when no source
# text file is present, so `--generate-embeddings` works out of the box.
_FALLBACK_TEXT = """
Alice was beginning to get very tired of sitting by her sister on the bank
and of having nothing to do once or twice she had peeped into the book her
sister was reading but it had no pictures or conversations in it and what is
the use of a book thought Alice without pictures or conversations So she was
considering in her own mind as well as she could for the hot day made her
feel very sleepy and stupid whether the pleasure of making a daisy chain
would be worth the trouble of getting up and picking the daisies when
suddenly a White Rabbit with pink eyes ran close by her
"""


def hash_embed(texts: list[str], dim: int = DEFAULT_DIM) -> np.ndarray:
    """Deterministic feature-hashed char-trigram embeddings, L2-normalized."""
    out = np.zeros((len(texts), dim), dtype=np.float32)
    for i, text in enumerate(texts):
        t = f"^{text.lower()}$"
        grams = [t[j:j + 3] for j in range(max(len(t) - 2, 1))]
        for g in grams:
            h = hashlib.blake2b(g.encode("utf-8"), digest_size=8).digest()
            idx = int.from_bytes(h[:4], "little") % dim
            sign = 1.0 if h[4] & 1 else -1.0
            out[i, idx] += sign
        norm = np.linalg.norm(out[i])
        if norm > 0:
            out[i] /= norm
    return out


def word_hash_features(words: list[str], vocab: int) -> "np.ndarray":
    """Deterministic (n, 2) int64 token-id featurization for word-level
    torch/ONNX embedders: crc32 of the word and of its reversal, modulo the
    model's vocabulary. This is the documented input contract for model
    FILES passed to :func:`resolve_embed_fn` (directories use the model's
    own tokenizer instead)."""
    import zlib
    return np.array(
        [[zlib.crc32(w.encode()) % vocab,
          zlib.crc32(w[::-1].encode()) % vocab] for w in words],
        dtype=np.int64).reshape(len(words), 2)


def _chunked(embed, texts: list[str], chunk: int = 256) -> np.ndarray:
    outs = [embed(texts[i:i + chunk]) for i in range(0, len(texts), chunk)]
    if outs:
        return np.concatenate(outs, axis=0)
    # Empty batch: the result's dim must still be the MODEL's output dim
    # (hardcoding DEFAULT_DIM here made `-g 0` report 384 for a 16-dim
    # local model, disagreeing with every non-empty run). One probe call
    # answers it; only the empty path pays for it.
    return np.zeros((0, np.asarray(embed(["a"])).shape[1]), np.float32)


def _hf_embed_fn(path: Path):
    """Local ``transformers`` model directory (the real-model analogue of
    the reference's fastembed BGESmallENV15, ``embeddings.rs:7``): CLS-pool
    the last hidden state and L2-normalize — the BGE family's recipe."""
    import torch
    from transformers import AutoModel, AutoTokenizer
    tok = AutoTokenizer.from_pretrained(str(path))
    model = AutoModel.from_pretrained(str(path))
    model.eval()

    def embed_batch(texts):
        with torch.no_grad():
            enc = tok(texts, padding=True, truncation=True, max_length=512,
                      return_tensors="pt")
            out = model(**enc).last_hidden_state[:, 0]
            out = torch.nn.functional.normalize(out, dim=-1)
        return out.numpy().astype(np.float32)

    return lambda texts: _chunked(embed_batch, texts)


def _torch_embed_fn(path: Path):
    """TorchScript (.pt via ``torch.jit.load``) or pickled ``nn.Module``:
    must map a (n, 2) int64 tensor of :func:`word_hash_features` ids to
    (n, dim) embeddings (e.g. an ``EmbeddingBag``)."""
    import torch
    try:
        model = torch.jit.load(str(path), map_location="cpu")
    except Exception:
        model = torch.load(str(path), map_location="cpu",
                           weights_only=False)
    if not callable(model):
        from ..errors import VrodError
        raise VrodError(
            f"Torch embed model at {path} is not a callable module")
    if hasattr(model, "eval"):
        model.eval()
    vocab = getattr(model, "num_embeddings", None)
    if vocab is None:
        for m in (model.modules() if hasattr(model, "modules") else ()):
            vocab = getattr(m, "num_embeddings", None)
            if vocab is not None:
                break
    vocab = int(vocab or 997)

    def embed_batch(texts):
        with torch.no_grad():
            ids = torch.from_numpy(word_hash_features(texts, vocab))
            return model(ids).numpy().astype(np.float32)

    return lambda texts: _chunked(embed_batch, texts)


def _onnx_embed_fn(path: Path):
    """ONNX model (the reference's actual runtime) — gated on a locally
    available onnxruntime (this environment has no egress to install one).
    Contract: single int64 input fed :func:`word_hash_features` ids."""
    try:
        import onnxruntime  # not baked into this image; user-provided
    except ImportError as e:
        from ..errors import VrodError
        raise VrodError(
            "An .onnx embed model needs onnxruntime, which is not "
            "installed in this environment; export the model for torch "
            "(TorchScript .pt) or point VROD_EMBED_MODEL at a local "
            "transformers directory instead") from e
    sess = onnxruntime.InferenceSession(str(path))
    inp = sess.get_inputs()[0].name
    import os
    vocab = int(os.environ.get("VROD_EMBED_VOCAB", "997"))

    def embed_batch(texts):
        (out,) = sess.run(None, {inp: word_hash_features(texts, vocab)})
        return np.asarray(out, dtype=np.float32)

    return lambda texts: _chunked(embed_batch, texts)


def resolve_embed_fn(model_path=None):
    """Locate a LOCAL embedding model for the ingest path and return
    ``(embed_fn, description)``; ``(None, ...)`` means the builtin
    feature-hash fallback.

    Search order: explicit ``model_path`` argument, the
    ``VROD_EMBED_MODEL`` environment variable, then a ``.vrod_embed_model``
    file/directory in the working directory. Model kinds by shape:
    a DIRECTORY is a ``transformers`` checkpoint (tokenizer + model,
    CLS-pooled and L2-normalized like the reference's BGE default);
    ``.pt``/``.pth`` is a TorchScript or pickled torch module over
    :func:`word_hash_features` ids; ``.onnx`` needs a locally installed
    onnxruntime. An explicitly named model that cannot be loaded is an
    error (never silently fall back to the hash embedder); only the
    ABSENCE of any model selects the fallback."""
    import os
    cand = model_path or os.environ.get("VROD_EMBED_MODEL")
    if not cand:
        probe = Path(".vrod_embed_model")
        cand = probe if probe.exists() else None
    if not cand:
        return None, "builtin feature-hash embedder (384-dim)"
    p = Path(cand)
    if not p.exists():
        from ..errors import VrodError
        raise VrodError(f"Embed model not found: {p}")
    # The ./.vrod_embed_model probe has no suffix of its own, so "points
    # at" works two ways: a SYMLINK dispatches on its resolved target's
    # shape, and a small TEXT FILE holds the real model's path (relative
    # to the file's directory). Both also work for VROD_EMBED_MODEL.
    p = p.resolve()
    if (p.is_file() and p.suffix not in (".pt", ".pth", ".onnx")
            and p.stat().st_size <= 4096):
        try:
            text = p.read_text().strip()
        except (OSError, UnicodeDecodeError):
            text = ""
        if text and "\x00" not in text and "\n" not in text:
            t = Path(text).expanduser()
            ind = t if t.is_absolute() else (p.parent / t)
            if ind.exists():
                p = ind.resolve()
    if p.is_dir():
        return _hf_embed_fn(p), f"transformers model at {p}"
    if p.suffix in (".pt", ".pth"):
        return _torch_embed_fn(p), f"torch model at {p}"
    if p.suffix == ".onnx":
        return _onnx_embed_fn(p), f"onnx model at {p}"
    from ..errors import VrodError
    raise VrodError(
        f"Unrecognized embed model {p}: expected a transformers "
        f"directory, a .pt/.pth torch module, or a .onnx file")


def extract_words(text: str, n: int) -> list[str]:
    """First n whitespace-split words (reference: extract_words, :22-27)."""
    return text.split()[:n]


def print_embeddings_info(embeddings: np.ndarray, words: list[str]) -> None:
    """Count/dim/memory diagnostics (reference: print_embeddings_info, :33-50)."""
    n, dim = embeddings.shape
    mem = embeddings.nbytes
    print(f"Number of embeddings: {n}")
    print(f"Embedding dimension: {dim}")
    print(f"Embeddings memory size: {mem} bytes ({mem / 1024:.2f} KiB)")
    if words:
        print(f"First word: {words[0]!r}")


def write_embeddings_to_file(embeddings: np.ndarray, words: list[str],
                             path: str | Path = DEFAULT_OUTPUT) -> Path:
    """One ``v0,v1,...;word`` line per vector (reference: :52-71)."""
    from ..records import format_record
    path = Path(path)
    with open(path, "w") as f:
        for vec, word in zip(embeddings, words):
            f.write(format_record(vec, word) + "\n")
    print(f"Wrote {len(words)} embeddings to {path} "
          f"({path.stat().st_size} bytes)")
    return path


def process_embeddings(n: int, source: str | Path | None = None,
                       output: str | Path = DEFAULT_OUTPUT,
                       embed_fn=None, dim: int = DEFAULT_DIM) -> Path:
    """End-to-end ingest (reference: process_embeddings, :6-20)."""
    if n < 0:
        from ..errors import VrodError
        raise VrodError(
            f"--generate-embeddings amount must be >= 0, got {n} "
            f"(a negative slice would silently trim from the tail)")
    src = Path(source) if source else Path(DEFAULT_SOURCE)
    if source is not None and not src.exists():
        # The built-in excerpt only substitutes for the DEFAULT source; an
        # explicitly requested corpus that is missing must error, not
        # silently embed the wrong text.
        from ..errors import VrodError
        raise VrodError(f"Embeddings source file not found: {src}")
    text = src.read_text() if src.exists() else _FALLBACK_TEXT
    words = extract_words(text, n)
    embed = embed_fn
    if embed is None:
        # CLI path: auto-detect a local model (VROD_EMBED_MODEL env var or
        # ./.vrod_embed_model), falling back to the builtin hash embedder.
        embed, desc = resolve_embed_fn()
        print(f"Embedder: {desc}")
        if embed is None:
            embed = lambda ws: hash_embed(ws, dim)  # noqa: E731
    embeddings = np.asarray(embed(words), dtype=np.float32)
    print_embeddings_info(embeddings, words)
    return write_embeddings_to_file(embeddings, words, output)
