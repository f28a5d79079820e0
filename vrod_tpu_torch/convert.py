"""Carry engine state between the JAX package and the port, byte for byte.

``engine_state_from_numpy`` turns the JAX engine's arrays
(``np.asarray(eng.x)``, ``np.asarray(eng.aux)``, ``np.asarray(eng.valid)``:
the global ``(capacity, ...)`` state, whatever its shards) into the port's
tensors without conversion, and ``DeviceEngine.load_state`` installs them,
splitting them over the port's shards as ``P(ROWS_AXIS)`` splits them, so
both packages can search identical stored rows (a JAX 8-shard state
searches the same in the port at 8 shards). The int8/int4 l2 norms lane is derived state: it is
never carried, and ``load_state`` rebuilds it from x and aux, bit for bit
the JAX engine's.

bfloat16 needs no numpy bfloat16 type here: ``to_numpy`` hands it out as
its raw 16-bit words (``np.uint16``, the snapshot's storage dtype), and
``to_tensor`` takes those words (or an array whose dtype is named
``bfloat16``, as the JAX package's are) back as bfloat16 with the same
bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import CollectionConfig


def to_tensor(a: np.ndarray, device, dtype: torch.dtype | None = None
              ) -> torch.Tensor:
    """numpy -> a new torch tensor on ``device`` with the same bytes (never
    a view of ``a``). An array whose dtype is named bfloat16, or 16-bit
    words (uint16/int16) with ``dtype=torch.bfloat16``, becomes bfloat16
    with the same bit patterns."""
    a = np.array(a, order="C", copy=True) if not a.flags.writeable \
        else np.ascontiguousarray(a)
    words = a.dtype.name == "bfloat16" or (
        dtype == torch.bfloat16 and a.dtype in (np.uint16, np.int16))
    if words:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device, copy=True)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy with the same bytes (bfloat16 -> its raw uint16
    words)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def engine_state_from_numpy(cfg: CollectionConfig, x, aux, valid, device):
    """(x, aux, valid) tensors on ``device`` holding exactly the given
    arrays: x (capacity, storage dim) in the collection's stored dtype
    (bfloat16 also as uint16 words), aux (capacity,) float32, valid
    (capacity,) bool."""
    x, aux, valid = np.asarray(x), np.asarray(aux), np.asarray(valid)
    storage_dim = cfg.dim // 2 if cfg.dtype == "int4" else cfg.dim
    want = "int8" if cfg.dtype in ("int8", "int4") else cfg.dtype
    ok = {want, "uint16"} if want == "bfloat16" else {want}
    cap = x.shape[0]
    if x.shape != (cap, storage_dim) or x.dtype.name not in ok:
        raise ValueError(f"x is {x.shape} {x.dtype}, the collection stores "
                         f"(capacity, {storage_dim}) {want}")
    if aux.shape != (cap,) or aux.dtype != np.float32:
        raise ValueError(f"aux must be ({cap},) float32")
    if valid.shape != (cap,) or valid.dtype != np.bool_:
        raise ValueError(f"valid must be ({cap},) bool")
    bf16 = torch.bfloat16 if want == "bfloat16" else None
    return (to_tensor(x, device, bf16), to_tensor(aux, device),
            to_tensor(valid, device))
