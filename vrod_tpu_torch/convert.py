"""Carry engine state between the JAX package and the port, byte for byte.

``engine_state_from_numpy`` turns the JAX engine's arrays
(``np.asarray(eng.x)``, ``np.asarray(eng.aux)``, ``np.asarray(eng.valid)``)
into the port's tensors without conversion, and
``DeviceEngine.load_state`` installs them, so both packages can search
identical stored rows.
"""

from __future__ import annotations

import numpy as np
import torch

from vrod_tpu.config import CollectionConfig


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> a new torch tensor on ``device`` with the same bytes (never
    a view of ``a``); bfloat16 (the ml_dtypes numpy type) travels as its
    16-bit pattern."""
    a = np.array(a, order="C", copy=True) if not a.flags.writeable \
        else np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device, copy=True)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch -> numpy with the same bytes (bfloat16 -> ml_dtypes)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def engine_state_from_numpy(cfg: CollectionConfig, x, aux, valid, device):
    """(x, aux, valid) tensors on ``device`` holding exactly the given
    arrays: x (capacity, storage dim) in the collection's stored dtype,
    aux (capacity,) float32, valid (capacity,) bool."""
    x, aux, valid = np.asarray(x), np.asarray(aux), np.asarray(valid)
    storage_dim = cfg.dim // 2 if cfg.dtype == "int4" else cfg.dim
    want = "int8" if cfg.dtype in ("int8", "int4") else cfg.dtype
    cap = x.shape[0]
    if x.shape != (cap, storage_dim) or x.dtype.name != want:
        raise ValueError(f"x is {x.shape} {x.dtype}, the collection stores "
                         f"(capacity, {storage_dim}) {want}")
    if aux.shape != (cap,) or aux.dtype != np.float32:
        raise ValueError(f"aux must be ({cap},) float32")
    if valid.shape != (cap,) or valid.dtype != np.bool_:
        raise ValueError(f"valid must be ({cap},) bool")
    return (to_tensor(x, device), to_tensor(aux, device),
            to_tensor(valid, device))
