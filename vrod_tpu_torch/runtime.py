"""Device choice for the port.

``VROD_PLATFORM`` is the variable the JAX package and its tests use:
``cpu`` places collections on the CPU (plain PyTorch ops); ``gpu`` or
``cuda``, or no value, places them on ``cuda:0``. Without a GPU the latter
raises: the port never moves to the CPU on its own.
"""

from __future__ import annotations

import os

import torch

from .errors import ConfigError


def default_device() -> torch.device:
    platform = os.environ.get("VROD_PLATFORM", "").strip().lower()
    if platform == "cpu":
        return torch.device("cpu")
    if platform in ("", "gpu", "cuda"):
        return resolve_device("cuda")
    raise ConfigError(
        f"VROD_PLATFORM={platform!r}: expected cpu, gpu or cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device (``None``: ``default_device()``). A
    CUDA device must exist; ``cuda`` without an index means ``cuda:0``."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; set VROD_PLATFORM=cpu to run "
                "vrod_tpu_torch on the CPU")
        return torch.device("cuda", 0 if dev.index is None else dev.index)
    if dev.type != "cpu":
        raise ConfigError(f"unsupported device {dev}")
    return dev
