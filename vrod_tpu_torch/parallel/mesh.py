"""Row mesh of the port: which device, in which process, holds each shard.

The port of ``vrod_tpu.parallel.mesh``. A collection row-shards over an
ordered list of devices, one per shard: shard ``s`` holds the global slots
``[s * rows_local, (s + 1) * rows_local)``, the layout of JAX's
``P(ROWS_AXIS, None)``. A device may appear more than once: ``[cpu] * 8``
is the CPU stand-in for the JAX tests' 8 forced host devices, and
``[cuda:0] * 4`` is four shards on one card. A mesh whose devices belong
to more than one process (``parallel.distributed.global_devices()``) is
process-spanning: each process holds only its own shards, and search,
growth and the row gathers become collectives over the process group.
"""

from __future__ import annotations

import dataclasses

import torch

from ..runtime import default_devices, resolve_device


@dataclasses.dataclass(frozen=True)
class ShardDevice:
    """A device of a process-spanning mesh: ``device`` in the process of
    rank ``process_index`` (``jax.Device.process_index``)."""

    device: torch.device
    process_index: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One row axis: ``devices[s]`` of process ``process_indices[s]`` holds
    shard ``s``; ``process_index`` is the process that built the mesh."""

    devices: tuple[torch.device, ...]
    process_indices: tuple[int, ...]
    process_index: int

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> tuple[int, ...]:
        """The shards this process holds, in shard order."""
        return tuple(s for s, p in enumerate(self.process_indices)
                     if p == self.process_index)

    @property
    def multiprocess(self) -> bool:
        return len(set(self.process_indices)) > 1

    def shards_of(self, process_index: int) -> tuple[int, ...]:
        return tuple(s for s, p in enumerate(self.process_indices)
                     if p == process_index)


def make_mesh(shards: int, devices=None) -> Mesh:
    """The first ``shards`` of ``devices`` (default ``default_devices()``)
    as a row mesh. An entry is a torch device (or its name) of this
    process, or a ``ShardDevice`` of any process."""
    from . import distributed
    if devices is None:
        devices = default_devices()
    devices = list(devices)
    if shards > len(devices):
        raise ValueError(
            f"Requested {shards} shards but only {len(devices)} devices are "
            f"available"
        )
    here = distributed.process_index()
    devs, procs = [], []
    for d in devices[:shards]:
        if isinstance(d, ShardDevice):
            devs.append(resolve_device(d.device) if d.process_index == here
                        else torch.device(d.device))
            procs.append(int(d.process_index))
        else:
            devs.append(resolve_device(d))
            procs.append(here)
    mesh = Mesh(tuple(devs), tuple(procs), here)
    if not mesh.local:
        raise ValueError(f"process {here} holds no shard of the mesh")
    return mesh


def replicated(mesh: Mesh) -> torch.device:
    """Where this process keeps replicated values (queries, merged
    candidates, results): the device of its first shard."""
    return mesh.devices[mesh.local[0]]
