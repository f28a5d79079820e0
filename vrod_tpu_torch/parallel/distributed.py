"""Multi-process support: the process group, its host-side KV store, and
the global row mesh.

The port of ``vrod_tpu.parallel.distributed``. Every process runs the same
program with the same (replicated) query and mutation inputs (SPMD); device
state lives sharded over all processes' devices; rank 0 owns host-side
durability (the WAL) and the others replay.

Usage (one call per process, before building collections):

    from vrod_tpu_torch.parallel import distributed
    distributed.initialize()          # env-driven, see below
    eng = DeviceEngine(cfg, devices=distributed.global_devices())

Environment variables (as in the JAX package):
    VROD_COORDINATOR   host:port of rank 0's store (e.g. "10.0.0.1:8476")
    VROD_NUM_PROCESSES total process count
    VROD_PROCESS_ID    this process's rank

``initialize`` builds one ``torch.distributed.TCPStore`` (rank 0 serves
it) and hands it to ``init_process_group``; the same store is
``coordination_client()``, the host-side KV of the agreement rounds.

The backend follows a rule, decided the same way on every rank from what
each rank publishes in the store: NCCL when every rank has a CUDA device
of its own, gloo otherwise (on the CPU, and with several ranks on one card,
where NCCL refuses a shared GPU). Under gloo the collectives' tensors go
through host memory. The choice is printed to standard error.
"""

from __future__ import annotations

import atexit
import datetime
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..runtime import default_device, resolve_device

# How long a rank waits for the others in the store (initialization, device
# exchange) before it raises.
STORE_TIMEOUT_S = 300.0


class _Group:
    def __init__(self, store, rank, world, backend, device):
        self.store, self.rank, self.world = store, rank, world
        self.backend, self.device = backend, device
        self.rounds = 0  # store rounds of global_devices (unique keys)


_group: _Group | None = None


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device=None) -> None:
    """Join the process group. Arguments default to the VROD_* env vars;
    no-op when neither arguments nor env vars are present (one process).
    ``device`` is this rank's own device (default: under
    ``VROD_PLATFORM=cpu`` the CPU, else the card of its place among the
    ranks on its host)."""
    global _group
    if _group is not None:
        return
    coordinator = coordinator or os.environ.get("VROD_COORDINATOR")
    if num_processes is None and "VROD_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["VROD_NUM_PROCESSES"])
    if process_id is None and "VROD_PROCESS_ID" in os.environ:
        process_id = int(os.environ["VROD_PROCESS_ID"])
    if coordinator is None and num_processes is None and process_id is None:
        return  # one process
    if coordinator is None or num_processes is None or process_id is None:
        # A half-configured launch (e.g. VROD_PROCESS_ID exported but the
        # coordinator var typo'd) must not silently serve as an
        # independent single-host node: that process would own its own
        # WAL and fork durable truth from the group it meant to join.
        raise RuntimeError(
            "Incomplete multi-host configuration: VROD_COORDINATOR, "
            "VROD_NUM_PROCESSES and VROD_PROCESS_ID must all be set "
            f"(got coordinator={coordinator!r}, "
            f"num_processes={num_processes!r}, process_id={process_id!r})")
    host, port = coordinator.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=STORE_TIMEOUT_S)
    store = dist.TCPStore(host, int(port), world_size=num_processes,
                          is_master=process_id == 0, timeout=timeout)
    device = _own_device(store, process_id, num_processes, device)
    backend, why = _choose_backend(store, process_id, num_processes, device)
    print(f"vrod_tpu_torch.parallel: rank {process_id} of {num_processes} "
          f"on {device}, backend {backend} ({why})", file=sys.stderr,
          flush=True)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    _group = _Group(store, process_id, num_processes, backend, device)
    # Leave the group before the interpreter tears down: a rank whose
    # group outlives its peers' exit aborts in the backend's threads.
    atexit.register(shutdown)


def _exchange(store, key, rank, world, value: str) -> list[str]:
    store.set(f"{key}/{rank}", value)
    keys = [f"{key}/{r}" for r in range(world)]
    store.wait(keys, datetime.timedelta(seconds=STORE_TIMEOUT_S))
    return [store.get(k).decode() for k in keys]


def _own_device(store, rank, world, device) -> torch.device:
    """This rank's device: ``device`` if given; the CPU under
    ``VROD_PLATFORM=cpu``; else card ``i % cards``, ``i`` the rank's place
    among the ranks on its host."""
    hosts = _exchange(store, "vrod/init/host", rank, world,
                      socket.gethostname())
    if device is not None:
        return resolve_device(device)
    if default_device().type == "cpu":
        return torch.device("cpu")
    place = sum(1 for r in range(rank) if hosts[r] == hosts[rank])
    return resolve_device(f"cuda:{place % torch.cuda.device_count()}")


def _choose_backend(store, rank, world, device) -> tuple[str, str]:
    """NCCL when every rank has a CUDA device of its own, else gloo; the
    same answer on every rank (from the same exchanged values)."""
    mine = f"{socket.gethostname()}|{device}"
    seen = _exchange(store, "vrod/init/device", rank, world, mine)
    if not all(s.split("|", 1)[1].startswith("cuda") for s in seen):
        return "gloo", "a rank is on the CPU"
    if len(set(seen)) < world:
        return "gloo", "ranks share a card, which NCCL refuses"
    return "nccl", "every rank has a card of its own"


def is_distributed() -> bool:
    return _group is not None and _group.world > 1


def process_index() -> int:
    return _group.rank if _group is not None else 0


def process_count() -> int:
    return _group.world if _group is not None else 1


def backend() -> str | None:
    return _group.backend if _group is not None else None


def local_device() -> torch.device | None:
    """This rank's own device (``initialize``'s choice), or None."""
    return _group.device if _group is not None else None


def shutdown() -> None:
    """Leave the process group (every rank, at the end of its work)."""
    global _group
    if _group is not None:
        dist.destroy_process_group()
        _group = None


def coordination_client():
    """The process group's host-side KV store (``TCPStore``), or ``None``
    outside a distributed init. Collective maintenance uses it for
    cross-rank agreement without a device collective: a collective must
    occupy the same position in every rank's stream, which is the property
    agreement is trying to establish."""
    return _group.store if _group is not None else None


def kv_exchange(client, prefix: str, rank: int, nprocs: int,
                payload: str, timeout_s: float):
    """One host-side allgather round over the KV store: publish ``payload``
    under ``prefix/<rank>`` and block until every rank's is there.
    ``prefix`` must be unique per round (see Collection's nonce/seq key
    scheme)."""
    client.set(f"{prefix}/{rank}", payload)
    keys = [f"{prefix}/{r}" for r in range(nprocs)]
    client.wait(keys, datetime.timedelta(seconds=max(timeout_s, 0.001)))
    return [client.get(k).decode() for k in keys]


def is_leader() -> bool:
    """Rank 0 owns host-side durability (WAL writes, snapshots)."""
    return process_index() == 0


def global_devices(local=None):
    """All devices across the process group, in stable global order: rank
    0's, then rank 1's, ... Each rank offers ``local`` (default: its own
    device; ``[cpu] * 4`` gives 4 CPU shards). Collective over the store:
    every rank calls it, in the same order. Outside a distributed init,
    ``local`` itself (default ``runtime.default_devices()``)."""
    from .mesh import ShardDevice
    if _group is None:
        from ..runtime import default_devices
        return list(local) if local is not None else default_devices()
    local = [resolve_device(d) for d in (local or [_group.device])]
    _group.rounds += 1
    seen = _exchange(_group.store, f"vrod/devices/{_group.rounds}",
                     _group.rank, _group.world,
                     ",".join(str(d) for d in local))
    return [ShardDevice(torch.device(d), r)
            for r, devs in enumerate(seen) for d in devs.split(",")]


# -- collectives over the default group ------------------------------------
# NCCL takes tensors on the rank's card, gloo on the host; these helpers
# stage a tensor to where the backend wants it and back, and move dtypes
# that a backend may not reduce or gather (bool, bfloat16) as raw bytes.
# Outside a process group each acts over a world of one process, as JAX's
# collectives do in a single process.


def _staged(t: torch.Tensor) -> torch.Tensor:
    dev = _group.device if _group.backend == "nccl" else torch.device("cpu")
    t = t.contiguous()
    if t.dtype in (torch.bool, torch.bfloat16):
        t = t.view(torch.uint8 if t.dtype == torch.bool else torch.int16)
    return t.to(dev)


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """(world, *t.shape): every rank's ``t``, on ``t``'s device."""
    if _group is None:
        return t.unsqueeze(0).clone()
    x = _staged(t)
    out = [torch.empty_like(x) for _ in range(_group.world)]
    dist.all_gather(out, x)
    return torch.stack(out).to(t.device).view(t.dtype)


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    """The elementwise max of every rank's float32 ``t``."""
    if _group is None:
        return t.clone()
    x = _staged(t)
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return x.to(t.device)


def broadcast(t: torch.Tensor, src: int) -> torch.Tensor:
    """Rank ``src``'s ``t`` (every rank passes a tensor of its shape and
    dtype), on ``t``'s device."""
    if _group is None:
        return t.clone()
    x = _staged(t)
    dist.broadcast(x, src)
    return x.to(t.device).view(t.dtype)


def broadcast_int(value: int, src: int = 0) -> int:
    return int(broadcast(torch.tensor([value], dtype=torch.int64), src)[0])


def all_gather_int64(values) -> np.ndarray:
    """(world, n) int64: every rank's ``values`` (n int64 each)."""
    t = torch.as_tensor(np.asarray(values, np.int64))
    return all_gather(t).numpy()
