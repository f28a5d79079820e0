"""Device engine of the port: one collection's rows, row-sharded over a mesh.

The port of ``vrod_tpu.engine``. A collection's device state is, for each
shard, three tensors, and a fourth for int8/int4 + l2 (``capacity`` below
is the shard's ``rows_local``):

  x     (capacity, dim)  stored dtype — the rows (int4: packed, dim/2 bytes)
  aux   (capacity,) f32  — int8/int4: the per-row dequant scale; float
                           rows: 1/|x| (cosine) or |x|^2 (l2, dot)
  valid (capacity,) bool — live bitmap (free-list holes and deletes False)
  norms (capacity,) f32  — int8/int4 + l2 only: |x_hat|^2 per row
                           (``distances.row_norms2``), K1/K3's -|x_hat|^2
                           mask bias. Derived state: every mutation keeps
                           it, ``load_state`` and ``rebuild_norms``
                           recompute it, and snapshots never hold it.

The mesh (``parallel.mesh``) is an ordered list of devices, one per shard;
shard ``s`` holds the global slots ``[s * rows_local, (s + 1) *
rows_local)``, the layout of JAX's ``P(ROWS_AXIS, None)``, and one device
may hold several shards. Capacity grows in whole segments on every shard
(``segment_rows * shards`` at a time), and growth or shrinking re-lays the
rows over the shards as XLA re-shards them: slot ``s`` is on shard ``s //
rows_local`` after every change. Where the JAX package rebuilt arrays in
jitted scatters with donated buffers, the port updates these tensors in
place (``index_copy_``, ``index_put_``). A JAX scatter with ``mode="drop"``
ignores indices past the end; the port drops them before scattering.

Search, for every dtype and metric, runs the program of
``vrod_tpu.engine._search_fn`` with the port's kernels: quantize the query
(int8/int4; l2 keeps its scale); on each shard, the sampled sub-max
pre-pass (``cuda_topk.sampled_submax``) on the shard's own prefix when the
floor gate opens at ``rows_local``, the exact k-th sub-max by counting
(less the accumulation margin for float dot/l2, from the shard's rows) and
the fused scan (``cuda_topk.fused_topk``) with the shard's slot offset;
then the merge of the shards' candidates (``merge_shards``), the exact
float32 rescore of the merged candidates (each read on the shard that
holds it) and ``finalize_scores``. On a CUDA device the wrappers launch the CUDA kernels;
on the CPU they run their plain versions. ``search`` takes the JAX
engine's options (``precision``, ``impl``, ``rescore``, ``as_numpy``,
``margin``, ``filter_mask``) and its ``VROD_THETA0*`` variables.

On a process-spanning mesh (``parallel.distributed``) each process holds
its own shards only. Every mutation and search is then called by every
rank with the same arguments (SPMD): writes and erases touch local shards
alone; growth, ``move``, the gathers and search are collectives (the
shards' candidates are all-gathered, each rank rescores the merged
candidates it holds, and a max over the ranks combines the scores), so
every rank returns the same answer.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
import warnings

import numpy as np
import torch

from .config import CollectionConfig

from .convert import to_numpy, to_tensor
from .ops import cuda_topk
from .ops import distances as D
from .parallel import distributed
from .parallel.mesh import make_mesh, replicated
from .runtime import default_devices

# Queries pad to these batch sizes and k to these widths, as in the JAX
# engine, so the two return the same candidates.
BATCH_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
K_BUCKETS = (8, 16, 32, 64, 96, 100, 112, 128, 256, 512, 1024)
MAX_K = 1024

# The least rescore margin, by stored dtype, of a search whose k_out exceeds
# 16, measured on the H100 (tools/recall_margin.py, 1,048,576 x 768 rows,
# 4 batches of 256 queries, cosine/dot/l2, tools/recall_results_h100.jsonl):
# 1.5 x the least margin that held recall 1.0 on every batch at top-100
# (int8 and int4 24, bfloat16 8), rounded up. At k_out 16 the JAX policy
# held with room (int8/int4 8 of 12, floats 4 of 8), and float32 in TF32
# needed 4 at top-100, so those stay the JAX engine's.
WIDE_K_MARGIN = {"int8": 36, "int4": 36, "bfloat16": 12}

# Sampled-floor defaults, the JAX engine's (engine.py:106-158 and the
# VROD_THETA0_* defaults at :829-844); their H100 values are not measured
# yet (ROADMAP). The tile budget is the TPU pre-pass's
# (pallas_topk.SUBMAX_VMEM_BYTES): it only shapes which block size the gate
# picks. The floor opens from k_scan THETA0_MINK on int8/int4 rows and from
# THETA0_MINK_FLOAT on float rows (engine.py:124).
SUBMAX_TILE_BYTES = 24 * 1024 * 1024
THETA0_FRAC = 8
THETA0_MINK = 24
THETA0_MINK_FLOAT = 64
THETA0_MARGIN = 1e-3
THETA0_METHODS = ("approx", "count", "minmax", "topk")


@dataclasses.dataclass(frozen=True)
class FloorSettings:
    """The sampled floor's knobs, as the JAX engine reads them from the
    environment at every search (engine.py:811-860): ``VROD_THETA0=0``
    turns the floor off; ``VROD_THETA0_MARGIN``, ``_FRAC``, ``_BLK`` (0:
    the largest block that keeps the gate open) and ``_MINK`` override the
    defaults; ``VROD_THETA0_METHOD`` names the k-th sub-max method. Every
    method gives a sound floor, so results are exact whichever runs:
    "count" and "topk" take the exact k-th sub-max (by counting, by a
    sort), "minmax" the looser min over k group maxima, and "approx" takes
    the exact one too (``lax.approx_max_k`` is exact off the TPU)."""

    on: bool = True
    margin: float = THETA0_MARGIN
    frac: int = THETA0_FRAC
    method: str = "count"
    blk: int = 0
    mink: int = THETA0_MINK

    @classmethod
    def from_env(cls) -> "FloorSettings":
        env = os.environ.get
        method = env("VROD_THETA0_METHOD", "count")
        if method not in THETA0_METHODS:
            raise ValueError(
                f"VROD_THETA0_METHOD={method!r}: expected "
                f"approx|count|minmax|topk")
        return cls(on=env("VROD_THETA0", "1") != "0",
                   margin=float(env("VROD_THETA0_MARGIN", "1e-3")),
                   frac=int(env("VROD_THETA0_FRAC", "8")),
                   method=method,
                   blk=int(env("VROD_THETA0_BLK", "0")),
                   mink=int(env("VROD_THETA0_MINK", "24")))


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(math.ceil(n / buckets[-1])) * buckets[-1]


def _pick_block_rows(rows: int, segment_rows: int) -> int:
    """Row block of the plain scan (``impl="scan"``): the JAX engine's
    ``_pick_block_rows``. Any block gives the same top-k."""
    block = min(segment_rows, rows)
    while block > 8192 and block % 2 == 0:
        block //= 2
    while rows % block:
        block //= 2
    return max(block, 8)


def floor_gate(rows: int, k_scan: int, dim: int, itemsize: int,
               quant: bool, fs: FloorSettings) -> tuple[bool, int, int]:
    """(open, n_sample, block rows) of the sampled floor for a scan of
    ``rows`` rows of ``dim`` stored elements of ``itemsize`` bytes at
    ``k_scan``: the arithmetic of the JAX engine's ``_gate_for``/
    ``floor_gate``, with the knobs of ``fs`` (the search's one reading of
    the environment, ``FloorSettings.from_env()``).
    The pre-pass block is ``fs.blk`` if set, else the largest of 16384/8192
    rows whose tile stays within SUBMAX_TILE_BYTES; the sample is a prefix
    of whole blocks; the floor is sound only with at least 2 * k_scan
    sub-maxima, and opens from k_scan ``fs.mink`` (int8/int4) or 64
    (float)."""
    frac = fs.frac if k_scan >= 64 else max(fs.frac, 32)
    min_k = fs.mink if quant else THETA0_MINK_FLOAT

    def gate_for(blk):
        n_sample = min(rows, max(128 * k_scan * 2, rows // frac))
        n_sample = (n_sample // blk) * blk
        nsub = (n_sample // blk) * 128
        ok = (fs.on and k_scan >= min_k and nsub >= 2 * k_scan
              and rows >= min(frac, 4) * n_sample)
        return ok, n_sample

    if fs.blk:
        ok, n_sample = gate_for(fs.blk)
        return ok, n_sample if ok else 0, fs.blk
    cands, fallback = [], 8192
    for blk in (16384, 8192):
        while blk * dim * itemsize > SUBMAX_TILE_BYTES and blk > 128:
            blk //= 2
        fallback = blk
        if blk not in cands:
            cands.append(blk)
    for blk in cands:
        ok, n_sample = gate_for(blk)
        if ok:
            return True, n_sample, blk
    return False, 0, fallback


def floor_threshold(sub, k_scan, q_scan, aux, valid, *, metric, quant,
                    dim, fs: FloorSettings):
    """The sampled floor theta0 (B, 1) from K3's sub-maxima ``sub``: the
    k-th sub-max by ``fs.method``, less its margins. K3 scores with K1's
    own code, so its sub-maxima are K1 scores; float dot/l2 still subtract
    the JAX engine's accumulation margin (:203-206)."""
    extra = None
    if metric != "cosine" and not quant:
        extra = D.accumulation_margin(q_scan, aux, valid, metric=metric,
                                      dim=dim)
    method = "topk" if fs.method == "approx" else fs.method
    return D.threshold_from_submax(sub, k_scan, margin_abs=fs.margin,
                                   extra=extra, method=method)


def merge_shards(vals, idx, k: int):
    """The top-k of the shards' candidates (B, shards * k'), shard-major:
    ``lax.top_k`` over the all-gathered lists, which keeps equal values in
    candidate order, so ties go lowest shard first, that is lowest slot
    first. A stable sort gives the same order."""
    top_v, pos = torch.sort(vals, dim=1, descending=True, stable=True)
    return top_v[:, :k], torch.gather(idx, 1, pos[:, :k])


def _sel(t: torch.Tensor, pos: np.ndarray) -> torch.Tensor:
    """Rows ``pos`` (numpy positions) of ``t``."""
    return t[torch.from_numpy(pos).to(t.device)]


class DeviceEngine:
    """Owns the device state of one collection, row-sharded over a mesh.

    ``DeviceEngine(cfg, mesh=None, devices=None, device=None)`` takes a
    ``parallel.mesh.Mesh``, or the devices to shard over (default
    ``runtime.default_devices()``); ``device=d`` is the shorthand of
    ``devices=[d]``. A collection configured for more shards than there
    are devices row-shards over as many as there are, with the JAX
    engine's warning (its snapshots and WAL address record ids, not slots).

    ``x``, ``aux``, ``valid`` and ``norms`` exist at one shard only: they
    are the shard's own tensors, so in-place writes reach the state. With
    more shards no one tensor holds the state and reading them raises;
    ``gather_state()`` returns a copy of the whole state (a collective on
    a process-spanning mesh), and ``gather_raw``/``gather`` read rows.
    ``device`` is where this process keeps queries and results: the device
    of its first shard."""

    # Rows per host->device chunk of a write.
    WRITE_CHUNK_ROWS = 131072

    def __init__(self, cfg: CollectionConfig, mesh=None, devices=None,
                 device=None):
        self.cfg = cfg
        if device is not None:
            if devices is not None or mesh is not None:
                raise ValueError("pass device= or devices=/mesh=, not both")
            devices = [device]
        if mesh is None:
            avail = list(devices) if devices is not None \
                else default_devices()
            shards = cfg.shards
            if shards > len(avail):
                # A collection sharded on a larger topology restores fine on
                # fewer devices: snapshots/WAL address record ids, not
                # slots, so the row layout is rebuilt for the local mesh.
                warnings.warn(
                    f"Collection {cfg.name!r} configured for {shards} shards "
                    f"but only {len(avail)} devices are available; "
                    f"row-sharding over {len(avail)}.")
                shards = len(avail)
            mesh = make_mesh(shards, avail)
        self.mesh = mesh
        self.shards = mesh.size
        # True when the mesh's devices span processes: every mutation and
        # search is then called by every rank (SPMD), and growth, move,
        # the gathers and search are collectives over the process group.
        self.multiprocess = mesh.multiprocess
        if self.multiprocess and \
                set(mesh.process_indices) != set(
                    range(distributed.process_count())):
            raise ValueError("a process-spanning mesh must hold shards of "
                             "every rank of the process group")
        self._local = mesh.local
        self._devs = [mesh.devices[s] for s in self._local]
        self.device = replicated(mesh)
        # One token per collective engine construction, identical on every
        # rank and unique across the process group's lifetime: rank 0's
        # clock, broadcast. Collective maintenance keys its KV agreement
        # rounds on it (Collection._mh_agreed_write).
        self.mh_nonce = 0
        if self.multiprocess:
            self.mh_nonce = distributed.broadcast_int(time.time_ns(), 0)
        self.packed = cfg.dtype == "int4"
        self.quant = cfg.dtype in ("int8", "int4")
        self.dtype = torch.int8 if self.quant else D._as_dtype(cfg.dtype)
        self.has_norms = self.quant and cfg.metric == "l2"
        self.storage_dim = cfg.dim // 2 if self.packed else cfg.dim
        # Capacity granularity: whole segments, evenly divided over shards.
        self._grow_unit = cfg.segment_rows * self.shards
        self.capacity = self._grow_unit
        self._x, self._aux, self._valid = [], [], []
        self._norms = [] if self.has_norms else None
        for dev in self._devs:
            self._x.append(self._zeros(self.rows_local, self.dtype, dev,
                                       self.storage_dim))
            self._aux.append(self._zeros(self.rows_local, torch.float32,
                                         dev))
            self._valid.append(self._zeros(self.rows_local, torch.bool, dev))
            if self.has_norms:
                self._norms.append(self._zeros(self.rows_local,
                                               torch.float32, dev))

    @staticmethod
    def _zeros(rows, dtype, device, dim=None):
        shape = (rows,) if dim is None else (rows, dim)
        return torch.zeros(shape, dtype=dtype, device=device)

    def _lanes(self) -> list[list[torch.Tensor]]:
        """The state, lane by lane (x, aux, valid[, norms]), each a list
        over this process's shards."""
        return [self._x, self._aux, self._valid] + (
            [self._norms] if self.has_norms else [])

    def _global(self, lane):
        if self.shards > 1:
            raise AttributeError(
                f"the state of a {self.shards}-shard engine is not one "
                f"tensor; gather_state() returns a copy of it")
        return lane[0]

    @property
    def x(self) -> torch.Tensor:
        return self._global(self._x)

    @property
    def aux(self) -> torch.Tensor:
        return self._global(self._aux)

    @property
    def valid(self) -> torch.Tensor:
        return self._global(self._valid)

    @property
    def norms(self) -> torch.Tensor | None:
        return self._global(self._norms) if self.has_norms else None

    @property
    def rows_local(self) -> int:
        return self.capacity // self.shards

    def gather_state(self):
        """(x, aux, valid, norms): copies of the whole state (capacity,
        ...) on ``device``, norms None but for int8/int4 + l2. On a
        process-spanning mesh a collective that leaves it on every rank."""
        lanes = self._read(np.arange(self.capacity), self._lanes())
        return tuple(lanes) + ((None,) if not self.has_norms else ())

    def load_state(self, x, aux, valid) -> None:
        """Install the global state (``convert.engine_state_from_numpy``):
        the capacity becomes ``x.shape[0]``, split over the shards as the
        JAX engine's ``P(ROWS_AXIS)`` splits it, and the norms lane is
        rebuilt from x and aux."""
        cap = x.shape[0]
        if x.shape != (cap, self.storage_dim) or x.dtype != self.dtype:
            raise ValueError(f"x is {tuple(x.shape)} {x.dtype}")
        if aux.shape != (cap,) or valid.shape != (cap,):
            raise ValueError("aux and valid must be (capacity,)")
        if cap % self.shards:
            raise ValueError(f"capacity {cap} does not split over "
                             f"{self.shards} shards")
        self.capacity = cap
        rl = self.rows_local
        for j, s in enumerate(self._local):
            dev, lo, hi = self._devs[j], s * rl, (s + 1) * rl
            self._x[j] = x[lo:hi].to(dev).contiguous()
            self._aux[j] = aux[lo:hi].to(dev, torch.float32).contiguous()
            self._valid[j] = valid[lo:hi].to(dev, torch.bool).contiguous()
            if self.has_norms:
                self._norms[j] = torch.empty_like(self._aux[j])
        self.rebuild_norms()

    # -- capacity ----------------------------------------------------------

    def ensure_capacity(self, needed_slots: int) -> bool:
        """Grow the tensors so at least ``needed_slots`` exist. True if
        grown. On a process-spanning mesh this is a collective."""
        if needed_slots <= self.capacity:
            return False
        self._relayout(int(math.ceil(needed_slots / self._grow_unit))
                       * self._grow_unit)
        self._release_cached()
        return True

    def shrink_target(self, needed_slots: int) -> int:
        """Smallest whole-segment capacity holding ``needed_slots``."""
        return max(self._grow_unit,
                   int(math.ceil(needed_slots / self._grow_unit))
                   * self._grow_unit)

    def shrink_capacity(self, needed_slots: int) -> bool:
        """Shrink the tensors to ``shrink_target(needed_slots)`` (after
        compaction packed the live rows to the front). True if shrunk."""
        new_cap = self.shrink_target(needed_slots)
        if new_cap >= self.capacity:
            return False
        self._relayout(new_cap)
        self._release_cached()
        return True

    def _release_cached(self) -> None:
        """Return the freed buffers of a relayout to the device (the
        caching allocator keeps a freed block for reuse, but no later
        capacity fits a smaller block): without this a collection grown
        segment by segment keeps every earlier capacity reserved (10M x
        768 int8 rows grown by 1,048,576-row segments: 44 GB reserved for
        7.7 GB of rows, on a card that two such processes share)."""
        for dev in set(self._devs):
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    torch.cuda.empty_cache()

    def _relayout(self, new_cap: int) -> None:
        """Capacity ``new_cap``, with every kept slot ``s`` moved to shard
        ``s // (new_cap / shards)`` (zeros past the old capacity). A piece
        that another process needs is broadcast by its holder."""
        old_rl, new_rl = self.rows_local, new_cap // self.shards
        lanes = self._lanes()
        here, owner = self.mesh.process_index, self.mesh.process_indices
        new = [[self._zeros(new_rl, lane[0].dtype, dev,
                            *lane[0].shape[1:]) for dev in self._devs]
               for lane in lanes]
        for s in range(self.shards):
            lo, hi = s * old_rl, min((s + 1) * old_rl, new_cap)
            if lo >= hi:
                continue
            targets = range(lo // new_rl, (hi - 1) // new_rl + 1)
            need = {owner[t] for t in targets}
            src = None
            if owner[s] == here:
                j = self._local.index(s)
                src = [lane[j] for lane in lanes]
            if need - {owner[s]}:
                if src is None:
                    src = [torch.empty((old_rl,) + lane[0].shape[1:],
                                       dtype=lane[0].dtype,
                                       device=self.device)
                           for lane in lanes]
                src = [distributed.broadcast(t, owner[s]) for t in src]
            for t in targets:
                if owner[t] != here:
                    continue
                j = self._local.index(t)
                a, b = max(lo, t * new_rl), min(hi, (t + 1) * new_rl)
                for out, piece in zip(new, src):
                    out[j][a - t * new_rl:b - t * new_rl] = \
                        piece[a - s * old_rl:b - s * old_rl].to(
                            self._devs[j])
        for lane, fresh in zip(lanes, new):
            lane[:] = fresh
        self.capacity = new_cap

    # -- mutations ---------------------------------------------------------

    def _in_range(self, slots) -> np.ndarray:
        """Slots as int64, without those past the capacity (the JAX
        scatters' ``mode="drop"``)."""
        slots = np.asarray(slots, dtype=np.int64).reshape(-1)
        return slots[(slots >= 0) & (slots < self.capacity)]

    def _owned(self, slots: np.ndarray):
        """For each of this process's shards holding any of ``slots``
        (int64, inside the capacity): (its index here, the positions in
        ``slots``, and its local slots on its device)."""
        rl = self.rows_local
        shard = slots // rl
        for j, s in enumerate(self._local):
            pos = np.flatnonzero(shard == s)
            if pos.size:
                yield j, pos, torch.from_numpy(slots[pos] - s * rl).to(
                    self._devs[j])

    def write(self, slots: np.ndarray, vecs: np.ndarray) -> None:
        """Quantize/prepare f32 vectors on the device and scatter them in
        place into ``slots``. A chunk is prepared whole, whatever the
        shards, so that the stored bytes are the one-shard engine's."""
        slots = np.asarray(slots, dtype=np.int64).reshape(-1)
        vecs = np.asarray(vecs, dtype=np.float32)
        dtype = "int4" if self.packed else self.dtype
        for start in range(0, len(slots), self.WRITE_CHUNK_ROWS):
            sl = slots[start:start + self.WRITE_CHUNK_ROWS]
            keep = (sl >= 0) & (sl < self.capacity)
            chunk = vecs[start:start + self.WRITE_CHUNK_ROWS][keep]
            if not chunk.shape[0]:
                continue
            v = to_tensor(chunk, self.device)
            rows, auxv = D.prepare_rows(v, metric=self.cfg.metric,
                                        dtype=dtype)
            for j, pos, loc in self._owned(sl[keep]):
                self._scatter(j, loc, _sel(rows, pos), _sel(auxv, pos))

    def write_raw(self, slots: np.ndarray, rows: np.ndarray,
                  aux: np.ndarray) -> None:
        """Scatter rows already in the stored representation (snapshot
        restore: no requantization)."""
        slots = np.asarray(slots, dtype=np.int64).reshape(-1)
        keep = (slots >= 0) & (slots < self.capacity)
        rows = np.asarray(rows)[keep]
        aux = np.asarray(aux, dtype=np.float32)[keep]
        for j, pos, loc in self._owned(slots[keep]):
            dev = self._devs[j]
            self._scatter(j, loc, to_tensor(rows[pos], dev, self.dtype).to(
                self.dtype), to_tensor(aux[pos], dev))

    def _scatter(self, j, idx, rows, auxv) -> None:
        """Stored rows and aux into local slots ``idx`` of shard ``j``
        (all inside it), their norms too, and mark them live."""
        dev = self._devs[j]
        rows, auxv = rows.to(dev), auxv.to(dev)
        self._x[j].index_copy_(0, idx, rows)
        self._aux[j].index_copy_(0, idx, auxv)
        if self.has_norms:
            self._norms[j].index_copy_(0, idx, D.row_norms2(rows, auxv,
                                                            self.packed))
        self._valid[j][idx] = True

    def _read(self, slots: np.ndarray, lanes) -> list[torch.Tensor]:
        """Each lane's values at global ``slots``, on ``device``, in order.
        On a process-spanning mesh a collective: every rank fills in the
        rows it holds, and all-gathers them from the others."""
        out = [self._zeros(slots.size, lane[0].dtype, self.device,
                           *lane[0].shape[1:]) for lane in lanes]
        for j, pos, loc in self._owned(slots):
            p = torch.from_numpy(pos).to(self.device)
            for o, lane in zip(out, lanes):
                o[p] = lane[j][loc].to(self.device)
        if self.multiprocess:
            rank = np.asarray(self.mesh.process_indices)[
                slots // self.rows_local]
            pick = (torch.from_numpy(rank).to(self.device),
                    torch.arange(slots.size, device=self.device))
            out = [distributed.all_gather(o)[pick] for o in out]
        return out

    def gather_raw(self, slots: np.ndarray, *, sync: bool = True):
        """(stored rows, aux) at ``slots``: numpy, or with ``sync=False``
        tensors on ``device`` (copies, so later in-place mutations do not
        reach them). On a process-spanning mesh a collective (every rank
        calls it with the same slots, in the same order) that leaves the
        whole chunk on every rank."""
        slots = np.asarray(slots, dtype=np.int64).reshape(-1)
        rows, auxv = self._read(slots, (self._x, self._aux))
        if not sync:
            return rows, auxv
        return to_numpy(rows), to_numpy(auxv)

    def erase(self, slots: np.ndarray) -> None:
        for j, _, loc in self._owned(self._in_range(slots)):
            self._valid[j][loc] = False

    def rebuild_norms(self) -> None:
        """Recompute the int8/int4 + l2 norms lane from x and aux (after
        ``load_state`` installed them), a chunk of rows at a time. No-op
        for the other legs. Dead slots get values that the mask never lets
        score."""
        if not self.has_norms:
            return
        for x, aux, norms in zip(self._x, self._aux, self._norms):
            for lo in range(0, x.shape[0], self.WRITE_CHUNK_ROWS):
                hi = lo + self.WRITE_CHUNK_ROWS
                norms[lo:hi] = D.row_norms2(x[lo:hi], aux[lo:hi],
                                            self.packed)

    def move(self, src: np.ndarray, dst: np.ndarray) -> None:
        """Compaction: copy rows src -> dst (across shards too), then
        invalidate src. Every source is read before any write."""
        if len(src) == 0:
            return
        src = np.asarray(src, dtype=np.int64).reshape(-1)
        dst = np.asarray(dst, dtype=np.int64).reshape(-1)
        keep = (dst >= 0) & (dst < self.capacity)
        lanes = self._lanes()
        vals = self._read(src[keep], lanes)
        for j, pos, loc in self._owned(dst[keep]):
            for lane, v in zip(lanes, vals):
                lane[j][loc] = _sel(v, pos).to(self._devs[j])
        self.erase(src)

    # -- reads -------------------------------------------------------------

    def filter_mask_from_slots(self, slots: np.ndarray, *,
                               mode: str = "within"):
        """Bool (capacity,) mask on ``device`` (every shard takes its
        slice): ``within`` is True only at ``slots``, ``exclude`` False
        only there."""
        if mode not in ("within", "exclude"):
            raise ValueError(f"Unknown filter mode {mode!r}")
        base = mode == "exclude"
        m = torch.full((self.capacity,), base, dtype=torch.bool,
                       device=self.device)
        m[torch.from_numpy(self._in_range(slots)).to(self.device)] = not base
        return m

    def gather(self, slots: np.ndarray) -> np.ndarray:
        """Rows (f32) for exact-lookup SEARCH (dequantized for int8/int4);
        a collective on a process-spanning mesh."""
        slots = np.asarray(slots, dtype=np.int64).reshape(-1)
        rows, aux = self._read(slots, (self._x, self._aux))
        if self.quant:
            rows = D.unpack_int4_rows(rows) if self.packed else rows.float()
            return to_numpy(rows * aux[:, None])
        return to_numpy(rows.float())

    def scan_widths(self, k: int, margin: int | None = None,
                    rescore: bool = True) -> tuple[int, int]:
        """(k_out, k_scan) of a search for top-k (k <= MAX_K): k bucketed,
        and that plus the candidate margin, slack for the scan's rank
        jitter that the exact rescore recovers from: the JAX engine's
        policy (:787-804), raised past k_out 16 to ``WIDE_K_MARGIN``, the
        margins measured on the H100. An explicit ``margin`` overrides the
        policy; without the rescore the margin is 0."""
        k_out = min(_bucket(k, K_BUCKETS), self.capacity)
        if not rescore:
            margin = 0
        elif margin is None:
            margin = max(self.cfg.rescore_margin,
                         k_out // 8 if k_out > 100 else 0)
            if self.quant:
                margin = max(margin, 12, k_out // 4 if k_out > 100 else 0)
            if k_out > 16:
                margin = max(margin, WIDE_K_MARGIN.get(self.cfg.dtype, 0))
        return k_out, min(k_out + margin, self.capacity)

    def _query_inputs(self, q, qp, precision):
        """(query for K1/K3, their extra keywords but the row bias)."""
        metric = self.cfg.metric
        extras = dict(packed=self.packed)
        if self.dtype == torch.float32 and precision != "fast":
            extras["precision"] = precision
        if self.has_norms:
            q_scan, qs = D.prepare_queries(q, metric=metric, quantize=True,
                                           return_scale=True)
            extras["q_scale"] = qs
            return q_scan, extras
        if self.quant:
            return D.prepare_queries(q, metric=metric, quantize=True), extras
        return qp, extras

    def scan_inputs(self, q, qp, precision="fast"):
        """(query for K1/K3, their extra keywords) for a padded batch on a
        one-shard engine: the int8-quantized query for int8/int4 rows
        (with its scale and the -|x_hat|^2 row bias for l2), the prepared
        float query otherwise; float32 rows at "high"/"exact" take the
        kernels' three-product leg (``precision``), the JAX Pallas
        kernel's HIGHEST."""
        q_scan, extras = self._query_inputs(q, qp, precision)
        if self.has_norms:
            extras["row_bias"] = -self.norms
        return q_scan, extras

    def _scan(self, j, q_scan, extras, valid, k_scan, fs: FloorSettings):
        """Candidate top-k_scan of the padded query batch on shard ``j``
        of this process: K3 on the shard's own sample and the floor when
        the gate opens at ``rows_local``, then K1 with the shard's slot
        offset (``_search_fn``'s ``local_topk``)."""
        metric = self.cfg.metric
        x, aux = self._x[j], self._aux[j]
        theta0 = None
        ok, n_sample, blk = floor_gate(self.rows_local, k_scan,
                                       self.storage_dim, x.element_size(),
                                       self.quant, fs)
        if ok:
            sub_extras = dict(extras)
            if self.has_norms:
                sub_extras["row_bias"] = extras["row_bias"][:n_sample]
            sub = cuda_topk.sampled_submax(
                x[:n_sample], aux[:n_sample], valid[:n_sample], q_scan,
                metric=metric, block_rows=blk, **sub_extras)
            theta0 = floor_threshold(sub, k_scan, q_scan, aux, valid,
                                     metric=metric, quant=self.quant,
                                     dim=self.storage_dim, fs=fs)
        return cuda_topk.fused_topk(
            x, aux, valid, q_scan, k=k_scan, metric=metric, theta0=theta0,
            index_offset=self._local[j] * self.rows_local, **extras)

    def _plain_scan(self, j, q_scan, valid, k_scan, precision):
        """Candidate top-k_scan by the plain blockwise scan on shard ``j``
        of this process, the JAX engine's ``impl="scan"``."""
        block = _pick_block_rows(self.rows_local, self.cfg.segment_rows)
        return D.blockwise_topk(
            self._x[j], self._aux[j], valid, q_scan, k=k_scan,
            metric=self.cfg.metric, precision=D.PRECISIONS[precision],
            block_rows=block, nblocks=self.rows_local // block,
            index_offset=self._local[j] * self.rows_local,
            packed=self.packed)

    def _merge(self, parts, k_scan):
        """The shards' candidates (this process's ``parts``, each (B,
        k_scan) on its shard's device) merged into the top-k_scan over all
        shards, on ``device``; all-gathered first on a process-spanning
        mesh (``shards * B * k_scan * 8`` bytes)."""
        if not self.multiprocess:
            vals = torch.cat([v.to(self.device) for v, _ in parts], dim=1)
            idx = torch.cat([i.to(self.device) for _, i in parts], dim=1)
            return merge_shards(vals, idx, k_scan)
        b = parts[0][0].shape[0]
        most = max(len(self.mesh.shards_of(r))
                   for r in set(self.mesh.process_indices))
        pad = torch.cat([
            torch.full((b, k_scan), D.NEG_INF, device=self.device).view(
                torch.int32),
            torch.full((b, k_scan), -1, dtype=torch.int32,
                       device=self.device)], dim=1)
        mine = [torch.cat([v.to(self.device).view(torch.int32),
                           i.to(self.device)], dim=1) for v, i in parts]
        mine += [pad] * (most - len(mine))
        every = distributed.all_gather(torch.stack(mine))
        cand = torch.cat([
            every[r, self.mesh.shards_of(r).index(s)]
            for s, r in enumerate(self.mesh.process_indices)], dim=1)
        cand = cand.view(b, self.shards, 2, k_scan)
        vals = cand[:, :, 0].reshape(b, -1).view(torch.float32)
        idx = cand[:, :, 1].reshape(b, -1)
        return merge_shards(vals, idx, k_scan)

    def _rescore(self, qp, idx, valid, k_out):
        """Exact rescore of the merged candidates ``idx``: each row read on
        the shard that holds it; on a process-spanning mesh each rank
        scores the rows it holds and a max over the ranks combines them."""
        metric = self.cfg.metric
        b, kp = idx.shape
        flat = idx.clamp(min=0).long().reshape(-1)
        shard = flat // self.rows_local
        rows = self._zeros(b * kp, self.dtype, self.device,
                           self.storage_dim)
        aux = self._zeros(b * kp, torch.float32, self.device)
        ok = self._zeros(b * kp, torch.bool, self.device)
        for j, s in enumerate(self._local):
            mask = shard == s
            loc = torch.where(mask, flat - s * self.rows_local, 0).to(
                self._devs[j])
            rows = torch.where(mask[:, None],
                               self._x[j][loc].to(self.device), rows)
            aux = torch.where(mask, self._aux[j][loc].to(self.device), aux)
            ok = mask & valid[j][loc].to(self.device) | ok
        combine = distributed.all_reduce_max if self.multiprocess else None
        return D.rescore_rows(rows.view(b, kp, -1), aux.view(b, kp),
                              ok.view(b, kp), qp, idx, k=k_out,
                              metric=metric, packed=self.packed,
                              combine=combine)

    def search(self, queries, k: int, *, precision=None, impl=None,
               rescore=None, as_numpy=True, margin=None, filter_mask=None):
        """Exact top-k: (values (B, k) f32, slots (B, k) i32), numpy, or
        tensors on the engine's device with ``as_numpy=False``. The
        options are the JAX engine's (engine.py:738-860):

        - ``queries``: numpy, or a torch tensor (taken on the device with
          no host round trip), (B, dim) or (dim,);
        - ``impl``: "pallas" (the default, the JAX name kept) runs the
          hand-written kernels, K3 then K1, on each shard; any other name
          runs the plain blockwise scan (``D.blockwise_topk``). The JAX
          engine's own small-batch route to its scan is not taken
          (ROADMAP);
        - ``precision``: "fast" (the default), "high" or "exact". The
          kernels score int8/int4 rows exactly at each, and bfloat16 rows
          from the query cast to bfloat16 at each, as the JAX Pallas
          kernels do; float32 rows in TF32 at "fast" and in three TF32
          products at "high" and "exact" (the Pallas kernels' HIGHEST,
          ``cuda_topk``'s f32x3 leg). The scan runs in float32 with TF32
          off;
        - ``rescore=False`` returns the merged scan's own top-k, finalized;
        - ``margin`` overrides the candidate margin (0 without the
          rescore);
        - ``filter_mask`` (bool (capacity,), from
          ``filter_mask_from_slots``) restricts the scan to ``valid &
          filter``.

        The sampled floor follows ``FloorSettings.from_env()``, read at
        every call. On a process-spanning mesh every rank calls it with
        the same queries and gets the same answer."""
        precision = precision or "fast"
        impl = impl or "pallas"
        rescore = True if rescore is None else bool(rescore)
        if precision not in D.PRECISIONS:
            raise ValueError(f"Unknown precision {precision!r}: expected "
                             f"{'|'.join(D.PRECISIONS)}")
        if isinstance(queries, torch.Tensor):
            q = queries.to(self.device, torch.float32)
            if q.ndim == 1:
                q = q[None, :]
        else:
            q = to_tensor(np.atleast_2d(np.asarray(queries, np.float32)),
                          self.device)
        B, dim = q.shape
        if dim != self.cfg.dim:
            raise ValueError(
                f"Query dim {dim} != collection dim {self.cfg.dim}")
        if k < 1:
            raise ValueError("k must be >= 1")
        fs = FloorSettings.from_env()
        k = min(k, MAX_K, self.capacity)
        Bp = _bucket(B, BATCH_BUCKETS)
        k_out, k_scan = self.scan_widths(k, margin, rescore)
        if Bp != B:
            q = torch.cat([q, q.new_zeros((Bp - B, dim))])
        valid = self._valid
        if filter_mask is not None:
            rl = self.rows_local
            valid = [v & filter_mask[s * rl:(s + 1) * rl].to(v.device)
                     for v, s in zip(self._valid, self._local)]
        metric = self.cfg.metric
        qp = D.prepare_queries(q, metric=metric)
        parts = []
        if impl == "pallas":
            q_scan, extras = self._query_inputs(q, qp, precision)
            for j, dev in enumerate(self._devs):
                ex = {n: v.to(dev) if isinstance(v, torch.Tensor) else v
                      for n, v in extras.items()}
                if self.has_norms:
                    ex["row_bias"] = -self._norms[j]
                parts.append(self._scan(j, q_scan.to(dev), ex, valid[j],
                                        k_scan, fs))
        else:
            # int8/int4 cosine/dot rows score an int8-quantized query
            # unless ``precision`` is "exact"; l2 and float rows score the
            # float32 query (bf16 rows from the query cast to bf16 unless
            # "exact"), with no TF32.
            q_scan = qp
            if self.quant and metric != "l2" and precision != "exact":
                q_scan = D.prepare_queries(q, metric=metric, quantize=True)
            for j, dev in enumerate(self._devs):
                parts.append(self._plain_scan(j, q_scan.to(dev), valid[j],
                                              k_scan, precision))
        vals, idx = self._merge(parts, k_scan)
        if rescore:
            vals, idx = self._rescore(qp, idx, valid, k_out)
        else:
            vals, idx = vals[:, :k_out], idx[:, :k_out]
        vals = D.finalize_scores(vals, q, metric=metric)
        vals, idx = vals[:B, :k], idx[:B, :k]
        if not as_numpy:
            return vals, idx
        return to_numpy(vals), to_numpy(idx)
