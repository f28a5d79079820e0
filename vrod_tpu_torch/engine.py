"""Device engine of the port: one collection's rows on one device.

The port of ``vrod_tpu.engine`` for one shard. A collection's device state
is three tensors, and a fourth for int8/int4 + l2:

  x     (capacity, dim)  stored dtype — the rows (int4: packed, dim/2 bytes)
  aux   (capacity,) f32  — int8/int4: the per-row dequant scale; float
                           rows: 1/|x| (cosine) or |x|^2 (l2, dot)
  valid (capacity,) bool — live bitmap (free-list holes and deletes False)
  norms (capacity,) f32  — int8/int4 + l2 only: |x_hat|^2 per row
                           (``distances.row_norms2``), K1/K3's -|x_hat|^2
                           mask bias. Derived state: every mutation keeps
                           it, ``load_state`` and ``rebuild_norms``
                           recompute it, and snapshots never hold it.

Capacity grows in whole segments. Where the JAX package rebuilt arrays in
jitted scatters with donated buffers, the port updates these tensors in
place (``index_copy_``, ``index_put_``). A JAX scatter with ``mode="drop"``
ignores indices past the end; the port drops them before scattering.

Search, for every dtype and metric, runs the program of
``vrod_tpu.engine._search_fn`` with the port's kernels: quantize the query
(int8/int4; l2 keeps its scale), the sampled sub-max pre-pass
(``cuda_topk.sampled_submax``) when the floor gate is open, the exact k-th
sub-max by counting (less the accumulation margin for float dot/l2), the
fused scan (``cuda_topk.fused_topk``), then the exact float32 rescore and
``finalize_scores``. On a CUDA device the wrappers launch the CUDA kernels;
on the CPU they run their plain versions.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from .config import CollectionConfig

from .convert import to_numpy, to_tensor
from .ops import cuda_topk
from .ops import distances as D
from .runtime import resolve_device

# Queries pad to these batch sizes and k to these widths, as in the JAX
# engine, so the two return the same candidates.
BATCH_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
K_BUCKETS = (8, 16, 32, 64, 96, 100, 112, 128, 256, 512, 1024)
MAX_K = 1024

# Sampled-floor constants, the JAX engine's defaults (engine.py:106-158 and
# the VROD_THETA0_* defaults at :829-844); their H100 values are not
# measured yet (ROADMAP Queue 1 item 4). The tile budget is the TPU
# pre-pass's (pallas_topk.SUBMAX_VMEM_BYTES): it only shapes which block
# size the gate picks. The floor opens from k_scan THETA0_MINK on int8/int4
# rows and from THETA0_MINK_FLOAT on float rows (engine.py:124).
SUBMAX_TILE_BYTES = 24 * 1024 * 1024
THETA0_FRAC = 8
THETA0_MINK = 24
THETA0_MINK_FLOAT = 64
THETA0_MARGIN = 1e-3


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(math.ceil(n / buckets[-1])) * buckets[-1]


def floor_gate(rows: int, k_scan: int, dim: int, itemsize: int,
               quant: bool) -> tuple[bool, int, int]:
    """(open, n_sample, block rows) of the sampled floor for a scan of
    ``rows`` rows of ``dim`` stored elements of ``itemsize`` bytes at
    ``k_scan``: the arithmetic of the JAX engine's ``_gate_for``/
    ``floor_gate``. The pre-pass block is the largest of 16384/8192 rows
    whose tile stays within SUBMAX_TILE_BYTES; the sample is a prefix of
    whole blocks; the floor is sound only with at least 2 * k_scan
    sub-maxima, and opens from k_scan 24 (int8/int4) or 64 (float)."""
    cands, fallback = [], 8192
    for blk in (16384, 8192):
        while blk * dim * itemsize > SUBMAX_TILE_BYTES and blk > 128:
            blk //= 2
        fallback = blk
        if blk not in cands:
            cands.append(blk)
    frac = THETA0_FRAC if k_scan >= 64 else max(THETA0_FRAC, 32)
    min_k = THETA0_MINK if quant else THETA0_MINK_FLOAT
    for blk in cands:
        n_sample = min(rows, max(128 * k_scan * 2, rows // frac))
        n_sample = (n_sample // blk) * blk
        nsub = (n_sample // blk) * 128
        if (k_scan >= min_k and nsub >= 2 * k_scan
                and rows >= min(frac, 4) * n_sample):
            return True, n_sample, blk
    return False, 0, fallback


def floor_threshold(sub, k_scan, q_scan, aux, valid, *, metric, quant,
                    dim):
    """The sampled floor theta0 (B, 1) from K3's sub-maxima ``sub``: the
    exact k-th sub-max by counting, less its margins. K3 scores with K1's
    own code, so its sub-maxima are K1 scores; float dot/l2 still subtract
    the JAX engine's accumulation margin (:203-206)."""
    extra = None
    if metric != "cosine" and not quant:
        extra = D.accumulation_margin(q_scan, aux, valid, metric=metric,
                                      dim=dim)
    return D.threshold_from_submax(sub, k_scan, margin_abs=THETA0_MARGIN,
                                   extra=extra, method="count")


class DeviceEngine:
    """Owns the device state of one collection (one shard)."""

    # Rows per host->device chunk of a write.
    WRITE_CHUNK_ROWS = 131072

    def __init__(self, cfg: CollectionConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.packed = cfg.dtype == "int4"
        self.quant = cfg.dtype in ("int8", "int4")
        self.dtype = torch.int8 if self.quant else D._as_dtype(cfg.dtype)
        self.has_norms = self.quant and cfg.metric == "l2"
        if cfg.shards > 1:
            warnings.warn(
                f"Collection {cfg.name!r} is configured for {cfg.shards} "
                "shards; the port keeps one shard on one device (row "
                "sharding is ROADMAP Queue 1 item 6)")
        self.shards = 1
        self.storage_dim = cfg.dim // 2 if self.packed else cfg.dim
        self._grow_unit = cfg.segment_rows
        self.capacity = self._grow_unit
        self.x = torch.zeros((self.capacity, self.storage_dim),
                             dtype=self.dtype, device=self.device)
        self.aux = torch.zeros(self.capacity, dtype=torch.float32,
                               device=self.device)
        self.valid = torch.zeros(self.capacity, dtype=torch.bool,
                                 device=self.device)
        self.norms = torch.zeros(self.capacity, dtype=torch.float32,
                                 device=self.device) \
            if self.has_norms else None

    def load_state(self, x, aux, valid) -> None:
        """Install state tensors (``convert.engine_state_from_numpy``);
        the capacity becomes ``x.shape[0]``, and the norms lane is rebuilt
        from x and aux."""
        cap = x.shape[0]
        if x.shape != (cap, self.storage_dim) or x.dtype != self.dtype:
            raise ValueError(f"x is {tuple(x.shape)} {x.dtype}")
        if aux.shape != (cap,) or valid.shape != (cap,):
            raise ValueError("aux and valid must be (capacity,)")
        self.x = x.to(self.device).contiguous()
        self.aux = aux.to(self.device, torch.float32).contiguous()
        self.valid = valid.to(self.device, torch.bool).contiguous()
        self.capacity = cap
        if self.has_norms:
            self.norms = torch.empty_like(self.aux)
            self.rebuild_norms()

    # -- capacity ----------------------------------------------------------

    def ensure_capacity(self, needed_slots: int) -> bool:
        """Grow the tensors so at least ``needed_slots`` exist. True if
        grown."""
        if needed_slots <= self.capacity:
            return False
        new_cap = int(math.ceil(needed_slots / self._grow_unit)) \
            * self._grow_unit
        pad = new_cap - self.capacity
        self.x = torch.cat([self.x, self.x.new_zeros((pad,
                                                      self.storage_dim))])
        self.aux = torch.cat([self.aux, self.aux.new_zeros(pad)])
        self.valid = torch.cat([self.valid, self.valid.new_zeros(pad)])
        if self.has_norms:
            self.norms = torch.cat([self.norms, self.norms.new_zeros(pad)])
        self.capacity = new_cap
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
        self.x = self.x[:new_cap].clone()
        self.aux = self.aux[:new_cap].clone()
        self.valid = self.valid[:new_cap].clone()
        if self.has_norms:
            self.norms = self.norms[:new_cap].clone()
        self.capacity = new_cap
        return True

    # -- mutations ---------------------------------------------------------

    def _kept(self, slots: np.ndarray) -> torch.Tensor:
        """Slots as a device index, without those past the capacity (the
        JAX scatters' ``mode="drop"``)."""
        slots = np.asarray(slots, dtype=np.int64).reshape(-1)
        slots = slots[(slots >= 0) & (slots < self.capacity)]
        return torch.from_numpy(slots).to(self.device)

    def write(self, slots: np.ndarray, vecs: np.ndarray) -> None:
        """Quantize/prepare f32 vectors on the device and scatter them in
        place into ``slots``."""
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
            self._scatter(torch.from_numpy(sl[keep]).to(self.device), rows,
                          auxv)

    def write_raw(self, slots: np.ndarray, rows: np.ndarray,
                  aux: np.ndarray) -> None:
        """Scatter rows already in the stored representation (snapshot
        restore: no requantization)."""
        slots = np.asarray(slots, dtype=np.int64).reshape(-1)
        keep = (slots >= 0) & (slots < self.capacity)
        if not keep.any():
            return
        self._scatter(
            torch.from_numpy(slots[keep]).to(self.device),
            to_tensor(np.asarray(rows)[keep], self.device,
                      self.dtype).to(self.dtype),
            to_tensor(np.asarray(aux, dtype=np.float32)[keep], self.device))

    def _scatter(self, idx, rows, auxv) -> None:
        """Stored rows and aux into slots ``idx`` (all inside capacity),
        their norms too, and mark them live."""
        self.x.index_copy_(0, idx, rows)
        self.aux.index_copy_(0, idx, auxv)
        if self.has_norms:
            self.norms.index_copy_(0, idx, D.row_norms2(rows, auxv,
                                                        self.packed))
        self.valid[idx] = True

    def gather_raw(self, slots: np.ndarray, *, sync: bool = True):
        """(stored rows, aux) at ``slots``: numpy, or with ``sync=False``
        device tensors (copies, so later in-place mutations do not reach
        them)."""
        idx = torch.from_numpy(
            np.asarray(slots, dtype=np.int64).reshape(-1)).to(self.device)
        rows, auxv = self.x[idx], self.aux[idx]
        if not sync:
            return rows, auxv
        return to_numpy(rows), to_numpy(auxv)

    def erase(self, slots: np.ndarray) -> None:
        self.valid[self._kept(slots)] = False

    def rebuild_norms(self) -> None:
        """Recompute the int8/int4 + l2 norms lane from x and aux (after
        they were written directly, or installed by ``load_state``), a
        chunk of rows at a time. No-op for the other legs. Dead slots get
        values that the mask never lets score."""
        if not self.has_norms:
            return
        for lo in range(0, self.capacity, self.WRITE_CHUNK_ROWS):
            hi = lo + self.WRITE_CHUNK_ROWS
            self.norms[lo:hi] = D.row_norms2(self.x[lo:hi], self.aux[lo:hi],
                                             self.packed)

    def move(self, src: np.ndarray, dst: np.ndarray) -> None:
        """Compaction: copy rows src -> dst, then invalidate src."""
        if len(src) == 0:
            return
        src = np.asarray(src, dtype=np.int64).reshape(-1)
        dst = np.asarray(dst, dtype=np.int64).reshape(-1)
        keep = (dst >= 0) & (dst < self.capacity)
        s = torch.from_numpy(src[keep]).to(self.device)
        d = torch.from_numpy(dst[keep]).to(self.device)
        # Indexing copies, so every source is read before any write.
        self.x[d] = self.x[s]
        self.aux[d] = self.aux[s]
        if self.has_norms:
            self.norms[d] = self.norms[s]
        self.valid[d] = self.valid[s]
        self.valid[self._kept(src)] = False

    # -- reads -------------------------------------------------------------

    def filter_mask_from_slots(self, slots: np.ndarray, *,
                               mode: str = "within"):
        """Bool (capacity,) device mask: ``within`` is True only at
        ``slots``, ``exclude`` False only there."""
        if mode not in ("within", "exclude"):
            raise ValueError(f"Unknown filter mode {mode!r}")
        base = mode == "exclude"
        m = torch.full((self.capacity,), base, dtype=torch.bool,
                       device=self.device)
        m[self._kept(slots)] = not base
        return m

    def gather(self, slots: np.ndarray) -> np.ndarray:
        """Rows (f32) for exact-lookup SEARCH (dequantized for int8/int4)."""
        idx = torch.from_numpy(
            np.asarray(slots, dtype=np.int64).reshape(-1)).to(self.device)
        rows = self.x[idx]
        if self.quant:
            rows = D.unpack_int4_rows(rows) if self.packed else rows.float()
            return to_numpy(rows * self.aux[idx][:, None])
        return to_numpy(rows.float())

    def scan_widths(self, k: int) -> tuple[int, int]:
        """(k_out, k_scan) of a search for top-k (k <= MAX_K): k bucketed,
        and that plus the candidate margin, slack for the scan's rank
        jitter that the exact rescore recovers from (JAX engine
        :787-804)."""
        k_out = min(_bucket(k, K_BUCKETS), self.capacity)
        margin = max(self.cfg.rescore_margin,
                     k_out // 8 if k_out > 100 else 0)
        if self.quant:
            margin = max(margin, 12, k_out // 4 if k_out > 100 else 0)
        return k_out, min(k_out + margin, self.capacity)

    def scan_inputs(self, q, qp):
        """(query for K1/K3, their extra keywords) for a padded batch: the
        int8-quantized query for int8/int4 rows (with its scale and the
        -|x_hat|^2 row bias for l2), the prepared float query otherwise."""
        metric = self.cfg.metric
        extras = dict(packed=self.packed)
        if self.has_norms:
            q_scan, qs = D.prepare_queries(q, metric=metric, quantize=True,
                                           return_scale=True)
            extras.update(row_bias=-self.norms, q_scale=qs)
            return q_scan, extras
        if self.quant:
            return D.prepare_queries(q, metric=metric, quantize=True), extras
        return qp, extras

    def _scan(self, q, qp, valid, k_scan):
        """Candidate top-k_scan of the padded query batch: K3 and the floor
        when the gate opens, then K1 (``_search_fn``'s ``local_topk``)."""
        metric = self.cfg.metric
        q_scan, extras = self.scan_inputs(q, qp)
        theta0 = None
        ok, n_sample, blk = floor_gate(self.capacity, k_scan,
                                       self.storage_dim,
                                       self.x.element_size(), self.quant)
        if ok:
            sub_extras = dict(extras)
            if self.has_norms:
                sub_extras["row_bias"] = extras["row_bias"][:n_sample]
            sub = cuda_topk.sampled_submax(
                self.x[:n_sample], self.aux[:n_sample], valid[:n_sample],
                q_scan, metric=metric, block_rows=blk, **sub_extras)
            theta0 = floor_threshold(sub, k_scan, q_scan, self.aux, valid,
                                     metric=metric, quant=self.quant,
                                     dim=self.storage_dim)
        return cuda_topk.fused_topk(self.x, self.aux, valid, q_scan,
                                    k=k_scan, metric=metric, theta0=theta0,
                                    **extras)

    def search(self, queries, k: int, *, filter_mask=None):
        """Exact top-k. Returns numpy (values (B, k) f32, slots (B, k) i32).
        ``filter_mask`` (bool (capacity,), from ``filter_mask_from_slots``)
        restricts the scan to ``valid & filter``."""
        q = to_tensor(np.atleast_2d(np.asarray(queries, np.float32)),
                      self.device)
        B, dim = q.shape
        if dim != self.cfg.dim:
            raise ValueError(
                f"Query dim {dim} != collection dim {self.cfg.dim}")
        if k < 1:
            raise ValueError("k must be >= 1")
        k = min(k, MAX_K, self.capacity)
        Bp = _bucket(B, BATCH_BUCKETS)
        k_out, k_scan = self.scan_widths(k)
        if Bp != B:
            q = torch.cat([q, q.new_zeros((Bp - B, dim))])
        valid = self.valid if filter_mask is None \
            else self.valid & filter_mask
        qp = D.prepare_queries(q, metric=self.cfg.metric)
        _, idx = self._scan(q, qp, valid, k_scan)
        vals, idx = D.rescore(self.x, self.aux, valid, qp, idx, k=k_out,
                              metric=self.cfg.metric, packed=self.packed)
        vals = D.finalize_scores(vals, q, metric=self.cfg.metric)
        return to_numpy(vals[:B, :k]), to_numpy(idx[:B, :k])
