#!/usr/bin/env python3
"""Where X2's count (``cuda_extract.kexp2_call(..., count=True)``) differs
from its closed form on float rows: the kernel's per-block carry counts
against the plain version's, and at each (block, query) that differs the
plain k-th and (k+1)-th scores of the rows so far beside the query's score
bound (``cuda_topk.score_error_bound``). A difference whose two scores lie
within the bound is a near-tie that the kernel's summation order ranks the
other way, not a fault of the count.

    python3 tools/kexp_count_diff.py [--seed 14] [--rows 1000000]
        [--capacity 1048576] [--metric dot] [--precision exact] [--k 108]
        [--block-rows 2048]

The rows are ``chip_smoke.py``'s Database phases' (seeded numpy: its
SEARCHES query batches first, then the rows in 65,536-row chunks, float32,
stored as ingested, the capacity's tail dead), so ``--seed 14`` is phase
(iv)'s; the query is its first batch. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=14)
    p.add_argument("--rows", type=int, default=1_000_000)
    p.add_argument("--capacity", type=int, default=1 << 20)
    p.add_argument("--metric", default="dot")
    p.add_argument("--precision", default="exact")
    p.add_argument("--k", type=int, default=108)
    p.add_argument("--block-rows", type=int, default=2048)
    args = p.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kexp_count_diff: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as S
    import kexp_extract as ke
    from vrod_tpu_torch.ops import cuda_extract as X
    from vrod_tpu_torch.ops import cuda_topk as K
    from vrod_tpu_torch.ops import distances as D
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(S.card_line(), flush=True)
    rng = np.random.default_rng(args.seed)
    queries = [rng.standard_normal((S.BATCH, S.DIM), dtype=np.float32)
               for _ in range(S.SEARCHES)]
    x = torch.zeros((args.capacity, S.DIM), dtype=torch.float32, device=dev)
    for lo in range(0, args.rows, S.INGEST_CHUNK):
        n = min(S.INGEST_CHUNK, args.rows - lo)
        x[lo:lo + n] = torch.from_numpy(rng.standard_normal(
            (n, S.DIM), dtype=np.float32)).to(dev)
    x, aux = D.prepare_rows(x, metric=args.metric, dtype=torch.float32)
    valid = torch.zeros(args.capacity, dtype=torch.bool, device=dev)
    valid[:args.rows] = True
    q = D.prepare_queries(torch.from_numpy(queries[0]).to(dev),
                          metric=args.metric)
    xa = ke.experiment_args([x, aux, valid, q])
    k, blk = args.k, args.block_rows
    kw = dict(k=k, metric=args.metric, block_rows=blk,
              precision_name=args.precision)
    for tiles in (1, 2, 4):
        got = X.kexp2_call(*xa, tiles=tiles, count=True, **kw)[2]
        want = X.kexp2_plain(*xa, tiles=tiles, count=True, **kw)[2]
        print(f"tiles {tiles}: kernel {int(got[0])}, closed form "
              f"{int(want[0])}", flush=True)
    call = X._XCall(*xa, **kw)
    per_block = X._launch("carry", call, count=True)[2].cpu()
    bound = K.score_error_bound(x, aux, valid, q, metric=args.metric,
                                precision=args.precision).cpu()
    b = q.shape[0]
    vals = torch.full((b, k + 1), float("-inf"), device=dev)
    idx = torch.full((b, k + 1), -1, dtype=torch.int32, device=dev)
    diffs = near = 0
    for j in range(call.nblocks):
        lo, hi = j * blk, (j + 1) * blk
        ids = torch.arange(lo, hi, dtype=torch.int32, device=dev)
        vals, idx = D.merge_topk(vals, idx, call.scores(lo, hi),
                                 ids.expand(b, -1), k + 1)
        mine = ((vals[:, :k] > float("-inf")) & (idx[:, :k] >= lo)
                & (idx[:, :k] < hi)).sum(dim=1).cpu()
        for qq in (per_block[j] != mine).nonzero().flatten().tolist():
            v = vals[qq].cpu()
            gap = float(v[k - 1] - v[k])
            diffs += 1
            near += gap <= 2 * float(bound[qq, 0])
            print(f"block {j} query {qq}: kernel {int(per_block[j, qq])}, "
                  f"plain {int(mine[qq])}; plain k-th {float(v[k - 1])!r}, "
                  f"(k+1)-th {float(v[k])!r}, gap {gap:.3g}, bound "
                  f"{float(bound[qq, 0]):.3g}", flush=True)
    print(f"(block, query) pairs that differ: {diffs}, of them near-ties "
          f"(gap within twice the bound): {near}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
