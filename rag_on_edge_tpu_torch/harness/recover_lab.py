"""Recovery-shape lab: the price of zero spill (counterpart:
``rag_on_edge_tpu/harness/recover_lab.py``).

The auto recovery defaults buy zero lossy spill at a throughput cost: each
recovery pass re-inverts the still-unplaced pairs and runs the grouped
kernel (K4) over ``recover_blocks`` gathered blocks, a tranche sized for
the worst case, while the measured skew says spill concentrates in a few
hot cells.  This lab sweeps the pass shape (recover_qcap × recover_blocks
× recover_passes) at fixed (nlist, nprobe) and reports recall, residual
lossy spill and sustained QPS per shape, so the defaults can charge only
for the capacity the measured skew needs.

Reference analog: none; the reference's IVF drops nothing because it
gathers exact per-cluster candidate lists on the host
(``main_ivf.cpp:212-273``).  Zero-spill pricing belongs to the routed,
capacity-bounded design.

Usage (the cached index of the dataset):
    python -m rag_on_edge_tpu_torch.harness.recover_lab --dataset sift10m \
        --nlist 8192 --nprobe 8 --shapes auto off 128x256x1 128x512x1 \
        256x256x1 --json
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from rag_on_edge_tpu_torch.harness import timing
from rag_on_edge_tpu_torch.harness.bench_ivf import build_or_load_index
from rag_on_edge_tpu_torch.utils.cache import enable_compilation_cache
from rag_on_edge_tpu_torch.utils.datasets import load_dataset
from rag_on_edge_tpu_torch.utils.metrics import recall_at_k

__all__ = ["measure", "main"]


def _sweep_point(idx, ds, batch: int, k: int, nprobe: int, kw: dict, repeats: int = 3):
    """``search_device(q, k, nprobe, **kw)`` over ALL queries, in batches
    padded cyclically at the tail → (recall@k, recall@1, QPS of the
    distinct-input protocol, the residual spill of each batch)."""
    f = lambda x: idx.search_device(x, k, nprobe, **kw)  # noqa: E731
    dim = ds.queries.shape[1]
    nq = ds.queries.shape[0]
    ids_parts, spills = [], []
    for s in range(0, nq, batch):
        chunk = ds.queries[s:s + batch]
        qs = np.resize(chunk, (batch, dim)).astype(np.float32)
        out = f(torch.from_numpy(qs).to(idx.device))
        ids_parts.append(out[1].cpu().numpy()[: chunk.shape[0]])
        spills.append(int(idx.last_spill))
    ids = np.concatenate(ids_parts)
    gt = ds.ground_truth_l2
    r10 = float(recall_at_k(ids, gt[:nq], k))
    r1 = float(recall_at_k(ids[:, :1], gt[:nq, :1], 1))
    qs = torch.from_numpy(np.resize(ds.queries, (batch, dim)).astype(np.float32)).to(idx.device)
    batches = timing.unique_variants([qs], copies=4)
    qps = timing.measure_throughput(f, batches, repeats=repeats)
    return r10, r1, qps, spills


def measure(idx, ds, batch: int, k: int, nprobe: int, shape: str) -> dict:
    """One shape → dict(recall@10, recall@1, spill/batch, qps).

    shape: "off" (recover=False), "auto" (library defaults), or
    "RQxRBxRP" (explicit recover_qcap x recover_blocks x passes).
    Recall over ALL query rows; throughput by the distinct-input protocol
    (``harness/timing.py``).
    """
    kw = dict(mode="cluster")
    if shape == "off":
        kw["recover"] = False
    elif shape != "auto":
        rq, rb, rp = (int(x) for x in shape.split("x"))
        kw.update(recover=True, recover_qcap=rq, recover_blocks=rb,
                  recover_passes=rp)
    r10, r1, qps, spills = _sweep_point(idx, ds, batch, k, nprobe, kw)
    return {
        "shape": shape, "nprobe": nprobe, "batch": batch,
        "recall_at_10": round(r10, 4),
        "recall_at_1": round(r1, 4),
        "lossy_spill_per_batch": max(spills),
        "qps": round(qps, 1),
        "engine": idx.last_engine,
    }


def main(argv=None) -> None:
    enable_compilation_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="sift10m")
    p.add_argument("--nlist", type=int, default=8192)
    p.add_argument("--pad-block", type=int, default=2048)
    p.add_argument("--spill-eps", type=float, default=0.1)
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--nprobe", type=int, nargs="+", default=[8])
    p.add_argument("--shapes", nargs="+",
                   default=["off", "auto", "128x256x1", "128x512x1",
                            "256x256x1"])
    p.add_argument("--outdir", default="results")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    ds = load_dataset(args.dataset, gt_k=max(args.k, 10), device=args.device)
    idx = build_or_load_index(
        ds, nlist=args.nlist, metric="l2", dtype="int8",
        pad_block=args.pad_block, store="compact", spill_eps=args.spill_eps,
        device=args.device)

    rows = []
    for nprobe in args.nprobe:
        est = idx._est_max_load(args.batch, nprobe)
        qcap = idx._auto_qcap(args.batch, nprobe)
        print(f"# nprobe={nprobe}: est hottest-cell load "
              f"{est:.0f}, qcap {qcap}", flush=True)
        for shape in args.shapes:
            t0 = time.perf_counter()
            r = measure(idx, ds, args.batch, args.k, nprobe, shape)
            r["wall_s"] = round(time.perf_counter() - t0, 1)
            rows.append(r)
            print(json.dumps(r) if args.json else
                  f"  {shape:>12}: recall@10 {r['recall_at_10']:.4f} "
                  f"spill {r['lossy_spill_per_batch']:>6} "
                  f"QPS {r['qps']:>10,.0f}", flush=True)

    os.makedirs(args.outdir, exist_ok=True)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    path = os.path.join(
        args.outdir,
        f"recover_lab_{args.dataset}_nlist{args.nlist}_{stamp}.json")
    with open(path, "w") as f:
        json.dump({"config": vars(args), "rows": rows}, f, indent=1)
    print(f"# artifact: {path}", flush=True)


if __name__ == "__main__":
    main()
