"""Recovery-shape sweep: the cheapest zero-spill recovery configuration at
scale (counterpart: ``rag_on_edge_tpu/harness/recover_sweep.py``).

The auto policy reuses the search's qcap as ``recover_qcap`` and sizes the
passes to reach the estimated hottest-cluster load, but each pass
re-inverts the unplaced pairs and re-runs the grouped kernel (K4), so
fewer passes with a bigger tranche may reach the same capacity cheaper.
This sweep measures (recall@10, recall@1, QPS, residual spill) over
recover_qcap × recover_passes × recover_blocks at fixed nprobe, beside the
recovery-off and auto-default rows as anchors, so the frontier can be
stated and ``_auto_recover_passes`` recalibrated.

Usage (the cached index of the dataset):
    python -m rag_on_edge_tpu_torch.harness.recover_sweep --nprobe 8 16 \
        --recover-qcap 256 384 --recover-passes 1 2 3 [--json]

Reference analog: the reference has no routing capacity (its CSR scan
visits every assigned row, ``IVFIndex.cpp:675-686``); this frontier belongs
to the routed design and is measured, not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from rag_on_edge_tpu_torch.harness.bench_ivf import build_or_load_index
from rag_on_edge_tpu_torch.harness.recover_lab import _sweep_point
from rag_on_edge_tpu_torch.utils.cache import enable_compilation_cache
from rag_on_edge_tpu_torch.utils.datasets import load_dataset

__all__ = ["main"]


def _measure(idx, ds, batch: int, k: int, nprobe: int, kw: dict, repeats: int = 3):
    """(recall@10, recall@1, qps, spill_pairs_total, spill_max_batch) of
    ``search_device(..., mode="cluster", **kw)`` over ALL queries."""
    r10, r1, qps, spills = _sweep_point(idx, ds, batch, k, nprobe, dict(mode="cluster", **kw),
                                        repeats)
    return round(r10, 4), round(r1, 4), round(qps, 1), sum(spills), max(spills)


def main(argv=None) -> None:
    enable_compilation_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="sift10m")
    p.add_argument("--nlist", type=int, default=8192)
    p.add_argument("--spill-eps", type=float, default=0.1)
    p.add_argument("--pad-block", type=int, default=2048)
    p.add_argument("--store", default="compact")
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--nprobe", type=int, nargs="+", default=[8, 16])
    p.add_argument("--recover-qcap", type=int, nargs="+", default=[256, 384])
    p.add_argument("--recover-passes", type=int, nargs="+", default=[1, 2, 3])
    p.add_argument("--recover-blocks", type=int, nargs="+", default=[0],
                   help="0 = default (nblocks/4)")
    p.add_argument("--outdir", default="results")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    ds = load_dataset(args.dataset, gt_k=max(args.k, 10), device=args.device)
    idx = build_or_load_index(ds, nlist=args.nlist, metric="l2", dtype="int8",
                              pad_block=args.pad_block, store=args.store,
                              spill_eps=args.spill_eps, device=args.device)

    rows = []

    def emit(row: dict) -> None:
        rows.append(row)
        line = (f"np={row['nprobe']:<3} {row['config']:<22} "
                f"r@10={row['recall']:<7.4f} r@1={row['recall_at_1']:<7.4f} "
                f"QPS={row['qps']:>9,.0f} spill(max/batch)={row['spill_max']}")
        print(json.dumps(row) if args.json else line, flush=True)

    for nprobe in args.nprobe:
        # Anchor 1: recovery off (the raw qcap-spill price).
        r10, r1, qps, sp, spm = _measure(idx, ds, args.batch, args.k, nprobe,
                                         {"recover": False})
        emit({"nprobe": nprobe, "config": "off", "recall": r10,
              "recall_at_1": r1, "qps": qps, "spill_total": sp,
              "spill_max": spm})
        # Anchor 2: the auto defaults (what search_device picks today).
        r10, r1, qps, sp, spm = _measure(idx, ds, args.batch, args.k, nprobe, {})
        auto_rp = idx._auto_recover_passes(args.batch, nprobe,
                                           idx._auto_qcap(args.batch, nprobe))
        emit({"nprobe": nprobe, "config": f"auto(rq=qcap,rp={auto_rp})",
              "recall": r10, "recall_at_1": r1, "qps": qps,
              "spill_total": sp, "spill_max": spm})
        for rq in args.recover_qcap:
            for rp in args.recover_passes:
                for rb in args.recover_blocks:
                    kw = {"recover": True, "recover_qcap": rq,
                          "recover_passes": rp}
                    if rb:
                        kw["recover_blocks"] = rb
                    r10, r1, qps, sp, spm = _measure(
                        idx, ds, args.batch, args.k, nprobe, kw)
                    emit({"nprobe": nprobe,
                          "config": f"rq={rq},rp={rp},rb={rb or 'def'}",
                          "recall": r10, "recall_at_1": r1, "qps": qps,
                          "spill_total": sp, "spill_max": spm})

    if args.outdir:
        os.makedirs(args.outdir, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        path = os.path.join(
            args.outdir,
            f"recover_sweep_{args.dataset}_nlist{args.nlist}_{stamp}.json")
        with open(path, "w") as f:
            json.dump({"config": vars(args), "rows": rows}, f, indent=1)
        print(f"[recover_sweep] artifact: {path}", flush=True)


if __name__ == "__main__":
    main()
