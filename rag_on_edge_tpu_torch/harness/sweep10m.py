"""Recall-frontier sweep: spill_eps × nprobe on one card (counterpart:
``rag_on_edge_tpu/harness/sweep10m.py``).

At 10M rows the recall ceiling is coarse-probe misses: at nprobe 4-8 a near
neighbour just across a Voronoi boundary from the probed cells is
unreachable at any rescore depth.  Two levers target it: probing more cells
(nprobe: scan mass per query) and storing boundary vectors twice
(spill_eps: scan mass per index row, amortized over every query).  This
harness measures the whole frontier in one run, through ``bench_ivf.run``
on the compact store.

Every index shares one trained coarse quantizer (``build_or_load_index``
caches the centroids per dataset configuration), so a spill_eps point costs
one two-nearest assignment and a layout, not a k-means.

Usage:
    python -m rag_on_edge_tpu_torch.harness.sweep10m \
        [--dataset sift10m] [--spill-eps 0 0.1 0.2] [--nprobe 4 8] [--batch 8192] [--json]
"""

from __future__ import annotations

import argparse
import json

from rag_on_edge_tpu_torch.harness.bench_ivf import run
from rag_on_edge_tpu_torch.utils.cache import enable_compilation_cache

__all__ = ["main"]


def main(argv=None) -> None:
    enable_compilation_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="sift10m")
    p.add_argument("--spill-eps", type=float, nargs="+", default=[0.0, 0.1, 0.2])
    p.add_argument("--nprobe", type=int, nargs="+", default=[4, 8])
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--nlist", type=int, default=2048)
    p.add_argument("--pad-block", type=int, default=2048)
    p.add_argument("--outdir", default="results")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    all_rows = []
    for eps in args.spill_eps:
        rows = run(
            dataset=args.dataset, nlist=args.nlist,
            nprobes=tuple(args.nprobe), k=args.k, batch=args.batch,
            dtype="int8", metric="l2", mode="cluster",
            outdir=args.outdir, quiet=args.json,
            pad_block=args.pad_block, store="compact", spill_eps=eps,
            vs_brute=False, device=args.device,
        )
        for r in rows:
            r["spill_eps"] = eps
        all_rows.extend(rows)
        if not args.json:
            print(f"--- spill_eps={eps} done ---", flush=True)

    # Frontier summary: per (nprobe, eps) — recall@10 / recall@1 / QPS.
    if args.json:
        for r in all_rows:
            print(json.dumps({**r, "latency": r["latency"].__dict__}))
    else:
        print(f"\n{'eps':>5} {'np':>3} {'recall@10':>10} {'recall@1':>9} "
              f"{'QPS':>10} {'rows':>12} engine")
        for r in all_rows:
            print(f"{r['spill_eps']:>5g} {r['nprobe']:>3} "
                  f"{r['recall']:>10.4f} {r['recall_at_1']:>9.4f} "
                  f"{r['qps']:>10,.0f} {r.get('n_rows', ''):>12} "
                  f"{r.get('engine', '')}")


if __name__ == "__main__":
    main()
