"""Skew calibration: the measured hottest-cluster load against the
``_est_max_load`` estimate, per nlist (counterpart:
``rag_on_edge_tpu/harness/qcap_calib.py``).

``IVFIndex._est_max_load`` drives the recovery defaults from the index's
probe-skew table (a clipped-linear skew term where it has none).  This
harness measures the truth, :meth:`IVFIndex.required_qcap` (the exact
hottest-cluster load of the probe map), on real query batches at any
nlist, so new calibration points pin or correct the estimate.  One coarse
pass and a host sync per (nlist, nprobe).

Usage:
    python -m rag_on_edge_tpu_torch.harness.qcap_calib --dataset sift \
        --nlist 4096 --nprobe 4 8 16 [--batch 8192]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from rag_on_edge_tpu_torch.harness.bench_ivf import build_or_load_index
from rag_on_edge_tpu_torch.utils.cache import enable_compilation_cache
from rag_on_edge_tpu_torch.utils.datasets import load_dataset

__all__ = ["main"]


def main(argv=None) -> None:
    enable_compilation_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="sift")
    p.add_argument("--nlist", type=int, default=4096)
    p.add_argument("--nprobe", type=int, nargs="+", default=[4, 8, 16])
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--pad-block", type=int, default=2048)
    # The measured load depends only on the coarse quantizer, but the cache
    # name carries the fine store's settings: these pick whichever variant
    # is already on disk.
    p.add_argument("--spill-eps", type=float, default=None,
                   help="default: 0.1 for >=5M-row datasets (the cached "
                        "flagship variant), else 0")
    p.add_argument("--store", default=None,
                   help="default: compact for >=5M-row datasets")
    p.add_argument("--outdir", default="results")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    ds = load_dataset(args.dataset, gt_k=10, device=args.device)
    big = ds.base.shape[0] >= 5_000_000
    spill_eps = args.spill_eps if args.spill_eps is not None else (
        0.1 if big else 0.0)
    store = args.store or ("compact" if big else "padded")
    idx = build_or_load_index(ds, nlist=args.nlist, metric="l2", dtype="int8",
                              pad_block=args.pad_block, store=store,
                              spill_eps=spill_eps, device=args.device)

    rows = []
    for nprobe in args.nprobe:
        # The exact max load over the query batch (multiple=1: the raw max,
        # not the qcap rounding).
        need = idx.required_qcap(
            np.resize(ds.queries, (args.batch, ds.queries.shape[1])),
            nprobe, multiple=1)
        mean = args.batch * min(nprobe, idx.nlist) / idx.nlist
        est = idx._est_max_load(args.batch, nprobe)
        row = {
            "dataset": args.dataset, "nlist": idx.nlist, "batch": args.batch,
            "nprobe": nprobe, "measured_max_load": int(need),
            "mean_load": round(mean, 1),
            "max_over_mean": round(need / mean, 1),
            "est_max_load": round(est, 1),
            "est_over_measured": round(est / need, 2),
        }
        rows.append(row)
        print(json.dumps(row) if args.json else
              f"nlist={row['nlist']} np={nprobe:<3} max_load={need:<5} "
              f"mean={mean:<8.1f} max/mean={row['max_over_mean']:<5} "
              f"est={est:<7.1f} est/measured={row['est_over_measured']}",
              flush=True)

    if args.outdir:
        os.makedirs(args.outdir, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        path = os.path.join(
            args.outdir,
            f"qcap_calib_{args.dataset}_nlist{args.nlist}_{stamp}.json")
        with open(path, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"[qcap_calib] artifact: {path}", flush=True)


if __name__ == "__main__":
    main()
