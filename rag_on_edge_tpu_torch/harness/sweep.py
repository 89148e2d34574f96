"""Configuration sweep harness (counterpart: ``rag_on_edge_tpu/harness/sweep.py``).

The rebuild of the reference's L5 orchestration (``scripts/run_all.sh`` —
dataset × batch-size sweep — and ``scripts/run_all_ivf.sh`` — nprobe sweep):
one process drives every configuration through ``bench_bruteforce.run`` /
``bench_ivf.run`` and aggregates the same CSV schemas into a timestamped
directory (``run_all.sh:53-57``).

Usage:
    python -m rag_on_edge_tpu_torch.harness.sweep brute --dataset siftsmall \
        --batches 1 8 16 32 64
    python -m rag_on_edge_tpu_torch.harness.sweep ivf --dataset siftsmall \
        --nprobe 8 16 32 64
"""

from __future__ import annotations

import argparse
import datetime
import os

import torch

from rag_on_edge_tpu_torch.harness import bench_bruteforce, bench_ivf
from rag_on_edge_tpu_torch.utils.cache import enable_compilation_cache

__all__ = ["sweep_bruteforce", "recall_target_summary", "sweep_ivf", "main"]


def _stamped(outdir: str, prefix: str) -> str:
    ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    return os.path.join(outdir, f"{prefix}_{ts}")


def sweep_bruteforce(
    dataset: str = "siftsmall",
    batches: tuple[int, ...] = (1, 8, 16, 32, 64),
    k: int = 5,
    dtype: str = "int8",
    outdir: str = "results",
    device: str | torch.device = "cuda",
) -> list[dict]:
    """Batch-size sweep (the reference's {1,8,16,32,64}, ``run_all.sh:22``)."""
    out = _stamped(outdir, f"sweep_brute_{dataset}")
    return [
        bench_bruteforce.run(dataset=dataset, batch=b, k=k, dtype=dtype, outdir=out,
                             device=device)
        for b in batches
    ]


def recall_target_summary(rows: list[dict], targets=(0.95, 0.90, 0.80)) -> list[str]:
    """Best (fastest) configuration meeting each recall target — the
    reference study's closing table (``benchmark_ivf.py:259-295``)."""
    lines = []
    for t in targets:
        ok = [r for r in rows if r["recall"] >= t]
        if ok:
            best = max(ok, key=lambda r: r["qps"])
            lines.append(
                f"recall>={t:.0%}: nprobe={best['nprobe']} -> "
                f"{best['qps']:,.0f} QPS at recall@{best['k']}={best['recall']:.4f}"
            )
        else:
            lines.append(f"recall>={t:.0%}: no configuration reached the target")
    return lines


def sweep_ivf(
    dataset: str = "siftsmall",
    nprobes: tuple[int, ...] = (8, 16, 32, 64),
    k: int = 10,
    batch: int = 32,
    nlist: int | None = None,
    dtype: str = "fp32",
    metric: str = "ip",
    mode: str = "auto",
    outdir: str = "results",
    pad_block: int | None = None,
    recover: bool | None = None,
    store: str = "padded",
    spill_eps: float = 0.0,
    sharded: bool = False,
    device: str | torch.device = "cuda",
) -> list[dict]:
    """nprobe sweep (the reference's {8,16,32,64} with top_k=10,
    ``run_all_ivf.sh:26-27``) plus the recall-target summary of the
    reference's host-side study (``benchmark_ivf.py:259-295``)."""
    out = _stamped(outdir, f"sweep_ivf_{dataset}")
    rows = bench_ivf.run(
        dataset=dataset, nprobes=tuple(nprobes), k=k, batch=batch,
        nlist=nlist, dtype=dtype, metric=metric, mode=mode, outdir=out,
        pad_block=pad_block, recover=recover, store=store,
        spill_eps=spill_eps, sharded=sharded, device=device,
    )
    for line in recall_target_summary(rows):
        print(line)
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    pb = sub.add_parser("brute")
    pb.add_argument("--dataset", default="siftsmall")
    pb.add_argument("--batches", type=int, nargs="+", default=[1, 8, 16, 32, 64])
    pb.add_argument("--k", type=int, default=5)
    pb.add_argument("--dtype", default="int8")
    pb.add_argument("--outdir", default="results")
    pb.add_argument("--device", default="cuda")
    pi = sub.add_parser("ivf")
    pi.add_argument("--dataset", default="siftsmall")
    pi.add_argument("--nprobe", type=int, nargs="+", default=[8, 16, 32, 64])
    pi.add_argument("--k", type=int, default=10)
    pi.add_argument("--batch", type=int, default=32)
    pi.add_argument("--nlist", type=int, default=None)
    pi.add_argument("--dtype", default="fp32")
    pi.add_argument("--metric", default="ip", choices=["ip", "l2"])
    pi.add_argument("--mode", default="auto", choices=["auto", "query", "cluster"])
    pi.add_argument("--pad-block", type=int, default=None)
    pi.add_argument("--recover", action=argparse.BooleanOptionalAction, default=None,
                    help="spilled-pair recovery pass (default: the index's auto policy)")
    pi.add_argument("--store", default="padded", choices=["padded", "compact"],
                    help="device storage: compact keeps no fp32 copy beside the slabs "
                         "(cluster mode only)")
    pi.add_argument("--spill-eps", type=float, default=0.0,
                    help="redundant-assignment spill: duplicate boundary "
                         "vectors (d2 <= (1+eps)*d1) into their 2nd cluster "
                         "(recall lever at fixed nprobe)")
    pi.add_argument("--sharded", action="store_true",
                    help="run through ShardedIVFIndex over every device of --device's type")
    pi.add_argument("--outdir", default="results")
    pi.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    enable_compilation_cache()
    if args.cmd == "brute":
        sweep_bruteforce(args.dataset, tuple(args.batches), args.k, args.dtype, args.outdir,
                         args.device)
    else:
        sweep_ivf(args.dataset, tuple(args.nprobe), args.k, args.batch, args.nlist,
                  args.dtype, args.metric, args.mode, args.outdir, args.pad_block,
                  args.recover, args.store, args.spill_eps, args.sharded, args.device)


if __name__ == "__main__":
    main()
