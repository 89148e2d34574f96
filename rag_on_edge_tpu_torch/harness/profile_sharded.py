"""Per-stage breakdown of the SHARDED cluster-major search (counterpart:
``rag_on_edge_tpu/harness/profile_sharded.py``).

Times cumulative prefixes of the sharded call (coarse → invert →
route/gather → kernel → join → rescore → full with the merge) with the
distinct-input protocol of :mod:`rag_on_edge_tpu_torch.harness.timing`; a
stage's cost is the difference between successive prefixes.  The prefixes
are early returns inside the production call
(``ShardedIVFIndex._search_cluster``'s ``stage=``), so every stage runs the
arrays and the shard loop the full call runs: the replicated route on the
first device, then each shard's scan, join and rescore in turn.

Single-device analog: :mod:`rag_on_edge_tpu_torch.harness.profile_ivf`.

Usage (a mesh of every visible card):
    python -m rag_on_edge_tpu_torch.harness.profile_sharded --dataset sift \
        --dtype int8 --batch 8192 --nprobe 4 --pad-block 2048
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from rag_on_edge_tpu_torch.harness import timing
from rag_on_edge_tpu_torch.harness.bench_ivf import build_or_load_index
from rag_on_edge_tpu_torch.parallel.mesh import make_mesh
from rag_on_edge_tpu_torch.parallel.sharded import ShardedIVFIndex
from rag_on_edge_tpu_torch.utils.cache import enable_compilation_cache
from rag_on_edge_tpu_torch.utils.datasets import load_dataset

__all__ = ["STAGES", "profile", "main"]

STAGES = ("coarse", "invert", "route", "kernel", "join", "rescore", "full")


def profile(sidx: ShardedIVFIndex, queries: np.ndarray, k: int, nprobe: int,
            engine: str = "auto", repeats: int = 6):
    """Cumulative-prefix timing rows [(stage, cum_ms, delta_ms)] for the
    sharded cluster-mode call, with no recovery pass (as the JAX profiler
    runs it)."""
    sidx._ensure_cluster_state()
    if engine == "auto":
        engine = "pallas_accum" if sidx._cm_accum_ok else "pallas"
    b = queries.shape[0]
    qcap = sidx._auto_qcap(b, nprobe)
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(sidx.devices[0])

    def call(stage):
        return lambda x: sidx._search_cluster(x, k, nprobe, qcap, 0, 0, 1, engine, stage)

    rows, prev = [], 0.0
    for stage in STAGES:
        qps = timing.measure_throughput(call(stage), [q], repeats=repeats)
        ms = b / qps * 1e3
        rows.append((stage, ms, ms - prev))
        prev = ms
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="siftsmall")
    ap.add_argument("--metric", default="l2")
    ap.add_argument("--dtype", default="int8")
    ap.add_argument("--nlist", type=int, default=None)
    ap.add_argument("--pad-block", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--nprobe", type=int, default=4)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "pallas", "pallas_accum"])
    ap.add_argument("--device", default="cuda",
                    help="device type: the mesh is every device of it")
    args = ap.parse_args(argv)

    enable_compilation_cache()
    ds = load_dataset(args.dataset, gt_k=args.k, device=args.device)
    mesh = make_mesh(device_type=args.device)
    index = build_or_load_index(ds, nlist=args.nlist, metric=args.metric,
                                dtype=args.dtype, pad_block=args.pad_block, device=mesh[0])
    sidx = ShardedIVFIndex(index, mesh)
    rng = np.random.default_rng(0)
    q = rng.permuted(
        np.resize(ds.queries, (args.batch, ds.queries.shape[1])), axis=0
    ).astype(np.float32)
    rows = profile(sidx, q, args.k, args.nprobe, engine=args.engine)
    print(f"mesh={len(mesh)}dev batch={args.batch} "
          f"nprobe={args.nprobe} k={args.k} dtype={args.dtype} "
          f"engine={sidx.last_engine or args.engine} "
          f"qcap={sidx._auto_qcap(args.batch, args.nprobe)}")
    for name, cum, delta in rows:
        print(f"  {name:<10} cumulative {cum:8.2f} ms   stage {delta:8.2f} ms")


if __name__ == "__main__":
    main()
