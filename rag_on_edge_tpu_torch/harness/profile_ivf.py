"""Per-stage breakdown of the cluster-major IVF search (counterpart:
``rag_on_edge_tpu/harness/profile_ivf.py``).

Times cumulative prefixes of the pipeline (coarse → invert → route/gather →
kernel → join/rescore) with the distinct-input protocol of
:mod:`rag_on_edge_tpu_torch.harness.timing`; a stage's cost is the
difference between successive prefixes, printed as measured (a host-bound
prefix can time below the one before it).  Each prefix calls the index's
own production stages (``_coarse_probes``, ``_route``, ``_scan_inputs``,
``_scan_grouped``, ``search_device``), so it times what a search runs.
The reference reports the analogous split as ``SearchTiming{centroid,
gather, fine}`` (``IVFIndex.h:31-36``).

Usage:
    python -m rag_on_edge_tpu_torch.harness.profile_ivf --dataset sift \
        --dtype int8 --metric l2 --batch 2048 --nprobe 4
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from rag_on_edge_tpu_torch.harness import timing
from rag_on_edge_tpu_torch.models.ivf import IVFIndex
from rag_on_edge_tpu_torch.utils.cache import enable_compilation_cache
from rag_on_edge_tpu_torch.utils.datasets import load_dataset

__all__ = ["profile", "main"]

NAMES = ("coarse+topk", "+invert", "+route/gather", "+kernel", "+join/rescore")


def _stage_fns(index: IVFIndex, k: int, nprobe: int, qcap: int, engine: str = "pallas"):
    """The cumulative prefixes, each a function of the query batch.

    ``+kernel`` runs the grouped engine's scan (kernel K4) over the dense
    per-block routed table, as the JAX profiler does; ``+join/rescore`` is
    the whole call at ``engine`` with the rescore on and no recovery pass
    (JAX: ``_search_cluster_major_impl(..., rescore=True)``).  With
    ``engine="pallas_accum"`` the full prefix runs kernel K1, whose scan
    has no prefix of its own here."""
    index._ensure_kernel_state()

    def p_coarse(q):
        return index._coarse_probes(q, nprobe)

    def p_invert(q):
        return index._route(q, nprobe, qcap)

    def p_route(q):
        _, cq, *_ = index._route(q, nprobe, qcap)
        return index._scan_inputs(q, cq, pitched=True)

    def p_kernel(q):
        _, cq, *_ = index._route(q, nprobe, qcap)
        _, qb, bias, _, alpha = index._scan_inputs(q, cq, pitched=True)
        return index._scan_grouped(qb, bias, 2 * k, alpha)

    def p_full(q):
        return index.search_device(q, k, nprobe, mode="cluster", qcap=qcap, engine=engine,
                                   rescore=True, recover=False)

    return list(NAMES), [p_coarse, p_invert, p_route, p_kernel, p_full]


def profile(index: IVFIndex, queries: np.ndarray, k: int, nprobe: int,
            qcap: int | None = None, repeats: int = 6, engine: str = "pallas"):
    """Rows [(prefix, cumulative ms, stage ms)] for one batch of ``queries``
    on the index's device."""
    b = queries.shape[0]
    qcap = qcap or index._auto_qcap(b, nprobe)
    names, fns = _stage_fns(index, k, nprobe, qcap, engine=engine)
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(index.device)
    rows, prev = [], 0.0
    for name, fn in zip(names, fns):
        qps = timing.measure_throughput(fn, [q], repeats=repeats)
        ms = b / qps * 1e3
        rows.append((name, ms, ms - prev))
        prev = ms
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="siftsmall")
    ap.add_argument("--metric", default="l2")
    ap.add_argument("--dtype", default="int8")
    ap.add_argument("--nlist", type=int, default=None)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--nprobe", type=int, default=4)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--qcap", type=int, default=None)
    ap.add_argument("--engine", default="pallas",
                    choices=["pallas", "pallas_routed", "pallas_accum"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    enable_compilation_cache()
    ds = load_dataset(args.dataset, gt_k=args.k, device=args.device)
    index = IVFIndex.build(ds.base, nlist=args.nlist, metric=args.metric, dtype=args.dtype,
                           seed=42, device=args.device)
    rng = np.random.default_rng(0)
    q = rng.permuted(
        np.resize(ds.queries, (args.batch, ds.queries.shape[1])), axis=0
    ).astype(np.float32)
    rows = profile(index, q, args.k, args.nprobe, args.qcap, engine=args.engine)
    print(f"batch={args.batch} nprobe={args.nprobe} k={args.k} "
          f"dtype={args.dtype} qcap={args.qcap or index._auto_qcap(args.batch, args.nprobe)}")
    for name, cum, delta in rows:
        print(f"  {name:<16} cumulative {cum:8.2f} ms   stage {delta:8.2f} ms")


if __name__ == "__main__":
    main()
