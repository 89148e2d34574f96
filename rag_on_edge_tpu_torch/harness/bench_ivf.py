"""IVF benchmark harness (counterpart: ``rag_on_edge_tpu/harness/bench_ivf.py``).

Builds (or loads a cached) index, sweeps nprobe, reports recall / QPS /
latency percentiles / candidate reduction, and writes the JAX package's
files: ``results.txt`` and ``metrics.txt`` per configuration, a
``benchmark_ivf.csv`` row per point
(``dataset,nprobe,top_k,recall,qps,avg_ms,p50_ms,p95_ms,p99_ms,avg_candidates,reduction``)
and ``timing.txt``.  The index cache has the JAX package's names under the
same data root, and ``IVFIndex.save`` writes the JAX artifact set, so a
cache written by either package loads in the other; so does the shared
centroid cache ``centroids_nlist…_mi….npy``.  Times come from the port's
``harness/timing.py`` (see ``bench_bruteforce``).

Usage:
    python -m rag_on_edge_tpu_torch.harness.bench_ivf \
        --dataset siftsmall --nlist 100 --nprobe 8 16 32 --k 10
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import time

import numpy as np
import torch

from rag_on_edge_tpu_torch.harness import timing
from rag_on_edge_tpu_torch.harness.bench_bruteforce import _device_batches, latency_and_qps
from rag_on_edge_tpu_torch.models.ivf import IVFIndex
from rag_on_edge_tpu_torch.models.kmeans import default_nlist
from rag_on_edge_tpu_torch.utils import metrics
from rag_on_edge_tpu_torch.utils.datasets import DEFAULT_DATA_ROOT, load_dataset

__all__ = ["build_or_load_index", "run", "main"]


def build_or_load_index(
    ds, nlist: int | None, metric: str, dtype: str, seed: int = 42,
    cache_root: str | None = None, pad_block: int | None = None,
    store: str = "padded", kmeans_init: str = "kmeans++",
    spill_eps: float = 0.0, device: str | torch.device = "cuda",
) -> IVFIndex:
    """The index of a build configuration, loaded from its cache under
    ``cache_root`` (default: the data root) or built and saved there.  This
    function owns the canonical build config (``max_iter`` 25 past 200K
    rows, else 100).  The centroids depend only on (base, nlist, seed,
    init, max_iter) and are cached once per dataset, so dtype, pad_block
    and spill_eps variants reuse one k-means run; the k-means checkpoint
    beside the cache (``<cache>.kmeans_ckpt.npz``, named by the whole
    build) resumes a build cut short and is removed once the index is
    saved."""
    nlist = default_nlist(ds.base.shape[0], nlist)
    cache_root = cache_root or DEFAULT_DATA_ROOT
    pb_tag = f"_pb{pad_block}" if pad_block else ""
    init_tag = "_pp" if kmeans_init == "kmeans++" else ""
    sp_tag = f"_sp{spill_eps:g}" if spill_eps > 0 else ""
    cache = os.path.join(
        cache_root, ds.name,
        f"ivf_nlist{nlist}_{metric}_{dtype}_seed{seed}{pb_tag}{init_tag}{sp_tag}",
    )
    if os.path.exists(os.path.join(cache, "ivf_config.json")):
        return IVFIndex.load(cache, store=store, device=device)
    max_iter = 25 if ds.base.shape[0] > 200_000 else 100
    cent_path = os.path.join(
        cache_root, ds.name, f"centroids_nlist{nlist}_seed{seed}{init_tag}_mi{max_iter}.npy")
    centroids = np.load(cent_path) if os.path.exists(cent_path) else None
    ckpt = cache + ".kmeans_ckpt.npz"
    index = IVFIndex.build(ds.base, nlist=nlist, metric=metric, dtype=dtype, seed=seed,
                           pad_block=pad_block, store=store, kmeans_init=kmeans_init,
                           max_iter=max_iter, kmeans_checkpoint=ckpt, spill_eps=spill_eps,
                           centroids=centroids, device=device)
    if centroids is None:
        np.save(cent_path, index._centroids_np)
    index.save(cache)
    if os.path.exists(ckpt):
        os.remove(ckpt)
    return index


def run(
    dataset: str = "siftsmall",
    nlist: int | None = None,
    nprobes: tuple[int, ...] = (8, 16, 32, 64),
    k: int = 10,
    batch: int = 32,
    dtype: str = "fp32",
    metric: str = "ip",
    mode: str = "auto",
    repeats: int = 10,
    outdir: str | None = None,
    quiet: bool = False,
    max_queries: int | None = None,
    pad_block: int | None = None,
    recover: bool | None = None,
    store: str = "padded",
    vs_brute: bool | None = None,
    spill_eps: float = 0.0,
    sharded: bool = False,
    device: str | torch.device = "cuda",
) -> list[dict]:
    """One row per nprobe (``latency`` a :class:`metrics.LatencyStats`).
    ``sharded`` runs the same workload through ``ShardedIVFIndex`` over
    every device of ``device``'s type (``make_mesh``; one shard on the CPU),
    in the cluster mode where ``mode`` is "auto"."""
    device = torch.device(device)
    ds = load_dataset(dataset, gt_k=max(k, 10), device=device)
    if max_queries:
        ds.queries = ds.queries[:max_queries]
        ds.ground_truth_ip = ds.ground_truth_ip[:max_queries]
        ds.ground_truth_l2 = ds.ground_truth_l2[:max_queries]
    t0 = time.perf_counter()
    index = build_or_load_index(ds, nlist, metric, dtype, pad_block=pad_block, store=store,
                                spill_eps=spill_eps, device=device)
    build_s = time.perf_counter() - t0
    gt = ds.gt(metric)
    n = ds.base.shape[0]

    searcher = index
    if sharded:
        from rag_on_edge_tpu_torch.parallel.mesh import make_mesh
        from rag_on_edge_tpu_torch.parallel.sharded import ShardedIVFIndex

        searcher = ShardedIVFIndex(index, make_mesh(device_type=device.type))
        if mode == "auto":
            mode = "cluster"  # the sharded flagship path
    coarse_np = min(max(nprobes), index.nlist)
    coarse = lambda q: index._coarse_probes(q, coarse_np)  # noqa: E731

    # The measured IVF-vs-brute speedup, by default up to 1M base vectors.
    if vs_brute is None:
        vs_brute = n <= 1_000_000
    brute_qps = None
    if vs_brute:
        from rag_on_edge_tpu_torch.models.brute_force import BruteForceIndex

        brute = BruteForceIndex(ds.base, metric=metric, dtype=dtype, device=device)
        bbatches = _device_batches(ds.queries, batch, device=device)
        brute.compile(batch, k)
        it = itertools.cycle(bbatches)
        brute_qps = batch * 1e3 / timing.per_call_ms(
            lambda: brute.search_device(next(it), k), [device],
            calls=max(3, repeats // 3) * len(bbatches))
        del brute

    results = []
    deploy_lines = [f"index_build_or_load_s: {build_s:.2f}"]
    for nprobe in nprobes:
        t0 = time.perf_counter()
        batches = _device_batches(ds.queries, batch, device=device)
        if sharded:
            search = lambda q: searcher.search_device(q, k, nprobe, mode=mode,  # noqa: E731
                                                      recover=recover)
            search(batches[0])  # builds the sharded state and kernels
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        else:
            index.compile(batch, k, nprobe, mode=mode, recover=recover)
            search = lambda q: index.search_device(q, k, nprobe, mode=mode,  # noqa: E731
                                                   recover=recover)
        compile_s = time.perf_counter() - t0
        deploy_lines.append(f"compile_nprobe{nprobe}_s: {compile_s:.2f}")
        lat, qps = latency_and_qps(search, batches, device, repeats)
        it = itertools.cycle(batches)
        coarse_ms = timing.per_call_ms(lambda: coarse(next(it)), [device],
                                       calls=repeats * len(batches))
        total_ms = 1e3 * batch / qps
        phase_lines = [
            f"coarse (centroid GEMM + top-nprobe): {coarse_ms:.3f} ms/batch "
            f"({100 * coarse_ms / total_ms:.1f}%)",
            f"fine (+dispatch/join): {total_ms - coarse_ms:.3f} ms/batch "
            f"({100 * (1 - coarse_ms / total_ms):.1f}%)",
        ]

        if sharded:
            ids, scores, avg_cand = searcher.search(ds.queries, k=k, nprobe=nprobe,
                                                    batch_size=batch, mode=mode)
            engine = (f"sharded[{searcher.n_shards}]:{mode}"
                      f":{searcher.last_engine or 'gather'}")
        else:
            ids, scores, avg_cand = index.search(ds.queries, k=k, nprobe=nprobe,
                                                 batch_size=batch, mode=mode, recover=recover)
            engine = index.last_engine
        recall = metrics.recall_at_k(ids, gt, k) if gt is not None else float("nan")
        recall1 = metrics.recall_at_k(ids, gt, 1) if gt is not None else float("nan")
        reduction = n / avg_cand if avg_cand else float("inf")
        speedup = qps / brute_qps if brute_qps else None
        # Centroid and fine FLOPs a query (the fine ones at the measured
        # average candidate count), and the rate at the measured QPS.
        dim = ds.base.shape[1]
        centroid_flops_q = 2.0 * dim * index.nlist
        fine_flops_q = 2.0 * dim * avg_cand
        gflops = (centroid_flops_q + fine_flops_q) * qps / 1e9
        row = {
            "dataset": dataset,
            "nlist": index.nlist,
            "spill_eps": spill_eps,
            "nprobe": nprobe,
            "k": k,
            "batch": batch,
            "recall": recall,
            "recall_at_1": recall1,
            "qps": qps,
            "engine": engine,
            "n_rows": index.n,
            "n_base": index.n_base,
            "gflops": gflops,
            "speedup_vs_brute": speedup,
            "avg_candidates": avg_cand,
            "reduction": reduction,
            "latency": lat,
        }
        results.append(row)
        if not quiet:
            sp = f" speedup={speedup:.1f}x" if speedup else ""
            print(
                f"[ivf {dtype}] {dataset} nlist={index.nlist} nprobe={nprobe} B={batch} "
                f"K={k} engine={engine}: recall@{k}={recall:.4f} recall@1={recall1:.4f} "
                f"QPS={qps:,.0f}{sp} "
                f"cand={avg_cand:.0f} ({reduction:.1f}x reduction) "
                f"lat(ms) mean={lat.mean:.3f} p95={lat.p95:.3f}"
            )
        if outdir:
            sp_tag = f"_sp{spill_eps:g}" if spill_eps > 0 else ""
            cfg = f"{dataset}_ivf{index.nlist}_np{nprobe}_b{batch}_k{k}_{dtype}{sp_tag}"
            d = os.path.join(outdir, cfg)
            metrics.write_results_txt(os.path.join(d, "results.txt"), ids, scores)
            metrics.write_metrics_txt(
                os.path.join(d, "metrics.txt"),
                {
                    "Dataset and Index Info": [
                        f"dataset: {dataset}",
                        f"num_docs: {n}",
                        f"num_queries: {ds.queries.shape[0]}",
                        f"dim: {ds.base.shape[1]}",
                        f"n_clusters: {index.nlist}",
                        f"nprobe: {nprobe}",
                        f"batch_size: {batch}  top_k: {k}",
                        f"cluster sizes min/avg/max: "
                        f"{index.config['cluster_size_min']}/"
                        f"{index.config['cluster_size_avg']:.1f}/"
                        f"{index.config['cluster_size_max']}",
                    ],
                    "Accuracy": [
                        f"recall@{k}: {recall:.4f}",
                        f"recall@1: {recall1:.4f}",
                    ],
                    "Candidate Statistics": [
                        f"avg_candidates_per_query: {avg_cand:.1f}",
                        f"candidate_reduction: {reduction:.1f}x",
                    ],
                    "Overall Performance": [
                        f"throughput_qps: {qps:.1f}",
                        f"per_query_latency_amortized_ms: {1e3 / qps:.4f}",
                        f"engine: {engine}",
                    ]
                    + ([f"speedup_vs_bruteforce: {speedup:.2f}x "
                        f"(brute {brute_qps:.1f} QPS, same batch/dtype)"]
                       if speedup else []),
                    "Compute": [
                        f"centroid_flops_per_query: {centroid_flops_q:.3e}",
                        f"fine_flops_per_query (avg candidates): {fine_flops_q:.3e}",
                        f"total_gflops (sustained): {gflops:.1f}",
                    ],
                    "Phase Breakdown": phase_lines,
                    "Device Execution": lat.lines("batch"),
                },
            )
            metrics.append_sweep_csv(
                os.path.join(outdir, "benchmark_ivf.csv"),
                "dataset,nprobe,top_k,recall,qps,avg_ms,p50_ms,p95_ms,p99_ms,avg_candidates,"
                "reduction",
                f"{dataset},{nprobe},{k},{recall:.4f},{qps:.1f},{lat.mean:.4f},"
                f"{lat.p50:.4f},{lat.p95:.4f},{lat.p99:.4f},{avg_cand:.1f},{reduction:.1f}",
            )
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "timing.txt"), "w") as f:
            f.write("\n".join(deploy_lines) + "\n")
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="siftsmall")
    p.add_argument("--nlist", type=int, default=None)
    p.add_argument("--nprobe", type=int, nargs="+", default=[8, 16, 32, 64])
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--dtype", default="fp32", choices=["fp32", "bf16", "int8"])
    p.add_argument("--metric", default="ip", choices=["ip", "l2"])
    p.add_argument("--mode", default="auto", choices=["auto", "query", "cluster"])
    p.add_argument("--pad-block", type=int, default=None,
                   help="device slab block rows (e.g. 2048 for 1M cluster-major)")
    p.add_argument("--max-queries", type=int, default=None)
    p.add_argument("--repeats", type=int, default=10)
    p.add_argument("--outdir", default="results")
    p.add_argument("--json", action="store_true")
    p.add_argument("--vs-brute", dest="vs_brute", action="store_true", default=None,
                   help="force the measured IVF-vs-brute speedup (default: auto <= 1M)")
    p.add_argument("--no-vs-brute", dest="vs_brute", action="store_false")
    p.add_argument("--sharded", action="store_true",
                   help="run through ShardedIVFIndex over every device of --device's type")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    rows = run(
        dataset=args.dataset, nlist=args.nlist, nprobes=tuple(args.nprobe),
        k=args.k, batch=args.batch, dtype=args.dtype, metric=args.metric,
        mode=args.mode, repeats=args.repeats, outdir=args.outdir,
        quiet=args.json, max_queries=args.max_queries, pad_block=args.pad_block,
        vs_brute=args.vs_brute, sharded=args.sharded, device=args.device,
    )
    if args.json:
        for r in rows:
            print(json.dumps({**r, "latency": r["latency"].__dict__}))


if __name__ == "__main__":
    main()
