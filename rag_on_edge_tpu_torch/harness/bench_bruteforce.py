"""Brute-force benchmark harness (counterpart:
``rag_on_edge_tpu/harness/bench_bruteforce.py``).

Loads a dataset, drives batched search through ``BruteForceIndex``, and
writes ``results.txt`` (per-query top-k rows), ``metrics.txt`` (sectioned
report) and a sweep-CSV row with the JAX package's schema
(``dataset,batch,qps,gflops,avg_ms,p95_ms,p99_ms``).  Times come from the
port's ``harness/timing.py``: the latency is the host-timed round trip of
one call and a synchronize, per call; the throughput is the device time
per call of back-to-back calls (CUDA events on one card).

Usage:
    python -m rag_on_edge_tpu_torch.harness.bench_bruteforce \
        --dataset siftsmall --batch 32 --k 5 --dtype int8
"""

from __future__ import annotations

import argparse
import itertools
import json
import os

import numpy as np
import torch

from rag_on_edge_tpu_torch.harness import timing
from rag_on_edge_tpu_torch.models.brute_force import BruteForceIndex
from rag_on_edge_tpu_torch.utils import metrics
from rag_on_edge_tpu_torch.utils.datasets import load_dataset

__all__ = ["run", "main"]


def _device_batches(queries: np.ndarray, batch: int, min_batches: int = 8,
                    device: str | torch.device = "cuda") -> list[torch.Tensor]:
    """The queries as device batches of ``batch`` rows, tiled up to
    ``min_batches`` so a timing loop has enough work.  The tail pads by
    cyclic repeat, not zeros: a block of identical zero queries all probes
    the same few IVF cells, crowds real pairs out of their routing capacity
    and makes the padded batch unrepresentatively slow."""
    nq = queries.shape[0]
    batches = []
    for start in range(0, nq, batch):
        chunk = queries[start:start + batch]
        if chunk.shape[0] < batch:
            chunk = np.resize(chunk, (batch, chunk.shape[1]))
        batches.append(torch.from_numpy(np.ascontiguousarray(chunk, np.float32)).to(device))
    while len(batches) < min_batches:
        batches = batches + batches
    return batches


def latency_and_qps(search, batches, device, repeats: int):
    """(LatencyStats of the per-call round trip over one pass of
    ``batches``, queries/s of ``repeats`` passes back to back) for
    ``search(batch)``."""
    lat_it, qps_it = itertools.cycle(batches), itertools.cycle(batches)
    lat = metrics.LatencyStats.from_samples(timing.sync_latency_ms(
        lambda: search(next(lat_it)), [device], samples=len(batches)).tolist())
    ms = timing.per_call_ms(lambda: search(next(qps_it)), [device],
                            calls=repeats * len(batches))
    return lat, int(batches[0].shape[0]) * 1e3 / ms


def run(
    dataset: str = "siftsmall",
    batch: int = 32,
    k: int = 5,
    dtype: str = "int8",
    metric: str = "ip",
    select: str = "auto",
    repeats: int = 10,
    outdir: str | None = None,
    quiet: bool = False,
    profile: bool = False,
    device: str | torch.device = "cuda",
) -> dict:
    """One brute-force benchmark point on ``device`` → the result dict
    (``latency`` a :class:`metrics.LatencyStats`).  ``profile`` writes a
    ``torch.profiler`` trace of the throughput loop (Chrome trace JSON)
    under ``RAG_EDGE_TPU_PROFILE_DIR``, else ``<outdir>/trace``."""
    device = torch.device(device)
    ds = load_dataset(dataset, gt_k=max(k, 10), device=device)
    index = BruteForceIndex(ds.base, metric=metric, dtype=dtype, select=select, device=device)
    index.compile(batch, k)

    search = lambda q: index.search_device(q, k)  # noqa: E731
    batches = _device_batches(ds.queries, batch, device=device)
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        trace_dir = os.environ.get("RAG_EDGE_TPU_PROFILE_DIR",
                                   os.path.join(outdir or "results", "trace"))
        os.makedirs(trace_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with torch_profile(activities=acts) as prof:
            lat, qps = latency_and_qps(search, batches, device, repeats)
        path = os.path.join(trace_dir, f"{dataset}_b{batch}_k{k}_{dtype}.json")
        prof.export_chrome_trace(path)
        if not quiet:
            print(f"[profile] trace written to {path}")
    else:
        lat, qps = latency_and_qps(search, batches, device, repeats)

    ids, scores = index.search(ds.queries, k=k, batch_size=batch)
    gt = ds.gt(metric)
    recall = metrics.recall_at_k(ids, gt, k) if gt is not None else float("nan")

    n, dim = ds.base.shape
    flops_per_batch = 2.0 * batch * dim * n
    gflops = flops_per_batch / (lat.mean * 1e-3) / 1e9 if lat.mean else 0.0
    oi = metrics.operational_intensity(batch, dim, n,
                                       dtype_bytes={"int8": 1, "bf16": 2}.get(dtype, 4))

    # Device time per batch of back-to-back calls against the round trip of
    # one call and a synchronize: the rest is host dispatch and the wait.
    device_ms = 1e3 * batch / qps if qps else float("nan")
    dispatch_ms = max(lat.mean - device_ms, 0.0)
    breakdown = [
        f"device_compute_ms_per_batch (sustained): {device_ms:.4f} "
        f"({100 * device_ms / lat.mean:.1f}%)" if lat.mean else "n/a",
        f"dispatch_and_roundtrip_ms (single-dispatch - device): {dispatch_ms:.4f} "
        f"({100 * dispatch_ms / lat.mean:.1f}%)" if lat.mean else "n/a",
        f"single_dispatch_total_ms: {lat.mean:.4f}",
    ]

    result = {
        "dataset": dataset,
        "n_base": n,
        "dim": dim,
        "batch": batch,
        "k": k,
        "dtype": dtype,
        "metric": metric,
        "recall": recall,
        "qps": qps,
        "gflops": gflops,
        "oi": oi["oi"],
        "latency": lat,
    }

    if outdir:
        cfg = f"{dataset}_b{batch}_k{k}_{dtype}"
        d = os.path.join(outdir, cfg)
        metrics.write_results_txt(os.path.join(d, "results.txt"), ids, scores)
        metrics.write_metrics_txt(
            os.path.join(d, "metrics.txt"),
            {
                "Dataset Info": [
                    f"dataset: {dataset}",
                    f"num_docs: {n}",
                    f"num_queries: {ds.queries.shape[0]}",
                    f"dim: {dim}",
                    f"batch_size: {batch}",
                    f"top_k: {k}",
                    f"dtype: {dtype}  metric: {metric}  select: {select}",
                ],
                "Operational Intensity Analysis": [
                    f"flops_per_batch: {oi['flops']:.3e}",
                    f"bytes_per_batch: {oi['bytes']:.3e}",
                    f"operational_intensity: {oi['oi']:.2f} FLOPs/byte",
                ],
                "Overall Performance": [
                    f"throughput_qps: {qps:.1f}",
                    f"per_query_latency_amortized_ms: {1e3 / qps:.4f}",
                ],
                "Device Execution": lat.lines("batch"),
                "Time Breakdown": breakdown,
                "Compute Performance": [
                    f"gflops (batch-latency based): {gflops:.1f}",
                ],
                "Accuracy": [f"recall@{k}: {recall:.4f}"],
            },
        )
        metrics.append_sweep_csv(
            os.path.join(outdir, "benchmark_bruteforce.csv"),
            "dataset,batch,qps,gflops,avg_ms,p95_ms,p99_ms",
            f"{dataset},{batch},{qps:.1f},{gflops:.1f},{lat.mean:.4f},{lat.p95:.4f},{lat.p99:.4f}",
        )
    if not quiet:
        print(
            f"[brute {dtype}] {dataset} B={batch} K={k}: recall@{k}={recall:.4f} "
            f"QPS={qps:,.0f} GFLOPS={gflops:.1f} "
            f"lat(ms) mean={lat.mean:.3f} p95={lat.p95:.3f} p99={lat.p99:.3f}"
        )
    return result


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="siftsmall")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--dtype", default="int8", choices=["fp32", "bf16", "int8"])
    p.add_argument("--metric", default="ip", choices=["ip", "l2"])
    p.add_argument("--select", default="auto",
                   choices=["auto", "exact", "two_stage", "iterative", "approx"])
    p.add_argument("--repeats", type=int, default=10)
    p.add_argument("--outdir", default="results")
    p.add_argument("--json", action="store_true", help="print one JSON line")
    p.add_argument("--profile", action="store_true", help="write a torch.profiler trace")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    r = run(
        dataset=args.dataset, batch=args.batch, k=args.k, dtype=args.dtype,
        metric=args.metric, select=args.select, repeats=args.repeats,
        outdir=args.outdir, quiet=args.json, profile=args.profile, device=args.device,
    )
    if args.json:
        r = {**r, "latency": r["latency"].__dict__}
        print(json.dumps(r))


if __name__ == "__main__":
    main()
