"""End-to-end serving benchmark: singleton submits through the executor
(counterpart: ``rag_on_edge_tpu/harness/bench_executor.py``).

Measures what a caller of a search service sees (per-request futures,
micro-batching, pipelined dispatch), as opposed to the capacity numbers of
``bench_ivf`` (pre-batched, no serving glue).

Two protocols:

- **saturated** (default): all requests submitted up front.  The QPS is
  the serving capacity; the latency percentiles are queue depth, not
  service time.
- **open loop** (``--open-loop``): Poisson arrivals at fractions of the
  measured capacity (``--loads``).  Latency runs from each request's
  scheduled arrival to its completion, so producer lag counts as queueing:
  the latency-against-offered-load curve a capacity number says nothing
  about.  Each point also reports the recall of what it served (underfull
  batches are padded with zero rows, which probe the same few cells).

Usage:
    python -m rag_on_edge_tpu_torch.harness.bench_executor --dataset sift \
        --batch 2048 --nprobe 4 --requests 20000 [--open-loop]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from rag_on_edge_tpu_torch.runtime.executor import BatchingExecutor, _flatten
from rag_on_edge_tpu_torch.utils import metrics
from rag_on_edge_tpu_torch.utils.datasets import load_dataset

__all__ = ["run", "relay_cycle_probe", "run_open_loop", "auto_max_delay_ms", "run_load_curve",
           "main"]

# The stats() counters a run reports as differences over its timed region.
_COUNTERS = ("batches_dispatched", "rows_dispatched", "underfull_launches", "drains",
             "batches_collected", "packed_batches", "fused_drains")


def _wire_dtype(queries: np.ndarray, wire: str):
    """The upload wire format.  "auto": uint8 when the query corpus is
    integral in [0, 255] (real SIFT and the synthetic sets both are), a
    lossless quarter of the upload's bytes; ``search_device`` casts back
    to float32."""
    if wire == "f32":
        return None
    integral = (queries.min() >= 0 and queries.max() <= 255
                and np.all(queries == np.rint(queries)))
    if wire == "uint8":
        if not integral:
            raise ValueError("wire='uint8' needs integral queries in [0,255]")
        return np.uint8
    return np.uint8 if integral else None  # auto


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _warm(fn, batch: int, dim: int, wd, device) -> None:
    """One search at the wire dtype, so the executor's first batch builds
    nothing inside the timed pipeline."""
    dt = torch.from_numpy(np.zeros(0, wd or np.float32)).dtype
    fn(torch.zeros((batch, dim), dtype=dt, device=device))
    _sync(device)


def _device_busy_ms(prof) -> float:
    """Device ms summed over every op ``torch.profiler`` timed on the
    device (kernels and copies; copies overlapping kernels are counted
    twice)."""
    total = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        total += us / 1e3
    return total


def run(dataset: str = "sift", batch: int = 2048, nprobe: int = 4, k: int = 10,
        requests: int = 20000, max_delay_ms: float = 5.0, inflight: int = 8,
        recover_passes: int | None = None, quiet: bool = False,
        index=None, wire: str = "auto", profile: bool = False,
        device: str | torch.device = "cuda") -> dict:
    """The saturated protocol → the result dict.  ``index``: an index to
    serve (default: ``build_or_load_index``'s int8 L2 index of the
    dataset); it runs where the index lives.  ``profile``: trace the timed
    region with ``torch.profiler`` and add the device's busy ms and share
    of its wall time (``device_busy_ms``, ``device_busy_share``)."""
    from rag_on_edge_tpu_torch.harness.bench_ivf import build_or_load_index

    device = torch.device(index.device if index is not None else device)
    ds = load_dataset(dataset, gt_k=k, device=device)
    if index is None:
        pad_block = 2048 if ds.base.shape[0] >= 500_000 else None
        index = build_or_load_index(ds, nlist=None, metric="l2", dtype="int8",
                                    pad_block=pad_block, device=device)
    # recover_passes None: the auto policy; serving configs at nprobe <= 4
    # may pin 1.
    rp = recover_passes
    fn = lambda q: index.search_device(q, k, nprobe, mode="cluster",  # noqa: E731
                                       recover_passes=rp)

    nq = ds.queries.shape[0]
    reqs = np.resize(ds.queries, (requests, ds.queries.shape[1])).astype(np.float32)
    wd = _wire_dtype(ds.queries, wire)
    _warm(fn, batch, ds.base.shape[1], wd, device)

    busy_ms = None
    with BatchingExecutor(fn, dim=ds.base.shape[1], batch_size=batch,
                          max_delay_ms=max_delay_ms, inflight=inflight,
                          wire_dtype=wd, device=device) as ex:
        ex.submit(reqs[0]).result(timeout=600)  # warms the pipeline
        stats0 = ex.stats()
        t_submit = np.empty(requests)
        futs = []
        prof = None
        if profile and device.type == "cuda":
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as torch_profile

            prof = torch_profile(activities=[ProfilerActivity.CUDA])
        # The cyclic GC is off in the timed region (one gen-2 pass over the
        # request objects stalls the pipeline); the executor's objects hold
        # no cycles, so reference counting frees them.
        gc.collect()
        gc.freeze()
        gc.disable()
        try:
            if prof is not None:
                prof.__enter__()
            t0 = time.perf_counter()
            for i in range(requests):
                t_submit[i] = time.perf_counter()
                futs.append(ex.submit(reqs[i]))
            t_done = np.empty(requests)
            ids = np.empty((requests, k), np.int32)
            for i, f in enumerate(futs):
                r = f.result(timeout=600)
                t_done[i] = time.perf_counter()
                ids[i] = np.asarray(r[1])
            wall = time.perf_counter() - t0
            if prof is not None:
                _sync(device)
                prof.__exit__(None, None, None)
                busy_ms = _device_busy_ms(prof)
        finally:
            gc.enable()
            gc.unfreeze()
        stats = {key: (v - stats0[key] if key in _COUNTERS else v)
                 for key, v in ex.stats().items()}
        b, d = stats["batches_dispatched"], stats["drains"]
        stats["avg_rows_per_batch"] = round(stats["rows_dispatched"] / b, 1) if b else 0.0
        stats["batches_per_drain"] = round(stats["batches_collected"] / d, 2) if d else 0.0
    qps = requests / wall
    lat = metrics.LatencyStats.from_samples(((t_done - t_submit) * 1e3).tolist())
    # Recall over the requests issued (fewer than the queries: their rows).
    nr = min(nq, requests)
    recall = metrics.recall_at_k(ids[:nr], ds.ground_truth_l2[:nr], k)
    out = {
        "dataset": dataset, "requests": requests, "batch": batch,
        "nprobe": nprobe, "k": k, "inflight": inflight,
        "max_delay_ms": max_delay_ms,
        "wire": str(np.dtype(wd)) if wd is not None else "float32",
        "qps_end_to_end": round(qps, 1),
        "recall": round(float(recall), 4),
        "latency_ms": {"mean": round(lat.mean, 3), "p50": round(lat.p50, 3),
                       "p95": round(lat.p95, 3), "p99": round(lat.p99, 3)},
        "pipeline": stats,
    }
    if busy_ms is not None:
        out["device_busy_ms"] = busy_ms
        out["device_busy_share"] = busy_ms / (wall * 1e3)
    if not quiet:
        print(f"[executor] {dataset} B={batch} np={nprobe} inflight={inflight}: "
              f"{qps:,.0f} QPS end-to-end, recall@{k}={recall:.4f}, "
              f"lat ms p50={lat.p50:.1f} p95={lat.p95:.1f} p99={lat.p99:.1f}, "
              f"{stats['batches_per_drain']} batches/drain, "
              f"{stats['underfull_launches']} underfull")
    return out


def relay_cycle_probe(fn, dim: int, batch: int, cycles: int = 4, seed: int = 0,
                      wire_dtype=None, device: str | torch.device = "cuda") -> float:
    """The serialized upload → search → fetch cost, ms a batch (the JAX
    package's "weather" reading of its relay).  Each cycle uploads a
    distinct host batch (fresh randoms in ``wire_dtype``, the serving
    path's upload format), runs ``fn`` and moves its whole result to the
    host before the next cycle starts: no pipelining, so capacity ≈ B /
    cycle.  The median over the cycles, the first one dropped."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    qs = rng.uniform(0.0, 100.0, size=(cycles + 1, batch, dim)).astype(
        wire_dtype or np.float32)
    times = []
    for i in range(cycles + 1):
        t0 = time.perf_counter()
        leaves, _ = _flatten(fn(torch.from_numpy(qs[i]).to(device)))
        for leaf in leaves:
            leaf.cpu()
        times.append(time.perf_counter() - t0)
    return float(np.median(times[1:]) * 1e3)


def run_open_loop(ex, reqs: np.ndarray, rate_qps: float, max_delay_ms: float,
                  seed: int = 0, gt: np.ndarray | None = None, k: int = 10) -> dict:
    """One open-loop run: Poisson arrivals at ``rate_qps`` through a warm
    executor.  The latency of request i is its completion less its
    scheduled arrival.  ``gt`` (ground-truth rows of ``reqs``, e.g.
    ``np.resize`` of the queries' as ``reqs`` was made): the recall@k of
    the served ids is added.

    Pacing: sleep while more than 1 ms ahead of schedule, then yielding
    spins (``sleep(0)``): a pure-Python spin would hold the GIL for a whole
    switch interval and starve the dispatcher and collector.  The switch
    interval is cut to 1 ms for the run for the same reason."""
    n = len(reqs)
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_qps, size=n))
    t_done = np.empty(n)
    futs: list = [None] * n
    ids = np.empty((n, k), np.int32) if gt is not None else None

    def collect():
        # Futures resolve a batch at a time in FIFO order: waiting in submit
        # order wakes once a batch and stamps its members back to back.
        i = 0
        while i < n:
            f = futs[i]
            if f is None:  # the producer has not made it yet
                time.sleep(1e-4)
                continue
            r = f.result(timeout=600)
            t_done[i] = time.perf_counter()
            if ids is not None:
                ids[i] = np.asarray(r[1])[:k]
            i += 1

    col = threading.Thread(target=collect)
    col.start()
    perf = time.perf_counter
    sleep = time.sleep
    submit = ex.submit
    old_switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-3)
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        t0 = perf()
        for i in range(n):
            target = t0 + arrivals[i]
            while True:
                lag = target - perf()
                if lag <= 0:
                    break
                sleep(lag - 5e-4 if lag > 1e-3 else 0)
            futs[i] = submit(reqs[i])
        col.join()
    finally:
        sys.setswitchinterval(old_switch)
        gc.enable()
        gc.unfreeze()
    wall = time.perf_counter() - t0
    lat = metrics.LatencyStats.from_samples(((t_done - (t0 + arrivals)) * 1e3).tolist())
    out = {
        "offered_qps": round(rate_qps, 1),
        "achieved_qps": round(n / wall, 1),
        "latency_ms": {"mean": round(lat.mean, 3), "p50": round(lat.p50, 3),
                       "p95": round(lat.p95, 3), "p99": round(lat.p99, 3)},
    }
    if gt is not None:
        out["recall"] = round(float(metrics.recall_at_k(ids, gt, k)), 4)
    return out


def auto_max_delay_ms(batch: int, offered_qps: float, capacity_qps: float) -> float:
    """The batching window for an offered load: the smaller of the time the
    load takes to fill a batch (waiting longer adds latency and no rows)
    and one batch's time at capacity (past that the pipeline is
    dispatch-bound), clamped to [5, 200] ms."""
    fill_ms = 1e3 * batch / max(offered_qps, 1.0)
    cycle_ms = 1e3 * batch / max(capacity_qps, 1.0)
    return float(max(5.0, min(fill_ms, cycle_ms, 200.0)))


def run_load_curve(dataset: str = "sift", batch: int = 4096, nprobe: int = 4,
                   k: int = 10, requests: int = 20000,
                   max_delay_ms="auto", inflight: int = 8,
                   loads: tuple = (0.25, 0.5, 0.8), capacity: float | None = None,
                   quiet: bool = False, wire: str = "auto",
                   device: str | torch.device = "cuda") -> dict:
    """Latency against offered load: a saturated run measures the capacity,
    then one open-loop run per load fraction, each with its served recall.
    ``max_delay_ms="auto"`` retunes the window per load with
    :func:`auto_max_delay_ms` (capacity and latency want opposite
    windows)."""
    from rag_on_edge_tpu_torch.harness.bench_ivf import build_or_load_index

    device = torch.device(device)
    ds = load_dataset(dataset, gt_k=k, device=device)
    pad_block = 2048 if ds.base.shape[0] >= 500_000 else None
    index = build_or_load_index(ds, nlist=None, metric="l2", dtype="int8",
                                pad_block=pad_block, device=device)
    fn = lambda q: index.search_device(q, k, nprobe, mode="cluster")  # noqa: E731
    reqs = np.resize(ds.queries, (requests, ds.queries.shape[1])).astype(np.float32)
    gt = np.resize(ds.ground_truth_l2[:, :k], (requests, k))
    wd = _wire_dtype(ds.queries, wire)
    _warm(fn, batch, ds.base.shape[1], wd, device)

    auto = max_delay_ms == "auto"
    # The capacity probe wants full batches: the submit loop costs a few µs
    # a request, so a window below that times B launches underfull.
    probe_delay = max(10.0, batch * 5e-3) if auto else max_delay_ms
    out = {"dataset": dataset, "batch": batch, "nprobe": nprobe, "k": k,
           "inflight": inflight, "max_delay_ms": max_delay_ms,
           "wire": str(np.dtype(wd)) if wd is not None else "float32",
           "curve": []}
    with BatchingExecutor(fn, dim=ds.base.shape[1], batch_size=batch,
                          max_delay_ms=probe_delay, inflight=inflight,
                          wire_dtype=wd, device=device) as ex:
        ex.submit(reqs[0]).result(timeout=600)
        if capacity is None:
            gc.collect()
            gc.freeze()
            gc.disable()
            try:
                t0 = time.perf_counter()
                futs = [ex.submit(reqs[i]) for i in range(requests)]
                for f in futs:
                    f.result(timeout=600)
                capacity = requests / (time.perf_counter() - t0)
            finally:
                gc.enable()
                gc.unfreeze()
        out["capacity_qps"] = round(capacity, 1)
        if not quiet:
            print(f"[executor open-loop] capacity={capacity:,.0f} QPS "
                  f"(B={batch} np={nprobe} inflight={inflight})", flush=True)
        for frac in loads:
            delay = (auto_max_delay_ms(batch, frac * capacity, capacity)
                     if auto else max_delay_ms)
            ex.set_max_delay_ms(delay)
            row = run_open_loop(ex, reqs, frac * capacity, delay, gt=gt, k=k)
            row["load"] = frac
            row["max_delay_ms"] = round(delay, 1)
            out["curve"].append(row)
            if not quiet:
                lm = row["latency_ms"]
                print(f"[executor open-loop] load={frac:.0%} "
                      f"offered={row['offered_qps']:,.0f} "
                      f"achieved={row['achieved_qps']:,.0f} QPS  "
                      f"delay={delay:.0f} ms  "
                      f"lat ms p50={lm['p50']:.1f} p95={lm['p95']:.1f} "
                      f"p99={lm['p99']:.1f}  recall@{k}={row['recall']:.4f}", flush=True)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="sift")
    p.add_argument("--batch", type=int, default=2048)
    p.add_argument("--nprobe", type=int, default=4)
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--requests", type=int, default=20000)
    p.add_argument("--max-delay-ms", default=5.0,
                   type=lambda s: s if s == "auto" else float(s),
                   help='batching window; "auto" (open-loop only) picks '
                        "the per-load knee via auto_max_delay_ms")
    p.add_argument("--inflight", type=int, default=8)
    p.add_argument("--recover-passes", type=int, default=None,
                   help="pin recovery passes (default: the auto policy)")
    p.add_argument("--open-loop", action="store_true",
                   help="latency-vs-offered-load curve (Poisson arrivals at "
                        "--loads fractions of measured capacity)")
    p.add_argument("--loads", type=float, nargs="+", default=[0.25, 0.5, 0.8])
    p.add_argument("--capacity", type=float, default=None,
                   help="skip the capacity probe and use this QPS")
    p.add_argument("--wire", default="auto", choices=["auto", "uint8", "f32"],
                   help="query upload format (auto: uint8 when the corpus "
                        "is integral in [0,255]: lossless, 4x less upload)")
    p.add_argument("--profile", action="store_true",
                   help="saturated run: trace the timed region for the device's busy share")
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", action="store_true")
    p.add_argument("--outdir", default="results",
                   help='persist the result dict as a stamped JSON artifact ("" disables)')
    args = p.parse_args(argv)
    if args.open_loop:
        r = run_load_curve(dataset=args.dataset, batch=args.batch,
                           nprobe=args.nprobe, k=args.k,
                           requests=args.requests,
                           max_delay_ms=args.max_delay_ms,
                           inflight=args.inflight, loads=tuple(args.loads),
                           capacity=args.capacity, quiet=args.json,
                           wire=args.wire, device=args.device)
    else:
        r = run(dataset=args.dataset, batch=args.batch, nprobe=args.nprobe,
                k=args.k, requests=args.requests,
                max_delay_ms=args.max_delay_ms,
                inflight=args.inflight, recover_passes=args.recover_passes,
                quiet=args.json, wire=args.wire, profile=args.profile, device=args.device)
    if args.json:
        print(json.dumps(r))
    if args.outdir:
        os.makedirs(args.outdir, exist_ok=True)
        mode = "openloop" if args.open_loop else "serving"
        path = os.path.join(
            args.outdir,
            f"executor_{mode}_b{args.batch}_{time.strftime('%Y%m%d_%H%M%S')}.json")
        with open(path, "w") as f:
            json.dump(r, f, indent=1)
        print(f"[bench_executor] artifact: {path}", flush=True)


if __name__ == "__main__":
    main()
