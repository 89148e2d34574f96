"""Pre-build every artifact the benchmarks need (counterpart:
``rag_on_edge_tpu/harness/warmup.py``).

Run this before a benchmark (``python -m
rag_on_edge_tpu_torch.harness.warmup``): it builds every kernel library
into the build directory (``utils/cache.py``), synthesizes and caches the
datasets and their ground truth, builds the canonical 1M IVF indexes, and
runs each search the benchmark runs once, so a timed run builds nothing.
The JAX package warms its persistent compilation cache the same way; the
port has no program to compile but its kernels, so after the libraries
the later stages mostly pay for data, indexes and first calls.

Each stage prints its wall time (flushed); every stage is resumable
(dataset files, the k-means checkpoint, index artifacts and the kernel
libraries all persist).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from rag_on_edge_tpu_torch.harness import bench_ivf
from rag_on_edge_tpu_torch.models.brute_force import BruteForceIndex
from rag_on_edge_tpu_torch.ops import _build
from rag_on_edge_tpu_torch.utils import datasets
from rag_on_edge_tpu_torch.utils.cache import enable_compilation_cache

__all__ = ["KERNEL_SOURCES", "main"]

# Every kernel source of csrc/, one library each.
KERNEL_SOURCES = tuple(sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu")))


def _stage(name: str) -> float:
    print(f"[warmup] {name} ...", flush=True)
    return time.monotonic()


def _done(t0: float, device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"[warmup]   done in {time.monotonic() - t0:.1f}s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cache_dir = enable_compilation_cache()
    t = _stage(f"kernel libraries ({len(KERNEL_SOURCES)} sources, one nvcc each) into "
               f"{cache_dir}")
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as ex:
        list(ex.map(_build.load_library, KERNEL_SOURCES))
    _done(t, dev)

    t = _stage("siftsmall dataset (synth + GT)")
    ds_small = datasets.load_dataset("siftsmall", gt_k=10, device=dev)
    _done(t, dev)

    t = _stage("sift (1M) dataset (synth + GT; first run ~minutes)")
    ds = datasets.load_dataset("sift", gt_k=10, device=dev)
    _done(t, dev)

    t = _stage("1M IVF index build/load (nlist=1024 l2 int8 pb=2048)")
    idx = bench_ivf.build_or_load_index(ds, nlist=1024, metric="l2", dtype="int8",
                                        pad_block=2048, device=dev)
    _done(t, dev)

    dim = ds.queries.shape[1]
    t = _stage("first call: IVF search_device B=8192 np=4 k=10")
    qs = torch.from_numpy(np.resize(ds.queries, (8192, dim)).astype(np.float32)).to(dev)
    idx.search_device(qs, 10, 4, mode="cluster")
    _done(t, dev)

    t = _stage("1M IVF pb=512 variant build/load + first call")
    idx512 = bench_ivf.build_or_load_index(ds, nlist=1024, metric="l2", dtype="int8",
                                           pad_block=512, device=dev)
    idx512.search_device(qs, 10, 4, mode="cluster")
    del idx512
    _done(t, dev)

    t = _stage("first call: serving shape B=16384 np=4 rp=1, f32 and uint8 queries")
    qs16 = torch.from_numpy(np.resize(ds.queries, (16384, dim)).astype(np.float32)).to(dev)
    idx.search_device(qs16, 10, 4, mode="cluster", recover_passes=1)
    # The serving path uploads uint8 (lossless for integral corpora).
    idx.search_device(qs16.to(torch.uint8), 10, 4, mode="cluster", recover_passes=1)
    del qs16
    _done(t, dev)

    t = _stage("first call: brute 1M rescored (accum) + exact (pallas) B=8192 k=10")
    brute = BruteForceIndex(ds.base, metric="l2", dtype="int8", device=dev)
    brute.search_device(qs, 10)
    del brute
    brute_x = BruteForceIndex(ds.base, metric="l2", dtype="int8", engine="pallas", device=dev)
    brute_x.search_device(qs, 10)
    del brute_x
    _done(t, dev)

    # The 10M index only where its cache exists (its build is ~an hour).
    for nlist10, np10 in ((8192, 4), (4096, 8)):
        cache10 = os.path.join(
            bench_ivf.DEFAULT_DATA_ROOT, "sift10m",
            f"ivf_nlist{nlist10}_l2_int8_seed42_pb2048_pp_sp0.1", "ivf_config.json")
        if os.path.exists(cache10):
            t = _stage(f"10M IVF load + first call (nlist={nlist10} eps=0.1 np={np10} B=8192)")
            ds10 = datasets.load_dataset("sift10m", gt_k=10, device=dev)
            idx10 = bench_ivf.build_or_load_index(ds10, nlist=nlist10, metric="l2",
                                                  dtype="int8", pad_block=2048,
                                                  store="compact", spill_eps=0.1, device=dev)
            qs10 = torch.from_numpy(
                np.resize(ds10.queries, (8192, dim)).astype(np.float32)).to(dev)
            idx10.search_device(qs10, 10, np10, mode="cluster")
            del idx10, ds10, qs10
            _done(t, dev)
            break
    else:
        print("[warmup] 10M index cache absent — skipping (sweep10m builds it)", flush=True)

    t = _stage("first call: siftsmall brute (single batch + stream of 64)")
    small = BruteForceIndex(ds_small.base, dtype="int8", device=dev)
    small.compile(32, 5)
    stream = torch.from_numpy(
        np.resize(ds_small.queries, (64 * 32, ds_small.queries.shape[1]))
        .reshape(64, 32, -1).astype(np.float32)).to(dev)
    small.search_stream_device(stream, 5)
    _done(t, dev)

    print("[warmup] every benchmark artifact built and every first call made", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
