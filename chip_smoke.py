#!/usr/bin/env python3
"""Drive the PyTorch port's SIFT-1M IVF search path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its wall time; any failure raises and the
script exits non-zero without a result line:

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile kernels K1 and K4 (CUDA C++, nvcc, in parallel) and
             K2 (Triton) from the sources in this checkout.
3. kernels — build the SIFT-1M index the slice searches, route one real
             B=8192 batch, and hold each kernel against its plain PyTorch
             version on the card at the slice's shapes (bit-equal planes,
             exactly equal top-k; K4 at the recovery pass's shapes from
             this batch's dropped pairs and at the dense grouped walk's),
             with median times of both and each kernel's bound.
4. slice   — search all 10,000 queries through ``IVFIndex.search_device``
             with its defaults (nlist=1024, nprobe=4, k=10, B=8192, int8,
             pad_block=2048; the recovery pass where the auto policy turns
             it on), with the launch counters reset just before and read
             just after; require K1, K4 and K2 launched and no residual
             spill; check recall@10 and recall@1 against exact ground truth
             beside the recall without recovery, and time one B=8192 call
             and its stages.
5. grouped — the same queries through ``engine="pallas"`` (kernel K4 over
             the dense block walk): recall and one B=8192 call's time.

The last two lines are the kernel table as JSON and the result line
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

N_BASE, N_QUERIES, DIM, N_CENTERS = 1_000_000, 10_000, 128, 4096  # DATASET_SPECS["sift"]
NLIST, PAD_BLOCK, K, NPROBE, BATCH = 1024, 2048, 10, 4, 8192
REPS = 10
# H100 SXM5 peaks at a 700 W power limit (NVIDIA's data sheet): HBM3 bytes/s,
# dense int8 tensor-core ops/s, and 32-bit non-tensor ops/s.
HBM_BYTES_S, INT8_OPS_S, OPS32_S = 3.35e12, 1979e12, 67e12


def phase(name: str, t0: float, msg: str) -> None:
    print(f"[{name}] {time.time() - t0:.1f}s {msg}", flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = REPS) -> float:
    """Median device time of ``fn()`` in ms (CUDA events, after a warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float, ops_rate: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes
    over the memory rate and the operations over their peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def walked_blocks(np, block_first, block_last, rows_valid) -> int:
    """Blocks a cluster-major kernel reads: those with rows in a run of
    blocks that ends at a ``block_last`` (the run starts at the latest
    ``block_first``)."""
    bf, bl, rv = (x.cpu().numpy() for x in (block_first, block_last, rows_valid))
    walked = 0
    for t in np.nonzero(bl)[0]:
        b = t
        while b > 0 and bf[b] == 0:
            b -= 1
        walked += int((rv[b:t + 1] > 0).sum())
    return walked


def main() -> None:
    import torch

    t0 = time.time()
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch sees none")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from concurrent.futures import ThreadPoolExecutor

    from rag_on_edge_tpu_torch import IVFIndex
    from rag_on_edge_tpu_torch.ops import _build, fused_topk, ivf_accum, ivf_scan
    from rag_on_edge_tpu_torch.utils.datasets import ground_truth, make_synthetic
    from rag_on_edge_tpu_torch.utils.metrics import recall_at_k

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    phase("device", t0, f"{kind} x{torch.cuda.device_count()} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    t = time.time()
    with ThreadPoolExecutor(2) as ex:  # one nvcc per source, side by side
        list(ex.map(_build.load_library, ["ivf_accum_planes", "ivf_grouped_scan"]))
    nvcc_s = time.time() - t
    t = time.time()
    fused_topk.fused_topk(torch.zeros((4, NPROBE * 256), dtype=torch.int32, device=dev), 2 * K)
    torch.cuda.synchronize()
    phase("build", t0, f"K1 + K4 nvcc {nvcc_s:.1f}s, K2 triton {time.time() - t:.1f}s")

    # ---- set-up shared by phases 3 and 4: the SIFT-1M corpus and index.
    t = time.time()
    base, queries = make_synthetic(N_BASE, N_QUERIES, DIM, N_CENTERS, seed=42)
    phase("setup", t0, f"make_synthetic {time.time() - t:.1f}s")
    t = time.time()
    idx = IVFIndex.build(base, nlist=NLIST, metric="l2", dtype="int8",
                         pad_block=PAD_BLOCK, seed=42, max_iter=25, device=dev)
    idx._ensure_kernel_state()
    torch.cuda.synchronize()
    nblocks = idx._arrays["vectors_t"].shape[0]
    phase("setup", t0, f"IVFIndex.build {time.time() - t:.1f}s nblocks={nblocks} "
          f"n_padded={idx.n_padded} max_cluster={idx.max_cluster_size}")
    t = time.time()
    gt = ground_truth(base, queries, K, metric="l2", device=dev)
    phase("setup", t0, f"ground truth {time.time() - t:.1f}s")

    # ---- phase 3: each kernel against its plain version on one routed batch.
    qcap = idx._auto_qcap(BATCH, NPROBE)
    q = torch.from_numpy(np.ascontiguousarray(queries[:BATCH])).to(dev)
    probes, cq, slot, lossy, _ = idx._route(q, NPROBE, qcap)
    qi, qb, bias, bias_rows, alpha = idx._scan_inputs(q, cq)
    a = idx._arrays
    k1_args = (qb, a["vectors_t"], a["block_first"], a["block_last"], a["rows_valid"])
    pp = ivf_accum.cluster_major_accum_planes(*k1_args, blk=PAD_BLOCK, bias_rows=bias_rows)
    pp_ref = ivf_accum.cluster_major_accum_planes_reference(*k1_args, blk=PAD_BLOCK,
                                                            bias_rows=bias_rows)
    torch.cuda.synchronize()
    rows = torch.nonzero(a["block_last"]).flatten()
    k1_err = int((pp[rows].long() - pp_ref[rows].long()).abs().max())
    if k1_err:
        raise AssertionError(f"K1 planes differ from the plain version: max |err| {k1_err}")
    del pp_ref
    k1_ms = cuda_ms(torch, lambda: ivf_accum.cluster_major_accum_planes(
        *k1_args, blk=PAD_BLOCK, bias_rows=bias_rows))
    k1_plain_ms = cuda_ms(torch, lambda: ivf_accum.cluster_major_accum_planes_reference(
        *k1_args, blk=PAD_BLOCK, bias_rows=bias_rows))
    walked = walked_blocks(np, *k1_args[2:])
    k1_bound = bound(walked * (qcap * DIM + DIM * PAD_BLOCK + PAD_BLOCK * 4)
                     + rows.numel() * pp[0].numel() * 4,
                     2.0 * walked * qcap * PAD_BLOCK * DIM, INT8_OPS_S)
    phase("kernels", t0, f"K1 qg {tuple(qb.shape)} vectors_t {tuple(a['vectors_t'].shape)} "
          f"bias {tuple(bias_rows.shape)} qcap={qcap} lossy pairs={int(lossy.sum())}: "
          f"bit-equal on {rows.numel()} last blocks; {k1_ms} ms vs plain {k1_plain_ms} ms; "
          f"bound {k1_bound[0]} ms by {k1_bound[1]} ({walked} blocks walked)")

    pool = idx._join_pool(probes, slot, pp)
    kk = 2 * K
    ties = torch.from_numpy(np.random.default_rng(0).integers(
        0, 8, pool.shape, dtype=np.int32)).to(dev)
    ties[::97] = ivf_accum.KMIN
    k2_err = 0
    for name, x in (("pool", pool), ("ties", ties)):
        v, i = fused_topk.fused_topk(x, kk)
        rv, ri = fused_topk.fused_topk_reference(x, kk)
        torch.cuda.synchronize()
        err = max(int((v.long() - rv.long()).abs().max()), int((i - ri).abs().max()))
        if err:
            raise AssertionError(f"K2 differs from the plain version on {name}: {err}")
        k2_err = max(k2_err, err)
    k2_ms = cuda_ms(torch, lambda: fused_topk.fused_topk(pool, kk))
    k2_plain_ms = cuda_ms(torch, lambda: fused_topk.fused_topk_reference(pool, kk))
    k2_lib_ms = cuda_ms(torch, lambda: torch.topk(pool, kk, dim=1))
    k2_bound = bound(pool.numel() * 4 + pool.shape[0] * kk * 8, kk * pool.numel(), OPS32_S)
    phase("kernels", t0, f"K2 {tuple(pool.shape)} int32 k={kk}: exactly equal on the "
          f"joined pool and a tie-heavy matrix; {k2_ms} ms vs plain {k2_plain_ms} ms, "
          f"torch.topk {k2_lib_ms} ms; bound {k2_bound[0]} ms by {k2_bound[1]}")

    # K4 at the recovery pass's own inputs (this batch's lossy pairs, the
    # default recover_qcap and recover_blocks), then at the dense grouped walk.
    rq = qcap
    rb = -(-(nblocks // 4) // idx.CM_GROUP) * idx.CM_GROUP
    k4_rec, _, _, _ = idx._recover_tables(qi, probes, lossy, bias, rq, rb)
    k4_dense = (*k1_args, bias, None)
    k4 = {}
    for name, (qg_, vt_, bf_, bl_, rv_, bias_, rb_) in (("recovery", k4_rec),
                                                         ("dense", k4_dense)):
        kw = dict(k=kk, blk=PAD_BLOCK, group=idx.CM_GROUP, bias=bias_, row_base=rb_)
        args = (qg_, vt_, bf_, bl_, rv_)
        pv, pr = ivf_scan.cluster_major_scan_grouped(*args, **kw)
        rpv, rpr = ivf_scan.cluster_major_scan_grouped_reference(*args, **kw)
        torch.cuda.synchronize()
        r4 = torch.nonzero(bl_).flatten()
        fin = rpv[r4] > float("-inf")
        if not torch.equal(pv[r4], rpv[r4]) or not torch.equal(pr[r4][fin], rpr[r4][fin]):
            raise AssertionError(f"K4 differs from the plain version at the {name} shapes")
        err = float((pv[r4][fin] - rpv[r4][fin]).abs().max()) if fin.any() else 0.0
        del rpv, rpr
        walked = walked_blocks(np, bf_, bl_, rv_)
        k4[name] = dict(
            err=err, ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_grouped(*args, **kw)),
            plain_ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_grouped_reference(
                *args, **kw)),
            bound=bound(walked * (qcap * DIM + DIM * PAD_BLOCK + PAD_BLOCK * 4)
                        + r4.numel() * qcap * kk * 8,
                        2.0 * walked * qcap * PAD_BLOCK * DIM, INT8_OPS_S))
        phase("kernels", t0, f"K4 {name}: qg {tuple(qg_.shape)} vectors_t {tuple(vt_.shape)} "
              f"bias {tuple(bias_.shape)} k={kk}: pv bit-equal, pr equal where finite, on "
              f"{r4.numel()} last blocks ({int(fin.sum())} finite entries, {walked} blocks "
              f"walked); {k4[name]['ms']} ms vs plain {k4[name]['plain_ms']} ms; bound "
              f"{k4[name]['bound'][0]} ms by {k4[name]['bound'][1]}")

    def search_all(**kw):
        """All queries in B=BATCH batches (the tail padded cyclically) →
        (ids, scores, per-batch residual spill, wall s)."""
        t = time.time()
        ids_parts, score_parts, residual = [], [], []
        for s in range(0, N_QUERIES, BATCH):
            chunk = queries[s:s + BATCH]
            qs = torch.from_numpy(np.resize(chunk, (BATCH, DIM))).to(dev)
            vals, ids, _ = idx.search_device(qs, K, NPROBE, **kw)
            ids_parts.append(ids.cpu().numpy()[:chunk.shape[0]])
            score_parts.append(vals.cpu().numpy()[:chunk.shape[0]])
            residual.append(int(idx.last_spill))
        ids, scores = np.concatenate(ids_parts), np.concatenate(score_parts)
        if ids.shape != (N_QUERIES, K) or not np.isfinite(scores).all() or (ids < 0).any():
            raise AssertionError(f"search {kw} output has the wrong shape, -1 ids or "
                                 "non-finite scores")
        return ids, residual, time.time() - t

    def recalls(ids):
        return recall_at_k(ids, gt, K), recall_at_k(ids[:, :1], gt[:, :1], 1)

    # ---- phase 4: the slice through the public entry point, with its defaults.
    ivf_accum.LAUNCHES = fused_topk.LAUNCHES = ivf_scan.LAUNCHES = 0
    ids, residual, wall = search_all()
    launches = {"K1": ivf_accum.LAUNCHES, "K2": fused_topk.LAUNCHES, "K4": ivf_scan.LAUNCHES}
    engine = idx.last_engine
    spilled = [int(idx._route(torch.from_numpy(np.resize(queries[s:s + BATCH], (BATCH, DIM)))
                              .to(dev), NPROBE, qcap)[3].sum()) for s in range(0, N_QUERIES, BATCH)]
    passes = idx._auto_recover_passes(BATCH, NPROBE, rq)
    r10, r1 = recalls(ids)
    ids_norec, _, _ = search_all(recover=False)
    r10_norec, r1_norec = recalls(ids_norec)
    phase("slice", t0, f"{N_QUERIES} queries in B={BATCH} batches {wall:.1f}s: engine={engine} "
          f"auto_recover={idx._auto_recover(BATCH, NPROBE)} spilled before recovery="
          f"{spilled} residual last_spill={residual} passes={passes} recover_qcap={rq} "
          f"recover_blocks={rb} launches={launches} recall@10={r10:.4f} recall@1={r1:.4f} "
          f"(recover=False: recall@10={r10_norec:.4f} recall@1={r1_norec:.4f})")
    if min(launches.values()) < 1:
        raise AssertionError(f"the main path did not launch every kernel: {launches}")
    if any(residual):
        raise AssertionError(f"pairs still dropped after recovery: {residual}")
    if r10 < 0.99 or r1 < 0.99:
        raise AssertionError(f"recall below 0.99: recall@10 {r10}, recall@1 {r1}")
    if r10 < r10_norec or r1 < r1_norec:
        raise AssertionError("the recovery pass lowered recall")

    qs = torch.from_numpy(np.ascontiguousarray(queries[:BATCH])).to(dev)
    search_ms = cuda_ms(torch, lambda: idx.search_device(qs, K, NPROBE))
    norec_ms = cuda_ms(torch, lambda: idx.search_device(qs, K, NPROBE, recover=False))
    extra, _ = idx._recover(qi, probes, lossy, bias, alpha, kk, rq, rb, passes)
    stages = {
        "route": lambda: idx._route(qs, NPROBE, qcap),
        "prep": lambda: idx._scan_inputs(qs, cq),
        "K1": lambda: idx._scan(qb, bias_rows),
        "recover": lambda: idx._recover(qi, probes, lossy, bias, alpha, kk, rq, rb, passes),
        "finish": lambda: idx._cm_finish_planes(qs, probes, slot, pp, K, kk, True, alpha,
                                                extra=extra),
        # Not a stage of the default call: the finish without the
        # recovery pass's candidates, for the cost of joining them.
        "finish_without_recovered": lambda: idx._cm_finish_planes(
            qs, probes, slot, pp, K, kk, True, alpha),
    }
    stage_ms = {name: cuda_ms(torch, fn) for name, fn in stages.items()}
    phase("slice", t0, f"one B={BATCH} search_device: {search_ms} ms median = "
          f"{BATCH / search_ms * 1e3:,.0f} QPS on {card} (information, not a claim); "
          f"with recover=False {norec_ms} ms; stages ms {stage_ms}")

    # ---- phase 5: the grouped engine (K4 over the dense block walk).
    ids_g, residual_g, wall_g = search_all(engine="pallas")
    r10_g, r1_g = recalls(ids_g)
    grouped_ms = cuda_ms(torch, lambda: idx.search_device(qs, K, NPROBE, engine="pallas"))
    phase("grouped", t0, f"engine=pallas {N_QUERIES} queries {wall_g:.1f}s: residual "
          f"last_spill={residual_g} recall@10={r10_g:.4f} recall@1={r1_g:.4f}; one B={BATCH} "
          f"call {grouped_ms} ms")
    if r10_g < 0.99:
        raise AssertionError(f"engine='pallas' recall@10 {r10_g} below 0.99")

    kernels = [
        {"name": "cluster_major_accum_planes", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/ivf_accum_planes.cu",
         "replaces": "rag_on_edge_tpu/ops/pallas_ivf_dma.py:371",
         "launches": launches["K1"], "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": None},
        {"name": "fused_topk", "route": "triton",
         "source": "rag_on_edge_tpu_torch/csrc/fused_topk_triton.py",
         "replaces": "rag_on_edge_tpu/ops/pallas_topk.py:39",
         "launches": launches["K2"], "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "library_ms": k2_lib_ms},
        {"name": "cluster_major_scan_grouped", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/ivf_grouped_scan.cu",
         "replaces": "rag_on_edge_tpu/ops/pallas_ivf.py:144",
         "launches": launches["K4"], "max_abs_err": max(k4[n]["err"] for n in k4),
         "ms": k4["recovery"]["ms"], "plain_ms": k4["recovery"]["plain_ms"],
         "bound_ms": k4["recovery"]["bound"][0], "bound_by": k4["recovery"]["bound"][1],
         "library_ms": None},
    ]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
