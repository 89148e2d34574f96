#!/usr/bin/env python3
"""Drive the PyTorch port's SIFT-1M search paths once on one NVIDIA GPU:
the IVF index (its default engine, the grouped engine and the routed
engine), the brute-force index, both sharded over 4 logical shards on
the card, the kernel lab on the same index, the spatial GEMM, the
hardware probes, the float (fp32 and bf16) IVF and brute-force indexes
with the library's defaults, the float sharded index, routed engine and
kernel lab, and the query-major mode and xla engine of the IVF index.

    python3 chip_smoke.py

Phases, each printed with its wall time; any failure raises and the
script exits non-zero without a result line:

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile kernels K1 + K9, K4 + K6 + K7 + K10, K3, K5, K8 and
             K11-K14 (CUDA C++, one nvcc per source, all at once) and K2
             (Triton)
             from the sources in this checkout.
   setup   — the corpus, the IVF index, and the exact ground truth two
             ways: the plain branch (the recall reference below) and
             kernel K3 in fp32 (the 2 GiB rule picks it at SIFT-1M); the
             two must be equal on all 10,000 queries.
3. kernels — build the SIFT-1M index the slice searches, route one real
             B=8192 batch, and hold each kernel against its plain PyTorch
             version on the card at the slice's shapes (bit-equal planes,
             exactly equal top-k; K4 at the recovery pass's shapes from
             this batch's dropped pairs and at the dense grouped walk's;
             K7 at the same two walks, also against K4 on the gathered
             table; K9, which no search calls, at the batch's routed table
             twice, int8 IP and int8 L2 with its 4-bit bias rows, with its
             launches counted over those two calls), with median times of
             both and each kernel's bound.
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
6. routed  — the same queries through ``engine="pallas_routed"`` (kernel
             K7, the routing inside the kernel, in the main walk and in
             every recovery pass), counters reset just before and read just
             after: ids and scores equal to ``engine="pallas"``, K7 launched
             and K4 not, residual spill 0, recall@10 >= 0.99; one B=8192
             call and its stages.
7. brute   — ``BruteForceIndex(base, metric="l2", dtype="int8")`` two ways:
             the defaults (``engine="auto"``: accum, kernel K5, rescored)
             and ``engine="pallas", rescore=True`` (kernel K3 binned).
             K3 (int8 L2 binned and int8 IP exact) and K5 are held against
             their plain versions on a B=512 slice of real queries over the
             full base (exactly equal) and timed at B=8192; then all
             10,000 queries through each engine with the counters reset
             just before and read just after; recall@10 >= 0.99 (accum)
             and >= 0.999 (pallas) against the plain ground truth.
8. coarse  — one B=8192 batch through the fused coarse tier (kernel K3 on
             the augmented centroids) of a second IVF index over the same
             arrays, its tier threshold lowered on a subclass: K3 launched,
             probes equal to the fp32 tier's except at stated near-ties.
9. sharded — the same IVF index as ``ShardedIVFIndex`` over 4 logical
             shards on this card: kernel K6 held against its plain version
             at one shard's dense-walk shapes and at the recovery pass's;
             then all 10,000 queries through ``search_device(q, 10, 4,
             mode="cluster")`` with its defaults (K1, the recovery pass
             through K6, K2; counters reset just before and read just after;
             recall@10 and @1 >= 0.99, residual spill 0), through
             ``engine="pallas"`` (K6 over every shard's walk, recall@10 >=
             0.99), and through ``mode="query"`` at B=128 (recall@10 >=
             0.99); and ``ShardedBruteForceIndex(base, metric="l2",
             dtype="int8", rescore=True)`` (K3 per shard, recall@10 >=
             0.999).  One call of each timed with CUDA events.
10. lab    — the kernel lab (``harness/kernel_lab.py``) on the same index at
             its defaults (qcap 128, k 20, 128 bins, B=2048, nprobe 4, one
             fixed routing): kernel K10 in its four variants held against
             its plain version on each variant's defined windows, ``full``
             also against K6 on the same table; then the lab itself with
             the counters reset just before and read just after, printing
             its ms/call and µs/block for each variant.
11. gemm   — the index is freed first.  Kernel K8 (int8 on ``mma.sync``,
             bf16 on ``wgmma`` fed by TMA, fp32 on a ``cp.async`` FFMA tile)
             against its plain version at a ragged shape in int8 (exact),
             bf16 and fp32 (within the worst-case fp32 summation bound), and
             in bf16 and fp32 at the float kernels' edges (M 1, 65, 1153; N
             30, 257, 513; K 8, 72, 4096); the full-width int8 product
             [8192,128] x [128,1M] (the SIFT-1M scoring GEMM, 32.8 GB of
             int32 out) held exactly against the plain version in column
             chunks and timed beside ``torch._int_mm``; bf16 and fp32 at
             4096^3 beside ``torch.mm`` (TF32 off); the skinny bf16 product
             [8192,128] x [128,131072] (4.3 GB of f32 out) held in column
             chunks and timed beside ``torch.mm(out_dtype=float32)``; then,
             counters reset just before and read just after,
             ``spatial_matmul`` on a 1x1 and a logical 2x2 grid of this card
             through K8 and the plain product in int8, bf16 and fp32
             (``verify_matmul`` must pass; every K8 mode launched) and
             ``bench_gemm.run(128, 128, 10240, "int8")``, the AIE reference
             workload, whose result dict is printed.
12. probe  — the hardware probes (``harness/hw_probe.py``): kernels K11-K14
             against their plain versions at ragged shapes and at one JAX
             size each (K11 g=4096 moving; K12 the int8 512 MB walk at
             blk=2048 with and without the product; K13 the int8 2 GiB walk
             at depth 8; K14 (256, 2048) at g=2048 in int8 on mma.sync and
             on __dp4a, and in bf16), K12 and K14 in their value and in
             every step's max (K12 over walks with a planted max in every
             step), K13 with one value planted at a time across the walk
             (also in bf16 where its ring wraps, and past the walk), each
             timed beside its plain version
             and, for K12 and K13, ``data.amax()``; then, counters reset
             just before and read just after, the five probes at the JAX
             sizes through ``hw_probe.main([])``, and the ceilings they
             measure, one a line.
13. float  — the float modes of K1, K4, K5 and K3, held bit-equal to their
             plain versions at ragged sizes (D' odd, N and B off the
             tiles) on integer data, and K5's and K3's bf16 modes (the
             tensor cores) on non-integer data within the order bound
             2·D·2^-24·(|q|@|b|) of the row; then an fp32 ``IVFIndex`` (the default
             dtype; nlist=1024, L2, pad_block=2048, the int8 index's
             centroids) and the same index in bf16: K1 on one routed B=8192
             batch and K4 at its recovery list held bit-equal to their
             plain versions, then all 10,000 queries through
             ``search_device(q, 10, 4)`` with its defaults, counters reset
             just before and read just after (engine pallas_accum, K1 and
             the recovery pass's K4 launched, residual spill 0; fp32
             recall@10 >= 0.99 and recall@1 >= the int8 index's), one call
             and its stages timed; ``BruteForceIndex(base)`` with every
             default (ip, bf16, accum = K5, rescored; recall@10 >= 0.99
             against the plain IP ground truth) and an fp32 L2 accum index
             (K5 fp32 on the augmented dimension; >= 0.99), K5 held
             bit-equal at B=8192 and timed beside the GEMM alone
             (``torch.mm``); ``BruteForceIndex(base, metric="l2",
             dtype="bf16", engine="pallas", rescore=True)`` (K3 bf16, held
             bit-equal at B=1024 with nbins 0 and 128; ids equal to the
             plain path's, K3's plain version and the same rescore, on all
             10,000 queries; recall@10 >= 0.99: the bf16 rounding of the
             augmented column costs it the int8 path's 0.999).
14. floatscan, query — the float modes of K6, K7, K9 and K10, held
             bit-equal to their plain versions at ragged sizes (D' 37, 129
             and 320, 40 routed rows, a batch of 70) on integer data; then,
             on phase 13's fp32 and bf16 indexes rebuilt from its arrays: K7
             at the dense walk and a recovery list, and
             ``search_device(q, 10, 4, engine="pallas_routed")`` over all
             queries, counted (K7 alone; ids and scores equal to
             ``engine="pallas"``); K9 at K1's shapes, counted; K10's four
             variants on a float routed table at the lab's defaults, then the
             lab, counted; ``ShardedIVFIndex(index, [cuda:0] * 4)``: K6 at
             shard 0's dense walk and at a recovery list, then
             ``search_device(q, 10, 4, mode="cluster")`` with its defaults
             (K1, K6 in the recovery pass, K2; counted; spill 0, recall@10
             >= 0.99, @1 >= the fp32 index's, both within 0.001 of the single
             index of the same dtype) and with ``engine="pallas"``.  Then, on
             the fp32, bf16 and int8 indexes, ``IVFIndex.search(q, 10)`` with
             its defaults (nprobe 16, auto mode → query) over all queries at
             B=32, recall@10 no lower than the cluster mode's at nprobe 16,
             and the median of 100 one-query calls; and ``engine="xla"`` at
             B=8192 (recall@10 >= 0.99; where its routing dropped none of a
             query's pairs and its answer lies in the default engine's
             rescore pool, ids equal to the default engine's, or a tie).

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
BF16_OPS_S = 989e12  # dense bf16 tensor-core FLOP/s: the bound of the bf16 modes


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

    from rag_on_edge_tpu_torch import BruteForceIndex, IVFIndex
    from rag_on_edge_tpu_torch.harness import bench_gemm, hw_probe, kernel_lab, timing
    from rag_on_edge_tpu_torch.models import ivf as ivf_mod
    from rag_on_edge_tpu_torch.ops import (_build, bruteforce_accum, bruteforce_fused,
                                           fused_topk, ivf_accum, ivf_scan, quantize,
                                           tiled_matmul)
    from rag_on_edge_tpu_torch.utils.datasets import ground_truth, make_synthetic
    from rag_on_edge_tpu_torch.utils.metrics import recall_at_k

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    phase("device", t0, f"{kind} x{torch.cuda.device_count()} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    t = time.time()
    sources = ["ivf_accum_planes", "ivf_grouped_scan", "bruteforce_fused", "bruteforce_accum",
               "tiled_matmul", "hw_probe"]
    with ThreadPoolExecutor(len(sources)) as ex:  # one nvcc per source, all at once
        list(ex.map(_build.load_library, sources))
    nvcc_s = time.time() - t
    t = time.time()
    fused_topk.fused_topk(torch.zeros((4, NPROBE * 256), dtype=torch.int32, device=dev), 2 * K)
    torch.cuda.synchronize()
    phase("build", t0, f"K1 + K9, K4 + K6 + K7 + K10, K3, K5, K8, K11-K14 nvcc {nvcc_s:.1f}s, "
          f"K2 triton {time.time() - t:.1f}s")

    def reset_launches():
        for mod in (ivf_accum, fused_topk, ivf_scan, bruteforce_fused, bruteforce_accum,
                    kernel_lab):
            mod.LAUNCHES = 0
        ivf_scan.CLUSTER_LAUNCHES = ivf_scan.ROUTED_LAUNCHES = ivf_accum.ACCUM_LAUNCHES = 0
        for counts in (hw_probe.LAUNCHES, tiled_matmul.LAUNCHES):
            for key in counts:
                counts[key] = 0

    def read_launches():
        return {"K1": ivf_accum.LAUNCHES, "K2": fused_topk.LAUNCHES, "K3": bruteforce_fused.LAUNCHES,
                "K4": ivf_scan.LAUNCHES, "K5": bruteforce_accum.LAUNCHES,
                "K6": ivf_scan.CLUSTER_LAUNCHES, "K7": ivf_scan.ROUTED_LAUNCHES,
                "K8": sum(tiled_matmul.LAUNCHES.values()), "K9": ivf_accum.ACCUM_LAUNCHES,
                "K10": kernel_lab.LAUNCHES, **hw_probe.LAUNCHES}

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
    # The plain branch (a [512, N] fp32 score matrix is 2.05e9 bytes, under
    # the 2 GiB rule) is the recall reference; the default chunk of 1024
    # rows passes the rule and takes kernel K3 (exact fp32, k=10).
    t = time.time()
    gt = ground_truth(base, queries, K, metric="l2", device=dev, query_chunk=512)
    torch.cuda.synchronize()
    gt_plain_s = time.time() - t
    reset_launches()
    t = time.time()
    gt_fused = ground_truth(base, queries, K, metric="l2", device=dev)
    torch.cuda.synchronize()
    gt_launches = read_launches()["K3"]
    phase("setup", t0, f"ground truth: plain branch {gt_plain_s:.1f}s, K3 branch "
          f"{time.time() - t:.1f}s ({gt_launches} K3 launches); ids equal on "
          f"{int((gt_fused == gt).all(axis=1).sum())} of {N_QUERIES} queries")
    if gt_launches < 1:
        raise AssertionError("the fused ground truth did not launch K3")
    if not np.array_equal(gt_fused, gt):
        raise AssertionError("the K3 ground truth differs from the plain branch")

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

    # K7 at the same two walks: the routed table never exists, the kernel
    # gathers from the batch qi through cq_blocks.  Held against its plain
    # version and against K4 on the gathered table (the inputs above).
    k7_rec, _, _, _ = idx._recover_tables(qi, probes, lossy, bias, rq, rb, routed=True)
    k7_dense = (cq[a["block_cluster"].long()].unsqueeze(-1).contiguous(), *k1_args[1:], bias,
                None)
    k7 = {}
    for name, (cqb_, vt_, bf_, bl_, rv_, bias_, rb_), k4_in in (
            ("recovery", k7_rec, k4_rec), ("dense", k7_dense, k4_dense)):
        kw = dict(k=kk, blk=PAD_BLOCK, group=idx.CM_GROUP, bias=bias_, row_base=rb_)
        args = (qi, cqb_, vt_, bf_, bl_, rv_)
        pv, pr = ivf_scan.cluster_major_scan_routed(*args, **kw)
        rpv, rpr = ivf_scan.cluster_major_scan_routed_reference(*args, **kw)
        gpv, gpr = ivf_scan.cluster_major_scan_grouped(*k4_in[:5], **kw)
        torch.cuda.synchronize()
        r7 = torch.nonzero(bl_).flatten()
        fin = rpv[r7] > float("-inf")
        if not torch.equal(pv[r7], rpv[r7]) or not torch.equal(pr[r7][fin], rpr[r7][fin]):
            raise AssertionError(f"K7 differs from the plain version at the {name} shapes")
        if not torch.equal(pv[r7], gpv[r7]) or not torch.equal(pr[r7][fin], gpr[r7][fin]):
            raise AssertionError(f"K7 differs from K4 on the gathered table at the {name} shapes")
        err = float((pv[r7][fin] - rpv[r7][fin]).abs().max()) if fin.any() else 0.0
        del rpv, rpr, gpv, gpr
        walked = walked_blocks(np, bf_, bl_, rv_)
        k7[name] = dict(
            err=err, ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_routed(*args, **kw)),
            plain_ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_routed_reference(
                *args, **kw)),
            # K4's convention with the batch read once instead of a table,
            # and the walked blocks' rows of cq_blocks.
            bound=bound(walked * (qcap * 4 + DIM * PAD_BLOCK + PAD_BLOCK * 4) + qi.numel()
                        + r7.numel() * qcap * kk * 8,
                        2.0 * walked * qcap * PAD_BLOCK * DIM, INT8_OPS_S))
        phase("kernels", t0, f"K7 {name}: qi {tuple(qi.shape)} cq_blocks {tuple(cqb_.shape)} "
              f"vectors_t {tuple(vt_.shape)} k={kk}: pv bit-equal to the plain version and to "
              f"K4 on the gathered table, pr equal where finite, on {r7.numel()} last blocks "
              f"({int(fin.sum())} finite entries, {walked} blocks walked); {k7[name]['ms']} ms "
              f"vs plain {k7[name]['plain_ms']} ms; bound {k7[name]['bound'][0]} ms by "
              f"{k7[name]['bound'][1]}")
    del k7_rec, k7_dense

    # K9, the extract emit of K1's scan: no search of either package calls
    # it, so its counted run is these two calls at the batch's routed table
    # (int8 IP, and int8 L2 with the 4-bit bias rows of its JAX docstring).
    k9_inputs = {"int8-IP": None,
                 "int8-L2": ivf_accum.accum_bias_rows(bias, a["rows_valid"])}
    reset_launches()
    k9_out = {name: ivf_accum.cluster_major_accum(*k1_args, kk, blk=PAD_BLOCK, bias_rows=br_)
              for name, br_ in k9_inputs.items()}
    torch.cuda.synchronize()
    k9_launches = read_launches()["K9"]
    if k9_launches != 2:
        raise AssertionError(f"K9 launched {k9_launches} times in its two calls")
    k9 = {}
    for name, br_ in k9_inputs.items():
        pv, pr = k9_out.pop(name)
        rpv, rpr = ivf_accum.cluster_major_accum_reference(*k1_args, kk, blk=PAD_BLOCK,
                                                           bias_rows=br_)
        torch.cuda.synchronize()
        fin = rpv[rows] > float("-inf")
        if not torch.equal(pv[rows], rpv[rows]) or not torch.equal(pr[rows], rpr[rows]):
            raise AssertionError(f"K9 differs from the plain version ({name})")
        err = float((pv[rows][fin] - rpv[rows][fin]).abs().max()) if fin.any() else 0.0
        del pv, pr, rpv, rpr
        walked = walked_blocks(np, *k1_args[2:])
        k9[name] = dict(
            err=err, ms=cuda_ms(torch, lambda: ivf_accum.cluster_major_accum(
                *k1_args, kk, blk=PAD_BLOCK, bias_rows=br_)),
            plain_ms=cuda_ms(torch, lambda: ivf_accum.cluster_major_accum_reference(
                *k1_args, kk, blk=PAD_BLOCK, bias_rows=br_), reps=3),
            bound=bound(walked * (qcap * DIM + DIM * PAD_BLOCK + PAD_BLOCK * 4 * (br_ is not None))
                        + rows.numel() * qcap * kk * 8,
                        2.0 * walked * qcap * PAD_BLOCK * DIM, INT8_OPS_S))
        phase("kernels", t0, f"K9 {name} qg {tuple(qb.shape)} k={kk} bin2: pv bit-equal and pr "
              f"equal to the plain version on {rows.numel()} last blocks ({int(fin.sum())} "
              f"finite entries); {k9[name]['ms']} ms vs plain {k9[name]['plain_ms']} ms; bound "
              f"{k9[name]['bound'][0]} ms by {k9[name]['bound'][1]}")
    del k9_inputs

    def search_all(index, nprobe=NPROBE, **kw):
        """All queries through ``index`` in B=BATCH batches (the tail padded
        cyclically) → (ids, scores, per-batch residual spill, wall s)."""
        t = time.time()
        ids_parts, score_parts, residual = [], [], []
        for s in range(0, N_QUERIES, BATCH):
            chunk = queries[s:s + BATCH]
            qs = torch.from_numpy(np.resize(chunk, (BATCH, DIM))).to(dev)
            vals, ids, _ = index.search_device(qs, K, nprobe, **kw)
            ids_parts.append(ids.cpu().numpy()[:chunk.shape[0]])
            score_parts.append(vals.cpu().numpy()[:chunk.shape[0]])
            residual.append(int(index.last_spill))
        ids, scores = np.concatenate(ids_parts), np.concatenate(score_parts)
        if ids.shape != (N_QUERIES, K) or not np.isfinite(scores).all() or (ids < 0).any():
            raise AssertionError(f"search {kw} output has the wrong shape, -1 ids or "
                                 "non-finite scores")
        return ids, scores, residual, time.time() - t

    def recalls(ids):
        return recall_at_k(ids, gt, K), recall_at_k(ids[:, :1], gt[:, :1], 1)

    # ---- phase 4: the slice through the public entry point, with its defaults.
    reset_launches()
    ids, _, residual, wall = search_all(idx)
    launches = {name: n for name, n in read_launches().items() if name in ("K1", "K2", "K4")}
    engine = idx.last_engine
    spilled = [int(idx._route(torch.from_numpy(np.resize(queries[s:s + BATCH], (BATCH, DIM)))
                              .to(dev), NPROBE, qcap)[3].sum()) for s in range(0, N_QUERIES, BATCH)]
    passes = idx._auto_recover_passes(BATCH, NPROBE, rq)
    r10, r1 = recalls(ids)
    ids_norec, _, _, _ = search_all(idx, recover=False)
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
    ids_g, scores_g, residual_g, wall_g = search_all(idx, engine="pallas")
    r10_g, r1_g = recalls(ids_g)
    grouped_ms = cuda_ms(torch, lambda: idx.search_device(qs, K, NPROBE, engine="pallas"))
    phase("grouped", t0, f"engine=pallas {N_QUERIES} queries {wall_g:.1f}s: residual "
          f"last_spill={residual_g} recall@10={r10_g:.4f} recall@1={r1_g:.4f}; one B={BATCH} "
          f"call {grouped_ms} ms")
    if r10_g < 0.99:
        raise AssertionError(f"engine='pallas' recall@10 {r10_g} below 0.99")

    # ---- phase 6: the routed engine (K7 in the main walk and the recovery pass).
    reset_launches()
    ids_r, scores_r, residual_r, wall_r = search_all(idx, engine="pallas_routed")
    launch_r = read_launches()
    engine_r = idx.last_engine
    r10_r, r1_r = recalls(ids_r)
    n_batches = -(-N_QUERIES // BATCH)
    k7_expected = n_batches * (1 + (passes if idx._auto_recover(BATCH, NPROBE) else 0))
    phase("routed", t0, f"engine={engine_r} {N_QUERIES} queries in B={BATCH} batches "
          f"{wall_r:.1f}s: residual last_spill={residual_r} launches={launch_r} (K7 expected "
          f"{k7_expected}: main walks and recovery passes) recall@10={r10_r:.4f} "
          f"recall@1={r1_r:.4f}; ids equal to engine=pallas: {np.array_equal(ids_r, ids_g)}, "
          f"scores bit-equal: {scores_r.tobytes() == scores_g.tobytes()}")
    if engine_r != "pallas_routed":
        raise AssertionError(f"engine='pallas_routed' ran as {engine_r}")
    if launch_r["K7"] != k7_expected or launch_r["K4"] or launch_r["K1"]:
        raise AssertionError(f"the routed engine's launches are not K7's alone: {launch_r}")
    if not np.array_equal(ids_r, ids_g) or scores_r.tobytes() != scores_g.tobytes():
        raise AssertionError("engine='pallas_routed' differs from engine='pallas'")
    if any(residual_r):
        raise AssertionError(f"routed: pairs still dropped after recovery: {residual_r}")
    if r10_r < 0.99:
        raise AssertionError(f"engine='pallas_routed' recall@10 {r10_r} below 0.99")
    routed_ms = cuda_ms(torch, lambda: idx.search_device(qs, K, NPROBE, engine="pallas_routed"))
    pv_r, pr_r = idx._scan_routed(qi, cq, bias, kk, alpha)
    extra_r, _ = idx._recover(qi, probes, lossy, bias, alpha, kk, rq, rb, passes, routed=True)
    routed_stages = {
        "route": lambda: idx._route(qs, NPROBE, qcap),
        "prep": lambda: idx._query_prep(qs),
        "K7": lambda: idx._scan_routed(qi, cq, bias, kk, alpha),
        "recover": lambda: idx._recover(qi, probes, lossy, bias, alpha, kk, rq, rb, passes,
                                        routed=True),
        "finish": lambda: idx._cm_finish(qs, probes, slot, pv_r, pr_r, K, kk, True,
                                         extra=extra_r),
        # Not stages of the routed call: the grouped engine's prep, which
        # gathers the routed table (and K1's bias rows), and its K4 walk.
        "grouped prep": lambda: idx._scan_inputs(qs, cq),
        "grouped K4": lambda: idx._scan_grouped(qb, bias, kk, alpha),
    }
    routed_stage_ms = {name: cuda_ms(torch, fn) for name, fn in routed_stages.items()}
    del pv_r, pr_r, extra_r
    phase("routed", t0, f"one B={BATCH} search_device(engine='pallas_routed'): {routed_ms} ms "
          f"(engine='pallas' {grouped_ms} ms); stages ms {routed_stage_ms}")

    # ---- phase 7: the brute-force index, its kernels K3 and K5, two engines.
    t = time.time()
    bf_auto = BruteForceIndex(base, metric="l2", dtype="int8", device=dev)
    bf_pallas = BruteForceIndex(base, metric="l2", dtype="int8", engine="pallas",
                                rescore=True, device=dev)
    torch.cuda.synchronize()
    ba, bp = bf_auto._arrays, bf_pallas._arrays
    phase("brute", t0, f"two BruteForceIndex builds {time.time() - t:.1f}s: auto -> "
          f"engine={bf_auto.engine} rescore={bf_auto.rescore} tiles "
          f"{tuple(ba['base_tiles'].shape)} group={bf_auto._acc_group}; pallas base_t "
          f"{tuple(bp['base_t'].shape)}; memory {bf_auto.memory_report()['TOTAL']:,} + "
          f"{bf_pallas.memory_report()['TOTAL']:,} bytes")
    if bf_auto.engine != "accum":
        raise AssertionError(f"engine='auto' resolved to {bf_auto.engine}, not accum")

    kq = 2 * K  # the rescore pool, rescore_depth·k
    n_live = -(-N_BASE // bf_auto._acc_tile_n) * bf_auto._acc_tile_n  # columns K5 scores

    def k3_args(qf, l2):
        """K3's inputs as the pallas engine makes them (per-row int8
        queries; alpha and the norms bias in L2 mode)."""
        qv, qs = quantize.quantize_int8(qf, per_row=True)
        if not l2:
            return (qv, bp["base_t"], kq), {}
        alpha = 2.0 * qs.reshape(-1) * bp["base_scale"]
        return (qv, bp["base_t"], kq), dict(nbins=128, alpha=alpha, bias=bp["base_norms"])

    def k5_args(qf):
        """K5's inputs as the accum engine makes them (one global query
        scale, the pre-shifted bias rows)."""
        qv, qs = quantize.quantize_int8(qf, per_row=False)
        alpha = 2.0 * qs * ba["base_scale"]
        rows = bruteforce_accum.l2_bias_rows(ba["norms_tiled"], alpha, bf_auto._acc_group)
        return (qv, ba["base_tiles"], N_BASE, kq), dict(group=bf_auto._acc_group,
                                                         depth=bf_auto._acc_depth,
                                                         bias_rows=rows)

    SLICE = 512  # the plain versions score the whole [B, N] matrix: a B=512 slice
    q_slice = torch.from_numpy(np.ascontiguousarray(queries[:SLICE])).to(dev)
    q_full = torch.from_numpy(np.ascontiguousarray(queries[:BATCH])).to(dev)
    brute = {}
    for name, fn, plain, make in (
            ("K3 int8-L2 bin128", bruteforce_fused.fused_topk_matmul,
             bruteforce_fused.fused_topk_matmul_reference, lambda qf: k3_args(qf, True)),
            ("K3 int8-IP exact", bruteforce_fused.fused_topk_matmul,
             bruteforce_fused.fused_topk_matmul_reference, lambda qf: k3_args(qf, False)),
            ("K5 int8-L2", bruteforce_accum.fused_topk_accum,
             bruteforce_accum.fused_topk_accum_reference, k5_args)):
        args, kw = make(q_slice)
        v, i = fn(*args, **kw)
        rv, ri = plain(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(v, rv) or not torch.equal(i, ri):
            raise AssertionError(f"{name} differs from its plain version on the B={SLICE} "
                                 "slice")
        err = float((v.double() - rv.double()).abs().max())
        plain_ms = cuda_ms(torch, lambda: plain(*args, **kw), reps=3)
        args, kw = make(q_full)
        ms = cuda_ms(torch, lambda: fn(*args, **kw), reps=5)
        cols = n_live if name.startswith("K5") else N_BASE
        extra = (ba["base_tiles"].numel() + ba["norms_tiled"].numel() * 4
                 if name.startswith("K5")
                 else bp["base_t"].numel() + (BATCH + N_BASE) * 4 * ("L2" in name))
        brute[name] = dict(err=err, ms=ms, plain_ms=plain_ms, bound=bound(
            BATCH * DIM + extra + BATCH * kq * 8, 2.0 * BATCH * cols * DIM, INT8_OPS_S))
        phase("kernels", t0, f"{name} k={kq}: exactly equal to the plain version on "
              f"[{SLICE},{DIM}] x [{DIM},{N_BASE}]; {ms} ms at B={BATCH} (bound "
              f"{brute[name]['bound'][0]} ms by {brute[name]['bound'][1]}); plain {plain_ms} "
              f"ms at B={SLICE}")
        del v, i, rv, ri

    # K3 in its fp32 exact mode at the ground truth's shapes (one 1024-row chunk).
    bt_aug = torch.cat([torch.from_numpy(base.T.copy()),
                        torch.from_numpy(-0.5 * np.sum(base ** 2, axis=1))[None, :]]).to(dev)
    q_aug = torch.cat([torch.from_numpy(queries[:1024]),
                       torch.ones((1024, 1))], dim=1).to(dev)
    gt_ms = cuda_ms(torch, lambda: bruteforce_fused.fused_topk_matmul(q_aug, bt_aug, K), reps=3)
    gt_bound = bound(bt_aug.numel() * 4 + q_aug.numel() * 4 + 1024 * K * 8,
                     2.0 * 1024 * (DIM + 1) * N_BASE, OPS32_S)
    phase("kernels", t0, f"K3 fp32 exact k={K} [1024,{DIM + 1}] x [{DIM + 1},{N_BASE}] "
          f"(one ground-truth chunk): {gt_ms} ms (bound {gt_bound[0]} ms by {gt_bound[1]})")
    del bt_aug, q_aug

    # The GEMM floor for later work: torch._int_mm of the same int8 product,
    # [8192,128] x [128,1M] -> int32, in 8 column blocks of 4.3 GB each.
    qv8 = quantize.quantize_int8(q_full, per_row=True)[0]
    step = N_BASE // 8
    try:
        int_mm_ms = sum(cuda_ms(torch, lambda s=s: torch._int_mm(
            qv8, bp["base_t"][:, s:s + step]), reps=3) for s in range(0, N_BASE, step))
        print(f"[gemm floor] torch._int_mm [{BATCH},{DIM}] x [{DIM},{N_BASE}] int8 -> int32 in "
              f"8 column blocks: {int_mm_ms} ms on {card} (a library yardstick; the port "
              "never calls it)", flush=True)
    except RuntimeError as exc:
        print(f"[gemm floor] torch._int_mm not measured: {exc}", flush=True)

    def brute_all(idx):
        """All queries in B=BATCH batches (the tail padded cyclically) →
        (ids, launches, wall s)."""
        reset_launches()
        t = time.time()
        parts = []
        for s_ in range(0, N_QUERIES, BATCH):
            chunk = queries[s_:s_ + BATCH]
            vals, ids_ = idx.search_device(
                torch.from_numpy(np.resize(chunk, (BATCH, DIM))).to(dev), K)
            if not torch.isfinite(vals).all():
                raise AssertionError("brute-force scores are not finite")
            parts.append(ids_.cpu().numpy()[:chunk.shape[0]])
        got = read_launches()
        ids_ = np.concatenate(parts)
        if ids_.shape != (N_QUERIES, K) or (ids_ < 0).any() or (ids_ >= N_BASE).any():
            raise AssertionError("brute-force ids out of shape or range")
        return ids_, got, time.time() - t

    ids_a, launch_a, wall_a = brute_all(bf_auto)
    r10_a = recall_at_k(ids_a, gt, K)
    auto_ms = cuda_ms(torch, lambda: bf_auto.search_device(q_full, K), reps=5)
    phase("brute", t0, f"engine=auto ({bf_auto.engine}, rescore {bf_auto.rescore}) "
          f"{N_QUERIES} queries {wall_a:.1f}s: launches={launch_a} recall@10={r10_a:.4f}; "
          f"one B={BATCH} search_device {auto_ms} ms (information, not a claim)")
    if launch_a["K5"] < 1:
        raise AssertionError(f"engine='auto' did not launch K5: {launch_a}")
    if r10_a < 0.99:
        raise AssertionError(f"engine='auto' recall@10 {r10_a} below 0.99")
    ids_p, launch_p, wall_p = brute_all(bf_pallas)
    r10_p = recall_at_k(ids_p, gt, K)
    pallas_ms = cuda_ms(torch, lambda: bf_pallas.search_device(q_full, K), reps=5)
    phase("brute", t0, f"engine=pallas rescore=True {N_QUERIES} queries {wall_p:.1f}s: "
          f"launches={launch_p} recall@10={r10_p:.4f}; one B={BATCH} search_device "
          f"{pallas_ms} ms (information, not a claim)")
    if launch_p["K3"] < 1:
        raise AssertionError(f"engine='pallas' did not launch K3: {launch_p}")
    if r10_p < 0.999:
        raise AssertionError(f"engine='pallas' rescore=True recall@10 {r10_p} below 0.999")
    del bf_auto, bf_pallas, ba, bp

    # ---- phase 8: the fused coarse tier (K3) on a second index over the same arrays.
    class FusedTierIVF(IVFIndex):
        COARSE_FUSED_MIN_NLIST = NLIST

    t = time.time()
    fidx = FusedTierIVF.from_arrays(idx._centroids_np, idx._vectors_np, idx._offsets_np,
                                    idx._reorder_np, metric="l2", dtype="int8",
                                    pad_block=PAD_BLOCK, config=dict(idx.config), device=dev)
    if fidx._coarse_tier != "fused":
        raise AssertionError(f"the second index took the {fidx._coarse_tier} tier")
    reset_launches()
    vals_f, ids_f, _ = fidx.search_device(q_full, K, NPROBE)
    torch.cuda.synchronize()
    launch_f = read_launches()
    probes_f = fidx._coarse_probes(q_full, NPROBE)
    a = idx._arrays
    probes_32 = ivf_mod.coarse_probes_tiered(q_full, a["centroids"], a["centroid_norms"], NPROBE,
                                             tier="fp32", coarse_metric="l2")
    # Where the two probe lists differ, position by position, the two probes
    # must score within NEAR of each other in fp64: a near-tie that the two
    # fp32 sum orders broke differently.
    cents = a["centroids"].double()
    s64 = 2.0 * q_full.double() @ cents.T - (cents * cents).sum(1)[None, :]
    differ = (probes_f != probes_32).any(dim=1)
    NEAR = 1.0  # score units of 2q·c − ‖c‖² (~1e6 here): ~1e-6 relative, fp32 rounding
    far = ((torch.gather(s64, 1, probes_f.long()) - torch.gather(s64, 1, probes_32.long()))
           .abs() > NEAR).any(dim=1)
    r10_f = recall_at_k(ids_f.cpu().numpy(), gt[:BATCH], K)
    phase("coarse", t0, f"fused tier on nlist={NLIST} ({time.time() - t:.1f}s with the "
          f"build): launches={launch_f}; probe lists differ from the fp32 tier's on "
          f"{int(differ.sum())} of {BATCH} rows, {int(far.sum())} of them not near-ties "
          f"(fp64 scores of the two probes more than {NEAR} apart); recall@10 of the batch "
          f"{r10_f:.4f}")
    if launch_f["K3"] < 1:
        raise AssertionError(f"the fused coarse tier did not launch K3: {launch_f}")
    if int(far.sum()):
        raise AssertionError("fused-tier probes differ from the fp32 tier's beyond near-ties")
    del fidx, vals_f, ids_f

    # ---- phase 9: sharded search, 4 logical shards on this card.
    from rag_on_edge_tpu_torch.parallel import ShardedBruteForceIndex, ShardedIVFIndex
    from rag_on_edge_tpu_torch.parallel import sharded as sharded_mod

    shards = [torch.device("cuda", torch.cuda.current_device())] * 4
    t = time.time()
    sh = ShardedIVFIndex(idx, shards)
    sh._ensure_cluster_state()
    torch.cuda.synchronize()
    sa = sh._cm_arrays
    nb_local = sa[0]["vectors_t"].shape[0]
    per_shard = np.bincount(sa[0]["cluster_shard"].cpu().numpy(), minlength=len(shards))
    phase("sharded", t0, f"ShardedIVFIndex over {len(shards)} shards on {shards[0]}: cluster "
          f"state {time.time() - t:.1f}s, {nb_local} blocks per shard, clusters per shard "
          f"{per_shard.tolist()}, accum engine eligible {sh._cm_accum_ok}")

    # K6 against its plain version: shard 0's dense walk (engine="pallas"),
    # and the recovery pass of the shard with the most dropped pairs of
    # this batch (its first pass, the default recover_blocks).
    r = sh._cm_route(q, NPROBE, qcap)
    owned_lossy = [int((r["lossy"] & (a["cluster_shard"][r["probes"].long()] == s_)).sum())
                   for s_, a in enumerate(sa)]
    s_rec = int(np.argmax(owned_lossy))
    rb_sh = max(1, nb_local // 4)

    def shard_bias_of(route, s_):
        """The int8-L2 kernel bias of shard s_, as its search makes it."""
        return (sa[s_]["norms_pad"] / route["alpha"])[None, :]

    rec_scan, _, _ = sh._cm_recover_tables(s_rec, r, r["lossy"], shard_bias_of(r, s_rec), qcap,
                                           rb_sh)
    a0 = sa[0]
    k6_inputs = {
        "dense": ((r["qg"], a0["vectors_t"], a0["bc"], a0["bf"], a0["bl"], a0["rv"]),
                  dict(bias=shard_bias_of(r, 0), row_base=None)),
        "recovery": (rec_scan[:6], dict(bias=rec_scan[6], row_base=rec_scan[7])),
    }
    k6 = {}
    for name, (args, extra_kw) in k6_inputs.items():
        kw = dict(k=kk, blk=PAD_BLOCK, **extra_kw)
        pv, pr = ivf_scan.cluster_major_scan(*args, **kw)
        rpv, rpr = ivf_scan.cluster_major_scan_reference(*args, **kw)
        torch.cuda.synchronize()
        bc_, bf_, bl_, rv_ = args[2:6]
        r6 = bc_[torch.nonzero(bl_).flatten()].long()
        fin = rpv[r6] > float("-inf")
        if not torch.equal(pv[r6], rpv[r6]) or not torch.equal(pr[r6][fin], rpr[r6][fin]):
            raise AssertionError(f"K6 differs from the plain version at the {name} shapes")
        err = float((pv[r6][fin] - rpv[r6][fin]).abs().max()) if fin.any() else 0.0
        del rpv, rpr
        walked = walked_blocks(np, bf_, bl_, rv_)
        k6[name] = dict(
            err=err, ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan(*args, **kw)),
            plain_ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_reference(*args, **kw)),
            bound=bound(walked * (DIM * PAD_BLOCK + PAD_BLOCK * 4)
                        + r6.numel() * qcap * (DIM + kk * 8),
                        2.0 * walked * qcap * PAD_BLOCK * DIM, INT8_OPS_S))
        phase("kernels", t0, f"K6 {name} (shard {0 if name == 'dense' else s_rec}): qg "
              f"{tuple(args[0].shape)} vectors_t {tuple(args[1].shape)} k={kk}: pv bit-equal, "
              f"pr equal where finite, on {r6.numel()} emitted clusters ({int(fin.sum())} "
              f"finite entries, {walked} blocks walked); {k6[name]['ms']} ms vs plain "
              f"{k6[name]['plain_ms']} ms; bound {k6[name]['bound'][0]} ms by "
              f"{k6[name]['bound'][1]}")
    del r, rec_scan, k6_inputs

    def sharded_all(sh, bs, **kw):
        """All queries through the sharded index ``sh`` in B=bs batches (the
        tail padded cyclically) → (ids, per-batch residual spill, wall s)."""
        t = time.time()
        parts, residual = [], []
        for s_ in range(0, N_QUERIES, bs):
            chunk = queries[s_:s_ + bs]
            vals, ids_, _ = sh.search_device(
                torch.from_numpy(np.resize(chunk, (bs, DIM))).to(dev), K, NPROBE, **kw)
            if not torch.isfinite(vals).all():
                raise AssertionError(f"sharded search {kw} scores are not finite")
            parts.append(ids_.cpu().numpy()[:chunk.shape[0]])
            if kw.get("mode") == "cluster":
                residual.append(int(sh.last_spill))
        ids_ = np.concatenate(parts)
        if ids_.shape != (N_QUERIES, K) or (ids_ < 0).any() or (ids_ >= N_BASE).any():
            raise AssertionError(f"sharded search {kw} ids out of shape or range")
        return ids_, residual, time.time() - t

    reset_launches()
    ids_s, residual_s, wall_s = sharded_all(sh, BATCH, mode="cluster")
    launch_s = read_launches()
    r10_s, r1_s = recalls(ids_s)
    engine_s = sh.last_engine
    sh_ms = cuda_ms(torch, lambda: sh.search_device(qs, K, NPROBE, mode="cluster"))
    phase("sharded", t0, f"search_device(q, {K}, {NPROBE}, mode='cluster') defaults, {N_QUERIES} "
          f"queries in B={BATCH} batches {wall_s:.1f}s: engine={engine_s} auto_recover="
          f"{idx._auto_recover(BATCH, NPROBE)} recover_blocks={rb_sh} residual last_spill="
          f"{residual_s} launches={launch_s} recall@10={r10_s:.4f} recall@1={r1_s:.4f}; one "
          f"B={BATCH} call {sh_ms} ms (single index {search_ms} ms)")
    # Where the sharded call's time goes: the replicated route, one shard's
    # whole body (K1, the recovery pass, the join, the rescore) and its
    # recovery pass alone, and the merge of the four shards' top-k.
    r8 = sh._cm_route(qs, NPROBE, qcap)
    rp8 = idx._auto_recover_passes(BATCH, NPROBE, qcap)
    outs8 = [sh._cm_shard(s_, r8, K, qcap, rb_sh, rp8, engine_s) for s_ in range(len(shards))]
    owned0 = sa[0]["cluster_shard"][r8["probes"].long()] == 0
    sh_stage_ms = {name: cuda_ms(torch, fn) for name, fn in {
        "route": lambda: sh._cm_route(qs, NPROBE, qcap),
        "shard 0": lambda: sh._cm_shard(0, r8, K, qcap, rb_sh, rp8, engine_s),
        "shard 0 recovery": lambda: sh._cm_recover(0, r8, owned0, shard_bias_of(r8, 0), kk,
                                                   qcap, rb_sh, rp8),
        "merge": lambda: sharded_mod._gather_merge([o[0] for o in outs8],
                                                   [o[1] for o in outs8], K),
    }.items()}
    phase("sharded", t0, f"one B={BATCH} sharded call, stages ms {sh_stage_ms}")
    del r8, outs8
    if min(launch_s["K1"], launch_s["K2"], launch_s["K6"]) < 1:
        raise AssertionError(f"the sharded default path did not launch K1, K2 and K6: {launch_s}")
    if any(residual_s):
        raise AssertionError(f"sharded: pairs still dropped after recovery: {residual_s}")
    if r10_s < 0.99 or r1_s < 0.99:
        raise AssertionError(f"sharded recall below 0.99: recall@10 {r10_s}, recall@1 {r1_s}")

    reset_launches()
    ids_sp, residual_sp, wall_sp = sharded_all(sh, BATCH, mode="cluster", engine="pallas")
    launch_sp = read_launches()
    r10_sp, _ = recalls(ids_sp)
    sp_ms = cuda_ms(torch, lambda: sh.search_device(qs, K, NPROBE, mode="cluster",
                                                    engine="pallas"))
    phase("sharded", t0, f"engine=pallas {N_QUERIES} queries {wall_sp:.1f}s: residual "
          f"last_spill={residual_sp} launches={launch_sp} recall@10={r10_sp:.4f}; one "
          f"B={BATCH} call {sp_ms} ms")
    if launch_sp["K6"] < 1 or r10_sp < 0.99:
        raise AssertionError(f"sharded engine='pallas': launches {launch_sp}, recall@10 {r10_sp}")

    QBATCH = 128  # query mode, below _pick_mode's crossover
    ids_q, _, wall_q = sharded_all(sh, QBATCH, mode="query")
    r10_q, r1_q = recalls(ids_q)
    q128 = torch.from_numpy(np.ascontiguousarray(queries[:QBATCH])).to(dev)
    q_ms = cuda_ms(torch, lambda: sh.search_device(q128, K, NPROBE, mode="query"))
    phase("sharded", t0, f"mode=query B={QBATCH} ({idx._pick_mode(QBATCH, NPROBE)} by the "
          f"single index's rule; probe_chunk {sh._auto_probe_chunk(QBATCH)}) {N_QUERIES} "
          f"queries {wall_q:.1f}s: recall@10={r10_q:.4f} recall@1={r1_q:.4f}; one B={QBATCH} "
          f"call {q_ms} ms")
    if r10_q < 0.99:
        raise AssertionError(f"sharded mode='query' recall@10 {r10_q} below 0.99")
    del sh

    t = time.time()
    sbf = ShardedBruteForceIndex(base, shards, metric="l2", dtype="int8", rescore=True)
    torch.cuda.synchronize()
    build_sbf = time.time() - t
    ids_b, launch_b, wall_b = brute_all(sbf)
    r10_b = recall_at_k(ids_b, gt, K)
    sbf_ms = cuda_ms(torch, lambda: sbf.search_device(q_full, K), reps=5)
    phase("sharded", t0, f"ShardedBruteForceIndex(l2, int8, rescore) build {build_sbf:.1f}s, "
          f"{N_QUERIES} queries {wall_b:.1f}s: launches={launch_b} recall@10={r10_b:.4f}; one "
          f"B={BATCH} call {sbf_ms} ms")
    if launch_b["K3"] < 1 or r10_b < 0.999:
        raise AssertionError(f"sharded brute force: launches {launch_b}, recall@10 {r10_b}")
    del sbf

    # ---- phase 10: the kernel lab (K10) on the same index, at the lab's
    # defaults (qcap 128, k 20, 128 bins, B=2048, nprobe 4), one fixed routing.
    LAB_QCAP, LAB_K, LAB_BATCH = 128, 20, 2048
    a = idx._arrays
    qg_lab = kernel_lab.routed_table(idx, queries, LAB_BATCH, NPROBE, LAB_QCAP)
    lab_tabs = (a["vectors_t"], a["block_cluster"], a["block_first"], a["block_last"],
                a["rows_valid"])
    # The windows each variant defines: the clusters that end a run, every
    # cluster with blocks, and window 0.
    bc_lab = a["block_cluster"].long()
    run_ends = torch.unique(bc_lab[a["block_last"] > 0])
    lab_windows = {"full": run_ends, "nogate": run_ends, "maxonly": torch.unique(bc_lab),
                   "fixedout": torch.zeros(1, dtype=torch.long, device=dev)}
    k10 = {}
    for variant in kernel_lab.VARIANTS:
        args = (qg_lab, *lab_tabs, LAB_K, PAD_BLOCK, 128, variant)
        pv, pr = kernel_lab._variant_scan(*args)
        rpv, rpr = kernel_lab._variant_scan_reference(*args)
        torch.cuda.synchronize()
        win = lab_windows[variant]
        fin = rpv[win] > float("-inf")
        if not torch.equal(pv[win], rpv[win]) or not torch.equal(pr[win][fin], rpr[win][fin]):
            raise AssertionError(f"K10 {variant} differs from the plain version")
        if variant == "full":
            kv, ki = ivf_scan.cluster_major_scan(qg_lab, *lab_tabs, LAB_K, blk=PAD_BLOCK,
                                                 bin_depth=2)
            if not torch.equal(pv[win], kv[win]) or not torch.equal(pr[win][fin], ki[win][fin]):
                raise AssertionError("K10 full differs from K6 on the same table")
            del kv, ki
        err = float((pv[win][fin] - rpv[win][fin]).abs().max()) if fin.any() else 0.0
        del pv, pr, rpv, rpr
        k10[variant] = dict(err=err, windows=win.numel(), finite=int(fin.sum()),
                            plain_ms=cuda_ms(torch, lambda: kernel_lab._variant_scan_reference(
                                *args), reps=3))
    walked = walked_blocks(np, *lab_tabs[2:])
    n_win = lab_windows["full"].numel()
    k10_bound = bound(walked * DIM * PAD_BLOCK + n_win * LAB_QCAP * (DIM + LAB_K * 8),
                      2.0 * walked * LAB_QCAP * PAD_BLOCK * DIM, INT8_OPS_S)
    phase("lab", t0, f"K10 qg {tuple(qg_lab.shape)} vectors_t {tuple(a['vectors_t'].shape)} "
          f"k={LAB_K}: every variant equal to its plain version on its defined windows "
          f"({ {v: (k10[v]['windows'], k10[v]['finite']) for v in k10} } windows, finite "
          f"entries), full equal to K6; plain ms { {v: k10[v]['plain_ms'] for v in k10} }; "
          f"bound of full {k10_bound[0]} ms by {k10_bound[1]} ({walked} blocks walked)")
    # The lab itself, counted: its four variants, timed as the lab times them.
    print(f"[lab] sift: nblocks={nblocks} blk={PAD_BLOCK} qcap={LAB_QCAP} k={LAB_K} "
          f"nbins=128 on {card}", flush=True)
    reset_launches()
    lab_out = kernel_lab.lab(idx, qg_lab, LAB_K, 128, kernel_lab.VARIANTS, repeats=REPS)
    torch.cuda.synchronize()
    k10_launches = read_launches()["K10"]
    if k10_launches != len(kernel_lab.VARIANTS) * (REPS + 2):
        raise AssertionError(f"the lab launched K10 {k10_launches} times")
    del qg_lab, lab_tabs

    # ---- phase 11: the spatial GEMM (K8).  The index and its state go first:
    # the full-width product's output alone is 32.8 GB.
    from rag_on_edge_tpu_torch.parallel import spatial_matmul, verify_matmul

    int8_centroids = idx._centroids_np  # phase 13 builds its float indexes from them
    del a, idx, k1_args, k4_rec, k4_dense, qb, qi, bias, bias_rows, pp, pool, probes, cq, slot
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(7)

    def rand(shape, dtype):
        if dtype == torch.int8:
            return torch.randint(-128, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def k8_err(c, ref, a_, b_):
        """int8: max |err| (must be 0); floats: max |err|, which must lie
        within the worst-case bound of an fp32 sum of K products in any
        order, 2·K·2**-24·(|A| @ |B|), for the two sums."""
        err = (c.double() - ref.double()).abs()
        if c.dtype == torch.int32:
            return float(err.max()), bool(torch.equal(c, ref))
        lim = 2.0 * a_.shape[1] * 2.0**-24 * (a_.double().abs() @ b_.double().abs())
        return float(err.max()), bool((err <= lim).all())

    def library_mm(a_, b_):
        """One PyTorch call that computes K8's function (f32 out), with its
        name: the yardstick beside the kernel (TF32 off, the default)."""
        try:  # bf16 -> f32 in one call where this torch has out_dtype
            lib = lambda: torch.mm(a_, b_, out_dtype=torch.float32)  # noqa: E731
            lib()
            return lib, "torch.mm(out_dtype=float32)"
        except TypeError:
            return (lambda: torch.matmul(a_, b_)), "torch.matmul"

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the fp32 yardstick would not be an fp32 product")
    k8_checks = {}
    for dtype in (torch.int8, torch.bfloat16, torch.float32):
        a_, b_ = rand((999, 197), dtype), rand((197, 3001), dtype)
        c = tiled_matmul.tiled_matmul(a_, b_)
        ref = tiled_matmul.tiled_matmul_reference(a_, b_)
        torch.cuda.synchronize()
        k8_checks[str(dtype).split(".")[1]] = k8_err(c, ref, a_, b_)
        del a_, b_, c, ref
    phase("gemm", t0, f"K8 [999,197] x [197,3001] (ragged: K padded to 16 bytes, N odd) "
          f"(max |err|, within tolerance): {k8_checks}")
    if not all(ok for _, ok in k8_checks.values()):
        raise AssertionError(f"K8 differs from the plain version: {k8_checks}")
    # The float kernels' edges: M 1, 65 and 9 * 128 + 1 (rows past M in a
    # warpgroup's 64 and in a tile; a ragged run of the f32 kernel's tile
    # order); N off a multiple of 8 (padded) and 2 * 256 + 1; K 8, 72 (a
    # 64-K stage and a tail) and 4096.
    k8_edges = {}
    for dtype in (torch.bfloat16, torch.float32):
        for m_, k_, n_ in ((1, 72, 257), (65, 8, 30), (1153, 4096, 513)):
            a_, b_ = rand((m_, k_), dtype), rand((k_, n_), dtype)
            c = tiled_matmul.tiled_matmul(a_, b_)
            ref = tiled_matmul.tiled_matmul_reference(a_, b_)
            torch.cuda.synchronize()
            k8_edges[f"{str(dtype).split('.')[1]} {m_}x{k_}x{n_}"] = k8_err(c, ref, a_, b_)
            del a_, b_, c, ref
    phase("gemm", t0, f"K8 edges (max |err|, within tolerance): {k8_edges}")
    if not all(ok for _, ok in k8_edges.values()):
        raise AssertionError(f"K8 differs from the plain version at an edge: {k8_edges}")

    # The SIFT-1M scoring product: 8192 queries against the 1M base, both
    # L2-normalized and scaled to int8 (utils/preprocess), -> int32.
    from rag_on_edge_tpu_torch.utils.preprocess import prepare_int8_operands

    a8_np, b8_np, _ = prepare_int8_operands(queries[:BATCH], base, query_row_multiple=1,
                                            base_row_multiple=1)
    a8 = torch.from_numpy(a8_np).to(dev)
    b8 = torch.from_numpy(np.ascontiguousarray(b8_np.T)).to(dev)
    del a8_np, b8_np
    mem0 = torch.cuda.memory_allocated()
    c8 = tiled_matmul.tiled_matmul(a8, b8)
    torch.cuda.synchronize()
    chunk = 1 << 16
    k8_full_err, k8_plain_ms = 0, 0.0
    for c0 in range(0, N_BASE, chunk):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ref = tiled_matmul.tiled_matmul_reference(a8, b8[:, c0:c0 + chunk])
        end.record()
        end.synchronize()
        k8_plain_ms += start.elapsed_time(end)
        k8_full_err = max(k8_full_err, int((c8[:, c0:c0 + chunk] - ref).abs().max()))
        del ref
    del c8
    torch.cuda.empty_cache()
    if k8_full_err:
        raise AssertionError(f"K8 full-width int8 product differs: max |err| {k8_full_err}")
    k8_ms = cuda_ms(torch, lambda: tiled_matmul.tiled_matmul(a8, b8))
    k8_lib_ms = cuda_ms(torch, lambda: torch._int_mm(a8, b8))
    k8_bound = bound(a8.numel() + b8.numel() + BATCH * N_BASE * 4,
                     2.0 * BATCH * DIM * N_BASE, INT8_OPS_S)
    phase("gemm", t0, f"K8 int8 [{BATCH},{DIM}] x [{DIM},{N_BASE}] -> int32 "
          f"({BATCH * N_BASE * 4 / 1e9:.1f} GB out; {mem0 / 1e9:.1f} GB held before it): "
          f"exactly equal to the plain version in {N_BASE // chunk + 1} column chunks; "
          f"{k8_ms} ms vs plain {k8_plain_ms} ms (the chunks), torch._int_mm {k8_lib_ms} ms; "
          f"bound {k8_bound[0]} ms by {k8_bound[1]}")
    del a8, b8
    torch.cuda.empty_cache()

    # bf16 and f32 at the hardware probe's square shape, beside torch.mm.
    SQ = 4096
    k8_sq = {}
    for name, dtype, rate in (("bf16", torch.bfloat16, BF16_OPS_S),
                              ("fp32", torch.float32, OPS32_S)):
        a_, b_ = rand((SQ, SQ), dtype), rand((SQ, SQ), dtype)
        err = k8_err(tiled_matmul.tiled_matmul(a_, b_),
                     tiled_matmul.tiled_matmul_reference(a_, b_), a_, b_)
        if not err[1]:
            raise AssertionError(f"K8 {name} {SQ}^3 outside the tolerance: max |err| {err[0]}")
        lib, lib_name = library_mm(a_, b_)
        k8_sq[name] = dict(
            err=err[0], ms=cuda_ms(torch, lambda: tiled_matmul.tiled_matmul(a_, b_)),
            plain_ms=cuda_ms(torch, lambda: tiled_matmul.tiled_matmul_reference(a_, b_), reps=3),
            lib=lib_name, lib_ms=cuda_ms(torch, lib),
            bound=bound(2 * SQ * SQ * a_.element_size() + SQ * SQ * 4, 2.0 * SQ**3, rate))
        del a_, b_
    sq_lines = {n: (v["err"], v["ms"], v["plain_ms"], v["lib"], v["lib_ms"], v["bound"])
                for n, v in k8_sq.items()}
    phase("gemm", t0, f"K8 {SQ}^3 (max |err| within tolerance, ms, plain ms, library call "
          f"ms, bound): {sq_lines}")

    # One skinny bf16 product at the spatial GEMM's shape, K = 128: the f32
    # output is the work, so it shows whether the epilogue keeps up.
    SK_N, sk_chunk = 131072, 16384
    a_, b_ = rand((BATCH, DIM), torch.bfloat16), rand((DIM, SK_N), torch.bfloat16)
    c = tiled_matmul.tiled_matmul(a_, b_)
    torch.cuda.synchronize()
    sk_err, sk_plain_ms = 0.0, 0.0
    for c0 in range(0, SK_N, sk_chunk):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ref = tiled_matmul.tiled_matmul_reference(a_, b_[:, c0:c0 + sk_chunk])
        end.record()
        end.synchronize()
        sk_plain_ms += start.elapsed_time(end)
        e_, ok_ = k8_err(c[:, c0:c0 + sk_chunk], ref, a_, b_[:, c0:c0 + sk_chunk])
        if not ok_:
            raise AssertionError(f"K8 bf16 [{BATCH},{DIM}] x [{DIM},{SK_N}] outside the "
                                 f"tolerance: max |err| {e_}")
        sk_err = max(sk_err, e_)
        del ref
    del c
    lib, lib_name = library_mm(a_, b_)
    k8_sk = dict(err=sk_err, ms=cuda_ms(torch, lambda: tiled_matmul.tiled_matmul(a_, b_)),
                 plain_ms=sk_plain_ms, lib=lib_name, lib_ms=cuda_ms(torch, lib),
                 bound=bound(2 * (a_.numel() + b_.numel()) + BATCH * SK_N * 4,
                             2.0 * BATCH * DIM * SK_N, BF16_OPS_S))
    phase("gemm", t0, f"K8 bf16 [{BATCH},{DIM}] x [{DIM},{SK_N}] -> f32 "
          f"({BATCH * SK_N * 4 / 1e9:.1f} GB out): max |err| {sk_err} within tolerance in "
          f"{SK_N // sk_chunk} column chunks; {k8_sk['ms']} ms vs plain {sk_plain_ms} ms (the "
          f"chunks), {lib_name} {k8_sk['lib_ms']} ms; bound {k8_sk['bound'][0]} ms by "
          f"{k8_sk['bound'][1]}")
    del a_, b_
    torch.cuda.empty_cache()

    # The path itself, counted: spatial_matmul on a 1x1 grid and on a logical
    # 2x2 grid of this card, both local products, and the AIE reference
    # workload through bench_gemm (its default kernel, K8).
    here = torch.device("cuda", torch.cuda.current_device())
    operands = {"int8": bench_gemm._make_inputs(128, 128, 10240, "int8", 0),
                "bf16": bench_gemm._make_inputs(256, 64, 128, "bf16", 0),
                "fp32": bench_gemm._make_inputs(256, 64, 128, "fp32", 0)}
    reset_launches()
    grids = {}
    for grid_name, mesh in (("1x1", [[here]]), ("2x2", [[here] * 2] * 2)):
        for use_k8 in (True, False):
            for name, (x, y) in operands.items():
                c = spatial_matmul(x.to(dev), y.to(dev), mesh, use_pallas_kernel=use_k8)
                grids[f"{grid_name} {'K8' if use_k8 else 'plain'} {name}"] = verify_matmul(
                    bench_gemm._host(x), bench_gemm._host(y), c.cpu().numpy())
    res = bench_gemm.run(128, 128, 10240, "int8", quiet=True)
    torch.cuda.synchronize()
    k8_launches = dict(tiled_matmul.LAUNCHES)
    phase("gemm", t0, f"spatial_matmul verify_matmul: {grids}; launches by mode {k8_launches}")
    print(f"[gemm] bench_gemm.run(128, 128, 10240, 'int8') on {card}: {json.dumps(res)}",
          flush=True)
    if not all(grids.values()) or not res["verified"]:
        raise AssertionError(f"the spatial GEMM failed verify_matmul: {grids}, {res}")
    if min(k8_launches.values()) < 1:
        raise AssertionError(f"the spatial GEMM did not launch every K8 mode: {k8_launches}")
    k8_errs = {"bf16": max([k8_sq["bf16"]["err"], sk_err, k8_checks["bfloat16"][0]]
                           + [v[0] for key, v in k8_edges.items() if key.startswith("bf")]),
               "fp32": max([k8_sq["fp32"]["err"], k8_checks["float32"][0]]
                           + [v[0] for key, v in k8_edges.items() if key.startswith("fl")])}

    # ---- phase 12: the hardware probes (K11-K14), each kernel against its
    # plain version at a ragged shape and at one JAX size, then the probes.
    del operands
    torch.cuda.empty_cache()
    pgen = torch.Generator(device=dev).manual_seed(12)

    def prand(shape, dtype):
        if dtype == torch.int8:
            return torch.randint(-127, 127, shape, generator=pgen, device=dev, dtype=dtype)
        return torch.randn(shape, generator=pgen, device=dev, dtype=dtype)

    def bf16_bound(a_, b_):
        """2·K·2**-24·max(|A| @ |B|): two fp32 sums of K products, in any
        order, differ by at most this at the maximum entry."""
        return 2.0 * a_.shape[-1] * 2.0**-24 * float(
            torch.matmul(a_.double().abs(), b_.double().abs()).max())

    def k12_bf16_tol(x_, data_, fat_):
        """Each step's bf16 bound: 2·d·2**-24·max(|x| @ |tile|) over its
        fat tiles."""
        nb, d_, blk_ = data_.shape
        prod = torch.matmul(x_.double().abs(),
                            data_.double().abs().reshape(nb // fat_, fat_, d_, blk_))
        return 2.0 * d_ * 2.0**-24 * prod.amax(dim=(1, 2, 3))

    def k14_bf16_tol(q_, v_, g_):
        """Each step's bf16 bound: 2·d·2**-24·max(|twisted q| @ |v|)."""
        va, out = v_.double().abs(), []
        for s0 in range(0, g_, 64):
            ids = torch.arange(s0, min(g_, s0 + 64), device=dev)
            qx_ = hw_probe._twisted_q(q_, ids, torch.float64)
            out.append(torch.matmul(qx_.abs(), va).amax(dim=(1, 2)))
        return 2.0 * q_.shape[1] * 2.0**-24 * torch.cat(out)

    probe_err = {"K11": 0.0, "K12": 0.0, "K13": 0.0, "K14": 0.0}

    def probe_check(key, name, got, want, tol=0.0):
        """``got`` against ``want`` within ``tol`` (a number, or one per
        element); NaN, which the per-step views leave where no CTA wrote,
        fails."""
        torch.cuda.synchronize()
        diff = (got.double() - want.double()).abs()
        if got.shape != want.shape or not bool((diff <= tol).all()):
            raise AssertionError(f"{key} {name} differs from its plain version: |err| "
                                 f"{float(diff.max())}, tolerance "
                                 f"{float(torch.as_tensor(tol).max())}")
        probe_err[key] = max(probe_err[key], float(diff.max()))

    def k12_checks(name, x_, data_, blk_, fat_, gemm, tops, sems):
        """K12's value and its whole per-step buffer against the plain
        version; without the product, also against the planted maxima."""
        want = hw_probe._stream_steps_reference(x_, data_, fat_, gemm)
        if not gemm and not torch.equal(want, tops):
            raise AssertionError(f"K12 {name}: the plain version missed the planted maxima")
        tol = (k12_bf16_tol(x_, data_, fat_) if gemm and data_.dtype == torch.bfloat16
               else torch.zeros_like(want, dtype=torch.float64))
        for sem in sems:
            probe_check("K12", f"{name} gemm={gemm} {sem} steps",
                        hw_probe._stream_steps(x_, data_, blk_, fat_, gemm, sem), want, tol)
            probe_check("K12", f"{name} gemm={gemm} {sem}",
                        hw_probe._stream_probe(x_, data_, blk_, fat_, gemm, sem),
                        hw_probe._stream_probe_reference(x_, data_, blk_, fat_, gemm, sem),
                        tol[-1:])

    def k13_trials(name, data_, depth, plant, decoy, n):
        """K13 against its plain version with one value planted at a time
        above the bulk: ``plant`` at the first and the last walked element
        and at ``n`` seeded random walked ones, so that a walk or a ring
        that skips, drops or reuses a stage misses it; first, where blocks
        lie past the walk, ``decoy`` there alone, which a walk that reads
        past its end would return."""
        flat = data_.view(-1)
        walked = hw_probe._dma_blocks(data_, depth) * data_[0].numel()
        trials = [(0, plant), (walked - 1, plant)] + [
            (p_, plant) for p_ in torch.randint(walked, (n,), generator=pgen,
                                                device=dev).tolist()]
        if walked < flat.numel():
            trials.insert(0, (walked + int(torch.randint(flat.numel() - walked, (1,),
                                                         generator=pgen, device=dev)), decoy))
        for pos, val in trials:
            old = flat[pos].clone()
            flat[pos] = val
            want = hw_probe._dma_probe_reference(x1, data_, depth)
            if (float(want) == val) != (pos < walked):
                raise AssertionError(f"K13 {name}: the bulk reaches the planted {val}")
            probe_check("K13", f"{name} depth={depth} {val} at {pos}",
                        hw_probe._dma_probe(x1, data_, depth), want)
            flat[pos] = old
        return len(trials)

    t = time.time()
    xs = prand((8, 128), torch.float32)
    x1 = torch.ones((8, 128), dtype=torch.float32, device=dev)
    for g_ in (3, 300):
        for moving in (False, True):
            for sem in hw_probe.SEMANTICS:
                probe_check("K11", f"g={g_} moving={moving} {sem}",
                            hw_probe._step_probe(xs, g_, moving, sem),
                            hw_probe._step_probe_reference(xs, g_, moving, sem))
    ntrials = 0
    for dtype, plant, decoy in ((torch.int8, 127, 127), (torch.bfloat16, 64.0, 128.0)):
        xr = prand((100, 36), dtype)
        for gemm, blk_ in ((False, 301), (True, 300)):
            data_, tops = hw_probe._planted_walk(9, 36, blk_, 3, dtype, pgen)
            k12_checks(f"{dtype} [9,36,{blk_}] fat=3", xr, data_, blk_, 3, gemm, tops,
                       hw_probe.SEMANTICS)
        data_ = prand((11, 24, 40), dtype)
        for depth in (3, 8):
            ntrials += k13_trials(f"{dtype} [11,24,40]", data_, depth, plant, decoy, 4)
    # bf16 over 36 MB: ~17 stages a CTA, so the ring wraps at depth 3 and 8,
    # and 70 blocks leave blocks past the walk at both.
    data_ = prand((70, 128, 2048), torch.bfloat16)
    for depth in (3, 8):
        ntrials += k13_trials("bf16 [70,128,2048]", data_, depth, 64.0, 128.0, 16)
    for dtype, unit in ((torch.int8, "mma"), (torch.int8, "dp4a"), (torch.bfloat16, "mma")):
        q_, v_ = prand((200, 96), dtype), prand((96, 300), dtype)
        tol = (k14_bf16_tol(q_, v_, 37) if dtype == torch.bfloat16
               else torch.zeros(37, dtype=torch.float64, device=dev))
        probe_check("K14", f"{dtype} {unit} [200,96]x[96,300] g=37 steps",
                    hw_probe._gemm_rate_steps(q_, v_, 37, 200, 300, True, unit),
                    hw_probe._gemm_rate_steps_reference(q_, v_, 37, 200, 300, True, unit), tol)
        probe_check("K14", f"{dtype} {unit} [200,96]x[96,300] g=37",
                    hw_probe._gemm_rate_probe(xs, q_, v_, 37, 200, 300, True, unit),
                    hw_probe._gemm_rate_probe_reference(xs, q_, v_, 37, 200, 300, True, unit),
                    tol[-1:])
    del data_, q_, v_, xr
    phase("probe", t0, f"K11-K14 equal to their plain versions at ragged shapes (K11 g 3 and "
          f"300; K12 [9,36,301] and [9,36,300] x [100,36], fat 3, planted step maxima, "
          f"value and every step; K13 [11,24,40] at depth 3 and 8 and bf16 [70,128,2048] "
          f"(the ring wraps) at depth 3 and 8, {ntrials} planted trials; K14 [200,96] x "
          f"[96,300] g=37, sel, value and every step), max |err| {probe_err} "
          f"({time.time() - t:.1f}s)")

    # One JAX size each, timed beside the plain version (and data.amax()):
    # device time of REPS calls captured in one CUDA graph, since the
    # Python wrapper's host time exceeds K11's device time.
    t = time.time()

    def gms(fn):
        return timing.graph_ms(fn, dev, calls=REPS)

    probe_check("K11", "g=4096 moving", hw_probe._step_probe(x1, 4096, True, None),
                hw_probe._step_probe_reference(x1, 4096, True, None))
    k11 = dict(ms=gms(lambda: hw_probe._step_probe(x1, 4096, True, None)),
               plain_ms=gms(lambda: hw_probe._step_probe_reference(
                   x1, 4096, True, None)),
               bound=bound(4096 * 4096 + 4096, 0, INT8_OPS_S))
    D128, BLK2 = 128, 2048
    walk, tops = hw_probe._planted_walk((512 << 20) // (D128 * BLK2), D128, BLK2, 1, torch.int8,
                                        pgen)
    xw = prand((128, D128), torch.int8)
    k12 = {}
    for gemm in (False, True):
        k12_checks(f"int8 512 MB blk={BLK2}", xw, walk, BLK2, 1, gemm, tops,
                   (None, "arbitrary"))
        k12[gemm] = dict(
            ms=gms(lambda: hw_probe._stream_probe(xw, walk, BLK2, 1, gemm, None)),
            plain_ms=gms(lambda: hw_probe._stream_probe_reference(
                xw, walk, BLK2, 1, gemm, None)),
            bound=bound(walk.numel() + walk.shape[0] * 4,
                        2.0 * 128 * walk.numel() if gemm else 0, INT8_OPS_S))
    k12[False]["lib_ms"] = gms(lambda: walk.amax())
    del walk, tops
    torch.cuda.empty_cache()
    walk = prand(((2 << 30) // (D128 * BLK2), D128, BLK2), torch.int8)
    k13_n = k13_trials("int8 2 GiB", walk, 8, 127, 127, 16)
    k13 = dict(ms=gms(lambda: hw_probe._dma_probe(x1, walk, 8)),
               plain_ms=gms(lambda: hw_probe._dma_probe_reference(x1, walk, 8)),
               lib_ms=gms(lambda: walk.amax()),
               bound=bound(walk.numel() + 4, 0, INT8_OPS_S))
    del walk
    torch.cuda.empty_cache()
    TB, TN, G = 256, 2048, 2048
    k14 = {}
    for dtype, unit, rate in ((torch.int8, "mma", INT8_OPS_S), (torch.int8, "dp4a", INT8_OPS_S),
                              (torch.bfloat16, "mma", 989e12)):
        q_, v_ = prand((TB, D128), dtype), prand((D128, TN), dtype)
        tol = (k14_bf16_tol(q_, v_, G) if dtype == torch.bfloat16
               else torch.zeros(G, dtype=torch.float64, device=dev))
        probe_check("K14", f"{dtype} {unit} ({TB}, {TN}) g={G} steps",
                    hw_probe._gemm_rate_steps(q_, v_, G, TB, TN, False, unit),
                    hw_probe._gemm_rate_steps_reference(q_, v_, G, TB, TN, False, unit), tol)
        probe_check("K14", f"{dtype} {unit} ({TB}, {TN}) g={G}",
                    hw_probe._gemm_rate_probe(x1, q_, v_, G, TB, TN, False, unit),
                    hw_probe._gemm_rate_probe_reference(x1, q_, v_, G, TB, TN, False, unit),
                    tol[-1:])
        units = (TB // 128) * (TN // 128)
        k14[f"{str(dtype).split('.')[1]} {unit}"] = dict(
            ms=gms(lambda: hw_probe._gemm_rate_probe(x1, q_, v_, G, TB, TN, False,
                                                                unit)),
            plain_ms=gms(lambda: hw_probe._gemm_rate_probe_reference(
                x1, q_, v_, G, TB, TN, False, unit)),
            bound=bound(q_.numel() * q_.element_size() + v_.numel() * v_.element_size()
                        + G * units * 8 * 4 + 4, 2.0 * TB * D128 * TN * G, rate))
    del q_, v_
    phase("probe", t0, f"JAX sizes, equal to the plain versions, value and every step (K12 "
          f"planted step maxima; K13 {k13_n} planted trials) ({time.time() - t:.1f}s); ms, "
          f"plain ms, library ms, bound: K11 g=4096 moving {k11}; K12 int8 512 MB blk={BLK2} "
          f"{k12[False]}, with the product {k12[True]}; K13 int8 2 GiB depth 8 {k13}; K14 "
          f"({TB}, {TN}) g={G} {k14}")

    # The probes themselves, counted, at the JAX sizes.
    t = time.time()
    reset_launches()
    ceil = hw_probe.main([])
    torch.cuda.synchronize()
    probe_launches = {k: read_launches()[k] for k in hw_probe.LAUNCHES}
    phase("probe", t0, f"hw_probe.main([]) {time.time() - t:.1f}s on {card}: launches "
          f"{probe_launches}")
    if min(probe_launches.values()) < 1:
        raise AssertionError(f"the probes did not launch every kernel: {probe_launches}")
    step, stream, dma, rate = (ceil[p] for p in ("pallas_step", "pallas_stream", "pallas_dma",
                                                 "pallas_gemm"))
    for name, value in (
            ("per-step us, a CTA per step (None, pinned)", step["slope_us"][None, False]),
            ("per-step us, a CTA per step (parallel, moving)", step["slope_us"]["parallel", True]),
            ("per-step us, one CTA looping (arbitrary, pinned)",
             step["slope_us"]["arbitrary", False]),
            ("per-step us, one CTA looping (arbitrary, moving)",
             step["slope_us"]["arbitrary", True]),
            ("launch us, eager", step["launch_us"]["eager"]),
            ("launch us, CUDA graph", step["launch_us"]["graph"]),
            ("streaming GB/s, int8 blk=2048 fat=1 (K12, a CTA per step)",
             stream["int8", 2048, 1, False, None]),
            ("streaming GB/s, best K12 walk", max(v for k, v in stream.items() if not k[3])),
            ("marginal DMA GB/s, int8 blk=2048 depth 8 (K13)", dma["int8", 2048, 8]),
            ("marginal DMA GB/s, best K13 walk", max(dma.values())),
            ("mma int8 TOPS at (256, 2048) (K14)", rate["int8", 256, 2048, "mma"]),
            ("dp4a int8 TOPS at (256, 2048) (K14)", rate["int8", 256, 2048, "dp4a"]),
            ("mma bf16 TFLOP/s at (256, 2048) (K14)", rate["bfloat16", 256, 2048, "mma"]),
            ("best mma int8 / dp4a int8 / mma bf16 TOPS (K14)",
             tuple(max(v for k, v in rate.items() if k[0] == dt and k[3] == u)
                   for dt, u in (("int8", "mma"), ("int8", "dp4a"), ("bfloat16", "mma")))),
            ("torch._int_mm 4096^3 TOPS / torch.mm bf16 4096^3 TFLOP/s",
             (ceil["xla"]["gemm"][4096, 4096, 4096, "int8"],
              ceil["xla"]["gemm"][4096, 4096, 4096, "bfloat16"])),
            ("1 GiB reduce GB/s int8 / copy GB/s r+w int8",
             (ceil["xla"]["reduce"]["int8"], ceil["xla"]["copy"]["int8"]))):
        print(f"[ceiling] {name}: {value}", flush=True)

    # ---- phase 13: the float modes (fp32, bf16) of K1, K4, K5 and K3 on the
    # corpus and queries loaded above.  Every check holds integer-valued data
    # (SIFT is 0..141, bf16 holds it exactly and every fp32 sum is exact), so
    # each kernel is bit-equal to its plain version.
    from rag_on_edge_tpu_torch.ops.block_tables import build_block_tables

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions and torch.mm in full fp32
    torch.cuda.empty_cache()
    fgen = torch.Generator(device=dev).manual_seed(13)
    floats = {"fp32": (torch.float32, OPS32_S), "bf16": (torch.bfloat16, BF16_OPS_S)}

    def fint(shape, dtype):
        """Integers in [-127, 127] as ``dtype``: exact in bf16, exact sums."""
        return torch.randint(-127, 128, shape, generator=fgen, device=dev).to(dtype)

    def bits_equal(x, y):
        """Equal bit for bit (fp32 as int32: -0 is not +0, NaN is its pattern)."""
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        return torch.equal(x, y)

    # Ragged sizes first (uncounted): D' = 129 and 37 (odd), 40 routed rows
    # (not a multiple of the 32-row tile), B = 70, N = 1300 and 3001 (not
    # multiples of the tile), 2900 valid columns of 3001.
    rsizes = np.array([2000, 0, 5000, 129, 700])
    roffs = np.concatenate([[0], np.cumsum(-(-rsizes // PAD_BLOCK) * PAD_BLOCK)[:-1]])
    rtabs = [torch.from_numpy(np.pad(x, (0, (-len(x)) % 8)).astype(np.int32)).to(dev)
             for x in build_block_tables(roffs, rsizes, PAD_BLOCK)[1:4]]
    rrows = torch.nonzero(rtabs[1]).flatten()
    ragged = {}
    for mode, (dt, _) in floats.items():
        qg_r, vt_r = fint((len(rtabs[0]), 40, 129), dt), fint((len(rtabs[0]), 129, PAD_BLOCK), dt)
        got = ivf_accum.cluster_major_accum_planes(qg_r, vt_r, *rtabs, blk=PAD_BLOCK)
        want = ivf_accum.cluster_major_accum_planes_reference(qg_r, vt_r, *rtabs, blk=PAD_BLOCK)
        ragged[f"K1 {mode}"] = torch.equal(got[rrows], want[rrows])
        pv, pr = ivf_scan.cluster_major_scan_grouped(qg_r, vt_r, *rtabs, kk, blk=PAD_BLOCK)
        rpv, rpr = ivf_scan.cluster_major_scan_grouped_reference(qg_r, vt_r, *rtabs, kk,
                                                                 blk=PAD_BLOCK)
        fin = rpv[rrows] > float("-inf")
        ragged[f"K4 {mode}"] = bool(fin.any()) and torch.equal(pv[rrows], rpv[rrows]) \
            and torch.equal(pr[rrows][fin], rpr[rrows][fin])
        tiles_r, _ = bruteforce_accum.tile_base(fint((37, 1300), dt), 128, 4)
        q_r = fint((70, 37), dt)
        v, i = bruteforce_accum.fused_topk_accum(q_r, tiles_r, 1300, 32, group=4, depth=4)
        rv, ri = bruteforce_accum.fused_topk_accum_reference(q_r, tiles_r, 1300, 32, group=4,
                                                             depth=4)
        ragged[f"K5 {mode}"] = bits_equal(v, rv) and torch.equal(i, ri)
    q_r, b_r = fint((70, 37), torch.bfloat16), fint((37, 3001), torch.bfloat16)
    nv_r = torch.tensor([2900], dtype=torch.int32, device=dev)
    for nbins in (0, 128):
        v, i = bruteforce_fused.fused_topk_matmul(q_r, b_r, 32, nbins=nbins, n_valid=nv_r)
        rv, ri = bruteforce_fused.fused_topk_matmul_reference(q_r, b_r, 32, nbins=nbins,
                                                              n_valid=nv_r)
        ragged[f"K3 bf16 nbins={nbins}"] = bits_equal(v, rv) and torch.equal(i, ri)
    torch.cuda.synchronize()
    phase("float", t0, f"ragged sizes, bit-equal to the plain versions: {ragged}")
    if not all(ragged.values()):
        raise AssertionError(f"a float mode differs from its plain version: {ragged}")
    del qg_r, vt_r, got, want, pv, pr, rpv, rpr, tiles_r, q_r, b_r

    # Non-integer data (uncounted): K5's and K3's bf16 modes sum on the
    # tensor cores in another order than the plain fp32 product of the same
    # bf16 values.  Values within the order bound 2·D·2^-24·(|q|@|b|) of the
    # row (K5's keys cede log2(group) low bits on top), -inf where the plain
    # version has it, ids equal where a value stands more than twice the
    # bound from both neighbours.
    def topk_close(v, i, rv, ri, bnd):
        fin = rv > float("-inf")
        err = (v.double() - rv.double()).abs()
        ok = (torch.equal(v > float("-inf"), fin)
              and bool((err[fin] <= bnd.expand_as(err)[fin]).all()))
        gap = rv.double().diff(dim=-1).abs() > 2.0 * bnd
        sep = fin.clone()
        sep[..., :-1] &= gap
        sep[..., 1:] &= gap
        sep[..., -1] = False
        return (ok and bool(sep.any()) and torch.equal(i[sep], ri[sep]),
                float(err[fin].max()))

    ngen = torch.Generator(device=dev).manual_seed(131)
    q_n = torch.randn((200, 129), generator=ngen, device=dev).to(torch.bfloat16)
    b_n = torch.randn((129, 9000), generator=ngen, device=dev).to(torch.bfloat16)
    order = 2.0 * 129 * 2.0**-24 * (q_n.double().abs() @ b_n.double().abs()).amax(
        dim=1, keepdim=True)
    tiles_n, _ = bruteforce_accum.tile_base(b_n, 2048, 4)
    v, i = bruteforce_accum.fused_topk_accum(q_n, tiles_n, 9000, 20, group=4, depth=4)
    rv, ri = bruteforce_accum.fused_topk_accum_reference(q_n, tiles_n, 9000, 20, group=4,
                                                         depth=4)
    nonint = {"K5 bf16": topk_close(v, i, rv, ri, order + rv.double().abs().amax(
        dim=1, keepdim=True) * 2.0**-21)}
    nv_n = torch.tensor([8500], dtype=torch.int32, device=dev)
    for nbins in (0, 128):
        v, i = bruteforce_fused.fused_topk_matmul(q_n, b_n, 32, nbins=nbins, n_valid=nv_n)
        rv, ri = bruteforce_fused.fused_topk_matmul_reference(q_n, b_n, 32, nbins=nbins,
                                                              n_valid=nv_n)
        nonint[f"K3 bf16 nbins={nbins}"] = topk_close(v, i, rv, ri, order)
    torch.cuda.synchronize()
    phase("float", t0, f"non-integer data, within the order bound (ok, max |err|): {nonint}")
    if not all(ok for ok, _ in nonint.values()):
        raise AssertionError(f"a bf16 mode leaves the order bound: {nonint}")
    del q_n, b_n, tiles_n, v, i, rv, ri

    fl = {}  # "K1 fp32" ... → err, ms, plain_ms, bound, launches, lib_ms

    def float_ivf(index, mode):
        """K1 and K4 of a float index against their plain versions on the
        first routed B=8192 batch (K4 at the batch's recovery list), then
        the default call over all queries, counted; its recall and stages."""
        rate = floats[mode][1]
        fa = index._arrays
        vt = fa["vectors_t"]
        es, dp = vt.element_size(), vt.shape[1]
        qcap_f = index._auto_qcap(BATCH, NPROBE)
        probes_f, cq_f, slot_f, lossy_f, _ = index._route(q, NPROBE, qcap_f)
        qi_f, qb_f, _, _, _ = index._scan_inputs(q, cq_f)
        args = (qb_f, vt, fa["block_first"], fa["block_last"], fa["rows_valid"])
        pp_f = ivf_accum.cluster_major_accum_planes(*args, blk=PAD_BLOCK)
        pp_ref = ivf_accum.cluster_major_accum_planes_reference(*args, blk=PAD_BLOCK)
        torch.cuda.synchronize()
        rows_f = torch.nonzero(fa["block_last"]).flatten()
        err = int((pp_f[rows_f].long() - pp_ref[rows_f].long()).abs().max())
        if err:
            raise AssertionError(f"K1 {mode} planes differ from the plain version: {err}")
        del pp_ref
        walked_f = walked_blocks(np, *args[2:])
        fl[f"K1 {mode}"] = dict(
            err=err, ms=cuda_ms(torch, lambda: ivf_accum.cluster_major_accum_planes(
                *args, blk=PAD_BLOCK)),
            plain_ms=cuda_ms(torch, lambda: ivf_accum.cluster_major_accum_planes_reference(
                *args, blk=PAD_BLOCK), reps=3),
            bound=bound(walked_f * (qcap_f + PAD_BLOCK) * dp * es + rows_f.numel()
                        * pp_f[0].numel() * 4, 2.0 * walked_f * qcap_f * PAD_BLOCK * dp, rate),
            lib_ms=None)
        phase("float", t0, f"K1 {mode} qg {tuple(qb_f.shape)} vectors_t {tuple(vt.shape)}: "
              f"bit-equal on {rows_f.numel()} last blocks ({walked_f} walked); "
              f"{fl[f'K1 {mode}']}")
        nb_f = vt.shape[0]
        rb_f = -(-(nb_f // 4) // index.CM_GROUP) * index.CM_GROUP
        rec, _, _, _ = index._recover_tables(qi_f, probes_f, lossy_f, None, qcap_f, rb_f)
        kw = dict(k=kk, blk=PAD_BLOCK, group=index.CM_GROUP, row_base=rec[6])
        pv, pr = ivf_scan.cluster_major_scan_grouped(*rec[:5], **kw)
        rpv, rpr = ivf_scan.cluster_major_scan_grouped_reference(*rec[:5], **kw)
        torch.cuda.synchronize()
        r4 = torch.nonzero(rec[3]).flatten()
        fin = rpv[r4] > float("-inf")
        if not torch.equal(pv[r4], rpv[r4]) or not torch.equal(pr[r4][fin], rpr[r4][fin]):
            raise AssertionError(f"K4 {mode} differs from the plain version at the recovery "
                                 "list")
        walked4 = walked_blocks(np, *rec[2:5])
        fl[f"K4 {mode}"] = dict(
            err=float((pv[r4][fin] - rpv[r4][fin]).abs().max()) if fin.any() else 0.0,
            ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_grouped(*rec[:5], **kw)),
            plain_ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_grouped_reference(
                *rec[:5], **kw), reps=3),
            bound=bound(walked4 * (qcap_f + PAD_BLOCK) * dp * es + r4.numel() * qcap_f * kk * 8,
                        2.0 * walked4 * qcap_f * PAD_BLOCK * dp, rate),
            lib_ms=None)
        phase("float", t0, f"K4 {mode} recovery list qg {tuple(rec[0].shape)} ({int(lossy_f.sum())} "
              f"lossy pairs, {walked4} blocks walked): pv bit-equal, pr equal where finite "
              f"({int(fin.sum())} finite entries); {fl[f'K4 {mode}']}")
        del pv, pr, rpv, rpr, rec
        # The default call, counted.
        reset_launches()
        ids_f, _, residual_f, wall_f = search_all(index)
        launch_f = read_launches()
        r10_f, r1_f = recalls(ids_f)
        fl[f"K1 {mode}"]["launches"] = launch_f["K1"]
        fl[f"K4 {mode}"]["launches"] = launch_f["K4"]
        call_ms = cuda_ms(torch, lambda: index.search_device(qs, K, NPROBE))
        rp = index._auto_recover_passes(BATCH, NPROBE, qcap_f)
        pp_f = index._scan(qb_f, None)
        extra_f, _ = index._recover(qi_f, probes_f, lossy_f, None, None, kk, qcap_f, rb_f, rp)
        stage_f = {name: cuda_ms(torch, fn) for name, fn in {
            "route": lambda: index._route(qs, NPROBE, qcap_f),
            "prep": lambda: index._scan_inputs(qs, cq_f),
            "K1": lambda: index._scan(qb_f, None),
            "recover": lambda: index._recover(qi_f, probes_f, lossy_f, None, None, kk, qcap_f,
                                              rb_f, rp),
            "finish": lambda: index._cm_finish_planes(qs, probes_f, slot_f, pp_f, K, kk, True,
                                                      None, extra=extra_f)}.items()}
        phase("float", t0, f"{mode} IVFIndex search_device(q, {K}, {NPROBE}) defaults, "
              f"{N_QUERIES} queries {wall_f:.1f}s: engine={index.last_engine} auto_recover="
              f"{index._auto_recover(BATCH, NPROBE)} residual last_spill={residual_f} "
              f"launches={launch_f} recall@10={r10_f:.4f} recall@1={r1_f:.4f} (int8 index "
              f"{r10:.4f}, {r1:.4f}); one B={BATCH} call {call_ms} ms on {card}; stages ms "
              f"{stage_f}")
        if index.last_engine != "pallas_accum" or min(launch_f["K1"], launch_f["K4"]) < 1:
            raise AssertionError(f"{mode} default call: engine {index.last_engine}, launches "
                                 f"{launch_f} (K1 and the recovery pass's K4 expected)")
        if any(residual_f):
            raise AssertionError(f"{mode}: pairs still dropped after recovery: {residual_f}")
        return r10_f, r1_f

    t = time.time()
    fidx = IVFIndex.build(base, nlist=NLIST, metric="l2", pad_block=PAD_BLOCK,
                          centroids=int8_centroids, device=dev)
    fidx._ensure_kernel_state()
    torch.cuda.synchronize()
    phase("float", t0, f"IVFIndex.build(nlist={NLIST}, metric='l2', pad_block={PAD_BLOCK}, "
          f"centroids=the int8 index's) {time.time() - t:.1f}s: dtype={fidx.dtype} vectors_t "
          f"{tuple(fidx._arrays['vectors_t'].shape)} {fidx._arrays['vectors_t'].dtype}")
    if fidx.dtype != "fp32":
        raise AssertionError(f"IVFIndex.build defaulted to {fidx.dtype}, not fp32")
    r10_f32, r1_f32 = float_ivf(fidx, "fp32")
    if r10_f32 < 0.99 or r1_f32 < r1:
        raise AssertionError(f"fp32 IVF recall@10 {r10_f32} below 0.99 or recall@1 {r1_f32} "
                             f"below the int8 index's {r1}")
    arrays_f = (fidx._centroids_np, fidx._vectors_np, fidx._offsets_np, fidx._reorder_np)
    config_f = dict(fidx.config)
    del fidx
    torch.cuda.empty_cache()
    bidx = IVFIndex.from_arrays(*arrays_f, metric="l2", dtype="bf16", pad_block=PAD_BLOCK,
                                config=config_f, device=dev)
    bidx._ensure_kernel_state()
    r10_b16, r1_b16 = float_ivf(bidx, "bf16")
    del bidx  # phase 14 builds its indexes from arrays_f again
    torch.cuda.empty_cache()

    # Brute force: the defaults (ip, bf16, accum = K5, rescored), K5 fp32 on
    # an L2 accum index (the augmented dimension), and K3 bf16 (engine="pallas").
    gt_ip = ground_truth(base, queries, K, metric="ip", device=dev, query_chunk=512)

    def gemm_ms(qx, bt):
        """The product alone, one PyTorch call per column block of 1/8 (the
        whole [8192, 1M] fp32 output would be 34 GB): fp32 with TF32 off,
        bf16 through torch.mm(out_dtype=float32)."""
        step = -(-bt.shape[1] // 8)
        if qx.dtype == torch.bfloat16:
            return sum(cuda_ms(torch, lambda s=s: torch.mm(qx, bt[:, s:s + step],
                                                           out_dtype=torch.float32), reps=3)
                       for s in range(0, bt.shape[1], step))
        return sum(cuda_ms(torch, lambda s=s: torch.mm(qx, bt[:, s:s + step]), reps=3)
                   for s in range(0, bt.shape[1], step))

    def brute_float(index, mode, gt_, floor):
        """K5 of an accum index against its plain version on one B=8192
        batch, timed beside the GEMM alone; then all queries, counted."""
        ba_ = index._arrays
        tiles = ba_["base_tiles"]
        qx = index._augment(q_full)
        kw = dict(group=index._acc_group, depth=index._acc_depth)
        v, i = bruteforce_accum.fused_topk_accum(qx, tiles, N_BASE, kq, **kw)
        rv, ri = bruteforce_accum.fused_topk_accum_reference(qx, tiles, N_BASE, kq, **kw)
        torch.cuda.synchronize()
        if not bits_equal(v, rv) or not torch.equal(i, ri):
            raise AssertionError(f"K5 {mode} differs from its plain version at B={BATCH}")
        dp = tiles.shape[1]
        bt = tiles.permute(1, 0, 2).reshape(dp, -1)[:, :N_BASE].contiguous()
        name = f"K5 {mode}"
        fl[name] = dict(
            err=float((v.double() - rv.double()).abs().max()), ms=cuda_ms(torch, lambda: bruteforce_accum.fused_topk_accum(
                qx, tiles, N_BASE, kq, **kw), reps=5),
            plain_ms=cuda_ms(torch, lambda: bruteforce_accum.fused_topk_accum_reference(
                qx, tiles, N_BASE, kq, **kw), reps=3),
            lib_ms=gemm_ms(qx, bt),
            bound=bound(qx.numel() * qx.element_size() + tiles.numel() * tiles.element_size()
                        + BATCH * kq * 8, 2.0 * BATCH * n_live * dp, floats[mode][1]))
        del v, i, rv, ri, bt
        ids_, launch_, wall_ = brute_all(index)
        r10_ = recall_at_k(ids_, gt_, K)
        fl[name]["launches"] = launch_["K5"]
        call_ms = cuda_ms(torch, lambda: index.search_device(q_full, K), reps=5)
        phase("float", t0, f"BruteForceIndex(metric={index.metric!r}, dtype={index.dtype!r}) "
              f"engine={index.engine} rescore={index.rescore} tiles {tuple(tiles.shape)}: K5 "
              f"bit-equal to the plain version at B={BATCH}; {fl[name]}; {N_QUERIES} queries "
              f"{wall_:.1f}s: launches={launch_} recall@10={r10_:.4f}; one B={BATCH} call "
              f"{call_ms} ms")
        if launch_["K5"] < 1 or r10_ < floor:
            raise AssertionError(f"{mode} accum: launches {launch_}, recall@10 {r10_} below "
                                 f"{floor}")

    bf_def = BruteForceIndex(base, device=dev)  # every default
    if (bf_def.metric, bf_def.dtype, bf_def.engine, bf_def.rescore) != ("ip", "bf16", "accum",
                                                                         True):
        raise AssertionError(f"BruteForceIndex defaults: {bf_def.metric} {bf_def.dtype} "
                             f"{bf_def.engine} rescore={bf_def.rescore}")
    brute_float(bf_def, "bf16", gt_ip, 0.99)
    del bf_def
    torch.cuda.empty_cache()
    bf_f32 = BruteForceIndex(base, metric="l2", dtype="fp32", device=dev)
    brute_float(bf_f32, "fp32", gt, 0.99)
    del bf_f32
    torch.cuda.empty_cache()

    bf_k3 = BruteForceIndex(base, metric="l2", dtype="bf16", engine="pallas", rescore=True,
                            device=dev)
    bt3 = bf_k3._arrays["base_t"]
    q3 = bf_k3._augment(q_full)
    k3_eq, k3_err = {}, 0.0
    for nbins in (0, 128):  # the exact mode and the rescore's binned mode
        v, i = bruteforce_fused.fused_topk_matmul(q3[:1024], bt3, kq, nbins=nbins)
        rv, ri = bruteforce_fused.fused_topk_matmul_reference(q3[:1024], bt3, kq, nbins=nbins)
        torch.cuda.synchronize()
        k3_eq[nbins] = bits_equal(v, rv) and torch.equal(i, ri)
        k3_err = max(k3_err, float((v.double() - rv.double()).abs().max()))
    del v, i, rv, ri
    if not all(k3_eq.values()):
        raise AssertionError(f"K3 bf16 differs from its plain version: {k3_eq}")
    fl["K3 bf16"] = dict(
        err=k3_err, ms=cuda_ms(torch, lambda: bruteforce_fused.fused_topk_matmul(
            q3, bt3, kq, nbins=128), reps=3),
        plain_ms=cuda_ms(torch, lambda: bruteforce_fused.fused_topk_matmul_reference(
            q3[:1024], bt3, kq, nbins=128), reps=3),
        lib_ms=gemm_ms(q3, bt3),
        bound=bound((q3.numel() + bt3.numel()) * 2 + BATCH * kq * 8,
                    2.0 * BATCH * N_BASE * bt3.shape[0], BF16_OPS_S))
    ids_3, launch_3, wall_3 = brute_all(bf_k3)
    r10_3 = recall_at_k(ids_3, gt, K)
    fl["K3 bf16"]["launches"] = launch_3["K3"]
    k3_call_ms = cuda_ms(torch, lambda: bf_k3.search_device(q_full, K), reps=3)
    # The same search through K3's plain version and the same rescore, over
    # all queries: the index must return its ids, so its recall is the bf16
    # algorithm's (the augmented column -|b|^2/2 rounded to bf16), which the
    # JAX package shares, and not the kernel's.  The exact selection
    # (nbins=0) beside it tells the rounding from the bins.
    plain_ids = {0: [], 128: []}
    for s_ in range(0, N_QUERIES, 1024):
        qf = torch.from_numpy(np.ascontiguousarray(queries[s_:s_ + 1024])).to(dev)
        for nbins in plain_ids:
            _, cand = bruteforce_fused.fused_topk_matmul_reference(bf_k3._augment(qf), bt3, kq,
                                                                   nbins=nbins)
            plain_ids[nbins].append(bf_k3._rescore_exact(qf, cand, K)[1].cpu().numpy())
    plain_ids = {nbins: np.concatenate(v) for nbins, v in plain_ids.items()}
    k3_same = np.array_equal(plain_ids[128], ids_3)
    phase("float", t0, f"BruteForceIndex(metric='l2', dtype='bf16', engine='pallas', "
          f"rescore=True): K3 bf16 bit-equal to the plain version at B=1024 (nbins 0 and "
          f"128: {k3_eq}); {fl['K3 bf16']} (ms at B={BATCH}, plain at B=1024); {N_QUERIES} "
          f"queries {wall_3:.1f}s: launches={launch_3} recall@10={r10_3:.4f} (int8 "
          f"{r10_p:.4f}), ids equal to the plain path's on all queries: {k3_same}, the plain "
          f"path with the exact selection recall@10={recall_at_k(plain_ids[0], gt, K):.4f}; "
          f"one B={BATCH} call {k3_call_ms} ms")
    if launch_3["K3"] < 1 or not k3_same or r10_3 < 0.99:
        raise AssertionError(f"bf16 engine='pallas': launches {launch_3}, ids equal to the "
                             f"plain path {k3_same}, recall@10 {r10_3}")
    del bf_k3, bt3, q3
    torch.cuda.empty_cache()

    # ---- phase 14: the float modes (fp32, bf16) of K6, K7, K9 and K10 and the
    # paths that reach them (the float sharded index, the float routed engine,
    # the kernel lab on a float table), then the query-major mode and the xla
    # engine of the int8, fp32 and bf16 indexes.  Integer-valued data again:
    # every kernel is held bit-equal to its plain version.
    from rag_on_edge_tpu_torch.ops import topk as topk_mod

    def scan_equal(pv, pr, rpv, rpr, need_finite=True):
        """pv bit-equal, pr equal where the value is finite, and (with
        ``need_finite``) some value finite."""
        fin = rpv > float("-inf")
        return (bool(fin.any()) or not need_finite) and bits_equal(pv, rpv) \
            and torch.equal(pr[fin], rpr[fin])

    def k10_windows(variant, bc_, bl_):
        """The windows a K10 variant defines (phase 10)."""
        if variant == "fixedout":
            return torch.zeros(1, dtype=torch.long, device=dev)
        if variant == "maxonly":
            return torch.unique(bc_.long())
        return torch.unique(bc_[bl_ > 0].long())

    # Ragged sizes first (uncounted): D' 37, 129 and 320; 40 routed rows; a
    # batch of 70 with one slot past it; phase 13's clusters, with the block
    # cluster table, and the walk cut after its last block with rows for K10.
    bc_r, bf_r, bl_r, rv_r, _ = build_block_tables(roffs, rsizes, PAD_BLOCK)
    pad_r = (-len(bc_r)) % 8
    tabs_r = [torch.from_numpy(x.astype(np.int32)).to(dev) for x in (
        np.pad(bc_r, (0, pad_r), constant_values=len(rsizes) - 1),
        *(np.pad(x, (0, pad_r)) for x in (bf_r, bl_r, rv_r)))]
    nb_r, last_r = tabs_r[0].numel(), torch.nonzero(tabs_r[2]).flatten()
    cut_r = int(torch.nonzero(tabs_r[3]).max()) + 1
    rng14 = np.random.default_rng(14)
    cq_r = np.full((len(rsizes), 40), -1, np.int32)
    for c_ in range(len(rsizes)):
        n_ = int(rng14.integers(1, 41))
        cq_r[c_, :n_] = rng14.choice(70, n_, replace=False)
    cq_r[0, 0] = 70  # past the batch: a zero row, as -1 gives
    cqb_r = torch.from_numpy(cq_r).to(dev)[tabs_r[0].long()].unsqueeze(-1).contiguous()
    ragged14 = {}
    for mode, (dt, _) in floats.items():
        for dp in (37, 129, 320):
            qg_r = fint((len(rsizes), 40, dp), dt)
            qg_r[:, ::7] = 0  # empty routed slots: scores +0
            vt_r = fint((nb_r, dp, PAD_BLOCK), dt)
            qi_r = fint((70, dp), dt)
            r6 = tabs_r[0][last_r].long()
            out = ivf_scan.cluster_major_scan(qg_r, vt_r, *tabs_r, kk, blk=PAD_BLOCK)
            ref = ivf_scan.cluster_major_scan_reference(qg_r, vt_r, *tabs_r, kk, blk=PAD_BLOCK)
            ragged14[f"K6 {mode} D'{dp}"] = scan_equal(out[0][r6], out[1][r6], ref[0][r6],
                                                       ref[1][r6])
            args = (qi_r, cqb_r, vt_r, *tabs_r[1:], kk)
            out = ivf_scan.cluster_major_scan_routed(*args, blk=PAD_BLOCK)
            ref = ivf_scan.cluster_major_scan_routed_reference(*args, blk=PAD_BLOCK)
            ragged14[f"K7 {mode} D'{dp}"] = scan_equal(out[0][last_r], out[1][last_r],
                                                       ref[0][last_r], ref[1][last_r])
            args = (qg_r[tabs_r[0].long()].contiguous(), vt_r, *tabs_r[1:], kk)
            out = ivf_accum.cluster_major_accum(*args, blk=PAD_BLOCK)
            ref = ivf_accum.cluster_major_accum_reference(*args, blk=PAD_BLOCK)
            ragged14[f"K9 {mode} D'{dp}"] = bits_equal(out[0][last_r], ref[0][last_r]) \
                and torch.equal(out[1][last_r], ref[1][last_r])
            tabs_c = [x[:cut_r] for x in tabs_r]
            for variant in kernel_lab.VARIANTS:
                args = (qg_r, vt_r[:cut_r], *tabs_c, kk, PAD_BLOCK, 128, variant)
                out = kernel_lab._variant_scan(*args)
                ref = kernel_lab._variant_scan_reference(*args)
                win = k10_windows(variant, tabs_c[0], tabs_c[2])
                ragged14[f"K10 {variant} {mode} D'{dp}"] = scan_equal(out[0][win], out[1][win],
                                                                      ref[0][win], ref[1][win])
    torch.cuda.synchronize()
    del qg_r, vt_r, qi_r, out, ref
    phase("floatscan", t0, f"ragged sizes, bit-equal to the plain versions: "
          f"{sum(ragged14.values())} of {len(ragged14)} {ragged14}")
    if not all(ragged14.values()):
        raise AssertionError(f"a float mode of K6, K7, K9 or K10 differs from its plain "
                             f"version: {[n for n, ok in ragged14.items() if not ok]}")

    fl14 = {}  # "K6 fp32", ... → err, ms, plain_ms, bound, launches, lib_ms
    n_batches = -(-N_QUERIES // BATCH)

    def max_err(pv, rpv):
        fin = rpv > float("-inf")
        return float((pv[fin] - rpv[fin]).abs().max()) if fin.any() else 0.0

    def float_paths(index, mode, single_r10, single_r1):
        """K7, K9, K10 and K6 of a float index at SIFT-1M size against their
        plain versions, and the paths that launch them, counted."""
        rate = floats[mode][1]
        fa = index._arrays
        vt = fa["vectors_t"]
        es, dp = vt.element_size(), vt.shape[1]
        tabs = (fa["block_first"], fa["block_last"], fa["rows_valid"])
        qcap_f = index._auto_qcap(BATCH, NPROBE)
        probes_f, cq_f, _, lossy_f, _ = index._route(q, NPROBE, qcap_f)
        qi_f, _, _ = index._query_prep(q)
        rb_f = -(-(vt.shape[0] // 4) // index.CM_GROUP) * index.CM_GROUP
        passes_f = index._auto_recover_passes(BATCH, NPROBE, qcap_f)

        # K7 at the dense walk and at this batch's recovery list.
        k7_in = {"dense": (cq_f[fa["block_cluster"].long()].unsqueeze(-1).contiguous(), vt,
                           *tabs, None, None),
                 "recovery": index._recover_tables(qi_f, probes_f, lossy_f, None, qcap_f, rb_f,
                                                   routed=True)[0]}
        k7 = {}
        for name, (cqb_, vt_, bf_, bl_, rv_, _, rb_) in k7_in.items():
            kw = dict(k=kk, blk=PAD_BLOCK, group=index.CM_GROUP, row_base=rb_)
            args = (qi_f, cqb_, vt_, bf_, bl_, rv_)
            pv, pr = ivf_scan.cluster_major_scan_routed(*args, **kw)
            rpv, rpr = ivf_scan.cluster_major_scan_routed_reference(*args, **kw)
            torch.cuda.synchronize()
            r7 = torch.nonzero(bl_).flatten()
            if not scan_equal(pv[r7], pr[r7], rpv[r7], rpr[r7]):
                raise AssertionError(f"K7 {mode} differs from the plain version at the {name} "
                                     "walk")
            err = max_err(pv[r7], rpv[r7])
            del pv, pr, rpv, rpr
            walked = walked_blocks(np, bf_, bl_, rv_)
            k7[name] = dict(
                err=err, ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_routed(*args, **kw)),
                plain_ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_routed_reference(
                    *args, **kw), reps=3),
                bound=bound(walked * (qcap_f * 4 + dp * PAD_BLOCK * es) + qi_f.numel() * es
                            + r7.numel() * qcap_f * kk * 8,
                            2.0 * walked * qcap_f * PAD_BLOCK * dp, rate), lib_ms=None)
            phase("floatscan", t0, f"K7 {mode} {name}: qi {tuple(qi_f.shape)} cq_blocks "
                  f"{tuple(cqb_.shape)} vectors_t {tuple(vt_.shape)} k={kk}: pv bit-equal, pr "
                  f"equal where finite, on {r7.numel()} last blocks ({walked} walked); {k7[name]}")
        del k7_in
        fl14[f"K7 {mode}"] = k7["dense"]

        # The routed engine over all queries, counted, against engine="pallas".
        reset_launches()
        ids_r, scores_r, residual_r, wall_r = search_all(index, engine="pallas_routed")
        launch_r = read_launches()
        engine_r = index.last_engine
        ids_g, scores_g, residual_g, _ = search_all(index, engine="pallas")
        r10_r, r1_r = recalls(ids_r)
        k7_expected = n_batches * (1 + (passes_f if index._auto_recover(BATCH, NPROBE) else 0))
        fl14[f"K7 {mode}"]["launches"] = launch_r["K7"]
        routed_ms = cuda_ms(torch, lambda: index.search_device(qs, K, NPROBE,
                                                               engine="pallas_routed"))
        grouped_ms = cuda_ms(torch, lambda: index.search_device(qs, K, NPROBE, engine="pallas"))
        same = np.array_equal(ids_r, ids_g) and scores_r.tobytes() == scores_g.tobytes()
        phase("floatscan", t0, f"{mode} engine={engine_r} {N_QUERIES} queries {wall_r:.1f}s: "
              f"residual last_spill={residual_r} launches={launch_r} (K7 expected "
              f"{k7_expected}) recall@10={r10_r:.4f} recall@1={r1_r:.4f}; ids and scores equal "
              f"to engine=pallas on every query: {same}; one B={BATCH} call {routed_ms} ms "
              f"(engine=pallas {grouped_ms} ms) on {card}")
        if engine_r != "pallas_routed" or launch_r["K7"] != k7_expected or launch_r["K4"] \
                or launch_r["K1"]:
            raise AssertionError(f"{mode} routed engine: {engine_r}, launches {launch_r}")
        if not same or any(residual_r) or any(residual_g) or r10_r < 0.99:
            raise AssertionError(f"{mode} routed engine: equal to pallas {same}, residual "
                                 f"{residual_r} {residual_g}, recall@10 {r10_r}")
        del ids_r, scores_r, ids_g, scores_g

        # K9 at K1's shapes (the batch's routed table per block), counted.
        _, qb_f, _, _, _ = index._scan_inputs(q, cq_f)
        args9 = (qb_f, vt, *tabs, kk)
        reset_launches()
        pv, pr = ivf_accum.cluster_major_accum(*args9, blk=PAD_BLOCK)
        torch.cuda.synchronize()
        n9 = read_launches()["K9"]
        rpv, rpr = ivf_accum.cluster_major_accum_reference(*args9, blk=PAD_BLOCK)
        torch.cuda.synchronize()
        rows9 = torch.nonzero(fa["block_last"]).flatten()
        if n9 != 1 or not bits_equal(pv[rows9], rpv[rows9]) or not torch.equal(pr[rows9],
                                                                                rpr[rows9]):
            raise AssertionError(f"K9 {mode} differs from the plain version (launches {n9})")
        walked9 = walked_blocks(np, *tabs)
        fl14[f"K9 {mode}"] = dict(
            err=max_err(pv[rows9], rpv[rows9]), launches=n9, lib_ms=None,
            ms=cuda_ms(torch, lambda: ivf_accum.cluster_major_accum(*args9, blk=PAD_BLOCK)),
            plain_ms=cuda_ms(torch, lambda: ivf_accum.cluster_major_accum_reference(
                *args9, blk=PAD_BLOCK), reps=3),
            bound=bound(walked9 * (qcap_f + PAD_BLOCK) * dp * es + rows9.numel() * qcap_f * kk * 8,
                        2.0 * walked9 * qcap_f * PAD_BLOCK * dp, rate))
        del pv, pr, rpv, rpr, qb_f, args9
        phase("floatscan", t0, f"K9 {mode} (K1's shapes, k={kk}, bin2): pv (the masked key) "
              f"bit-equal and pr equal on {rows9.numel()} last blocks; {fl14[f'K9 {mode}']}")

        # K10: the lab's defaults on a float routed table, made as the lab's
        # routed_table makes its int8 one (same shuffle, IP probes, qcap 128)
        # with the index's own query prep (the ones column of L2).
        rng = np.random.default_rng(0)
        ql = torch.from_numpy(rng.permuted(np.resize(queries, (LAB_BATCH, DIM)), axis=0)
                              .astype(np.float32)).to(dev)
        _, probes_l = topk_mod.small_topk(ql @ fa["centroids"].T, NPROBE)
        cq_l, _, _ = ivf_mod.invert_probes(probes_l, NLIST, LAB_QCAP)
        ql_i = index._query_prep(ql)[0]
        qg_l = torch.where((cq_l >= 0)[..., None], ql_i[cq_l.clamp_min(0).long()],
                           torch.zeros((), dtype=ql_i.dtype, device=dev)).contiguous()
        lab_tabs = (vt, fa["block_cluster"], *tabs)
        err10, plain10 = 0.0, None
        for variant in kernel_lab.VARIANTS:
            args = (qg_l, *lab_tabs, LAB_K, PAD_BLOCK, 128, variant)
            pv, pr = kernel_lab._variant_scan(*args)
            rpv, rpr = kernel_lab._variant_scan_reference(*args)
            torch.cuda.synchronize()
            win = k10_windows(variant, fa["block_cluster"], fa["block_last"])
            # fixedout's window is the walk's last block, a dummy without rows.
            if not scan_equal(pv[win], pr[win], rpv[win], rpr[win],
                              need_finite=variant != "fixedout"):
                raise AssertionError(f"K10 {variant} {mode} differs from the plain version")
            if variant == "full":
                kv, ki = ivf_scan.cluster_major_scan(qg_l, *lab_tabs, LAB_K, blk=PAD_BLOCK)
                if not scan_equal(pv[win], pr[win], kv[win], ki[win]):
                    raise AssertionError(f"K10 full {mode} differs from K6 on the same table")
                del kv, ki
                plain10 = cuda_ms(torch, lambda: kernel_lab._variant_scan_reference(*args),
                                  reps=3)
            err10 = max(err10, max_err(pv[win], rpv[win]))
            del pv, pr, rpv, rpr
        reset_launches()
        lab_f = kernel_lab.lab(index, qg_l, LAB_K, 128, kernel_lab.VARIANTS, repeats=REPS,
                               quiet=True)
        torch.cuda.synchronize()
        n10 = read_launches()["K10"]
        walked10 = walked_blocks(np, *tabs)
        n_win = k10_windows("full", fa["block_cluster"], fa["block_last"]).numel()
        fl14[f"K10 {mode}"] = dict(
            err=err10, ms=lab_f["full"][0], plain_ms=plain10, launches=n10, lib_ms=None,
            bound=bound(walked10 * dp * PAD_BLOCK * es + n_win * LAB_QCAP * (dp * es + LAB_K * 8),
                        2.0 * walked10 * LAB_QCAP * PAD_BLOCK * dp, rate))
        phase("floatscan", t0, f"K10 {mode} qg {tuple(qg_l.shape)}: the four variants equal "
              f"to their plain versions on their windows, full equal to K6; lab ms/call and "
              f"us/block {lab_f}; launches {n10}; {fl14[f'K10 {mode}']}")
        if n10 != len(kernel_lab.VARIANTS) * (REPS + 2):
            raise AssertionError(f"the {mode} lab launched K10 {n10} times")
        del qg_l, ql, ql_i

        # K6: the index as ShardedIVFIndex over 4 logical shards on this card.
        sh = ShardedIVFIndex(index, shards)
        sh._ensure_cluster_state()
        sa = sh._cm_arrays
        r = sh._cm_route(q, NPROBE, qcap_f)
        owned_lossy = [int((r["lossy"] & (a_["cluster_shard"][r["probes"].long()] == s_)).sum())
                       for s_, a_ in enumerate(sa)]
        s_rec = int(np.argmax(owned_lossy))
        rb_sh = max(1, sa[0]["vectors_t"].shape[0] // 4)
        rec_scan, _, _ = sh._cm_recover_tables(s_rec, r, r["lossy"], None, qcap_f, rb_sh)
        a0 = sa[0]
        k6_in = {"dense": ((r["qg"], a0["vectors_t"], a0["bc"], a0["bf"], a0["bl"], a0["rv"]),
                           None),
                 "recovery": (rec_scan[:6], rec_scan[7])}
        k6 = {}
        for name, (args, rb_) in k6_in.items():
            kw = dict(k=kk, blk=PAD_BLOCK, row_base=rb_)
            pv, pr = ivf_scan.cluster_major_scan(*args, **kw)
            rpv, rpr = ivf_scan.cluster_major_scan_reference(*args, **kw)
            torch.cuda.synchronize()
            r6 = args[2][torch.nonzero(args[4]).flatten()].long()
            if not scan_equal(pv[r6], pr[r6], rpv[r6], rpr[r6]):
                raise AssertionError(f"K6 {mode} differs from the plain version at the {name} "
                                     "walk")
            err = max_err(pv[r6], rpv[r6])
            del pv, pr, rpv, rpr
            walked = walked_blocks(np, *args[3:6])
            k6[name] = dict(
                err=err, ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan(*args, **kw)),
                plain_ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_reference(
                    *args, **kw), reps=3), lib_ms=None,
                bound=bound(walked * (qcap_f + PAD_BLOCK) * dp * es + r6.numel() * qcap_f * kk * 8,
                            2.0 * walked * qcap_f * PAD_BLOCK * dp, rate))
            phase("floatscan", t0, f"K6 {mode} {name} (shard {0 if name == 'dense' else s_rec}):"
                  f" qg {tuple(args[0].shape)} vectors_t {tuple(args[1].shape)} k={kk}: pv "
                  f"bit-equal, pr equal where finite, on {r6.numel()} emitted clusters "
                  f"({walked} blocks walked); {k6[name]}")
        del r, rec_scan, k6_in
        fl14[f"K6 {mode}"] = k6["recovery"]
        reset_launches()
        ids_s, residual_s, wall_s = sharded_all(sh, BATCH, mode="cluster")
        launch_s = read_launches()
        r10_s, r1_s = recalls(ids_s)
        engine_s = sh.last_engine
        fl14[f"K6 {mode}"]["launches"] = launch_s["K6"]
        sh_ms = cuda_ms(torch, lambda: sh.search_device(qs, K, NPROBE, mode="cluster"))
        r8 = sh._cm_route(qs, NPROBE, qcap_f)
        outs8 = [sh._cm_shard(s_, r8, K, qcap_f, rb_sh, passes_f, engine_s)
                 for s_ in range(len(shards))]
        owned0 = sa[0]["cluster_shard"][r8["probes"].long()] == 0
        stage_s = {name: cuda_ms(torch, fn) for name, fn in {
            "route": lambda: sh._cm_route(qs, NPROBE, qcap_f),
            "shard 0": lambda: sh._cm_shard(0, r8, K, qcap_f, rb_sh, passes_f, engine_s),
            "shard 0 recovery": lambda: sh._cm_recover(0, r8, owned0, None, kk, qcap_f, rb_sh,
                                                       passes_f),
            "merge": lambda: sharded_mod._gather_merge([o[0] for o in outs8],
                                                       [o[1] for o in outs8], K)}.items()}
        del r8, outs8
        phase("floatscan", t0, f"{mode} ShardedIVFIndex over {len(shards)} shards, "
              f"search_device(q, {K}, {NPROBE}, mode='cluster') defaults, {N_QUERIES} queries "
              f"{wall_s:.1f}s: engine={engine_s} residual last_spill={residual_s} launches="
              f"{launch_s} recall@10={r10_s:.4f} recall@1={r1_s:.4f} (single {mode} index "
              f"{single_r10:.4f}, {single_r1:.4f}); one B={BATCH} call {sh_ms} ms on {card}; "
              f"stages ms {stage_s}")
        if min(launch_s["K1"], launch_s["K2"], launch_s["K6"]) < 1 or any(residual_s):
            raise AssertionError(f"{mode} sharded defaults: launches {launch_s}, residual "
                                 f"{residual_s}")
        if r10_s < 0.99 or r1_s < r1_f32 or abs(r10_s - single_r10) > 0.001 \
                or abs(r1_s - single_r1) > 0.001:
            raise AssertionError(f"{mode} sharded recall@10 {r10_s} @1 {r1_s}: below 0.99, @1 "
                                 f"below the fp32 index's {r1_f32}, or more than 0.001 from the "
                                 f"single {mode} index's {single_r10}, {single_r1}")
        reset_launches()
        ids_sp, residual_sp, wall_sp = sharded_all(sh, BATCH, mode="cluster", engine="pallas")
        launch_sp = read_launches()
        r10_sp, r1_sp = recalls(ids_sp)
        sp_ms = cuda_ms(torch, lambda: sh.search_device(qs, K, NPROBE, mode="cluster",
                                                        engine="pallas"))
        phase("floatscan", t0, f"{mode} sharded engine=pallas {N_QUERIES} queries "
              f"{wall_sp:.1f}s: residual last_spill={residual_sp} launches={launch_sp} "
              f"recall@10={r10_sp:.4f} recall@1={r1_sp:.4f}; one B={BATCH} call {sp_ms} ms")
        if launch_sp["K6"] < 1 or any(residual_sp) or r10_sp < 0.99:
            raise AssertionError(f"{mode} sharded engine='pallas': launches {launch_sp}, "
                                 f"residual {residual_sp}, recall@10 {r10_sp}")
        del sh, sa, a0

    qmode = {}  # dtype → recalls and times of the query mode and the xla engine

    def query_paths(index, mode):
        """The query-major mode through the host API at B=32 and at one query,
        beside the same index's cluster mode at nprobe 16; then the cluster
        mode's xla engine at B=8192, beside the kernel engines' pool."""
        ids_c, _, _, wall_c = search_all(index, nprobe=16)
        r10_c, r1_c = recalls(ids_c)
        engine_c = index.last_engine
        t = time.time()
        ids_q, scores_q, avg_q = index.search(queries, K, batch_size=32)
        wall_q = time.time() - t
        mode_q = index.last_mode
        r10_q, r1_q = recalls(ids_q)
        if ids_q.shape != (N_QUERIES, K) or not np.isfinite(scores_q).all() or (ids_q < 0).any() \
                or (ids_q >= N_BASE).any():
            raise AssertionError(f"{mode} query mode output out of shape or range")
        lat = []
        for i in range(100):
            t1 = time.perf_counter()
            index.search(queries[i:i + 1], K)
            lat.append((time.perf_counter() - t1) * 1e3)
        q1 = torch.from_numpy(np.ascontiguousarray(queries[:1])).to(dev)
        q32 = torch.from_numpy(np.ascontiguousarray(queries[:32])).to(dev)
        dev_ms = {b_: cuda_ms(torch, lambda x=x: index.search_device(x, K, 16))
                  for b_, x in ((1, q1), (32, q32))}
        phase("query", t0, f"{mode} IVFIndex.search(q, {K}) defaults (nprobe 16, mode "
              f"{mode_q}, probe_chunk {index._auto_probe_chunk(32)} at B=32) over {N_QUERIES} "
              f"queries at B=32 {wall_q:.1f}s: recall@10={r10_q:.4f} recall@1={r1_q:.4f} "
              f"avg candidates {avg_q:.0f}; cluster mode at nprobe 16 (B={BATCH}, "
              f"{wall_c:.1f}s, engine {engine_c}): recall@10={r10_c:.4f} "
              f"recall@1={r1_c:.4f}; one-query search() median {statistics.median(lat)} ms of "
              f"100 (host clock, copies included; min {min(lat)}, max {max(lat)}); "
              f"search_device at nprobe 16 by CUDA events: B=1 {dev_ms[1]} ms, B=32 "
              f"{dev_ms[32]} ms on {card}")
        if mode_q != "query" or r10_q < r10_c:
            raise AssertionError(f"{mode} query mode ({mode_q}) recall@10 {r10_q} below the "
                                 f"cluster mode's {r10_c} at nprobe 16")
        # The xla engine, beside the kernel engines' pool: the default call's
        # rescore pool is its top-2k by the kernel's binned scores
        # (rescore=False at k=2k gives it).  Where the xla engine's routing
        # dropped none of a query's pairs and its answer lies in that pool,
        # both rank the same candidates exactly: ids equal, or equal scores
        # (a tie at the k-th place).
        ids_x, scores_x, residual_x, wall_x = search_all(index, engine="xla")
        r10_x, r1_x = recalls(ids_x)
        ids_p, scores_p, _, _ = search_all(index)
        qcap_x = index._auto_qcap(BATCH, NPROBE)
        agree = ids_equal = ties = 0
        for s_ in range(0, N_QUERIES, BATCH):
            n_ = min(BATCH, N_QUERIES - s_)
            qb_ = torch.from_numpy(np.resize(queries[s_:s_ + BATCH], (BATCH, DIM))).to(dev)
            lossy_x = index._route(qb_, NPROBE, qcap_x)[3].any(dim=1).cpu().numpy()[:n_]
            pool = index.search_device(qb_, 2 * K, NPROBE, rescore=False)[1].cpu().numpy()[:n_]
            for i in range(n_):
                g = s_ + i
                if lossy_x[i] or not set(ids_x[g]) <= set(pool[i]):
                    continue
                agree += 1
                if set(ids_x[g]) == set(ids_p[g]):
                    ids_equal += 1
                elif np.array_equal(np.sort(scores_x[g]), np.sort(scores_p[g])):
                    ties += 1
                else:
                    raise AssertionError(f"{mode} engine='xla' differs from the default engine "
                                         f"on query {g}, whose pools agree")
        xla_ms = cuda_ms(torch, lambda: index.search_device(qs, K, NPROBE, engine="xla"),
                         reps=3)
        phase("query", t0, f"{mode} engine=xla {N_QUERIES} queries in B={BATCH} batches "
              f"{wall_x:.1f}s: spill (no recovery pass) {residual_x} recall@10={r10_x:.4f} "
              f"recall@1={r1_x:.4f}; pools agree on {agree} queries: ids equal on {ids_equal}, "
              f"a tie at the k-th place on {ties}; one B={BATCH} call {xla_ms} ms")
        if r10_x < 0.99 or agree < N_QUERIES // 2:
            raise AssertionError(f"{mode} engine='xla' recall@10 {r10_x}, pools agree on "
                                 f"{agree} queries")
        qmode[mode] = dict(r10_q=r10_q, r1_q=r1_q, r10_c16=r10_c, one_query_ms=statistics.median(
            lat), b1_ms=dev_ms[1], b32_ms=dev_ms[32], r10_xla=r10_x, xla_ms=xla_ms)

    for mode, single in (("fp32", (r10_f32, r1_f32)), ("bf16", (r10_b16, r1_b16))):
        t = time.time()
        fidx = IVFIndex.from_arrays(*arrays_f, metric="l2", dtype=mode, pad_block=PAD_BLOCK,
                                    config=dict(config_f), device=dev)
        fidx._ensure_kernel_state()
        torch.cuda.synchronize()
        phase("floatscan", t0, f"{mode} IVFIndex.from_arrays (phase 13's arrays) "
              f"{time.time() - t:.1f}s: vectors_t {tuple(fidx._arrays['vectors_t'].shape)}")
        float_paths(fidx, mode, *single)
        query_paths(fidx, mode)
        del fidx
        torch.cuda.empty_cache()
    iidx = IVFIndex.from_arrays(*arrays_f, metric="l2", dtype="int8", pad_block=PAD_BLOCK,
                                config=dict(config_f), device=dev)
    query_paths(iidx, "int8")
    del iidx, arrays_f
    torch.cuda.empty_cache()

    kernels = [
        {"name": "cluster_major_accum_planes", "mode": "int8", "route": "cuda",
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
        {"name": "cluster_major_scan_grouped", "mode": "int8", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/ivf_grouped_scan.cu",
         "replaces": "rag_on_edge_tpu/ops/pallas_ivf.py:144",
         "launches": launches["K4"], "max_abs_err": max(k4[n]["err"] for n in k4),
         "ms": k4["recovery"]["ms"], "plain_ms": k4["recovery"]["plain_ms"],
         "bound_ms": k4["recovery"]["bound"][0], "bound_by": k4["recovery"]["bound"][1],
         "library_ms": None},
        {"name": "fused_topk_matmul", "mode": "int8", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/bruteforce_fused.cu",
         "replaces": "rag_on_edge_tpu/ops/pallas_bruteforce.py:193",
         "launches": launch_p["K3"],
         "max_abs_err": max(brute["K3 int8-L2 bin128"]["err"], brute["K3 int8-IP exact"]["err"]),
         "ms": brute["K3 int8-L2 bin128"]["ms"], "plain_ms": brute["K3 int8-L2 bin128"]["plain_ms"],
         "bound_ms": brute["K3 int8-L2 bin128"]["bound"][0],
         "bound_by": brute["K3 int8-L2 bin128"]["bound"][1], "library_ms": None},
        {"name": "fused_topk_accum", "mode": "int8", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/bruteforce_accum.cu",
         "replaces": "rag_on_edge_tpu/ops/pallas_bruteforce_dma.py:212",
         "launches": launch_a["K5"], "max_abs_err": brute["K5 int8-L2"]["err"],
         "ms": brute["K5 int8-L2"]["ms"], "plain_ms": brute["K5 int8-L2"]["plain_ms"],
         "bound_ms": brute["K5 int8-L2"]["bound"][0], "bound_by": brute["K5 int8-L2"]["bound"][1],
         "library_ms": None},
        {"name": "cluster_major_scan", "mode": "int8", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/ivf_grouped_scan.cu",
         "replaces": "rag_on_edge_tpu/ops/pallas_ivf.py:485",
         "launches": launch_s["K6"], "max_abs_err": max(k6[n]["err"] for n in k6),
         "ms": k6["recovery"]["ms"], "plain_ms": k6["recovery"]["plain_ms"],
         "bound_ms": k6["recovery"]["bound"][0], "bound_by": k6["recovery"]["bound"][1],
         "library_ms": None},
        {"name": "cluster_major_scan_routed", "mode": "int8", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/ivf_grouped_scan.cu",
         "replaces": "rag_on_edge_tpu/ops/pallas_ivf.py:320",
         "launches": launch_r["K7"], "max_abs_err": max(k7[n]["err"] for n in k7),
         "ms": k7["dense"]["ms"], "plain_ms": k7["dense"]["plain_ms"],
         "bound_ms": k7["dense"]["bound"][0], "bound_by": k7["dense"]["bound"][1],
         "library_ms": None},
        {"name": "cluster_major_accum", "mode": "int8", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/ivf_accum_planes.cu",
         "replaces": "rag_on_edge_tpu/ops/pallas_ivf_dma.py:253",
         "launches": k9_launches, "max_abs_err": max(k9[n]["err"] for n in k9),
         "ms": k9["int8-L2"]["ms"], "plain_ms": k9["int8-L2"]["plain_ms"],
         "bound_ms": k9["int8-L2"]["bound"][0], "bound_by": k9["int8-L2"]["bound"][1],
         "library_ms": None},
        {"name": "tiled_matmul", "mode": "int8", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/tiled_matmul.cu",
         "replaces": "rag_on_edge_tpu/ops/pallas_matmul.py:50",
         "launches": k8_launches["int8"], "max_abs_err": k8_full_err, "ms": k8_ms,
         "plain_ms": k8_plain_ms, "bound_ms": k8_bound[0], "bound_by": k8_bound[1],
         "library_ms": k8_lib_ms},
        *({"name": "tiled_matmul", "mode": mode, "route": "cuda",
           "source": "rag_on_edge_tpu_torch/csrc/tiled_matmul.cu",
           "replaces": "rag_on_edge_tpu/ops/pallas_matmul.py:50",
           "launches": k8_launches[mode], "max_abs_err": k8_errs[mode], "ms": k8_sq[mode]["ms"],
           "plain_ms": k8_sq[mode]["plain_ms"], "bound_ms": k8_sq[mode]["bound"][0],
           "bound_by": k8_sq[mode]["bound"][1], "library_ms": k8_sq[mode]["lib_ms"]}
          for mode in ("bf16", "fp32")),
        {"name": "_variant_scan", "mode": "int8", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/ivf_grouped_scan.cu",
         "replaces": "rag_on_edge_tpu/harness/kernel_lab.py:93",
         "launches": k10_launches, "max_abs_err": max(k10[v]["err"] for v in k10),
         "ms": lab_out["full"][0], "plain_ms": k10["full"]["plain_ms"],
         "bound_ms": k10_bound[0], "bound_by": k10_bound[1], "library_ms": None},
        {"name": "_step_probe", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/hw_probe.cu",
         "replaces": "rag_on_edge_tpu/harness/hw_probe.py:111",
         "launches": probe_launches["K11"], "max_abs_err": probe_err["K11"], "ms": k11["ms"],
         "plain_ms": k11["plain_ms"], "bound_ms": k11["bound"][0], "bound_by": k11["bound"][1],
         "library_ms": None},
        {"name": "_stream_probe", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/hw_probe.cu",
         "replaces": "rag_on_edge_tpu/harness/hw_probe.py:177",
         "launches": probe_launches["K12"], "max_abs_err": probe_err["K12"],
         "ms": k12[False]["ms"], "plain_ms": k12[False]["plain_ms"],
         "bound_ms": k12[False]["bound"][0], "bound_by": k12[False]["bound"][1],
         "library_ms": k12[False]["lib_ms"]},
        {"name": "_dma_probe", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/hw_probe.cu",
         "replaces": "rag_on_edge_tpu/harness/hw_probe.py:273",
         "launches": probe_launches["K13"], "max_abs_err": probe_err["K13"], "ms": k13["ms"],
         "plain_ms": k13["plain_ms"], "bound_ms": k13["bound"][0], "bound_by": k13["bound"][1],
         "library_ms": k13["lib_ms"]},
        {"name": "_gemm_rate_probe", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/hw_probe.cu",
         "replaces": "rag_on_edge_tpu/harness/hw_probe.py:351",
         "launches": probe_launches["K14"], "max_abs_err": probe_err["K14"],
         "ms": k14["int8 mma"]["ms"], "plain_ms": k14["int8 mma"]["plain_ms"],
         "bound_ms": k14["int8 mma"]["bound"][0], "bound_by": k14["int8 mma"]["bound"][1],
         "library_ms": None},
    ]
    # The float modes, one entry per (kernel, mode): phase 13's and phase 14's.
    fl.update(fl14)
    for key, name, src, tpu in (
            ("K1", "cluster_major_accum_planes", "ivf_accum_planes.cu", "ops/pallas_ivf_dma.py:371"),
            ("K4", "cluster_major_scan_grouped", "ivf_grouped_scan.cu", "ops/pallas_ivf.py:144"),
            ("K5", "fused_topk_accum", "bruteforce_accum.cu", "ops/pallas_bruteforce_dma.py:212"),
            ("K3", "fused_topk_matmul", "bruteforce_fused.cu", "ops/pallas_bruteforce.py:193"),
            ("K6", "cluster_major_scan", "ivf_grouped_scan.cu", "ops/pallas_ivf.py:485"),
            ("K7", "cluster_major_scan_routed", "ivf_grouped_scan.cu", "ops/pallas_ivf.py:320"),
            ("K9", "cluster_major_accum", "ivf_accum_planes.cu", "ops/pallas_ivf_dma.py:253"),
            ("K10", "_variant_scan", "ivf_grouped_scan.cu", "harness/kernel_lab.py:93")):
        for mode in ("fp32", "bf16"):
            if f"{key} {mode}" not in fl:
                continue  # K3 fp32 is an int8-slice mode, timed in phase 7
            r = fl[f"{key} {mode}"]
            kernels.append({
                "name": name, "mode": mode, "route": "cuda",
                "source": f"rag_on_edge_tpu_torch/csrc/{src}",
                "replaces": f"rag_on_edge_tpu/{tpu}", "launches": r["launches"],
                "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": r["lib_ms"]})
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
