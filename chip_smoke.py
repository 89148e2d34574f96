#!/usr/bin/env python3
"""Drive the PyTorch port's SIFT-1M search paths once on one NVIDIA GPU:
the IVF index (its default engine, the grouped engine and the routed
engine), the brute-force index, both sharded over 4 logical shards on
the card, the kernel lab on the same index, k-means with its checkpoint,
the compact store, the serving executor, the per-stage profilers, the
native CPU oracle, the transfer probes, the gated serving run, the skew
and recovery harnesses, the spatial GEMM, the
hardware probes, the float (fp32 and bf16) IVF and brute-force indexes
with the library's defaults, the float sharded index, routed engine and
kernel lab, and the query-major mode and xla engine of the IVF index.

    python3 chip_smoke.py

Phases, each printed with its wall time; any failure raises and the
script exits non-zero without a result line:

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile kernels K1 + K9, K2, K4 + K6 + K7 + K10, K3, K5, K8
             and K11-K14 (CUDA C++, one nvcc per source, all at once) from
             the sources in this checkout; beside them, K3's, K5's, K1's,
             K4's and K2's sources once more to cubins with ``-Xptxas -v``:
             each wgmma kernel's registers, spills and warpgroup MMA opcodes
             (``cuobjdump -sass``; every int8 instantiation must hold the s8
             MMA, every bf16 one the bf16 MMA; ``grouped_wgmma_kernel`` and
             ``grouped_ffma_kernel`` must hold K4's, K6's and K7's depths
             1-4 and their general selection (depth 0: any nbins and bin
             depth) and K10's nogate, maxonly and fixedout at depth 2,
             ``planes_wgmma_kernel`` K1's and K9's three modes and
             ``planes_ffma_kernel`` both, and no kernel of these four
             sources a ``__dp4a``; K14's ``__dp4a`` probe is unchecked), the
             probes' ``wgmma`` kernels (K12's ``stream_wgmma_kernel``, K14's
             ``gemm_rate_wgmma_kernel`` at each of its 16 k-step counts and
             its ``gemm_rate_chunked_kernel`` past them; int8 and bf16, no
             ``mma.sync``, no serialized groups), the fp32 register-tiled
             kernels' registers, spills
             and FFMA count (K3's ``fused_f32_kernel``, K5's
             ``accum_ffma_kernel``, K1's ``planes_ffma_kernel``, K4's, K6's,
             K7's and K10's ``grouped_ffma_kernel``), and K2's registers,
             spills and warp reductions (``REDUX``, required).
   setup   — the corpus, the IVF index, and the exact ground truth two
             ways: the plain branch (the recall reference below) and
             kernel K3 in fp32 (the 2 GiB rule picks it at SIFT-1M; its
             column splits joined by K2); the two must be equal on all
             10,000 queries, at k = 10 and at k = 100 (``load_dataset``'s
             default depth).
3. kernels — build the SIFT-1M index the slice searches, route one real
             B=8192 batch, and hold each kernel against its plain PyTorch
             version on the card at the slice's shapes (bit-equal planes,
             exactly equal top-k; K4 at the recovery pass's shapes from
             this batch's dropped pairs and at the dense grouped walk's;
             K2 also at W = 4096 and 8192, the joins of nprobe 16 and 32,
             each timed beside its plain version and ``torch.topk``;
             K7 at the same two walks, also against K4 on the gathered
             table; K9, which no search calls, at the batch's routed table
             twice, int8 IP and int8 L2 with its 4-bit bias rows, with its
             launches counted over those two calls), with median times of
             both and each kernel's bound; beside K1, the same per-block
             product alone as ``torch.bmm`` of bf16 operands into fp32
             (``prod_ms``, a yardstick); and the routed slots of each walked
             block that hold a query (mean, median, max of qcap, and the
             128-row tiles that hold none).  K9 runs K1's kernels with its
             own key and an emit kernel; its lines print the parent
             design's times (``K9_PARENT_MS``) beside the new ones.
   caps    — what the kernels once refused (F8, F9), each against its
             plain version: K4 at the dense walk at bin depths 5, 8, 16 and
             nbins 64, 256 (timed); K4, K6, K7 in int8, fp32 and bf16 at
             depths 5, 8, 16, nbins 64, 256 and 96 (blk 384, and blk 480
             padded to whole chunks), with K10's full and nogate at depth
             2; K3 at nbins 64, 32, 256, 96 and 192; K4 fp32 at blk 65536;
             ``search_device(q[:1024], 10, 4, qcap=4, bin_depth=5,
             recover=True)`` on the SIFT index against the same index on
             the CPU (K4 launched); an fp32 index at pad_block 65536
             through ``engine="pallas"`` and its recovery pass against the
             CPU.
4. slice   — search all 10,000 queries through ``IVFIndex.search_device``
             with its defaults (nlist=1024, nprobe=4, k=10, B=8192, int8,
             pad_block=2048; the recovery pass where the auto policy turns
             it on), with the launch counters reset just before and read
             just after; require K1, K4 and K2 launched and no residual
             spill; check recall@10 and recall@1 against exact ground truth
             beside the recall without recovery, and time one B=8192 call
             and its stages, and split one call by kernel with
             ``torch.profiler`` (K1, K4, K2 and the rest; the device's busy
             time and idle share).
5. grouped — the same queries through ``engine="pallas"`` (kernel K4 over
             the dense block walk): recall and one B=8192 call's time.
6. routed  — the same queries through ``engine="pallas_routed"`` (kernel
             K7, the routing inside the kernel, in the main walk and in
             every recovery pass), counters reset just before and read just
             after: ids and scores equal to ``engine="pallas"``, K7 launched
             and K4 not, residual spill 0, recall@10 >= 0.99; one B=8192
             call and its stages.
   wide    — the public calls at k = 20, whose rescore pool of 2k = 40 is
             past the 32 a row K4 and K7 keep a pass: ``search_device(q,
             20, 4)`` with its defaults (the recovery pass's K4 in two
             passes), ``engine="pallas"`` and ``engine="pallas_routed"``
             (ids and scores equal to ``pallas``), each over all queries,
             counted, spill 0, recall@20 >= 0.99 against the k = 100 ground
             truth; and ``engine="pallas_accum"`` at nprobe 128 on 2,048
             queries at the capacity that drops no pair (the join W =
             32768: K2 in two segments and a merge; recall@10 >= 0.99 and
             no lower than the defaults' on the same queries).
7. brute   — ``BruteForceIndex(base, metric="l2", dtype="int8")`` two ways:
             the defaults (``engine="auto"``: accum, kernel K5, rescored)
             and ``engine="pallas", rescore=True`` (kernel K3 binned).
             K3 (int8 L2 binned and int8 IP exact) and K5 (int8 L2 and
             int8 IP, on ``wgmma``) are held against their plain versions
             on a B=512 slice of real queries over the full base (exactly
             equal) and timed at B=8192 beside the GEMM alone
             (``torch._int_mm``, ``gemm_ms``) and the K-major copies their
             wrappers make; one call of K3 int8 L2 and of K5 int8 L2 split
             by kernel (``torch.profiler``); then all 10,000 queries
             through each engine
             with the counters reset just before and read just after;
             recall@10 >= 0.99 (accum) and >= 0.999 (pallas) against the
             plain ground truth; the pallas engine again at k = 20 (K3 int8
             in two passes of 32, recall@20 >= 0.999).  K3's fp32 mode,
             bit-equal to its plain version and timed beside it, beside
             ``torch.mm`` of the same product (TF32 off, ``gemm_ms``) and
             its bound: a ground-truth chunk [1024, 129] x [129, 1M] at k =
             10 and 100, and the fused coarse tier's [8192, 129] x [129,
             8192] at k = 4.
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
             recall@10 and @1 >= 0.99, residual spill 0; again at k = 20,
             the recovery pass's K6 in two passes, recall@20 >= 0.99), through
             ``engine="pallas"`` (K6 over every shard's walk, recall@10 >=
             0.99), and through ``mode="query"`` at B=128 (recall@10 >=
             0.99); and ``ShardedBruteForceIndex(base, metric="l2",
             dtype="int8", rescore=True)`` (K3 per shard, recall@10 >=
             0.999).  One call of each timed with CUDA events; the default
             call and ``engine="pallas"`` split by kernel (K1, K6, K2 and
             the rest, launches counted over one call, ``torch.profiler``:
             device busy time and idle share).
10. lab    — the kernel lab (``harness/kernel_lab.py``) on the same index at
             its defaults (qcap 128, k 20, 128 bins, B=2048, nprobe 4, one
             fixed routing): kernel K10 in its four variants held against
             its plain version on each variant's defined windows, ``full``
             also against K6 on the same table, and again at k = 64 (``full``
             and ``nogate`` in two passes, ``maxonly`` and ``fixedout`` in one
             launch, counted and timed), and in int8 at D 1152 on a small
             walk (each variant against its plain version, ``full`` against
             K6); then the lab itself with the counters reset just before
             and read just after, printing its ms/call and µs/block for each
             variant, and each variant's time beside its bound.
   f11     — K3's binned modes at tiles off the 128-column chunk (F11: a
             chunk across two tiles binned once for each): int8 L2 at
             tile_n 192, nbins 48, k 4, and int8 IP, int8 L2, bf16 and fp32
             at tile_n 320, nbins 40, k 20, each at [8192, 128] x [128, 1M]
             (the corpus shifted into int8), launched, bit-equal to the plain
             version on every row (in blocks of 512 rows) and timed.
   kmeans  — ``kmeans`` on the SIFT-1M base at nlist 1024, 6 steps: two
             uninterrupted runs bit-equal; 3 steps with a checkpoint, then a
             resume to 6, bit-equal to them; ``IVFIndex.build`` resumed from
             the 3-step checkpoint lays out the same clusters; times.
   compact — the setup's arrays in ``store="compact"``: at B=8192, nprobe 4,
             k 10 and a capacity that drops no pair, ids equal to the
             padded store's, single and sharded over ``[cuda:0] * 4``.
   serving — the serving path: ``bench_executor.run`` on the setup's index
             (``load_dataset("sift")`` is the setup's corpus, checked) at the
             JAX package's defaults (B 2048, nprobe 4, k 10, 20,000
             requests, ``max_delay_ms`` 5, ``inflight`` 8, the uint8 wire),
             counters reset just before and read just after (K1 launched:
             at B 2048 the join takes no K2 and the auto policy runs no
             recovery pass): QPS, recall@10 (>= 0.99 and within 0.001 of direct
             ``search_device`` at B 2048 over the same queries), latency
             percentiles, batches per drain, underfull launches; the same
             run under ``torch.profiler`` for the device's busy share; then
             ``run_open_loop`` at 0.25, 0.5 and 0.8 of the measured
             capacity (6,000 requests each, the window from
             ``auto_max_delay_ms``), each with its latency percentiles and
             served recall.
   profile — ``build_or_load_index("sift")`` caches the setup's index (its
             centroids and clusters checked) for the harnesses below;
             ``profile_ivf.profile`` at B=8192 for ``engine="pallas"`` and
             ``"pallas_accum"`` (cumulative prefixes coarse+topk, +invert,
             +route/gather, +kernel = K4, +join/rescore = the whole call;
             K4, and K1 and K2 under the accum engine, launched) and
             ``profile_sharded.profile`` over ``[cuda:0] * 4`` with the auto
             engine (K1, K2) and ``"pallas"`` (K6), each counted, every
             prefix finite, each full prefix's ids equal to the public
             call's (``recover=False``).
   oracle  — the native CPU oracle (``runtime/oracle.py``, g++) over 1,000
             queries x 1M, L2, k 10, against the card's exact ground truth
             (K3 fp32, counted): the exact scores of the returned ids equal
             within rtol 1e-4; both timed.
   relay   — ``relay_probe.probe_fetch`` (pageable device -> host copies:
             the per-copy and per-MB terms, the one-element round trip),
             ``probe_cycle`` at B=16384 (unpacked and packed through the
             executor's pack) and ``bench_executor.relay_cycle_probe`` at
             B=16384 on the uint8 wire, counted (K1).
   hunt    — ``serve_hunt`` at B=2048 with no wait: its record holds one
             probe and one saturated run of "sift" and no error; recall@10
             >= 0.99, counted (K1).
   recover — ``qcap_calib`` at nprobe 4, 8 and 16 (measured hottest-cell
             load beside ``_est_max_load``), and ``recover_sweep`` at nprobe
             4 with one swept shape (recover_qcap 256, one pass), counted
             (K1, K4, K2): the auto row drops no pair and keeps at least the
             off row's recall.
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
             against their plain versions at ragged shapes (K12's product
             also at x rows 1, 64 and 65 and blk 128 and 2052, 16- and
             4-byte row pitches; K14 also at tb 64 and 65, d 32, 48 and 512
             bytes, tn 16 and 130, g not a multiple of the CTAs a unit, on
             ``wgmma`` beside the ``__dp4a`` unit; and what they once
             refused, F10: K12's product at 256 and 300 x rows, odd d and
             blk, d 1100; K13 at depths 9 and 16 over 15-byte blocks; K14
             at 640 bytes of K and odd d past 512 bytes) and at one JAX
             size each (K11 g=4096 moving; K12 the int8 512 MB walk at
             blk=2048 with and without the product, and the bf16 512 MB
             walk with it; K13 the int8 2 GiB walk at depth 8; K14 (256,
             2048) at g=2048 in int8 on ``wgmma`` and on __dp4a, and in
             bf16), K12 and K14 in their value and in
             every step's max (K12 over walks with a planted max in every
             step), K13 with one value planted at a time across the walk
             (also in bf16 where its ring wraps, and past the walk), each
             timed beside its plain version
             and, for K12 and K13, ``data.amax()`` (K11 also by kernel,
             ``torch.profiler``: its timed call writes the 16 MB moving
             input before the kernel reads it); then, counters reset
             just before and read just after, the five probes at the JAX
             sizes through ``hw_probe.main([])``, and the ceilings they
             measure, one a line; where torch sees more than one card,
             each further card in turn (``probe_other_cards``): the probes'
             entry points counted at toy sizes through the paths past 48
             KB of dynamic shared memory, and K11-K14 against their plain
             versions there at the ragged and F10 shapes, a line a card
             with its own launches and max |err| (the kernel line keeps
             the first card's main-path counts; one card: a line saying
             the other-cards check was not run).
13. float  — the float modes of K1, K4, K5 and K3, held bit-equal to their
             plain versions at ragged sizes (D' odd, N and B off the
             tiles) on integer data, with K1's int8 (± bias rows) and bf16
             modes also at 65 routed rows and D 33, and K1's, K5's and K3's
             bf16 modes (the tensor cores) on non-integer data within the
             order bound 2·D·2^-24·(|q|@|b|) (K1 and K5 plus the low key bits
             they cede); then an fp32 ``IVFIndex`` (the default
             dtype; nlist=1024, L2, pad_block=2048, the int8 index's
             centroids) and the same index in bf16: K1 on one routed B=8192
             batch and K4 (bf16 on ``grouped_wgmma_kernel``, fp32 on
             ``grouped_ffma_kernel``) at its recovery list and at the dense
             walk (the table at the 16-byte row pitch, as
             ``engine="pallas"`` builds it) held bit-equal to their plain
             versions and timed beside ``torch.bmm`` of the dense product,
             then all 10,000 queries through ``search_device(q, 10, 4)``
             with its defaults, counters reset just before and read just
             after (engine pallas_accum, K1 and the recovery pass's K4
             launched, residual spill 0; fp32 recall@10 >= 0.99 and
             recall@1 >= the int8 index's), one call and its stages timed,
             and through ``engine="pallas"``, counted (K4 alone), equal to
             ``engine="pallas_routed"`` in ids and scores, spill 0,
             recall@10 >= 0.99; ``BruteForceIndex(base)`` with every
             default (ip, bf16, accum = K5, rescored; recall@10 >= 0.99
             against the plain IP ground truth) and an fp32 L2 accum index
             (K5 fp32 on the augmented dimension; >= 0.99), K5 held
             bit-equal at B=8192 and timed beside the GEMM alone
             (``torch.mm``); K1 fp32 beside ``torch.bmm`` of its per-block
             product in fp32 (TF32 off); ``BruteForceIndex(base, metric="l2",
             dtype="bf16", engine="pallas", rescore=True)`` (K3 bf16, held
             bit-equal at B=1024 with nbins 0 and 128; ids equal to the
             plain path's, K3's plain version and the same rescore, on all
             10,000 queries; recall@10 >= 0.99: the bf16 rounding of the
             augmented column costs it the int8 path's 0.999).
14. floatscan, query — the float modes of K6, K7, K9 and K10, held
             bit-equal to their plain versions at ragged sizes (D' 37, 129
             and 320, 40 routed rows, a batch of 70) on integer data; then,
             on phase 13's fp32 and bf16 indexes rebuilt from its arrays: K7
             (bf16 on ``grouped_wgmma_kernel``, fp32 on ``grouped_ffma_kernel``)
             at the dense walk and a recovery list, timed beside
             ``torch.bmm`` of the dense walk's product alone, and
             ``search_device(q, 10, 4, engine="pallas_routed")`` over all
             queries, counted (K7 alone; ids and scores equal to
             ``engine="pallas"``); K9 at K1's shapes, counted; K10's four
             variants on the lab's float routed table at its defaults
             (``kernel_lab.routed_table``, at the 16-byte row pitch), then
             the lab, counted, each variant beside its bound;
             ``ShardedIVFIndex(index, [cuda:0] * 4)``: K6 (K7's
             kernels) at shard 0's dense walk, beside ``torch.bmm`` of its
             product alone, and at a recovery list, then
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
15. widedim — sentence-embedding widths past the kernels' old D caps, on
             synthetic corpora of 200,000 vectors and 1,024 queries at D =
             384 and 768: ``BruteForceIndex(base)`` with every default (ip,
             bf16, accum = K5; recall@10 >= 0.99) and an fp32 and a bf16
             ``IVFIndex`` (nlist 256, L2, nprobe 16, the recovery pass on:
             K1 and K4 launched, recall@10 >= 0.95), counted; at D = 384 also
             ``BruteForceIndex(base, metric="l2", dtype="fp32",
             engine="pallas")`` at k = 300 (K3 fp32 in two passes of 256,
             recall@300 >= 0.999 against the plain ground truth); an int8 L2
             ``IVFIndex`` at D = 3072 (N 200,000, 1,024 queries, nlist 256,
             nprobe 16: engine auto → pallas, K4 with each unit's routed rows
             gathered beside its transpose; recall@10 >= 0.95, counted); then
             K2 at [8192, 32768], past the 16384 columns one warp holds,
             equal to its plain version in three launches and timed.

The last two lines are the kernel table as JSON and the result line
``{"ok": true, "device": {...}}``.  The bounds of K4, K6, K7 and K10 charge
the products of each walked block's live routed rows (an empty slot needs
none: ``timing.live_products``).  The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

N_BASE, N_QUERIES, DIM, N_CENTERS = 1_000_000, 10_000, 128, 4096  # DATASET_SPECS["sift"]
NLIST, PAD_BLOCK, K, NPROBE, BATCH = 1024, 2048, 10, 4, 8192
# k of the public calls past the kernels' old 32 a row (their rescore pool
# is 2k), and the ground truth's depth as load_dataset takes it by default.
K_WIDE, GT_K = 20, 100
# k past one launch of K10 (32 a row) and of K3's fp32 mode (256 a row).
K10_WIDE_K, K3_WIDE_K = 64, 300
REPS = 10
# The kernels of the int8 IVF default calls, by a substring of their device
# names: the single index's (K1, the recovery pass's K4, K2) and the sharded
# index's (K1, the recovery pass's K6, K2; its engine="pallas" walk is K6).
HEADLINE_KERNELS = {"K1": "planes_wgmma_kernel", "K4": "grouped_wgmma_kernel",
                    "K2": "fused_topk_kernel"}
SHARDED_KERNELS = {"K1": "planes_wgmma_kernel", "K6": "grouped_wgmma_kernel",
                   "K2": "fused_topk_kernel"}
# K9's times on its first design (the staged __dp4a / scalar-fmaf kernel
# of ivf_stage.cuh) at these shapes, as PERF.md section 6 records them from
# this script on an NVIDIA H100 80GB HBM3 at 700 W: the parent's, printed
# beside the new design's.
K9_PARENT_MS = {"int8-IP": 6.4436, "int8-L2": 6.5680, "fp32": 12.1328, "bf16": 14.0377}

# The CUDA kernel of K6's and K7's float modes, by mode (the kernel line).
K67_KERNEL = {"bf16": "grouped_wgmma_kernel", "fp32": "grouped_ffma_kernel"}


def phase(name: str, t0: float, msg: str) -> None:
    print(f"[{name}] {time.time() - t0:.1f}s {msg}", flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = REPS) -> float:
    """Median device time of ``fn()`` in ms (``timing.median_ms``)."""
    from rag_on_edge_tpu_torch.harness.timing import median_ms

    return median_ms(fn, reps)


def device_ms_by_kernel(torch, fn, calls: int = 1) -> dict | str:
    """Device ms of one ``fn()`` call, summed by kernel name, from
    ``torch.profiler`` over ``calls`` calls (after a warm-up call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            name = ev.key.replace("void ", "").replace("(anonymous namespace)::", "")
            name = name.split("(")[0][:60]
            out[name] = out.get(name, 0.0) + us / 1e3 / calls
    return out or "not measured (the profiler saw no device time)"


def bound(nbytes: float, ops: float, ops_rate: float) -> tuple[float, str]:
    """The least time (ms) the card could take (``timing.bound_ms``): the
    larger of the bytes over the memory rate and the operations over their
    peak rate."""
    from rag_on_edge_tpu_torch.harness.timing import bound_ms

    return bound_ms(nbytes, ops, ops_rate)


def cubin_report(_build, name: str):
    """Compile ``csrc/<name>.cu`` once more to a cubin with ``-Xptxas -v``
    and read it back with ``cuobjdump -sass`` → (props: each kernel's
    registers, stack frame and spills; ptxas's warnings that serialize the
    wgmma groups (C7520); opcodes: each kernel's SASS opcodes, counted)."""
    import re
    from collections import Counter

    nvcc = _build._nvcc()
    cubin = _build.BUILD_DIR / f"{name}-report.cubin"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([nvcc, "-arch=sm_90a", "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v",
                          "-o", str(cubin), str(_build.CSRC_DIR / f"{name}.cu")],
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc -cubin failed for {name}:\n{res.stderr}")
    props, entry = {}, None
    warnings = [ln.strip() for ln in res.stderr.splitlines() if "C7520" in ln or "serializ" in ln]
    for ln in res.stderr.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", ln)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", ln)
        if m and entry:
            props.setdefault(entry, {})["stack"] = int(m.group(1))
            props.setdefault(entry, {})["spills"] = (int(m.group(2)), int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            props.setdefault(entry, {})["regs"] = int(m.group(1))
    sass = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, timeout=600, check=True).stdout
    opcodes, fn = {}, None
    for ln in sass.splitlines():
        m = re.match(r"\s*Function : (\w+)", ln)
        if m:
            fn = m.group(1)
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", ln)
        if m and fn:
            opcodes.setdefault(fn, Counter())[m.group(1)] += 1
    return props, warnings, opcodes


# The instances of ivf_grouped_scan.cu's two kernels, by (QSrc, Variant)
# template arguments: K4, K6 and K7 at kFull (K6's depth-2 instance is also
# K10's full, its general selection K10's full and nogate at other bins),
# K10's other variants on K6's source.
GROUPED_KERN = {("0", "0"): "K4", ("1", "0"): "K6", ("2", "0"): "K7", ("1", "1"): "K10 nogate",
                ("1", "2"): "K10 maxonly", ("1", "3"): "K10 fixedout"}


def wgmma_report(_build, name: str) -> list[str]:
    """Each wgmma kernel's registers, stack frame, spills and warpgroup MMA
    opcodes in ``csrc/<name>.cu`` (:func:`cubin_report`), each fp32
    register-tiled kernel's registers, spills and FFMA count, any ptxas
    warning that serializes the wgmma groups, and the count of ``__dp4a``
    (IDP) instructions by kernel.  Raises if an int8 instantiation holds no
    s8 warpgroup MMA or a bf16 one no bf16 warpgroup MMA, any kernel holds
    IDP, ``grouped_wgmma_kernel`` lacks one of K4's, K6's and K7's int8 and
    bf16 depths 0-4 (0: the general selection) or K10's nogate, maxonly
    and fixedout in int8 and bf16 at depth 2, ptxas serializes its groups
    (C7520), ``grouped_ffma_kernel`` lacks one of K4's, K6's and K7's fp32
    depths 0-4 or K10's three at depth 2, or ``ivf_accum_planes.cu`` lacks
    one of K1's and K9's ``planes_wgmma_kernel`` modes (int8, int8 L2,
    bf16) or ``planes_ffma_kernel`` instances."""
    import re

    props, warnings, opcodes = cubin_report(_build, name)
    ops = {f: {o for o in c if "GMMA" in o} for f, c in opcodes.items()}
    idp = {f: n for f, c in opcodes.items() if (n := sum(v for o, v in c.items()
                                                          if o.startswith("IDP")))}
    lines, grouped_seen, ffma_seen, planes_seen = [], set(), set(), set()
    for fn in sorted(f for f in set(ops) | set(props) if "wgmma_kernel" in f):
        short = re.search(r"([a-z][a-z_]*_wgmma_kernel)I(\w+?)EEv", fn)
        grouped = re.search(r"grouped_wgmma_kernelI(a|13__nv_bfloat16)Li(\d)E\w*?QSrcE(\d)E"
                            r"\w*?VariantE(\d)E", fn)
        tag = f"{short.group(1)}<{short.group(2)}>" if short else fn
        planes = re.search(r"planes_(wgmma|ffma)_kernelI(?:Li(\d)E)?Lb([01])E", fn)
        if planes:
            planes_seen.add((planes.group(1), planes.group(2), planes.group(3)))
        if grouped:
            kern = GROUPED_KERN[grouped.group(3), grouped.group(4)]
            mode = "int8" if grouped.group(1) == "a" else "bf16"
            grouped_seen.add((kern, mode, grouped.group(2)))
            tag = f"grouped_wgmma_kernel<{kern} {mode}, depth {grouped.group(2)}>"
        p_ = props.get(fn, {})
        lines.append(f"{tag}: {p_.get('regs')} registers, {p_.get('stack')} bytes stack frame, "
                     f"spill stores/loads {p_.get('spills')}, wgmma opcodes "
                     f"{sorted(ops.get(fn, ()))}")
        int8 = re.search(r"wgmma_kernelILi[12]E", fn) or (grouped and grouped.group(1) == "a")
        if int8 and not any("S8" in o or o.startswith("IGMMA") for o in ops.get(fn, ())):
            raise AssertionError(f"{tag} holds no s8 warpgroup MMA: {sorted(ops.get(fn, ()))}")
        bf16 = re.search(r"wgmma_kernelILi0E", fn) or (grouped and grouped.group(1) != "a")
        if bf16 and not any("BF16" in o for o in ops.get(fn, ())):
            raise AssertionError(f"{tag} holds no bf16 warpgroup MMA: {sorted(ops.get(fn, ()))}")
    serial = [w for w in warnings if "grouped_wgmma_kernel" in w]
    if serial:
        raise AssertionError(f"ptxas serializes grouped_wgmma_kernel's groups: {serial}")
    for fn in sorted(f for f in set(opcodes) | set(props)
                     if "ffma_kernel" in f or "fused_f32_kernel" in f):
        # The fp32 modes on ffma_tile.cuh's register tile (K3, K5, K1, K6, K7).
        p_ = props.get(fn, {})
        short = re.search(r"(fused_f32_kernel|accum_ffma_kernel|planes_ffma_kernel)(?:I(\w+?)EEv)?",
                          fn)
        tag = (f"{short.group(1)}<{short.group(2)}>" if short and short.group(2) else
               short.group(1) if short else fn)
        grouped = re.search(r"grouped_ffma_kernelILi(\d)E\w*?QSrcE(\d)E\w*?VariantE(\d)E", fn)
        planes = re.search(r"planes_ffma_kernelILb([01])E", fn)
        if planes:
            planes_seen.add(("ffma", None, planes.group(1)))
        if grouped:
            kern = GROUPED_KERN[grouped.group(2), grouped.group(3)]
            ffma_seen.add((kern, grouped.group(1)))
            tag = f"grouped_ffma_kernel<{kern} fp32, depth {grouped.group(1)}>"
        lines.append(f"{tag}: {p_.get('regs')} registers, "
                     f"{p_.get('stack')} bytes stack frame, spill stores/loads "
                     f"{p_.get('spills')}, FFMA {opcodes.get(fn, {}).get('FFMA', 0)}")
    full = {(kern, str(dp)) for kern in ("K4", "K6", "K7") for dp in range(5)}
    lab = {(kern, "2") for kern in ("K10 nogate", "K10 maxonly", "K10 fixedout")}
    want_w = {(kern, mode, dp) for kern, dp in full | lab for mode in ("int8", "bf16")}
    if grouped_seen and grouped_seen != want_w:
        raise AssertionError(f"grouped_wgmma_kernel instances {sorted(grouped_seen)}: K4, K6 "
                             "and K7 int8 and bf16 at depths 0-4 and K10's other variants at "
                             "depth 2 expected")
    if grouped_seen and ffma_seen != full | lab:
        raise AssertionError(f"grouped_ffma_kernel instances {sorted(ffma_seen)}: K4, K6 and "
                             "K7 fp32 at depths 0-4 and K10's other variants at depth 2 expected")
    # K1 (EX 0) and K9 (EX 1): planes_wgmma_kernel<bf16 0, int8 1, int8 L2
    # 2> and planes_ffma_kernel (fp32).
    want_p = ({("wgmma", m, ex) for m in "012" for ex in "01"}
              | {("ffma", None, ex) for ex in "01"})
    if name == "ivf_accum_planes" and planes_seen != want_p:
        raise AssertionError(f"ivf_accum_planes instances {sorted(planes_seen, key=str)}: K1's "
                             "and K9's planes_wgmma_kernel modes and planes_ffma_kernel expected")
    by_kernel = {}
    for f, n in idp.items():
        short = re.search(r"[a-z][a-z_]*_kernel", f)
        key = short.group(0) if short else f
        by_kernel[key] = by_kernel.get(key, 0) + n
    if by_kernel:
        raise AssertionError(f"lib{name} holds IDP (__dp4a) instructions in {by_kernel}")
    lines.append(f"IDP (__dp4a) instructions in lib{name}: {sum(idp.values())} "
                 f"{by_kernel or ''}; ptxas serialization warnings: {warnings or 'none'}")
    return lines


def k2_report(_build) -> list[str]:
    """K2's two instances (int32, float32): registers, stack frame, spills
    and the warp reductions (``REDUX``) in their SASS; raises if an
    instance holds no ``REDUX`` or spills."""
    props, _, opcodes = cubin_report(_build, "fused_topk")
    lines = []
    for fn in sorted(f for f in opcodes if "fused_topk_kernel" in f):
        redux = {o: n for o, n in opcodes[fn].items() if o.startswith("REDUX")}
        p_ = props.get(fn, {})
        tag = f"fused_topk_kernel<{'float32' if 'ILb1E' in fn else 'int32'}>"
        if not redux or (p_.get("spills") or (0, 0)) != (0, 0):
            raise AssertionError(f"{tag}: REDUX {redux}, spills {p_.get('spills')}")
        lines.append(f"{tag}: {p_.get('regs')} registers, {p_.get('stack')} bytes stack frame, "
                     f"spill stores/loads {p_.get('spills')}, REDUX {redux}, "
                     f"{sum(opcodes[fn].values())} instructions")
    if len(lines) != 2:
        raise AssertionError(f"libfused_topk: {len(lines)} fused_topk_kernel instances, 2 expected")
    return lines


def probe_report(_build) -> list[str]:
    """The probes' tensor-core kernels in ``csrc/hw_probe.cu`` (K12's
    ``stream_wgmma_kernel``, K14's ``gemm_rate_wgmma_kernel`` at 1-16
    k-steps of 32 bytes and ``gemm_rate_chunked_kernel`` past them):
    registers, stack frame and spills, one line a kernel and dtype (ranges
    over K14's k-step counts).  Raises if an int8 instance holds no s8
    warpgroup MMA or a bf16 one no bf16 warpgroup MMA, any holds
    ``mma.sync`` (IMMA / HMMA), K14 lacks one of its 16 k-step counts or
    its chunked kernel in either dtype, or ptxas serializes their groups."""
    import re

    props, warnings, opcodes = cubin_report(_build, "hw_probe")
    fams = {}
    for fn in sorted(set(props) | set(opcodes)):
        m = re.search(r"(stream_wgmma|gemm_rate_wgmma|gemm_rate_chunked)_kernel"
                      r"I(a|13__nv_bfloat16)(?:Li(\d+)E)?", fn)
        if not m:
            continue
        mode = "int8" if m.group(2) == "a" else "bf16"
        ops = set(opcodes.get(fn, ()))
        want = "IGMMA" if mode == "int8" else "HGMMA"
        if not any(o.startswith(want) for o in ops) or any(
                o.startswith(("IMMA", "HMMA")) for o in ops):
            raise AssertionError(f"{fn}: {want} expected and no mma.sync, got {sorted(ops)}")
        fam = fams.setdefault((f"{m.group(1)}_kernel", mode), {"nkt": [], "regs": [],
                                                             "stack": [], "spills": []})
        fam["nkt"].append(int(m.group(3) or 0))
        p_ = props.get(fn, {})
        fam["regs"].append(p_.get("regs"))
        fam["stack"].append(p_.get("stack"))
        fam["spills"].append(p_.get("spills"))
    for mode in ("int8", "bf16"):
        if sorted(fams.get(("gemm_rate_wgmma_kernel", mode), {}).get("nkt", [])) != list(
                range(1, 17)) or {("stream_wgmma_kernel", mode),
                                  ("gemm_rate_chunked_kernel", mode)} - set(fams):
            raise AssertionError(f"hw_probe's wgmma instances {sorted(fams)}: K12, K14 at "
                                 "1-16 k-steps and K14 chunked in int8 and bf16 expected")
    serial = [w for w in warnings if "wgmma_kernel" in w or "chunked_kernel" in w]
    if serial:
        raise AssertionError(f"ptxas serializes the probes' wgmma groups: {serial}")
    lines = []
    for (name, mode), f in sorted(fams.items()):
        spilled = {n: sp for n, sp in zip(f["nkt"], f["spills"]) if sp and sp != (0, 0)}
        lines.append(f"{name}<{mode}>: {min(f['regs'])}-{max(f['regs'])} registers, stack "
                     f"frame up to {max(f['stack'])} bytes, spill stores/loads "
                     f"{spilled or 'none'}" + (" (by k-steps)" if len(f["nkt"]) > 1 else ""))
    return lines


def split_by_kernel(by_kernel: dict, families: dict) -> dict:
    """Device ms by kernel family ({label: name substring}), the rest under
    ``other``."""
    out = {label: 0.0 for label in families}
    out["other"] = 0.0
    for name, ms in by_kernel.items():
        label = next((lb for lb, sub in families.items() if sub in name), "other")
        out[label] += ms
    return out


def prod_ms(torch, qg, vectors_t) -> float | str:
    """Device ms of the per-block product ``qg @ vectors_t`` alone as one
    ``torch.bmm`` (K1's yardstick; ``timing.bmm_ms``)."""
    from rag_on_edge_tpu_torch.harness.timing import bmm_ms

    return bmm_ms(qg, vectors_t, REPS)


def planes_close(ivf_accum, got, want, order) -> tuple[bool, float]:
    """K1 bf16 planes against the plain version's on non-integer data:
    KMIN exactly where the plain version has it, every other value (the key
    back in fp32, its 8 low bits ceded) within ``order`` plus those bits on
    both sides → (ok, max |err|)."""
    ok = want != ivf_accum.KMIN
    gv = ivf_accum._key_to_f32(got[ok]).double()
    wv = ivf_accum._key_to_f32(want[ok]).double()
    err = (gv - wv).abs()
    return (bool(((got == ivf_accum.KMIN) == ~ok).all())
            and bool((err <= order + wv.abs() * 2.0**-14).all()), float(err.max()))


def walked_blocks(np, block_first, block_last, rows_valid) -> tuple[int, int]:
    """The blocks a cluster-major function must read and their valid
    columns (``timing.walked_blocks``)."""
    from rag_on_edge_tpu_torch.harness.timing import walked_blocks as walked

    return walked(block_first, block_last, rows_valid)


class ProbeChecks:
    """K11-K14 held against their plain versions on one card: seeded data
    made there, each kernel's max |err| in ``errs``.  ``check`` raises where
    a kernel is refused or differs."""

    # K14's ragged shape (tb, tn, d, g), then the edges of its wgmma design:
    # tb 64 (one warpgroup) and 65, tn 16 and 130, d 32 and 48 (int8: one and
    # 1.5 k-steps) and the 512-byte cap (0: int8 512, bf16 256); g 37 and
    # 300, which no CTA count a unit divides.
    K14_SHAPES = ((200, 300, 96, 37), (65, 130, 48, 300), (64, 16, 32, 37), (65, 16, 0, 37))

    def __init__(self, torch, hw_probe, dev, seed: int):
        self.torch, self.hw, self.dev = torch, hw_probe, dev
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.errs = {"K11": 0.0, "K12": 0.0, "K13": 0.0, "K14": 0.0}
        self.x1 = torch.ones((8, 128), dtype=torch.float32, device=dev)

    def rand(self, shape, dtype):
        torch = self.torch
        if dtype == torch.int8:
            return torch.randint(-127, 127, shape, generator=self.gen, device=self.dev,
                                 dtype=dtype)
        return torch.randn(shape, generator=self.gen, device=self.dev, dtype=dtype)

    def check(self, key, name, got, want, tol=0.0):
        """``got`` against ``want`` within ``tol`` (a number, or one per
        element); NaN, which the per-step views leave where no CTA wrote,
        fails."""
        torch = self.torch
        torch.cuda.synchronize(self.dev)
        diff = (got.double() - want.double()).abs()
        if got.shape != want.shape or not bool((diff <= tol).all()):
            raise AssertionError(f"{self.dev} {key} {name} differs from its plain version: "
                                 f"|err| {float(diff.max())}, tolerance "
                                 f"{float(torch.as_tensor(tol).max())}")
        self.errs[key] = max(self.errs[key], float(diff.max()))

    def k12(self, name, x, data, blk, fat, gemm, tops, sems):
        """K12's value and its whole per-step buffer against the plain
        version; without the product, also against the planted maxima.
        bf16's bound for each step: 2·d·2**-24·max(|x| @ |tile|) over its
        fat tiles."""
        torch, hw = self.torch, self.hw
        want = hw._stream_steps_reference(x, data, fat, gemm)
        if not gemm and not torch.equal(want, tops):
            raise AssertionError(f"K12 {name}: the plain version missed the planted maxima")
        if gemm and data.dtype == torch.bfloat16:
            nb, d, nblk = data.shape
            prod = torch.matmul(x.double().abs(),
                                data.double().abs().reshape(nb // fat, fat, d, nblk))
            tol = 2.0 * d * 2.0**-24 * prod.amax(dim=(1, 2, 3))
        else:
            tol = torch.zeros_like(want, dtype=torch.float64)
        for sem in sems:
            self.check("K12", f"{name} gemm={gemm} {sem} steps",
                       hw._stream_steps(x, data, blk, fat, gemm, sem), want, tol)
            self.check("K12", f"{name} gemm={gemm} {sem}",
                       hw._stream_probe(x, data, blk, fat, gemm, sem),
                       hw._stream_probe_reference(x, data, blk, fat, gemm, sem), tol[-1:])

    def k13(self, name, data, depth, plant, decoy, n):
        """K13 against its plain version with one value planted at a time
        above the bulk: ``plant`` at the first and the last walked element
        and at ``n`` seeded random walked ones, so that a walk or a ring
        that skips, drops or reuses a stage misses it; first, where blocks
        lie past the walk, ``decoy`` there alone, which a walk that reads
        past its end would return → the number of trials."""
        torch, hw = self.torch, self.hw
        flat = data.view(-1)
        walked = hw._dma_blocks(data, depth) * data[0].numel()
        trials = [(0, plant), (walked - 1, plant)] + [
            (p, plant) for p in torch.randint(walked, (n,), generator=self.gen,
                                              device=self.dev).tolist()]
        if walked < flat.numel():
            trials.insert(0, (walked + int(torch.randint(flat.numel() - walked, (1,),
                                                         generator=self.gen,
                                                         device=self.dev)), decoy))
        for pos, val in trials:
            old = flat[pos].clone()
            flat[pos] = val
            want = hw._dma_probe_reference(self.x1, data, depth)
            if (float(want) == val) != (pos < walked):
                raise AssertionError(f"K13 {name}: the bulk reaches the planted {val}")
            self.check("K13", f"{name} depth={depth} {val} at {pos}",
                       hw._dma_probe(self.x1, data, depth), want)
            flat[pos] = old
        return len(trials)

    def k14_tol(self, q, v, g):
        """K14's tolerance for each step: bf16's 2·d·2**-24·max(|twisted q|
        @ |v|), int8's 0."""
        torch = self.torch
        if q.dtype != torch.bfloat16:
            return torch.zeros(g, dtype=torch.float64, device=self.dev)
        va, out = v.double().abs(), []
        for s0 in range(0, g, 64):
            ids = torch.arange(s0, min(g, s0 + 64), device=self.dev)
            out.append(torch.matmul(self.hw._twisted_q(q, ids, torch.float64).abs(), va)
                       .amax(dim=(1, 2)))
        return 2.0 * q.shape[1] * 2.0**-24 * torch.cat(out)

    def ragged(self) -> tuple[int, list[str]]:
        """Every kernel at ragged shapes and at what the probes once refused
        (F10), value and every step; among them every launch past 48 KB of
        dynamic shared memory (K12's product, K13 at depth 3 and 8 over
        [70,128,2048], K14 on ``wgmma`` at d 512 bytes, chunked past it, and
        ``__dp4a`` at d 640 and 1025) → (K13's planted trials, F10's
        cases)."""
        torch, hw = self.torch, self.hw
        rand = self.rand
        xs = rand((8, 128), torch.float32)
        for g in (3, 300):
            for moving in (False, True):
                for sem in hw.SEMANTICS:
                    self.check("K11", f"g={g} moving={moving} {sem}",
                               hw._step_probe(xs, g, moving, sem),
                               hw._step_probe_reference(xs, g, moving, sem))
        ntrials = 0
        for dtype, plant, decoy in ((torch.int8, 127, 127), (torch.bfloat16, 64.0, 128.0)):
            # The product's edges beside the ragged walk: x of 1 and 65 rows
            # (one past a warpgroup), blk 128 (16-byte cp.async pieces) and
            # 2052 (a 4-byte row pitch: 4-byte pieces, the last slice 4
            # columns wide).
            for m, gemm, blk in ((100, False, 301), (100, True, 300), (1, True, 128),
                                 (65, True, 2052)):
                xr = rand((m, 36), dtype)
                data, tops = hw._planted_walk(9, 36, blk, 3, dtype, self.gen)
                self.k12(f"{dtype} [9,36,{blk}] x [{m},36] fat=3", xr, data, blk, 3, gemm,
                         tops, hw.SEMANTICS)
            data = rand((11, 24, 40), dtype)
            for depth in (3, 8):
                ntrials += self.k13(f"{dtype} [11,24,40]", data, depth, plant, decoy, 4)
        # bf16 over 36 MB: ~17 stages a CTA, so the ring wraps at depth 3 and
        # 8, and 70 blocks leave blocks past the walk at both.
        data = rand((70, 128, 2048), torch.bfloat16)
        for depth in (3, 8):
            ntrials += self.k13("bf16 [70,128,2048]", data, depth, 64.0, 128.0, 16)
        for dtype, unit in ((torch.int8, "mma"), (torch.int8, "dp4a"), (torch.bfloat16, "mma")):
            for tb, tn, d, g in self.K14_SHAPES:
                d = d or 512 // dtype.itemsize
                q, v = rand((tb, d), dtype), rand((d, tn), dtype)
                tol = self.k14_tol(q, v, g)
                name = f"{dtype} {unit} [{tb},{d}]x[{d},{tn}] g={g}"
                self.check("K14", f"{name} steps",
                           hw._gemm_rate_steps(q, v, g, tb, tn, True, unit),
                           hw._gemm_rate_steps_reference(q, v, g, tb, tn, True, unit), tol)
                self.check("K14", name, hw._gemm_rate_probe(xs, q, v, g, tb, tn, True, unit),
                           hw._gemm_rate_probe_reference(xs, q, v, g, tb, tn, True, unit),
                           tol[-1:])
        # F10: what the probes once refused.  K12's product at 256 and 300 x
        # rows (row tiles in turn), odd d and blk (padded to 4-byte words),
        # and d 1100 (K past 512 bytes: x rides the ring); K13 at JAX depths
        # 9 and 16 (past the ring of 8) over 15-byte int8 / 30-byte bf16
        # blocks; K14 at 640 bytes of K and an odd d past 512 bytes (int8
        # 1025: dp4a's K in chunks; bf16 257) on both units.
        f10 = []
        for dtype, plant, decoy in ((torch.int8, 127, 127), (torch.bfloat16, 64.0, 128.0)):
            for m, d, blk in ((256, 37, 130), (300, 1100, 515)):
                xr = rand((m, d), dtype)
                data, tops = hw._planted_walk(6, d, blk, 2, dtype, self.gen)
                self.k12(f"{dtype} [6,{d},{blk}] x [{m},{d}] fat=2", xr, data, blk, 2, True,
                         tops, (None, "arbitrary"))
                f10.append(f"K12 {dtype} x [{m},{d}] blk {blk}")
            data = rand((40, 3, 5), dtype)
            for depth in (9, 16):
                ntrials += self.k13(f"{dtype} [40,3,5]", data, depth, plant, decoy, 4)
                f10.append(f"K13 {dtype} [40,3,5] depth {depth}")
        for dtype, unit in ((torch.int8, "mma"), (torch.int8, "dp4a"), (torch.bfloat16, "mma")):
            for tb, tn, d, g in ((65, 130, 640 // dtype.itemsize, 37),
                                 (20, 40, 1025 if dtype == torch.int8 else 257, 37)):
                q, v = rand((tb, d), dtype), rand((d, tn), dtype)
                self.check("K14", f"{dtype} {unit} [{tb},{d}]x[{d},{tn}] steps",
                           hw._gemm_rate_steps(q, v, g, tb, tn, True, unit),
                           hw._gemm_rate_steps_reference(q, v, g, tb, tn, True, unit),
                           self.k14_tol(q, v, g))
                f10.append(f"K14 {dtype} {unit} d {d}")
        return ntrials, f10


def probe_other_cards(torch, hw_probe, t0: float) -> None:
    """K11-K14 on each card after the first, in turn: counters reset just
    before and read just after, the probes' entry points at toy sizes
    through every path past 48 KB of dynamic shared memory (K12's product,
    K13 at depth 8, K14 at d 512: int8 on ``wgmma``, bf16 chunked, int8 on
    ``__dp4a``); then :meth:`ProbeChecks.ragged` there.  Prints one line a
    card, with its launches and max |err|; the main path's counts are not
    touched.  Raises where a kernel is refused, not launched or differs."""
    for i in range(1, torch.cuda.device_count()):
        t = time.time()
        c = torch.device("cuda", i)
        for key in hw_probe.LAUNCHES:
            hw_probe.LAUNCHES[key] = 0
        hw_probe.probe_pallas_step(repeats=2, device=c, grids=(4, 64))
        hw_probe.probe_pallas_stream(repeats=2, device=c, total=32 << 20, blks=(2048,))
        hw_probe.probe_pallas_dma(repeats=2, device=c, total=64 << 20,
                                  cases=((torch.int8, 2048),), depths=(8,))
        hw_probe.probe_pallas_gemm(repeats=2, device=c, shapes=((256, 512),), gs=(4, 16), d=512)
        torch.cuda.synchronize(c)
        launches = dict(hw_probe.LAUNCHES)
        if min(launches.values()) < 1:
            raise AssertionError(f"the probes did not launch every kernel on {c}: {launches}")
        checks = ProbeChecks(torch, hw_probe, c, 12 + i)
        ntrials, _ = checks.ragged()
        torch.cuda.synchronize(c)
        phase("probe", t0, f"{c} ({torch.cuda.get_device_name(c)}): the probes' entry points "
              f"launched {launches}; K11-K14 equal to their plain versions at the ragged and "
              f"F10 shapes ({ntrials} K13 trials), max |err| {checks.errs} "
              f"({time.time() - t:.1f}s)")


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
    from rag_on_edge_tpu_torch.harness.timing import BF16_OPS_S, DP4A_OPS_S, INT8_OPS_S, OPS32_S
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
               "tiled_matmul", "hw_probe", "fused_topk"]
    # K5's, K3's, K1's and K9's, and K4's, K6's, K7's and K10's kernels: no
    # __dp4a in any of the four sources.
    reported = ["bruteforce_accum", "bruteforce_fused", "ivf_accum_planes", "ivf_grouped_scan"]
    with ThreadPoolExecutor(len(sources) + len(reported) + 2) as ex:  # one nvcc each, all at once
        reports = [ex.submit(wgmma_report, _build, name) for name in reported]
        report_k2 = ex.submit(k2_report, _build)
        report_probe = ex.submit(probe_report, _build)
        list(ex.map(_build.load_library, sources))
        for name, rep in zip(reported, reports):
            for line in rep.result():
                print(f"[build] {name} ptxas -v / SASS: {line}", flush=True)
        for line in report_k2.result():
            print(f"[build] fused_topk ptxas -v / SASS: {line}", flush=True)
        for line in report_probe.result():
            print(f"[build] hw_probe ptxas -v / SASS: {line}", flush=True)
    phase("build", t0, f"K1 + K9, K2, K4 + K6 + K7 + K10, K3, K5, K8, K11-K14 nvcc "
          f"{time.time() - t:.1f}s")

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
    gt_k10_s = time.time() - t
    # load_dataset's default depth, k = 100: the K3 branch (fp32 k = 100 in
    # one launch a chunk, the splits joined by K2) over all queries, held to
    # the plain branch on the first GT_PLAIN_Q (its 100 passes a column
    # chunk take ~10 s a 1,000 queries) and to the k = 10 truth on all.
    GT_PLAIN_Q = 2048
    reset_launches()
    t = time.time()
    gt100 = ground_truth(base, queries, GT_K, metric="l2", device=dev)
    torch.cuda.synchronize()
    gt100_s = time.time() - t
    gt100_launches = {key: n for key, n in read_launches().items() if n}
    t = time.time()
    gt100_plain = ground_truth(base, queries[:GT_PLAIN_Q], GT_K, metric="l2", device=dev,
                               query_chunk=512)
    torch.cuda.synchronize()
    phase("setup", t0, f"ground truth k={GT_K}: K3 branch {gt100_s:.1f}s over {N_QUERIES} "
          f"queries (launches {gt100_launches}); plain branch {time.time() - t:.1f}s over the "
          f"first {GT_PLAIN_Q}: ids equal on "
          f"{int((gt100[:GT_PLAIN_Q] == gt100_plain).all(axis=1).sum())} of them")
    if gt100_launches.get("K3", 0) < 1:
        raise AssertionError(f"the k={GT_K} fused ground truth did not launch K3")
    if not np.array_equal(gt100[:GT_PLAIN_Q], gt100_plain) or not np.array_equal(
            gt100[:, :K], gt):
        raise AssertionError(f"the k={GT_K} K3 ground truth differs from the plain branch")
    del gt100_plain

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
    walked, cols = walked_blocks(np, *k1_args[2:])
    k1_bound = bound(walked * qcap * DIM + cols * (DIM + 4) + rows.numel() * pp[0].numel() * 4,
                     2.0 * qcap * cols * DIM, INT8_OPS_S)
    k1_prod_ms = prod_ms(torch, qb, a["vectors_t"])
    phase("kernels", t0, f"K1 qg {tuple(qb.shape)} vectors_t {tuple(a['vectors_t'].shape)} "
          f"bias {tuple(bias_rows.shape)} qcap={qcap} lossy pairs={int(lossy.sum())}: "
          f"bit-equal on {rows.numel()} last blocks; {k1_ms} ms vs plain {k1_plain_ms} ms; "
          f"bound {k1_bound[0]} ms by {k1_bound[1]} ({walked} blocks walked, {cols} valid "
          f"columns); prod_ms {k1_prod_ms} (torch.bmm bf16 -> fp32 of the same per-block "
          f"product, a yardstick)")

    # The routed slots of each walked (last) block that hold a query (a
    # routed row with a nonzero byte; an empty slot is a zero row), and the
    # 128-row tiles with none, which K1's fp32 mode still multiplies.
    live_rows = (qb[rows] != 0).any(-1).sum(-1).float()
    occupancy = dict(qcap=qcap, blocks=rows.numel(), mean=float(live_rows.mean()),
                     median=float(live_rows.median()), max=int(live_rows.max()),
                     empty_128_row_tiles=int(((qb[rows] != 0).any(-1).reshape(
                         rows.numel(), -1, 128).any(-1) == 0).sum()) if qcap % 128 == 0 else None)
    phase("kernels", t0, f"live routed rows per walked block at B={BATCH}, nprobe={NPROBE}: "
          f"{occupancy}")

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
    # K2 timed at the joins of nprobe 4, 16 and 32 (W = nprobe * 256): the
    # pool at W = 1024, full-range int32 with 1/8 KMIN (empty probes) beyond
    # it, each held to the plain version first.  CUDA events around one call
    # count the wrapper's host time wherever the card idles while the host
    # launches it; calls captured in one CUDA graph count the device alone
    # (the plain version's scalar tensors cannot be captured).
    gen = torch.Generator(device=dev).manual_seed(15)
    k2_widths = {}
    for w in (pool.shape[1], 4096, 8192):
        if w == pool.shape[1]:
            xw = pool
        else:
            xw = torch.randint(-2**31, 2**31 - 1, (BATCH, w), generator=gen, device=dev,
                               dtype=torch.int32)
            xw[:, ::8] = ivf_accum.KMIN
        vw, iw = fused_topk.fused_topk(xw, kk)
        rvw, riw = fused_topk.fused_topk_reference(xw, kk)
        torch.cuda.synchronize()
        if not torch.equal(vw, rvw) or not torch.equal(iw, riw):
            raise AssertionError(f"K2 differs from the plain version at W={w}")
        k2_widths[w] = dict(
            ms=cuda_ms(torch, lambda: fused_topk.fused_topk(xw, kk)),
            device_ms=timing.graph_ms(lambda: fused_topk.fused_topk(xw, kk), dev, calls=REPS),
            plain_ms=cuda_ms(torch, lambda: fused_topk.fused_topk_reference(xw, kk)),
            lib_ms=cuda_ms(torch, lambda: torch.topk(xw, kk, dim=1)),
            lib_device_ms=timing.graph_ms(lambda: torch.topk(xw, kk, dim=1), dev, calls=REPS),
            bound=bound(xw.numel() * 4 + BATCH * kk * 8, kk * xw.numel(), OPS32_S))
        del xw, vw, iw, rvw, riw
    k2 = k2_widths[pool.shape[1]]
    phase("kernels", t0, f"K2 [{BATCH}, W] int32 k={kk}: exactly equal to the plain version on "
          f"the joined pool (W={pool.shape[1]}), a tie-heavy matrix and W 4096, 8192; by W, ms "
          f"(events around a call: kernel, plain, torch.topk; device time in a CUDA graph: "
          f"kernel, torch.topk) and bound: {k2_widths}")

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
        walked, cols = walked_blocks(np, bf_, bl_, rv_)
        k4[name] = dict(
            err=err, ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_grouped(*args, **kw)),
            plain_ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_grouped_reference(
                *args, **kw)),
            bound=bound(walked * qcap * DIM + cols * (DIM + 4) + r4.numel() * qcap * kk * 8,
                        2.0 * DIM * timing.live_products(timing.live_rows(qg_), bf_, bl_, rv_),
                        INT8_OPS_S))
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
        walked, cols = walked_blocks(np, bf_, bl_, rv_)
        k7[name] = dict(
            err=err, ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_routed(*args, **kw)),
            plain_ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_routed_reference(
                *args, **kw)),
            # K4's convention with the batch read once instead of a table,
            # and the walked blocks' rows of cq_blocks.
            bound=bound(walked * qcap * 4 + cols * (DIM + 4) + qi.numel()
                        + r7.numel() * qcap * kk * 8,
                        2.0 * DIM * timing.live_products(
                            ((cqb_ >= 0) & (cqb_ < qi.shape[0])).sum((1, 2)), bf_, bl_, rv_),
                        INT8_OPS_S))
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
        walked, cols = walked_blocks(np, *k1_args[2:])
        if br_ is not None:  # no row mask with bias rows: every column of a block is scored
            cols = walked * PAD_BLOCK
        k9[name] = dict(
            err=err, ms=cuda_ms(torch, lambda: ivf_accum.cluster_major_accum(
                *k1_args, kk, blk=PAD_BLOCK, bias_rows=br_)),
            plain_ms=cuda_ms(torch, lambda: ivf_accum.cluster_major_accum_reference(
                *k1_args, kk, blk=PAD_BLOCK, bias_rows=br_), reps=3),
            bound=bound(walked * qcap * DIM + cols * (DIM + 4 * (br_ is not None))
                        + rows.numel() * qcap * kk * 8,
                        2.0 * qcap * cols * DIM, INT8_OPS_S))
        phase("kernels", t0, f"K9 {name} qg {tuple(qb.shape)} k={kk} bin2: pv bit-equal and pr "
              f"equal to the plain version on {rows.numel()} last blocks ({int(fin.sum())} "
              f"finite entries); {k9[name]['ms']} ms vs plain {k9[name]['plain_ms']} ms; bound "
              f"{k9[name]['bound'][0]} ms by {k9[name]['bound'][1]}; the parent design's "
              f"{K9_PARENT_MS[name]} ms (PERF.md section 6, this script on the same card model)")
    del k9_inputs

    # ---- F8, F9: the grouped kernels (K4, K6, K7, K10) and K3 at what they
    # once refused, each against its plain version: bin depths past 4 and
    # nbins other than 128 on the general selection (csrc/ivf_grouped_scan.cu,
    # ivf_scan.selection), K3 at nbins other than 128 (its general binning),
    # and fp32 at blk 65536.  K4's new paths timed at the dense walk above.
    t = time.time()
    from rag_on_edge_tpu_torch.ops.block_tables import build_block_tables

    caps = {}
    for name, extra in (("depth5", dict(bin_depth=5)), ("depth8", dict(bin_depth=8)),
                        ("depth16", dict(bin_depth=16)), ("nbins64", dict(nbins=64)),
                        ("nbins256", dict(nbins=256))):
        kw = dict(k=kk, blk=PAD_BLOCK, group=idx.CM_GROUP, bias=bias, **extra)
        pv, pr = ivf_scan.cluster_major_scan_grouped(*k1_args, **kw)
        rpv, rpr = ivf_scan.cluster_major_scan_grouped_reference(*k1_args, **kw)
        torch.cuda.synchronize()
        fin = rpv[rows] > float("-inf")
        if not torch.equal(pv[rows], rpv[rows]) or not torch.equal(pr[rows][fin], rpr[rows][fin]):
            raise AssertionError(f"K4 {name} differs from the plain version at the dense walk")
        del pv, pr, rpv, rpr
        caps[f"K4 dense {name}"] = cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_grouped(
            *k1_args, **kw))
    cap_rng = np.random.default_rng(21)

    def cap_inputs(mode, blk_, qcap_=40, d_=37):
        """One to three blocks a cluster at blk_, half the routed slots
        empty, values in [-8, 7] (exact sums), int8 with bias → (qg,
        vectors_t, (bf, bl, rv, row_base), bias or None) on the card."""
        sizes = np.array([1500, 0, 40, 700, 129])
        offs = np.concatenate([[0], np.cumsum(-(-sizes // blk_) * blk_)[:-1]])
        tabs_ = [np.asarray(x, np.int32) for x in build_block_tables(offs, sizes, blk_)[1:4]]
        nb = len(tabs_[0])
        qg_ = cap_rng.integers(-8, 8, (nb, qcap_, d_))
        qg_[:, qcap_ // 2:] = 0
        dt = {"int8": torch.int8, "fp32": torch.float32, "bf16": torch.bfloat16}[mode]
        qg_, vt_ = (torch.from_numpy(x).to(dev, dt) for x in
                    (qg_, cap_rng.integers(-8, 8, (nb, d_, blk_))))
        tabs_ = [torch.from_numpy(x).to(dev) for x in tabs_]
        tabs_.append(torch.arange(nb, dtype=torch.int32, device=dev) * blk_)
        br_ = (torch.from_numpy(cap_rng.uniform(0, 300, (nb, 1, blk_)).astype(np.float32)).to(dev)
               if mode == "int8" else None)
        return qg_, vt_, tabs_, br_

    def cap_equal(name, got, want, out_rows):
        (pv_, pr_), (rpv_, rpr_) = got, want
        fin_ = rpv_[out_rows] > float("-inf")
        if not (torch.equal(pv_[out_rows].float().view(torch.int32),
                            rpv_[out_rows].float().view(torch.int32))
                and torch.equal(pr_[out_rows][fin_], rpr_[out_rows][fin_]) and fin_.any()):
            raise AssertionError(f"{name} differs from its plain version")

    ncases = 0
    for mode in ("int8", "fp32", "bf16"):
        for nbins_, depth_, blk_, k_ in ((128, 5, 2048, 20), (128, 8, 2048, 20),
                                         (128, 16, 2048, 33), (64, 2, 2048, 20),
                                         (256, 2, 2048, 20), (96, 2, 384, 20),
                                         (96, 3, 480, 33)):
            qg_, vt_, (bf_, bl_, rv_, rb_), br_ = cap_inputs(mode, blk_)
            kw = dict(k=k_, blk=blk_, nbins=nbins_, bin_depth=depth_, row_base=rb_)
            r_ = torch.nonzero(bl_).flatten()
            tag = f"{mode} nbins {nbins_} depth {depth_} blk {blk_} k {k_}"
            cap_equal(f"K4 {tag}", ivf_scan.cluster_major_scan_grouped(
                qg_, vt_, bf_, bl_, rv_, bias=br_, **kw),
                ivf_scan.cluster_major_scan_grouped_reference(qg_, vt_, bf_, bl_, rv_, bias=br_,
                                                              **kw), r_)
            bc_ = torch.cumsum(bf_, 0, dtype=torch.int32) - 1
            qc_ = qg_[torch.nonzero(bf_).flatten()]
            cap_equal(f"K6 {tag}", ivf_scan.cluster_major_scan(qc_, vt_, bc_, bf_, bl_, rv_, **kw),
                      ivf_scan.cluster_major_scan_reference(qc_, vt_, bc_, bf_, bl_, rv_, **kw),
                      bc_[r_].long())
            qi_ = qc_.reshape(-1, qc_.shape[-1])
            cqb_ = (bc_[:, None] * qc_.shape[1] + torch.arange(qc_.shape[1], device=dev)).to(
                torch.int32)[..., None].contiguous()
            cap_equal(f"K7 {tag}", ivf_scan.cluster_major_scan_routed(
                qi_, cqb_, vt_, bf_, bl_, rv_, bias=br_, **kw),
                ivf_scan.cluster_major_scan_routed_reference(qi_, cqb_, vt_, bf_, bl_, rv_,
                                                             bias=br_, **kw), r_)
            if depth_ == 2:
                for variant in ("full", "nogate"):
                    args_ = (qc_, vt_, bc_, bf_, bl_, rv_, k_, blk_, nbins_, variant)
                    cap_equal(f"K10 {variant} {tag}", kernel_lab._variant_scan(*args_),
                              kernel_lab._variant_scan_reference(*args_), bc_[r_].long())
            ncases += 1
        for nbins_, tile_ in ((64, 512), (32, 512), (256, 512), (96, 384), (192, 384)):
            qk = torch.from_numpy(cap_rng.integers(-8, 8, (70, 37))).to(dev)
            bk = torch.from_numpy(cap_rng.integers(-8, 8, (37, 3000))).to(dev)
            dt = {"int8": torch.int8, "fp32": torch.float32, "bf16": torch.bfloat16}[mode]
            got = bruteforce_fused.fused_topk_matmul(qk.to(dt), bk.to(dt), 20, tile_n=tile_,
                                                     nbins=nbins_)
            want = bruteforce_fused.fused_topk_matmul_reference(qk.to(dt), bk.to(dt), 20,
                                                                tile_n=tile_, nbins=nbins_)
            if not (torch.equal(got[0].float(), want[0].float())
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"K3 {mode} nbins {nbins_} differs from its plain version")
            ncases += 1
    qg_, vt_, (bf_, bl_, rv_, rb_), _ = cap_inputs("fp32", 65536, qcap_=24, d_=9)
    for depth_ in (2, 4):
        kw = dict(k=20, blk=65536, bin_depth=depth_, row_base=rb_)
        cap_equal(f"K4 fp32 blk 65536 depth {depth_}",
                  ivf_scan.cluster_major_scan_grouped(qg_, vt_, bf_, bl_, rv_, **kw),
                  ivf_scan.cluster_major_scan_grouped_reference(qg_, vt_, bf_, bl_, rv_, **kw),
                  torch.nonzero(bl_).flatten())
    del qg_, vt_
    phase("caps", t0, f"F8, F9: K4, K6, K7 (and K10 full, nogate at depth 2) in int8, fp32 and "
          f"bf16 at nbins 128 depths 5, 8, 16, nbins 64, 256, 96 (blk 384; blk 480 padded), "
          f"K3 at nbins 64, 32, 256, 96, 192, K4 fp32 at blk 65536: {ncases} cases equal to "
          f"the plain versions; K4 at the dense walk (k={kk}), ms: {caps} "
          f"({time.time() - t:.1f}s)")

    # The public calls at what they once refused: the SIFT index's default
    # search with bin_depth=5 (K1, then the recovery pass's K4 on the
    # general selection) against the same index on the CPU, on 1024
    # queries; an fp32 index with pad_block 65536 through engine="pallas"
    # and its recovery pass against the CPU, on a small corpus.
    t = time.time()
    q_cap = torch.from_numpy(np.ascontiguousarray(queries[:1024]))
    idx_cpu = IVFIndex.from_arrays(idx._centroids_np, idx._vectors_np, idx._offsets_np,
                                   idx._reorder_np, metric="l2", dtype="int8",
                                   pad_block=PAD_BLOCK, config=idx.config, device="cpu")
    reset_launches()
    # qcap 4 drops pairs, so the recovery pass has work.
    got = [x.cpu() for x in idx.search_device(q_cap.to(dev), K, NPROBE, qcap=4, bin_depth=5,
                                              recover=True)]
    torch.cuda.synchronize()
    depth5_launches = read_launches()
    want = idx_cpu.search_device(q_cap, K, NPROBE, qcap=4, bin_depth=5, recover=True)
    if not all(torch.equal(g, w) for g, w in zip(got, want)) or depth5_launches["K4"] < 1:
        raise AssertionError(f"search_device(bin_depth=5) differs from the CPU path or launched "
                             f"no K4: {depth5_launches}")
    del idx_cpu
    base_s, q_s = make_synthetic(3000, 40, 32, 4, seed=6)
    src_s = IVFIndex.build(base_s, nlist=4, metric="l2", dtype="int8", pad_block=256,
                           max_iter=5, device="cpu")
    wide_blk = []
    for device in (dev, "cpu"):
        ix = IVFIndex.from_arrays(src_s._centroids_np, src_s._vectors_np, src_s._offsets_np,
                                  src_s._reorder_np, metric="l2", dtype="fp32", pad_block=65536,
                                  config=src_s.config, device=device)
        wide_blk.append([x.cpu() for x in ix.search_device(
            torch.from_numpy(q_s).to(device), K, NPROBE, mode="cluster", engine="pallas",
            recover=True, qcap=16, recover_qcap=16)])
    if not all(torch.equal(g, w) for g, w in zip(*wide_blk)):
        raise AssertionError("the fp32 index at pad_block 65536 differs from the CPU path")
    phase("caps", t0, f"search_device(q[:1024], {K}, {NPROBE}, qcap=4, bin_depth=5, "
          f"recover=True) on "
          f"the SIFT index equal to the CPU path (launches {depth5_launches}); an fp32 index at "
          f"pad_block 65536 (engine='pallas', recovery) equal to the CPU path "
          f"({time.time() - t:.1f}s)")

    def search_all(index, nprobe=NPROBE, k=K, **kw):
        """All queries through ``index`` in B=BATCH batches (the tail padded
        cyclically) → (ids, scores, per-batch residual spill, wall s)."""
        t = time.time()
        ids_parts, score_parts, residual = [], [], []
        for s in range(0, N_QUERIES, BATCH):
            chunk = queries[s:s + BATCH]
            qs = torch.from_numpy(np.resize(chunk, (BATCH, DIM))).to(dev)
            vals, ids, _ = index.search_device(qs, k, nprobe, **kw)
            ids_parts.append(ids.cpu().numpy()[:chunk.shape[0]])
            score_parts.append(vals.cpu().numpy()[:chunk.shape[0]])
            residual.append(int(index.last_spill))
        ids, scores = np.concatenate(ids_parts), np.concatenate(score_parts)
        if ids.shape != (N_QUERIES, k) or not np.isfinite(scores).all() or (ids < 0).any():
            raise AssertionError(f"search {kw} output has the wrong shape, -1 ids or "
                                 "non-finite scores")
        return ids, scores, residual, time.time() - t

    def recalls(ids):
        return recall_at_k(ids, gt, K), recall_at_k(ids[:, :1], gt[:, :1], 1)

    def recall_wide(ids):
        return recall_at_k(ids, gt100[:, :K_WIDE], K_WIDE)

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
    by_kernel = device_ms_by_kernel(torch, lambda: idx.search_device(qs, K, NPROBE))
    if isinstance(by_kernel, dict):
        busy = sum(by_kernel.values())
        top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6])
        split = split_by_kernel(by_kernel, HEADLINE_KERNELS)
        phase("slice", t0, f"one B={BATCH} search_device by kernel (torch.profiler): device "
              f"busy {busy} ms of the {search_ms} ms call, idle share {1 - busy / search_ms:.3f}; "
              f"by kernel {split}; largest {top}")
    else:
        phase("slice", t0, f"one B={BATCH} search_device by kernel: {by_kernel}")

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

    # ---- phase 6b: the public calls at k = 20, whose rescore pool of 2k = 40
    # is past the 32 a row K4 and K7 keep (they run two passes), and the
    # accum engine at nprobe 128, whose join of W = 256 * 128 = 32768 is past
    # the 16384 K2 holds in a warp's shared memory (it runs in segments).
    wide = {}
    for name, kw in (("defaults", {}), ("pallas", dict(engine="pallas")),
                     ("pallas_routed", dict(engine="pallas_routed"))):
        reset_launches()
        ids_w, scores_w, residual_w, wall_w = search_all(idx, k=K_WIDE, **kw)
        wide[name] = dict(ids=ids_w, scores=scores_w, residual=residual_w, wall=wall_w,
                          launches={key: n for key, n in read_launches().items() if n},
                          recall=recall_wide(ids_w), engine=idx.last_engine)
    same_routed = (np.array_equal(wide["pallas_routed"]["ids"], wide["pallas"]["ids"])
                   and wide["pallas_routed"]["scores"].tobytes()
                   == wide["pallas"]["scores"].tobytes())
    phase("wide", t0, f"search_device(q, {K_WIDE}, {NPROBE}) over {N_QUERIES} queries: "
          + "; ".join(f"{name}: engine={w['engine']} {w['wall']:.1f}s residual "
                      f"last_spill={w['residual']} launches={w['launches']} "
                      f"recall@{K_WIDE}={w['recall']:.4f}" for name, w in wide.items())
          + f"; routed ids and scores equal to pallas: {same_routed}")
    for name, w in wide.items():
        key = "K7" if name == "pallas_routed" else "K4"
        if w["launches"].get(key, 0) < 2 or any(w["residual"]) or w["recall"] < 0.99:
            raise AssertionError(f"k={K_WIDE} {name}: launches {w['launches']}, residual "
                                 f"{w['residual']}, recall@{K_WIDE} {w['recall']}")
    if not same_routed:
        raise AssertionError(f"k={K_WIDE}: engine='pallas_routed' differs from engine='pallas'")
    del wide
    # nprobe 128 on 2048 queries (B·pool = 2048 * 32768 still takes the
    # fused join), routed at the capacity that drops no pair.
    NPROBE_WIDE, QW = 128, 2048
    qw = torch.from_numpy(np.ascontiguousarray(queries[:QW])).to(dev)
    qcap_w = idx.required_qcap(queries[:QW], NPROBE_WIDE)
    reset_launches()
    t = time.time()
    vals_n, ids_n, _ = idx.search_device(qw, K, NPROBE_WIDE, mode="cluster", qcap=qcap_w,
                                         engine="pallas_accum")
    torch.cuda.synchronize()
    wall_n = time.time() - t
    launch_n = {key: n for key, n in read_launches().items() if n}
    engine_n, spill_n = idx.last_engine, int(idx.last_spill)
    r10_n = recall_at_k(ids_n.cpu().numpy(), gt[:QW], K)
    r10_4 = recall_at_k(ids[:QW], gt[:QW], K)
    wide_ms = cuda_ms(torch, lambda: idx.search_device(qw, K, NPROBE_WIDE, mode="cluster",
                                                       qcap=qcap_w, engine="pallas_accum"),
                      reps=3)
    phase("wide", t0, f"engine=pallas_accum nprobe={NPROBE_WIDE} (join W={256 * NPROBE_WIDE}) "
          f"B={QW} qcap={qcap_w} (no pair dropped) {wall_n:.1f}s: engine={engine_n} "
          f"spill={spill_n} launches={launch_n} recall@10={r10_n:.4f} (nprobe {NPROBE}, the "
          f"defaults, on the same queries {r10_4:.4f}); one call {wide_ms} ms")
    if engine_n != "pallas_accum" or launch_n.get("K2", 0) != 3 or spill_n:
        raise AssertionError(f"nprobe={NPROBE_WIDE}: engine {engine_n}, spill {spill_n}, "
                             f"launches {launch_n} (K2: two segments and a merge)")
    if not torch.isfinite(vals_n).all() or r10_n < max(r10_4, 0.99):
        raise AssertionError(f"nprobe={NPROBE_WIDE} recall@10 {r10_n} below nprobe={NPROBE}'s "
                             f"{r10_4} or 0.99")

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

    def k5_args(qf, l2=True):
        """K5's inputs as the accum engine makes them: L2, one global query
        scale and the pre-shifted bias rows; IP, per-row query scales and no
        bias rows (over the same tiles)."""
        qv, qs = quantize.quantize_int8(qf, per_row=not l2)
        kw = dict(group=bf_auto._acc_group, depth=bf_auto._acc_depth)
        if l2:
            alpha = 2.0 * qs * ba["base_scale"]
            kw["bias_rows"] = bruteforce_accum.l2_bias_rows(ba["norms_tiled"], alpha,
                                                            bf_auto._acc_group)
        return (qv, ba["base_tiles"], N_BASE, kq), kw

    SLICE = 512  # the plain versions score the whole [B, N] matrix: a B=512 slice
    q_slice = torch.from_numpy(np.ascontiguousarray(queries[:SLICE])).to(dev)
    q_full = torch.from_numpy(np.ascontiguousarray(queries[:BATCH])).to(dev)

    # The GEMM alone (`gemm_ms`), the yardstick of the int8 kernels: torch._int_mm
    # of the same product, [8192,128] x [128,1M] -> int32, in 8 column blocks
    # of 4.3 GB each.  And the K-major copies the int8 kernels' wrappers make.
    qv8 = quantize.quantize_int8(q_full, per_row=True)[0]
    step = N_BASE // 8
    try:
        int_mm_ms = sum(cuda_ms(torch, lambda s=s: torch._int_mm(
            qv8, bp["base_t"][:, s:s + step]), reps=3) for s in range(0, N_BASE, step))
    except RuntimeError as exc:
        int_mm_ms = None
        print(f"[gemm floor] torch._int_mm not measured: {exc}", flush=True)
    print(f"[gemm floor] torch._int_mm [{BATCH},{DIM}] x [{DIM},{N_BASE}] int8 -> int32 in "
          f"8 column blocks (gemm_ms): {int_mm_ms} ms on {card} (a library yardstick; the port "
          "never calls it)", flush=True)
    copy_ms = {"K3": cuda_ms(torch, lambda: _build.kmajor_operands(qv8, bp["base_t"])),
               "K5": cuda_ms(torch, lambda: _build.kmajor_operands(qv8, ba["base_tiles"]))}
    print(f"[brute] the int8 wrappers' K-major copies (queries padded, base transposed; in each "
          f"call's time below): K3 base_t {tuple(bp['base_t'].shape)} -> [N, D] "
          f"{copy_ms['K3']} ms, K5 tiles {tuple(ba['base_tiles'].shape)} -> [T, tile_n, D] "
          f"{copy_ms['K5']} ms", flush=True)

    brute = {}
    for name, fn, plain, make in (
            ("K3 int8-L2 bin128", bruteforce_fused.fused_topk_matmul,
             bruteforce_fused.fused_topk_matmul_reference, lambda qf: k3_args(qf, True)),
            ("K3 int8-IP exact", bruteforce_fused.fused_topk_matmul,
             bruteforce_fused.fused_topk_matmul_reference, lambda qf: k3_args(qf, False)),
            ("K5 int8-L2", bruteforce_accum.fused_topk_accum,
             bruteforce_accum.fused_topk_accum_reference, k5_args),
            ("K5 int8-IP", bruteforce_accum.fused_topk_accum,
             bruteforce_accum.fused_topk_accum_reference, lambda qf: k5_args(qf, False))):
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
        extra = (ba["base_tiles"].numel() + ba["norms_tiled"].numel() * 4 * ("L2" in name)
                 if name.startswith("K5")
                 else bp["base_t"].numel() + (BATCH + N_BASE) * 4 * ("L2" in name))
        brute[name] = dict(err=err, ms=ms, plain_ms=plain_ms, bound=bound(
            BATCH * DIM + extra + BATCH * kq * 8, 2.0 * BATCH * cols * DIM, INT8_OPS_S))
        vs = (f"{ms / int_mm_ms:.3f}x gemm_ms {int_mm_ms}, faster than the GEMM alone: "
              f"{ms < int_mm_ms}" if int_mm_ms else "gemm_ms not measured")
        phase("kernels", t0, f"{name} k={kq}: exactly equal to the plain version on "
              f"[{SLICE},{DIM}] x [{DIM},{N_BASE}]; {ms} ms at B={BATCH} ({vs}; bound "
              f"{brute[name]['bound'][0]} ms by {brute[name]['bound'][1]}); plain {plain_ms} "
              f"ms at B={SLICE}")
        del v, i, rv, ri
    # Where one B=8192 call's device time goes, kernel by kernel.
    for name, make, fn in (("K3 int8-L2 bin128", lambda: k3_args(q_full, True),
                            bruteforce_fused.fused_topk_matmul),
                           ("K5 int8-L2", lambda: k5_args(q_full),
                            bruteforce_accum.fused_topk_accum)):
        args, kw = make()
        phase("kernels", t0, f"{name} one B={BATCH} call by kernel (torch.profiler, device ms): "
              f"{device_ms_by_kernel(torch, lambda: fn(*args, **kw))}")

    # K3 in its fp32 exact mode (the register-tiled kernel over column
    # splits, joined by K2) at the ground truth's shapes (one 1024-row
    # chunk), k = 10 and the loader's k = 100, and at the fused coarse
    # tier's [8192, D'] x [D', 8192], k = 4; beside each, the plain version
    # and torch.mm of the same product alone (TF32 off: `gemm_ms`).
    bt_aug = torch.cat([torch.from_numpy(base.T.copy()),
                        torch.from_numpy(-0.5 * np.sum(base ** 2, axis=1))[None, :]]).to(dev)
    q_aug = torch.cat([torch.from_numpy(queries[:1024]),
                       torch.ones((1024, 1))], dim=1).to(dev)
    # The coarse tier takes K3 from nlist 8192 (the 10M configuration's): its
    # transposed, augmented centroids [D + 1, 8192], here random integers.
    nl = 8192
    cents = torch.randint(0, 142, (DIM, nl), generator=torch.Generator().manual_seed(16))
    cents = torch.cat([cents, -0.5 * (cents * cents).sum(0, keepdim=True)]).float().to(dev)
    q_coarse = torch.cat([torch.from_numpy(np.resize(queries, (BATCH, DIM))),
                          torch.ones((BATCH, 1))], dim=1).to(dev)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k3_f32 = {}
    for name, (qx, btx, kx) in (("gt", (q_aug, bt_aug, K)), ("gt k=100", (q_aug, bt_aug, GT_K)),
                                ("coarse", (q_coarse, cents, NPROBE))):
        v, i = bruteforce_fused.fused_topk_matmul(qx, btx, kx)
        rv, ri = bruteforce_fused.fused_topk_matmul_reference(qx, btx, kx)
        torch.cuda.synchronize()
        if not torch.equal(v, rv) or not torch.equal(i, ri):
            raise AssertionError(f"K3 fp32 differs from its plain version at the {name} shape")
        del rv, ri
        bx, nx = qx.shape[0], btx.shape[1]
        k3_f32[name] = dict(
            err=0.0, splits=bruteforce_fused.split_plan(bx, nx, 512, 0, sms)[1],
            ms=cuda_ms(torch, lambda: bruteforce_fused.fused_topk_matmul(qx, btx, kx), reps=5),
            plain_ms=cuda_ms(torch, lambda: bruteforce_fused.fused_topk_matmul_reference(
                qx, btx, kx), reps=2),
            gemm_ms=cuda_ms(torch, lambda: torch.mm(qx, btx), reps=5),
            bound=bound(btx.numel() * 4 + qx.numel() * 4 + bx * kx * 8,
                        2.0 * bx * btx.shape[0] * nx, OPS32_S))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    phase("kernels", t0, f"K3 fp32 exact, bit-equal to its plain version: ground-truth chunk "
          f"[1024,{DIM + 1}] x [{DIM + 1},{N_BASE}] k={K} and k={GT_K}, fused coarse tier "
          f"[{BATCH},{DIM + 1}] x [{DIM + 1},{nl}] k={NPROBE}; ms, plain ms, gemm_ms "
          f"(torch.mm, TF32 off), bound and splits: {k3_f32}; the whole {N_QUERIES}-query "
          f"L2 ground truth through K3: k={K} {gt_k10_s:.2f}s, k={GT_K} {gt100_s:.2f}s")
    del bt_aug, q_aug, q_coarse, cents

    def brute_all(idx, k=K):
        """All queries in B=BATCH batches (the tail padded cyclically) →
        (ids, launches, wall s)."""
        reset_launches()
        t = time.time()
        parts = []
        for s_ in range(0, N_QUERIES, BATCH):
            chunk = queries[s_:s_ + BATCH]
            vals, ids_ = idx.search_device(
                torch.from_numpy(np.resize(chunk, (BATCH, DIM))).to(dev), k)
            if not torch.isfinite(vals).all():
                raise AssertionError("brute-force scores are not finite")
            parts.append(ids_.cpu().numpy()[:chunk.shape[0]])
        got = read_launches()
        ids_ = np.concatenate(parts)
        if ids_.shape != (N_QUERIES, k) or (ids_ < 0).any() or (ids_ >= N_BASE).any():
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
    # k = 20: the rescore pool of 2k = 40 runs K3's int8 mode in two passes.
    ids_pw, launch_pw, wall_pw = brute_all(bf_pallas, k=K_WIDE)
    r20_p = recall_wide(ids_pw)
    phase("wide", t0, f"BruteForceIndex(l2, int8, engine=pallas, rescore=True) k={K_WIDE} "
          f"{N_QUERIES} queries {wall_pw:.1f}s: launches={launch_pw} "
          f"recall@{K_WIDE}={r20_p:.4f}")
    if launch_pw["K3"] < 2 * n_batches or r20_p < 0.999:
        raise AssertionError(f"brute pallas k={K_WIDE}: launches {launch_pw}, recall {r20_p}")
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
        walked, cols = walked_blocks(np, bf_, bl_, rv_)
        # Beside CUDA events around one call (the wrapper's host time
        # included where the card idles), the kernel's own device time.
        dev_k6 = device_ms_by_kernel(torch, lambda: ivf_scan.cluster_major_scan(*args, **kw),
                                     calls=REPS)
        k6[name] = dict(
            err=err, ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan(*args, **kw)),
            plain_ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_reference(*args, **kw)),
            device_ms=split_by_kernel(dev_k6, {"K6": "grouped_wgmma_kernel"})["K6"]
            if isinstance(dev_k6, dict) else dev_k6,
            bound=bound(cols * (DIM + 4) + r6.numel() * qcap * (DIM + kk * 8),
                        2.0 * DIM * timing.live_products(timing.live_rows(args[0])[bc_.long()],
                                                         bf_, bl_, rv_), INT8_OPS_S))
        phase("kernels", t0, f"K6 {name} (shard {0 if name == 'dense' else s_rec}): qg "
              f"{tuple(args[0].shape)} vectors_t {tuple(args[1].shape)} k={kk}: pv bit-equal, "
              f"pr equal where finite, on {r6.numel()} emitted clusters ({int(fin.sum())} "
              f"finite entries, {walked} blocks walked); {k6[name]['ms']} ms (kernel alone "
              f"{k6[name]['device_ms']} ms by torch.profiler) vs plain "
              f"{k6[name]['plain_ms']} ms; bound {k6[name]['bound'][0]} ms by "
              f"{k6[name]['bound'][1]}")
    del r, rec_scan, k6_inputs

    def sharded_all(sh, bs, k=K, **kw):
        """All queries through the sharded index ``sh`` in B=bs batches (the
        tail padded cyclically) → (ids, per-batch residual spill, wall s)."""
        t = time.time()
        parts, residual = [], []
        for s_ in range(0, N_QUERIES, bs):
            chunk = queries[s_:s_ + bs]
            vals, ids_, _ = sh.search_device(
                torch.from_numpy(np.resize(chunk, (bs, DIM))).to(dev), k, NPROBE, **kw)
            if not torch.isfinite(vals).all():
                raise AssertionError(f"sharded search {kw} scores are not finite")
            parts.append(ids_.cpu().numpy()[:chunk.shape[0]])
            if kw.get("mode") == "cluster":
                residual.append(int(sh.last_spill))
        ids_ = np.concatenate(parts)
        if ids_.shape != (N_QUERIES, k) or (ids_ < 0).any() or (ids_ >= N_BASE).any():
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
    # The call split by kernel: its launches (counted over one call) and its
    # device time (torch.profiler), K1, K6 (the recovery passes) and K2 once
    # per shard.
    reset_launches()
    sh.search_device(qs, K, NPROBE, mode="cluster")
    torch.cuda.synchronize()
    one_call = {key: n for key, n in read_launches().items() if n}
    by_kernel_s = device_ms_by_kernel(torch, lambda: sh.search_device(qs, K, NPROBE,
                                                                      mode="cluster"))
    if isinstance(by_kernel_s, dict):
        busy_s = sum(by_kernel_s.values())
        phase("sharded", t0, f"one B={BATCH} sharded call by kernel (torch.profiler): launches "
              f"{one_call}; device ms {split_by_kernel(by_kernel_s, SHARDED_KERNELS)}; device "
              f"busy {busy_s} ms of the {sh_ms} ms call, idle share {1 - busy_s / sh_ms:.3f}")
    else:
        phase("sharded", t0, f"one B={BATCH} sharded call: launches {one_call}; {by_kernel_s}")
    if min(launch_s["K1"], launch_s["K2"], launch_s["K6"]) < 1:
        raise AssertionError(f"the sharded default path did not launch K1, K2 and K6: {launch_s}")
    if any(residual_s):
        raise AssertionError(f"sharded: pairs still dropped after recovery: {residual_s}")
    if r10_s < 0.99 or r1_s < 0.99:
        raise AssertionError(f"sharded recall below 0.99: recall@10 {r10_s}, recall@1 {r1_s}")
    # k = 20: each shard's recovery pass runs K6 in two passes of 32.
    reset_launches()
    ids_sw, residual_sw, wall_sw = sharded_all(sh, BATCH, k=K_WIDE, mode="cluster")
    launch_sw = {key: n for key, n in read_launches().items() if n}
    r20_s = recall_wide(ids_sw)
    phase("wide", t0, f"sharded search_device(q, {K_WIDE}, {NPROBE}, mode='cluster') "
          f"{N_QUERIES} queries {wall_sw:.1f}s: residual last_spill={residual_sw} "
          f"launches={launch_sw} recall@{K_WIDE}={r20_s:.4f}")
    if launch_sw.get("K6", 0) < 2 or any(residual_sw) or r20_s < 0.99:
        raise AssertionError(f"sharded k={K_WIDE}: launches {launch_sw}, residual "
                             f"{residual_sw}, recall@{K_WIDE} {r20_s}")

    reset_launches()
    ids_sp, residual_sp, wall_sp = sharded_all(sh, BATCH, mode="cluster", engine="pallas")
    launch_sp = read_launches()
    r10_sp, _ = recalls(ids_sp)
    sp_ms = cuda_ms(torch, lambda: sh.search_device(qs, K, NPROBE, mode="cluster",
                                                    engine="pallas"))
    phase("sharded", t0, f"engine=pallas {N_QUERIES} queries {wall_sp:.1f}s: residual "
          f"last_spill={residual_sp} launches={launch_sp} recall@10={r10_sp:.4f}; one "
          f"B={BATCH} call {sp_ms} ms")
    by_kernel_sp = device_ms_by_kernel(torch, lambda: sh.search_device(
        qs, K, NPROBE, mode="cluster", engine="pallas"))
    if isinstance(by_kernel_sp, dict):
        busy_sp = sum(by_kernel_sp.values())
        phase("sharded", t0, f"engine=pallas one B={BATCH} call by kernel (torch.profiler): "
              f"device ms {split_by_kernel(by_kernel_sp, SHARDED_KERNELS)}; device busy "
              f"{busy_sp} ms of the {sp_ms} ms call, idle share {1 - busy_sp / sp_ms:.3f}")
    else:
        phase("sharded", t0, f"engine=pallas one B={BATCH} call by kernel: {by_kernel_sp}")
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
    # Past 32 a row: full and nogate in passes of 32, maxonly and fixedout
    # in one launch (their row max in every slot), each against its plain
    # version on its windows, counted.
    k10_wide = {}
    for variant in kernel_lab.VARIANTS:
        args = (qg_lab, *lab_tabs, K10_WIDE_K, PAD_BLOCK, 128, variant)
        reset_launches()
        pv, pr = kernel_lab._variant_scan(*args)
        n_l = read_launches()["K10"]
        rpv, rpr = kernel_lab._variant_scan_reference(*args)
        torch.cuda.synchronize()
        win = lab_windows[variant]
        fin = rpv[win] > float("-inf")
        want_l = -(-K10_WIDE_K // 32) if variant in ("full", "nogate") else 1
        if (not torch.equal(pv[win], rpv[win]) or not torch.equal(pr[win][fin], rpr[win][fin])
                or n_l != want_l):
            raise AssertionError(f"K10 {variant} at k={K10_WIDE_K} differs from the plain "
                                 f"version or took {n_l} launches ({want_l} expected)")
        del pv, pr, rpv, rpr
        k10_wide[variant] = dict(launches=n_l, ms=cuda_ms(
            torch, lambda: kernel_lab._variant_scan(*args), reps=3))
    phase("lab", t0, f"K10 at k={K10_WIDE_K}: every variant equal to its plain version on its "
          f"windows; launches and ms {k10_wide}")
    # int8 past the D the old staged kernel took (1024): D 1152 (nine wgmma
    # units) on a small walk of four clusters with rows (one of three
    # blocks), 40 routed rows a cluster, every fifth one empty.
    from rag_on_edge_tpu_torch.ops.block_tables import build_block_tables

    gen10 = torch.Generator(device=dev).manual_seed(10)
    w_sizes = np.array([2000, 0, 5000, 129, 700])
    w_offs = np.concatenate([[0], np.cumsum(-(-w_sizes // PAD_BLOCK) * PAD_BLOCK)[:-1]])
    w_tabs = [torch.from_numpy(x.astype(np.int32)).to(dev)
              for x in build_block_tables(w_offs, w_sizes, PAD_BLOCK)[:4]]
    qg_w = torch.randint(-127, 128, (len(w_sizes), 40, 1152), generator=gen10, device=dev,
                         dtype=torch.int8)
    qg_w[:, ::5] = 0
    vt_w = torch.randint(-127, 128, (len(w_tabs[0]), 1152, PAD_BLOCK), generator=gen10,
                         device=dev, dtype=torch.int8)
    k10_d1152 = {}
    for variant in kernel_lab.VARIANTS:
        args = (qg_w, vt_w, *w_tabs, LAB_K, PAD_BLOCK, 128, variant)
        pv, pr = kernel_lab._variant_scan(*args)
        rpv, rpr = kernel_lab._variant_scan_reference(*args)
        torch.cuda.synchronize()
        bc_w = w_tabs[0].long()
        win = {"fixedout": torch.zeros(1, dtype=torch.long, device=dev),
               "maxonly": torch.unique(bc_w)}.get(variant, torch.unique(bc_w[w_tabs[2] > 0]))
        fin = rpv[win] > float("-inf")
        ok = bool(fin.any()) and torch.equal(pv[win], rpv[win]) \
            and torch.equal(pr[win][fin], rpr[win][fin])
        if variant == "full":
            kv, ki = ivf_scan.cluster_major_scan(*args[:6], LAB_K, blk=PAD_BLOCK, bin_depth=2)
            ok = ok and torch.equal(pv[win], kv[win]) and torch.equal(pr[win][fin], ki[win][fin])
        k10_d1152[variant] = ok
    phase("lab", t0, f"K10 int8 at D 1152 (qg {tuple(qg_w.shape)}), equal to the plain version "
          f"on each variant's windows, full also to K6: {k10_d1152}")
    if not all(k10_d1152.values()):
        raise AssertionError(f"K10 int8 at D 1152 differs from its plain version: {k10_d1152}")
    del qg_w, vt_w, pv, pr, rpv, rpr, kv, ki
    # The bounds of the four variants over the lab's walk (the valid
    # columns' slab, the routed rows each written window reads, the windows
    # written; the products of each block's live routed rows): full and
    # nogate write the clusters that end a run, maxonly every cluster with
    # blocks, fixedout one window, and every variant scores every block.
    walked, cols = walked_blocks(np, *lab_tabs[2:])
    k10_ops = 2.0 * DIM * timing.live_products(timing.live_rows(qg_lab)[bc_lab], *lab_tabs[2:])
    k10_bounds = {v: bound(cols * DIM + lab_windows[v].numel() * LAB_QCAP * (DIM + LAB_K * 8),
                           k10_ops, INT8_OPS_S)
                  for v in kernel_lab.VARIANTS}
    k10_bound = k10_bounds["full"]
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
    k10_variants = {v: {"ms": lab_out[v][0], "bound_ms": k10_bounds[v][0],
                        "bound_by": k10_bounds[v][1]} for v in kernel_lab.VARIANTS}
    phase("lab", t0, f"K10 int8 by variant (ms/call, bound) on {card}: {k10_variants}")
    del qg_lab, lab_tabs

    # ---- phase 10b (f11): K3's binned modes at tiles off the 128-column chunk
    # (F11), each chunk across two tiles binned once for each: at B=8192 over
    # the whole base, held row block by row block against the plain version
    # (its [B, N] score matrix is 32 GB at B=8192) and timed.
    bt_i8 = torch.from_numpy(np.ascontiguousarray(base.T) - 70.0).to(dev, torch.int8)
    q_i8 = torch.from_numpy(queries[:BATCH] - 70.0).to(dev, torch.int8)
    f11_l2 = dict(alpha=torch.full((BATCH,), 2.0, device=dev),
                  bias=(bt_i8.float() ** 2).sum(0))
    f11_ops = {"int8-IP": ((q_i8, bt_i8), {}), "int8-L2": ((q_i8, bt_i8), f11_l2),
               "bf16": ((q_i8.to(torch.bfloat16), bt_i8.to(torch.bfloat16)), {}),
               "fp32": ((q_i8.float(), bt_i8.float()), {})}
    f11 = {}
    for name, mode, (tile_n, nbins, kx) in (("int8-L2 t192 n48 k4", "int8-L2", (192, 48, 4)),
                                            *((f"{m} t320 n40 k20", m, (320, 40, 20))
                                              for m in f11_ops)):
        (qx, btx), extra = f11_ops[mode]
        kw = dict(tile_n=tile_n, nbins=nbins, **extra)
        reset_launches()
        v, i = bruteforce_fused.fused_topk_matmul(qx, btx, kx, **kw)
        torch.cuda.synchronize()
        f11_launches = read_launches()["K3"]
        if f11_launches < 1:
            raise AssertionError(f"F11: K3 {name} did not launch its kernel")
        for r0 in range(0, BATCH, SLICE):
            kr = dict(kw, alpha=kw["alpha"][r0:r0 + SLICE]) if "alpha" in kw else kw
            rv, ri = bruteforce_fused.fused_topk_matmul_reference(qx[r0:r0 + SLICE], btx, kx,
                                                                  **kr)
            if not torch.equal(v[r0:r0 + SLICE], rv) or not torch.equal(i[r0:r0 + SLICE], ri):
                raise AssertionError(f"F11: K3 {name} differs from its plain version at rows "
                                     f"{r0}..{r0 + SLICE}")
        kr = dict(kw, alpha=kw["alpha"][:SLICE]) if "alpha" in kw else kw
        eb = btx.element_size()
        f11[name] = dict(
            launches=f11_launches, err=0.0,
            ms=cuda_ms(torch, lambda: bruteforce_fused.fused_topk_matmul(qx, btx, kx, **kw),
                       reps=3),
            plain_ms=cuda_ms(torch, lambda: bruteforce_fused.fused_topk_matmul_reference(
                qx[:SLICE], btx, kx, **kr), reps=2),
            bound=bound(btx.numel() * eb + qx.numel() * eb + BATCH * kx * 8,
                        2.0 * BATCH * N_BASE * DIM,
                        {1: INT8_OPS_S, 2: BF16_OPS_S}.get(eb, OPS32_S)))
        del v, i, rv, ri
    phase("f11", t0, f"K3 binned at tiles off the 128-column chunk, [{BATCH},{DIM}] x "
          f"[{DIM},{N_BASE}], bit-equal to the plain version on every row (plain ms at "
          f"B={SLICE}); launches, ms, plain ms and bound on {card}: {f11}")
    del bt_i8, q_i8, f11_l2, f11_ops

    # ---- phase 10c (kmeans): k-means on the SIFT-1M base at nlist 1024, 6
    # steps: two uninterrupted runs bit-equal, then 3 steps with a
    # checkpoint and a resume to 6 bit-equal to them; IVFIndex.build resumed
    # from the same checkpoint lays out the uninterrupted run's clusters.
    from rag_on_edge_tpu_torch.models import kmeans as kmeans_mod

    ck_dir = Path(__file__).resolve().parent / "build"
    ck_dir.mkdir(exist_ok=True)
    ck = str(ck_dir / "chip_smoke_kmeans.npz")
    if os.path.exists(ck):
        os.remove(ck)
    km_s = {}
    km = []
    for run_ in ("run 1", "run 2"):
        t = time.time()
        km.append(kmeans_mod.kmeans(base, NLIST, seed=42, max_iter=6, tol=0.0, device=dev))
        km_s[run_] = round(time.time() - t, 3)
    t = time.time()
    kmeans_mod.kmeans(base, NLIST, seed=42, max_iter=3, tol=0.0, checkpoint=ck, device=dev)
    km_s["3 steps, checkpointed"] = round(time.time() - t, 3)
    if int(np.load(ck)["next_iter"]) != 3:
        raise AssertionError("the k-means checkpoint does not hold 3 steps")
    ck3 = ck + ".3"
    with open(ck, "rb") as fsrc, open(ck3, "wb") as fdst:
        fdst.write(fsrc.read())
    t = time.time()
    km.append(kmeans_mod.kmeans(base, NLIST, seed=42, max_iter=6, tol=0.0, checkpoint=ck,
                                device=dev))
    km_s["resume 3 -> 6"] = round(time.time() - t, 3)
    km_equal = [bool(np.array_equal(km[0][j], km[r][j])) for r in (1, 2) for j in (0, 1)]
    t = time.time()
    ck_idx = IVFIndex.build(base, nlist=NLIST, metric="l2", dtype="int8", pad_block=PAD_BLOCK,
                            seed=42, max_iter=6, kmeans_checkpoint=ck3, device=dev)
    km_s["IVFIndex.build resumed 3 -> 6"] = round(time.time() - t, 3)
    build_equal = (np.array_equal(ck_idx._centroids_np, km[0][0]) and np.array_equal(
        np.diff(ck_idx._offsets_np), np.bincount(km[0][1], minlength=NLIST)))
    phase("kmeans", t0, f"kmeans(base [{N_BASE},{DIM}], {NLIST}, max_iter=6, tol=0) on {card}: "
          f"seconds {km_s}; run 2 and the resume bit-equal to run 1 (centroids, assignment): "
          f"{km_equal}; IVFIndex.build(kmeans_checkpoint=) resumed to run 1's centroids and "
          f"cluster sizes: {build_equal}")
    if not all(km_equal) or not build_equal:
        raise AssertionError("k-means on the card is not bit-reproducible or its resume differs")
    del ck_idx, km
    for f in (ck, ck3):
        os.remove(f)

    # ---- phase 10d (compact): the setup's arrays in a compact store, at a
    # capacity that drops no pair, against the padded store, single and
    # sharded over [cuda:0] * 4.
    cidx = IVFIndex.from_arrays(idx._centroids_np, idx._vectors_np, idx._offsets_np,
                                idx._reorder_np, metric="l2", dtype="int8", pad_block=PAD_BLOCK,
                                config=idx.config, device=dev, store="compact")
    load = torch.bincount(idx._coarse_probes(q, NPROBE).flatten(), minlength=NLIST)
    qcap_all = int(-(-int(load.max()) // 128) * 128)
    compact = {}
    for name, (pad_s, cmp_s, kwx) in (
            ("single", (idx, cidx, {})),
            ("sharded", (ShardedIVFIndex(idx, [dev] * 4), ShardedIVFIndex(cidx, [dev] * 4),
                         dict(mode="cluster")))):
        out = {}
        for store, searcher in (("padded", pad_s), ("compact", cmp_s)):
            reset_launches()
            vals_, ids_, _ = searcher.search_device(q, K, NPROBE, qcap=qcap_all, **kwx)
            torch.cuda.synchronize()
            out[store] = (ids_.cpu().numpy(), int(searcher.last_spill),
                          {key: n for key, n in read_launches().items() if n})
        if not np.array_equal(out["padded"][0], out["compact"][0]) or out["compact"][1]:
            raise AssertionError(f"the compact store's ids differ from the padded store's "
                                 f"({name}) or it dropped pairs")
        compact[name] = dict(spill=out["compact"][1], launches=out["compact"][2],
                             recall10=recall_at_k(out["compact"][0], gt[:BATCH], K))
    phase("compact", t0, f"store='compact' (the setup's arrays) at B={BATCH}, nprobe "
          f"{NPROBE}, k {K}, qcap {qcap_all} (no pair dropped): ids equal to the padded "
          f"store's, single and sharded over [cuda:0] * 4: {compact}; memory compact "
          f"{cidx.memory_report()['TOTAL']:,} bytes, padded {idx.memory_report()['TOTAL']:,}")
    del cidx, load

    # ---- phase 10e (serving): the serving path, BatchingExecutor through
    # bench_executor on the setup's index: the saturated protocol at the
    # JAX package's defaults, again traced for the device's busy share, then
    # the open loop at three fractions of the measured capacity.
    from rag_on_edge_tpu_torch.harness import bench_executor
    from rag_on_edge_tpu_torch.runtime import BatchingExecutor
    from rag_on_edge_tpu_torch.utils.datasets import load_dataset

    t = time.time()
    ds = load_dataset("sift", gt_k=K, device=dev)
    if not (np.array_equal(ds.base, base) and np.array_equal(ds.queries, queries)):
        raise AssertionError("load_dataset('sift') is not the setup's corpus")
    ds_s = time.time() - t
    SB = 2048  # the JAX package's serving batch
    t = time.time()
    direct_ids, _, _ = idx.search(queries, K, NPROBE, batch_size=SB, mode="cluster")
    direct_r10 = recall_at_k(direct_ids, ds.ground_truth_l2, K)
    direct_s = time.time() - t
    serve_ms = cuda_ms(torch, lambda: idx.search_device(q[:SB], K, NPROBE, mode="cluster"))

    def host_then_done():
        """(ms until search_device returns, ms until its batch is done)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        idx.search_device(q[:SB], K, NPROBE, mode="cluster")
        th = time.perf_counter()
        torch.cuda.synchronize()
        return (th - t) * 1e3, (time.perf_counter() - t) * 1e3

    hd = np.array([host_then_done() for _ in range(REPS)])
    serve_host_ms, serve_done_ms = (float(np.median(hd[:, j])) for j in (0, 1))
    reset_launches()
    sat = bench_executor.run(dataset="sift", batch=SB, nprobe=NPROBE, k=K, requests=20000,
                             max_delay_ms=5.0, inflight=8, quiet=True, index=idx)
    serve_launches = {key: n for key, n in read_launches().items() if n}
    sat_p = bench_executor.run(dataset="sift", batch=SB, nprobe=NPROBE, k=K, requests=20000,
                               max_delay_ms=5.0, inflight=8, quiet=True, index=idx,
                               profile=True)
    phase("serving", t0, f"load_dataset('sift') {ds_s:.1f}s (the setup's corpus); direct "
          f"search_device at B={SB} over {N_QUERIES} queries {direct_s:.1f}s, recall@{K} "
          f"{direct_r10}; one B={SB} call {serve_ms} ms (CUDA events, median of {REPS}); "
          f"host clock, median of {REPS}: search_device returns after {serve_host_ms:.3f} ms, "
          f"its batch is done after {serve_done_ms:.3f} ms (a return near the done time "
          f"means the call waits on the device inside: the executor's dispatch is serial)")
    phase("serving", t0, f"saturated (B={SB}, nprobe {NPROBE}, k {K}, 20000 requests, "
          f"max_delay_ms 5, inflight 8, wire {sat['wire']}) on {card}: QPS "
          f"{sat['qps_end_to_end']}, recall@{K} {sat['recall']}, latency ms {sat['latency_ms']}, "
          f"pipeline {sat['pipeline']}; launches {serve_launches}")
    phase("serving", t0, f"saturated again under torch.profiler: QPS {sat_p['qps_end_to_end']}, "
          f"device busy {sat_p.get('device_busy_ms')} ms = share "
          f"{sat_p.get('device_busy_share')} of the timed region")
    if sat["recall"] < 0.99 or abs(sat["recall"] - direct_r10) > 0.001:
        raise AssertionError(f"served recall@{K} {sat['recall']} is below 0.99 or more than "
                             f"0.001 from direct search_device's {direct_r10}")
    # At B=2048 the path is K1 alone: the join takes K2 from B·pool >= 8 << 20
    # (B=8192 at nprobe 4), and the auto policy runs no recovery pass (K4).
    if serve_launches.get("K1", 0) < 1:
        raise AssertionError(f"the served path launched {serve_launches}, not K1")
    capacity = sat["qps_end_to_end"]
    fn_s = lambda qx: idx.search_device(qx, K, NPROBE, mode="cluster")  # noqa: E731
    wd = bench_executor._wire_dtype(queries, "auto")
    OPEN_N = 6000
    reqs = np.resize(queries, (OPEN_N, DIM)).astype(np.float32)
    gt_reqs = np.resize(ds.ground_truth_l2[:, :K], (OPEN_N, K))
    curve = []
    with BatchingExecutor(fn_s, dim=DIM, batch_size=SB, max_delay_ms=5.0, inflight=8,
                          wire_dtype=wd, device=dev) as ex:
        ex.submit(reqs[0]).result(timeout=600)
        for frac in (0.25, 0.5, 0.8):
            delay = bench_executor.auto_max_delay_ms(SB, frac * capacity, capacity)
            ex.set_max_delay_ms(delay)
            s0 = ex.stats()
            row = bench_executor.run_open_loop(ex, reqs, frac * capacity, delay, gt=gt_reqs,
                                               k=K)
            s1 = ex.stats()
            row.update(load=frac, max_delay_ms=round(delay, 2),
                       underfull=s1["underfull_launches"] - s0["underfull_launches"],
                       batches=s1["batches_dispatched"] - s0["batches_dispatched"])
            curve.append(row)
    phase("serving", t0, f"open loop, {OPEN_N} requests a load (max_delay_ms from "
          f"auto_max_delay_ms), each with its served recall@{K}: {curve}")
    del ds, direct_ids, reqs, gt_reqs

    # ---- phases 10f-10j: the harnesses ported last, on the setup's index.
    # The dataset harnesses load "sift" and its index through
    # build_or_load_index: its first call builds and caches the index of
    # the setup's configuration, which must be the setup's own.
    from rag_on_edge_tpu_torch.harness import (profile_ivf, profile_sharded, qcap_calib,
                                               recover_sweep, relay_probe, serve_hunt)
    from rag_on_edge_tpu_torch.harness.bench_ivf import build_or_load_index
    from rag_on_edge_tpu_torch.runtime import oracle

    t = time.time()
    cached = build_or_load_index(load_dataset("sift", gt_k=K, device=dev), nlist=None,
                                 metric="l2", dtype="int8", pad_block=PAD_BLOCK, device=dev)
    if not (np.array_equal(cached._centroids_np, idx._centroids_np)
            and np.array_equal(cached._offsets_np, idx._offsets_np)):
        raise AssertionError("build_or_load_index('sift') is not the setup's index")
    phase("profile", t0, f"build_or_load_index('sift') {time.time() - t:.1f}s: the setup's "
          f"index, cached for the harnesses")
    del cached
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_harness"
    if out_dir.exists():
        for f in out_dir.iterdir():
            f.unlink()

    def launched():
        return {key: n for key, n in read_launches().items() if n}

    def need(what, got, kernels):
        missing = [kx for kx in kernels if got.get(kx, 0) < 1]
        if missing:
            raise AssertionError(f"{what} launched {got}: no {missing}")

    # ---- phase 10f (profile): profile_ivf's cumulative prefixes at B=8192 for
    # the grouped engine and the default accum engine (the +kernel prefix is
    # K4 either way), and profile_sharded's stages over [cuda:0] * 4, auto
    # (K1, K2) and pallas (K6), counters reset just before each and read
    # just after; each full prefix must return the public call's ids.
    qcap = idx._auto_qcap(BATCH, NPROBE)
    prof = {}
    for engine, kernels in (("pallas", ["K4"]), ("pallas_accum", ["K4", "K1", "K2"])):
        reset_launches()
        t = time.time()
        rows_ = profile_ivf.profile(idx, queries[:BATCH], K, NPROBE, engine=engine)
        torch.cuda.synchronize()
        prof[f"profile_ivf {engine}"] = dict(rows=rows_, launches=launched(),
                                             wall_s=round(time.time() - t, 1))
        need(f"profile_ivf engine={engine}", prof[f"profile_ivf {engine}"]["launches"], kernels)
        if not all(np.isfinite(cum) and cum > 0 for _, cum, _ in rows_):
            raise AssertionError(f"profile_ivf {engine}: a prefix time is not finite: {rows_}")
        _, fns = profile_ivf._stage_fns(idx, K, NPROBE, qcap, engine=engine)
        ids_full = fns[-1](q)[1]
        ids_pub = idx.search_device(q, K, NPROBE, mode="cluster", engine=engine, recover=False)[1]
        if not torch.equal(ids_full, ids_pub):
            raise AssertionError(f"profile_ivf {engine}: the full prefix's ids differ from "
                                 "search_device's")
    sh_p = ShardedIVFIndex(idx, [dev] * 4)
    for engine, kernels in (("auto", ["K1", "K2"]), ("pallas", ["K6"])):
        reset_launches()
        t = time.time()
        rows_ = profile_sharded.profile(sh_p, queries[:BATCH], K, NPROBE, engine=engine)
        torch.cuda.synchronize()
        prof[f"profile_sharded {engine}"] = dict(rows=rows_, launches=launched(),
                                                 wall_s=round(time.time() - t, 1))
        need(f"profile_sharded engine={engine}", prof[f"profile_sharded {engine}"]["launches"],
             kernels)
        if not all(np.isfinite(cum) and cum > 0 for _, cum, _ in rows_):
            raise AssertionError(f"profile_sharded {engine}: a stage time is not finite: {rows_}")
        resolved = "pallas_accum" if engine == "auto" else engine
        ids_full = sh_p._search_cluster(q, K, NPROBE, qcap, 0, 0, 1, resolved, "full")[1]
        ids_pub = sh_p.search_device(q, K, NPROBE, mode="cluster", recover=False,
                                     engine=resolved)[1]
        if not torch.equal(ids_full, ids_pub):
            raise AssertionError(f"profile_sharded {engine}: the full stage's ids differ from "
                                 "search_device's")
    del sh_p
    for name, r in prof.items():
        phase("profile", t0, f"{name} B={BATCH} nprobe {NPROBE} k {K} qcap {qcap} on {card} "
              f"(prefix, cumulative ms, stage ms; host clock over 6 distinct batches): "
              f"{[(n, round(c, 4), round(d, 4)) for n, c, d in r['rows']]}; launches "
              f"{r['launches']}; {r['wall_s']}s")

    # ---- phase 10g (oracle): the native CPU oracle over 1,000 queries x 1M
    # against the card's exact ground truth (K3 fp32 by the 2 GiB rule):
    # the exact fp64 scores of each row's returned ids equal, sorted, within
    # rtol 1e-4 (ties may pick other ids).
    ORACLE_Q = 1000
    t = time.time()
    lib_path = oracle.build_library()
    oracle_build_s = time.time() - t
    if not oracle.native_available():
        raise AssertionError(f"the native oracle did not build ({lib_path})")
    t = time.time()
    o_ids, o_scores = oracle.oracle_search(queries[:ORACLE_Q], base, K, metric="l2")
    oracle_s = time.time() - t
    reset_launches()
    t = time.time()
    gt_o = ground_truth(base, queries[:ORACLE_Q], K, metric="l2", device=dev)
    torch.cuda.synchronize()
    k3_gt_s = time.time() - t
    gt_o_launches = launched()
    need("the oracle's K3 ground truth", gt_o_launches, ["K3"])
    q64 = queries[:ORACLE_Q].astype(np.float64)[:, None, :]

    def exact(ids):
        return np.sort(-((base[ids].astype(np.float64) - q64) ** 2).sum(-1), axis=1)

    oracle_err = float(np.max(np.abs(exact(o_ids) - exact(gt_o))
                              / np.maximum(np.abs(exact(gt_o)), 1.0)))
    ids_equal = int((o_ids == gt_o).all(axis=1).sum())
    phase("oracle", t0, f"native oracle (g++ {oracle_build_s:.1f}s, {lib_path}) over "
          f"{ORACLE_Q} queries x {N_BASE}, k {K}, L2: {oracle_s:.3f}s on the host's "
          f"{os.cpu_count()} cores; the card's exact ground truth (K3 fp32, launches "
          f"{gt_o_launches}) {k3_gt_s:.3f}s on {card}; ids equal on {ids_equal} of {ORACLE_Q} "
          f"rows, max relative score error of the returned ids {oracle_err:.3g}")
    if oracle_err > 1e-4:
        raise AssertionError(f"the oracle's scores differ from the card's ground truth by "
                             f"{oracle_err} (rtol 1e-4)")
    del o_ids, o_scores, gt_o, q64

    # ---- phase 10h (relay): the transfer terms (pageable device -> host
    # copies, as jax.device_get), the serialized serving cycle at B=16384
    # unpacked and packed (the executor's pack), and relay_cycle_probe.
    fetch = relay_probe.probe_fetch(rounds=5, device=dev)
    reset_launches()
    cycle = relay_probe.probe_cycle(batch=16384, nprobe=NPROBE, k=K, rounds=5, dataset="sift",
                                    device=dev)
    cycle_launches = launched()
    need("probe_cycle", cycle_launches, ["K1"])
    wd = bench_executor._wire_dtype(queries, "auto")
    reset_launches()
    relay_ms = bench_executor.relay_cycle_probe(
        lambda qx: idx.search_device(qx, K, NPROBE, mode="cluster", recover_passes=1), DIM,
        16384, wire_dtype=wd, device=dev)
    relay_launches = launched()
    need("relay_cycle_probe", relay_launches, ["K1"])
    terms = {**fetch, **cycle, "relay_cycle_probe_ms": relay_ms}
    if not all(np.isfinite(v) for v in terms.values()) or min(
            cycle["cycle_packed_ms"], cycle["cycle_unpacked_ms"], relay_ms) <= 0:
        raise AssertionError(f"a relay term is not a positive finite time: {terms}")
    phase("relay", t0, f"transfer terms on {card} (host clock ms, pageable copies): {fetch}; "
          f"cycle B=16384: {cycle} (launches {cycle_launches}); relay_cycle_probe B=16384 "
          f"wire {np.dtype(wd)}: {relay_ms} ms (launches {relay_launches})")

    # ---- phase 10i (hunt): serve_hunt with no wait at B=2048: one probe,
    # one saturated run of dataset "sift", no error in the record.
    reset_launches()
    t = time.time()
    if serve_hunt.main(["--dataset", "sift", "--batch", "2048", "--nprobe", str(NPROBE),
                        "--max-wait-s", "0", "--outdir", str(out_dir)]) != 0:
        raise AssertionError("serve_hunt exited non-zero")
    hunt_launches = launched()
    (hunt_file,) = out_dir.glob("serving_hunt_*.json")
    rec = json.loads(hunt_file.read_text())
    if (len(rec["probes"]) != 1 or len(rec["runs"]) != 1
            or any("error" in e for e in rec["probes"] + rec["runs"])):
        raise AssertionError(f"the hunt's record is not one probe and one run without error: "
                             f"{rec}")
    need("serve_hunt", hunt_launches, ["K1"])
    run_h = rec["runs"][0]
    phase("hunt", t0, f"serve_hunt B=2048 nprobe {NPROBE} (131072 requests, window 75 ms) on "
          f"{card}, {time.time() - t:.1f}s: probe cycle {rec['probes'][0]['cycle_ms']} ms; run "
          f"trigger {run_h['trigger']}, dataset {run_h['dataset']}, QPS "
          f"{run_h['qps_end_to_end']}, recall@{K} {run_h['recall']}, latency ms "
          f"{run_h['latency_ms']}, pipeline {run_h['pipeline']}; launches {hunt_launches}")
    if run_h["dataset"] != "sift" or run_h["recall"] < 0.99:
        raise AssertionError(f"the hunt's run served {run_h['dataset']} at recall "
                             f"{run_h['recall']}")

    # ---- phase 10j (recover): qcap_calib at nprobe 4, 8 and 16, and
    # recover_sweep at nprobe 4 with one swept shape (recover_qcap 256, one
    # pass), counted: the auto row drops no pair and keeps the off row's
    # recall or more.
    qcap_calib.main(["--dataset", "sift", "--nlist", str(NLIST), "--nprobe", "4", "8", "16",
                     "--batch", str(BATCH), "--pad-block", str(PAD_BLOCK), "--json",
                     "--outdir", str(out_dir)])
    (calib_file,) = out_dir.glob("qcap_calib_*.json")
    calib = json.loads(calib_file.read_text())
    reset_launches()
    t = time.time()
    recover_sweep.main(["--dataset", "sift", "--nlist", str(NLIST), "--spill-eps", "0",
                        "--pad-block", str(PAD_BLOCK), "--store", "padded", "--batch", str(BATCH),
                        "--k", str(K), "--nprobe", str(NPROBE), "--recover-qcap", "256",
                        "--recover-passes", "1", "--json", "--outdir", str(out_dir)])
    sweep_launches = launched()
    (sweep_file,) = out_dir.glob("recover_sweep_*.json")
    rs = json.loads(sweep_file.read_text())["rows"]
    phase("recover", t0, f"qcap_calib (B={BATCH}) on {card}: {calib}; recover_sweep "
          f"(nprobe {NPROBE}, 10,000 queries) {time.time() - t:.1f}s: {rs}; launches "
          f"{sweep_launches}")
    need("recover_sweep", sweep_launches, ["K1", "K4", "K2"])
    off, auto = rs[0], rs[1]
    if auto["spill_total"] != 0 or auto["recall"] < off["recall"]:
        raise AssertionError(f"recover_sweep: the auto row dropped pairs or lost recall to the "
                             f"off row: {auto} vs {off}")

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
    t = time.time()
    pc = ProbeChecks(torch, hw_probe, dev, 12)
    prand, pgen, x1 = pc.rand, pc.gen, pc.x1
    ntrials, f10 = pc.ragged()
    phase("probe", t0, f"F10, equal to the plain versions (value and every step): {f10}")
    phase("probe", t0, f"K11-K14 equal to their plain versions at ragged shapes (K11 g 3 and "
          f"300; K12 [9,36,301] and, with the product, [9,36,300] x [100,36], [9,36,128] x "
          f"[1,36] and [9,36,2052] x [65,36], fat 3, planted step maxima, value and every "
          f"step; K13 [11,24,40] at depth 3 and 8 and bf16 [70,128,2048] (the ring wraps) at "
          f"depth 3 and 8, {ntrials} planted trials; K14 (tb, tn, d, g) {pc.K14_SHAPES} (d 0: "
          f"the 512-byte cap) on wgmma and dp4a, sel, value and every step), max |err| "
          f"{pc.errs} ({time.time() - t:.1f}s)")

    # One JAX size each, timed beside the plain version (and data.amax()):
    # device time of REPS calls captured in one CUDA graph, since the
    # Python wrapper's host time exceeds K11's device time.
    t = time.time()

    def gms(fn):
        return timing.graph_ms(fn, dev, calls=REPS)

    pc.check("K11", "g=4096 moving", hw_probe._step_probe(x1, 4096, True, None),
             hw_probe._step_probe_reference(x1, 4096, True, None))
    # The timed call writes the moving input (16 MB, as the JAX broadcast
    # does) and the kernel reads it: its bound counts both.  The kernel's own
    # device time stands beside it; the HBM bound of its read alone does not
    # hold it, since it reads the L2 the write just filled.
    k11_by_kernel = device_ms_by_kernel(
        torch, lambda: hw_probe._step_probe(x1, 4096, True, None), calls=REPS)
    if isinstance(k11_by_kernel, str):
        k11_kernel_ms = None
    else:
        k11_kernel_ms = sum(ms for name, ms in k11_by_kernel.items()
                            if "step_grid_kernel" in name)
        if not k11_kernel_ms:
            raise AssertionError(f"torch.profiler saw no step_grid_kernel in K11's call: "
                                 f"{k11_by_kernel}")
    k11 = dict(ms=gms(lambda: hw_probe._step_probe(x1, 4096, True, None)),
               plain_ms=gms(lambda: hw_probe._step_probe_reference(
                   x1, 4096, True, None)),
               bound=bound(2 * 4096 * 4096 + 2 * 4096, 0, INT8_OPS_S),
               kernel_ms=k11_kernel_ms,
               kernel_read_hbm_ms=bound(4096 * 4096 + 4096, 0, INT8_OPS_S)[0],
               by_kernel=k11_by_kernel)
    D128, BLK2 = 128, 2048
    walk, tops = hw_probe._planted_walk((512 << 20) // (D128 * BLK2), D128, BLK2, 1, torch.int8,
                                        pgen)
    xw = prand((128, D128), torch.int8)
    k12 = {}
    for gemm in (False, True):
        pc.k12(f"int8 512 MB blk={BLK2}", xw, walk, BLK2, 1, gemm, tops,
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
    # The same 512 MB through the bf16 product ([1024,128,2048]).
    walk, tops = hw_probe._planted_walk((512 << 20) // (D128 * BLK2 * 2), D128, BLK2, 1,
                                        torch.bfloat16, pgen)
    xw = prand((128, D128), torch.bfloat16)
    pc.k12(f"bf16 512 MB blk={BLK2}", xw, walk, BLK2, 1, True, tops, (None, "arbitrary"))
    k12["bf16"] = dict(
        ms=gms(lambda: hw_probe._stream_probe(xw, walk, BLK2, 1, True, None)),
        plain_ms=gms(lambda: hw_probe._stream_probe_reference(xw, walk, BLK2, 1, True, None)),
        bound=bound(walk.numel() * 2 + walk.shape[0] * 4, 2.0 * 128 * walk.numel(),
                    BF16_OPS_S))
    del walk, tops, xw
    torch.cuda.empty_cache()
    walk = prand(((2 << 30) // (D128 * BLK2), D128, BLK2), torch.int8)
    k13_n = pc.k13("int8 2 GiB", walk, 8, 127, 127, 16)
    k13 = dict(ms=gms(lambda: hw_probe._dma_probe(x1, walk, 8)),
               plain_ms=gms(lambda: hw_probe._dma_probe_reference(x1, walk, 8)),
               lib_ms=gms(lambda: walk.amax()),
               bound=bound(walk.numel() + 4, 0, INT8_OPS_S))
    del walk
    torch.cuda.empty_cache()
    TB, TN, G = 256, 2048, 2048
    k14 = {}
    for dtype, unit, rate in ((torch.int8, "mma", INT8_OPS_S), (torch.int8, "dp4a", DP4A_OPS_S),
                              (torch.bfloat16, "mma", BF16_OPS_S)):
        q_, v_ = prand((TB, D128), dtype), prand((D128, TN), dtype)
        tol = pc.k14_tol(q_, v_, G)
        pc.check("K14", f"{dtype} {unit} ({TB}, {TN}) g={G} steps",
                 hw_probe._gemm_rate_steps(q_, v_, G, TB, TN, False, unit),
                 hw_probe._gemm_rate_steps_reference(q_, v_, G, TB, TN, False, unit), tol)
        pc.check("K14", f"{dtype} {unit} ({TB}, {TN}) g={G}",
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
          f"{k12[False]}, with the product {k12[True]}, bf16 with the product "
          f"{k12['bf16']}; K13 int8 2 GiB depth 8 {k13}; K14 "
          f"({TB}, {TN}) g={G} {k14} (the dp4a bound at {DP4A_OPS_S / 1e12:.1f} T ops/s)")

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
    # F12: every card after the first, a line each (the counts and errors
    # above stay the main path's, on this card).
    if torch.cuda.device_count() > 1:
        probe_other_cards(torch, hw_probe, t0)
    else:
        phase("probe", t0, "other cards: not run (torch.cuda.device_count() is 1)")
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
    # K1's wgmma modes at 65 routed rows (one into the second warpgroup)
    # and D 33 (one past a k32 step), int8 also with its bias rows.
    bias_r = torch.randint(-2**29, 2**29, (len(rtabs[0]), 1, PAD_BLOCK), generator=fgen,
                           device=dev, dtype=torch.int32)
    for mode, dt, br in (("int8", torch.int8, None), ("int8-L2", torch.int8, bias_r),
                         ("bf16", torch.bfloat16, None)):
        qg_r, vt_r = fint((len(rtabs[0]), 65, 33), dt), fint((len(rtabs[0]), 33, PAD_BLOCK), dt)
        got = ivf_accum.cluster_major_accum_planes(qg_r, vt_r, *rtabs, blk=PAD_BLOCK,
                                                   bias_rows=br)
        want = ivf_accum.cluster_major_accum_planes_reference(qg_r, vt_r, *rtabs, blk=PAD_BLOCK,
                                                              bias_rows=br)
        ragged[f"K1 {mode} qcap 65 D 33"] = torch.equal(got[rrows], want[rrows])
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
    # K1 bf16 on the ragged tables: 40 routed rows, D' 129.
    qg_n = torch.randn((len(rtabs[0]), 40, 129), generator=ngen, device=dev).to(torch.bfloat16)
    vt_n = torch.randn((len(rtabs[0]), 129, PAD_BLOCK), generator=ngen,
                       device=dev).to(torch.bfloat16)
    order1 = 2.0 * 129 * 2.0**-24 * float(torch.bmm(qg_n.double().abs(),
                                                     vt_n.double().abs()).max())
    got = ivf_accum.cluster_major_accum_planes(qg_n, vt_n, *rtabs, blk=PAD_BLOCK)
    want = ivf_accum.cluster_major_accum_planes_reference(qg_n, vt_n, *rtabs, blk=PAD_BLOCK)
    nonint["K1 bf16"] = planes_close(ivf_accum, got[rrows], want[rrows], order1)
    del qg_n, vt_n, got, want
    torch.cuda.synchronize()
    phase("float", t0, f"non-integer data, within the order bound (ok, max |err|): {nonint}")
    if not all(ok for ok, _ in nonint.values()):
        raise AssertionError(f"a bf16 mode leaves the order bound: {nonint}")
    del q_n, b_n, tiles_n, v, i, rv, ri

    fl = {}  # "K1 fp32" ... → err, ms, plain_ms, bound, launches, lib_ms

    def float_ivf(index, mode):
        """K1 and K4 of a float index against their plain versions on the
        first routed B=8192 batch (K4 at the batch's recovery list and at
        the dense walk, beside torch.bmm of the dense product), then the
        default call over all queries, counted, its recall and stages, and
        engine="pallas" over all queries, counted, against
        engine="pallas_routed"."""
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
        walked_f, cols_f = walked_blocks(np, *args[2:])
        fl[f"K1 {mode}"] = dict(
            err=err, ms=cuda_ms(torch, lambda: ivf_accum.cluster_major_accum_planes(
                *args, blk=PAD_BLOCK)),
            plain_ms=cuda_ms(torch, lambda: ivf_accum.cluster_major_accum_planes_reference(
                *args, blk=PAD_BLOCK), reps=3),
            bound=bound((walked_f * qcap_f + cols_f) * dp * es + rows_f.numel()
                        * pp_f[0].numel() * 4, 2.0 * qcap_f * cols_f * dp, rate),
            lib_ms=None)
        fl[f"K1 {mode}"]["prod_ms"] = prod_ms(torch, qb_f, vt)
        if mode == "bf16":
            # The routed rows' pad to TMA's 16-byte pitch (D' 129 -> 136), inside ms.
            fl["K1 bf16"]["pad_ms"] = cuda_ms(torch, lambda: ivf_accum.kernel_operands(qb_f))
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
        walked4, cols4 = walked_blocks(np, *rec[2:5])
        fl[f"K4 {mode}"] = dict(
            err=float((pv[r4][fin] - rpv[r4][fin]).abs().max()) if fin.any() else 0.0,
            ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_grouped(*rec[:5], **kw)),
            plain_ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_grouped_reference(
                *rec[:5], **kw), reps=3),
            bound=bound((walked4 * qcap_f + cols4) * dp * es + r4.numel() * qcap_f * kk * 8,
                        2.0 * dp * timing.live_products(timing.live_rows(rec[0]), *rec[2:5]),
                        rate),
            lib_ms=None)
        phase("float", t0, f"K4 {mode} recovery list qg {tuple(rec[0].shape)} ({int(lossy_f.sum())} "
              f"lossy pairs, {walked4} blocks walked): pv bit-equal, pr equal where finite "
              f"({int(fin.sum())} finite entries); {fl[f'K4 {mode}']}")
        del pv, pr, rpv, rpr, rec
        # K4 at the dense walk, on the table engine="pallas" builds (at the
        # 16-byte row pitch, read in place); dense_copy_ms: the same call on
        # K1's contiguous table, which the wrapper copies to the pitch.
        qb_p = index._scan_inputs(q, cq_f, pitched=True)[1]
        dense = (qb_p, *args[1:])
        kw_d = dict(k=kk, blk=PAD_BLOCK, group=index.CM_GROUP)
        pv, pr = ivf_scan.cluster_major_scan_grouped(*dense, **kw_d)
        rpv, rpr = ivf_scan.cluster_major_scan_grouped_reference(*dense, **kw_d)
        torch.cuda.synchronize()
        fin = rpv[rows_f] > float("-inf")
        if not bool(fin.any()) or not bits_equal(pv[rows_f], rpv[rows_f]) \
                or not torch.equal(pr[rows_f][fin], rpr[rows_f][fin]):
            raise AssertionError(f"K4 {mode} differs from the plain version at the dense walk")
        fl[f"K4 {mode}"].update(
            kernel=K67_KERNEL[mode],
            dense_err=float((pv[rows_f][fin] - rpv[rows_f][fin]).abs().max()),
            dense_ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_grouped(*dense, **kw_d)),
            dense_copy_ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_grouped(
                qb_f, *dense[1:], **kw_d)),
            dense_plain_ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_grouped_reference(
                *dense, **kw_d), reps=3),
            dense_bound_ms=bound((walked_f * qcap_f + cols_f) * dp * es
                                 + rows_f.numel() * qcap_f * kk * 8,
                                 2.0 * dp * timing.live_products(timing.live_rows(qb_f),
                                                                 *args[2:]), rate)[0],
            prod_ms=fl[f"K1 {mode}"]["prod_ms"])
        phase("float", t0, f"K4 {mode} dense walk qg {tuple(qb_p.shape)} (pitch "
              f"{qb_p.stride(1)}): pv bit-equal, pr equal where finite ({int(fin.sum())} finite "
              f"entries, {walked_f} blocks walked); ms {fl[f'K4 {mode}']['dense_ms']} (on the "
              f"contiguous table {fl[f'K4 {mode}']['dense_copy_ms']}), plain "
              f"{fl[f'K4 {mode}']['dense_plain_ms']}, bound {fl[f'K4 {mode}']['dense_bound_ms']}, "
              f"torch.bmm of the product alone {fl[f'K4 {mode}']['prod_ms']} on {card}")
        del pv, pr, rpv, rpr, qb_p, dense
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
        # engine="pallas" (K4 over the dense walk and in the recovery pass),
        # counted, against engine="pallas_routed" (K7): the same function.
        reset_launches()
        ids_g, scores_g, residual_g, wall_g = search_all(index, engine="pallas")
        launch_g = read_launches()
        ids_r, scores_r, residual_r, _ = search_all(index, engine="pallas_routed")
        r10_g, r1_g = recalls(ids_g)
        n_batch = -(-N_QUERIES // BATCH)
        k4_expected = n_batch * (1 + (rp if index._auto_recover(BATCH, NPROBE) else 0))
        same = np.array_equal(ids_g, ids_r) and scores_g.tobytes() == scores_r.tobytes()
        fl[f"K4 {mode}"]["pallas_launches"] = launch_g["K4"]
        pallas_ms = cuda_ms(torch, lambda: index.search_device(qs, K, NPROBE, engine="pallas"))
        phase("float", t0, f"{mode} IVFIndex search_device(q, {K}, {NPROBE}, engine='pallas') "
              f"{N_QUERIES} queries {wall_g:.1f}s: residual last_spill={residual_g} launches="
              f"{launch_g} (K4 expected {k4_expected}) recall@10={r10_g:.4f} recall@1={r1_g:.4f}; "
              f"ids and scores equal to engine=pallas_routed on every query: {same}; one "
              f"B={BATCH} call {pallas_ms} ms on {card}")
        if launch_g["K4"] != k4_expected or launch_g["K1"] or launch_g["K7"]:
            raise AssertionError(f"{mode} engine=pallas launches {launch_g}")
        if not same or any(residual_g) or any(residual_r) or r10_g < 0.99:
            raise AssertionError(f"{mode} engine=pallas: equal to pallas_routed {same}, residual "
                                 f"{residual_g} {residual_r}, recall@10 {r10_g}")
        del ids_g, scores_g, ids_r, scores_r
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
            walked, cols = walked_blocks(np, bf_, bl_, rv_)
            k7[name] = dict(
                err=err, ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_routed(*args, **kw)),
                plain_ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_routed_reference(
                    *args, **kw), reps=3),
                bound=bound(walked * qcap_f * 4 + cols * dp * es + qi_f.numel() * es
                            + r7.numel() * qcap_f * kk * 8,
                            2.0 * dp * timing.live_products(
                                ((cqb_ >= 0) & (cqb_ < qi_f.shape[0])).sum((1, 2)), bf_, bl_,
                                rv_), rate), lib_ms=None)
            if name == "dense":  # the per-block product alone, torch.bmm (K1's yardstick)
                k7[name]["prod_ms"] = prod_ms(torch, index._scan_inputs(q, cq_f)[1], vt)
            phase("floatscan", t0, f"K7 {mode} {name}: qi {tuple(qi_f.shape)} cq_blocks "
                  f"{tuple(cqb_.shape)} vectors_t {tuple(vt_.shape)} k={kk}: pv bit-equal, pr "
                  f"equal where finite, on {r7.numel()} last blocks ({walked} walked); {k7[name]}")
        del k7_in
        fl14[f"K7 {mode}"] = dict(k7["dense"], recovery_ms=k7["recovery"]["ms"],
                                  recovery_bound_ms=k7["recovery"]["bound"][0],
                                  kernel=K67_KERNEL[mode])

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
        walked9, cols9 = walked_blocks(np, *tabs)
        fl14[f"K9 {mode}"] = dict(
            err=max_err(pv[rows9], rpv[rows9]), launches=n9, lib_ms=None,
            ms=cuda_ms(torch, lambda: ivf_accum.cluster_major_accum(*args9, blk=PAD_BLOCK)),
            plain_ms=cuda_ms(torch, lambda: ivf_accum.cluster_major_accum_reference(
                *args9, blk=PAD_BLOCK), reps=3),
            bound=bound((walked9 * qcap_f + cols9) * dp * es + rows9.numel() * qcap_f * kk * 8,
                        2.0 * qcap_f * cols9 * dp, rate))
        del pv, pr, rpv, rpr, qb_f, args9
        phase("floatscan", t0, f"K9 {mode} (K1's shapes, k={kk}, bin2): pv (the masked key) "
              f"bit-equal and pr equal on {rows9.numel()} last blocks; {fl14[f'K9 {mode}']}; "
              f"the parent design's {K9_PARENT_MS[mode]} ms (PERF.md section 6, this script on "
              f"the same card model)")

        # K10: the lab's defaults on the lab's float routed table (same
        # shuffle, IP probes, qcap 128; the index's own query prep, the ones
        # column of L2), written at the 16-byte row pitch and read in place.
        qg_l = kernel_lab.routed_table(index, queries, LAB_BATCH, NPROBE, LAB_QCAP)
        if _build.pitched_storage(qg_l)[0].data_ptr() != qg_l.data_ptr():
            raise AssertionError(f"the lab's {mode} routed table is not at the 16-byte pitch")
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
        _, cols10 = walked_blocks(np, *tabs)
        ops10 = 2.0 * dp * timing.live_products(
            timing.live_rows(qg_l)[fa["block_cluster"].long()], *tabs)
        bounds10 = {v: bound(cols10 * dp * es + k10_windows(v, fa["block_cluster"],
                                                              fa["block_last"]).numel()
                             * LAB_QCAP * (dp * es + LAB_K * 8), ops10, rate)
                    for v in kernel_lab.VARIANTS}
        fl14[f"K10 {mode}"] = dict(
            err=err10, ms=lab_f["full"][0], plain_ms=plain10, launches=n10, lib_ms=None,
            bound=bounds10["full"], kernel=K67_KERNEL[mode],
            variants={v: {"ms": lab_f[v][0], "bound_ms": bounds10[v][0],
                          "bound_by": bounds10[v][1]} for v in kernel_lab.VARIANTS})
        phase("floatscan", t0, f"K10 {mode} qg {tuple(qg_l.shape)}: the four variants equal "
              f"to their plain versions on their windows, full equal to K6; lab ms/call and "
              f"us/block {lab_f}; launches {n10}; {fl14[f'K10 {mode}']}")
        if n10 != len(kernel_lab.VARIANTS) * (REPS + 2):
            raise AssertionError(f"the {mode} lab launched K10 {n10} times")
        del qg_l

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
            walked, cols = walked_blocks(np, *args[3:6])
            k6[name] = dict(
                err=err, ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan(*args, **kw)),
                plain_ms=cuda_ms(torch, lambda: ivf_scan.cluster_major_scan_reference(
                    *args, **kw), reps=3), lib_ms=None,
                bound=bound((walked * qcap_f + cols) * dp * es + r6.numel() * qcap_f * kk * 8,
                            2.0 * dp * timing.live_products(
                                timing.live_rows(args[0])[args[2].long()], *args[3:6]), rate))
            if name == "dense":  # the per-block product alone, torch.bmm
                k6[name]["prod_ms"] = prod_ms(torch, args[0][args[2].long()].contiguous(),
                                              args[1])
            phase("floatscan", t0, f"K6 {mode} {name} (shard {0 if name == 'dense' else s_rec}):"
                  f" qg {tuple(args[0].shape)} vectors_t {tuple(args[1].shape)} k={kk}: pv "
                  f"bit-equal, pr equal where finite, on {r6.numel()} emitted clusters "
                  f"({walked} blocks walked); {k6[name]}")
        del r, rec_scan, k6_in
        fl14[f"K6 {mode}"] = dict(k6["recovery"], dense_ms=k6["dense"]["ms"],
                                  dense_bound_ms=k6["dense"]["bound"][0],
                                  prod_ms=k6["dense"]["prod_ms"], kernel=K67_KERNEL[mode])
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

    # ---- phase 15: sentence-embedding widths, past the kernels' old D caps
    # (D = 384, all-MiniLM-L6-v2; 768, BERT-base) on synthetic corpora:
    # BruteForceIndex(base) with every default (ip, bf16, accum: K5), and
    # the fp32 and bf16 IVFIndex (K1, the recovery pass's K4) at nprobe 16;
    # then K2 at W = 32768, past the row one warp holds.
    WIDE_N, WIDE_Q, WIDE_NLIST, WIDE_NPROBE = 200_000, 1024, 256, 16
    widedim = {}
    for dw in (384, 768):
        t = time.time()
        base_w, queries_w = make_synthetic(WIDE_N, WIDE_Q, dw, 256, seed=43)
        qw = torch.from_numpy(queries_w).to(dev)
        gt_w = {m: ground_truth(base_w, queries_w, K, metric=m, device=dev) for m in ("ip", "l2")}
        reset_launches()
        bfw = BruteForceIndex(base_w, device=dev)
        vals_w, ids_w = bfw.search_device(qw, K)
        torch.cuda.synchronize()
        res = {"brute": dict(engine=bfw.engine, dtype=bfw.dtype, launches=read_launches()["K5"],
                             finite=bool(torch.isfinite(vals_w).all()),
                             recall=recall_at_k(ids_w.cpu().numpy(), gt_w["ip"], K),
                             ms=cuda_ms(torch, lambda: bfw.search_device(qw, K), reps=3))}
        del bfw
        if dw == 384:
            # fp32 brute force through K3 at k = 300, past one launch's 256:
            # two passes a call, ids against the plain ground truth.
            gt_300 = ground_truth(base_w, queries_w, K3_WIDE_K, metric="l2", device=dev)
            bf3 = BruteForceIndex(base_w, metric="l2", dtype="fp32", engine="pallas", device=dev)
            reset_launches()
            vals_w, ids_w = bf3.search_device(qw, K3_WIDE_K)
            torch.cuda.synchronize()
            res["brute fp32 pallas k=300"] = dict(
                launches=read_launches()["K3"], finite=bool(torch.isfinite(vals_w).all()),
                recall=recall_at_k(ids_w.cpu().numpy(), gt_300, K3_WIDE_K),
                ms=cuda_ms(torch, lambda: bf3.search_device(qw, K3_WIDE_K), reps=3))
            del bf3, gt_300
        ivf_w = IVFIndex.build(base_w, nlist=WIDE_NLIST, metric="l2", dtype="fp32",
                               pad_block=512, seed=42, max_iter=10, device=dev)
        for mode in ("fp32", "bf16"):
            ix = ivf_w if mode == "fp32" else IVFIndex.from_arrays(
                ivf_w._centroids_np, ivf_w._vectors_np, ivf_w._offsets_np, ivf_w._reorder_np,
                metric="l2", dtype="bf16", pad_block=512, config=dict(ivf_w.config), device=dev)
            reset_launches()
            vals_w, ids_w, _ = ix.search_device(qw, K, WIDE_NPROBE, mode="cluster", recover=True)
            torch.cuda.synchronize()
            got = read_launches()
            res[f"ivf {mode}"] = dict(
                engine=ix.last_engine, launches={"K1": got["K1"], "K4": got["K4"]},
                spill=int(ix.last_spill), finite=bool(torch.isfinite(vals_w).all()),
                recall=recall_at_k(ids_w.cpu().numpy(), gt_w["l2"], K),
                ms=cuda_ms(torch, lambda: ix.search_device(qw, K, WIDE_NPROBE, mode="cluster",
                                                           recover=True), reps=3))
            del ix
        del ivf_w, base_w, queries_w, qw
        torch.cuda.empty_cache()
        widedim[dw] = res
        phase("widedim", t0, f"D={dw}, N={WIDE_N}, {WIDE_Q} queries ({time.time() - t:.1f}s "
              f"with the builds): {res}")
        for name, r_ in res.items():
            floor = {"brute": 0.99, "brute fp32 pallas k=300": 0.999}.get(name, 0.95)
            ran = (r_["launches"] >= 1 if name == "brute" else
                   r_["launches"] >= 2 if name.startswith("brute fp32") else
                   min(r_["launches"].values()) >= 1)
            if not (ran and r_["finite"] and r_["recall"] >= floor):
                raise AssertionError(f"D={dw} {name}: {r_} (recall floor {floor})")
    # int8 L2 IVF at D 3072 (OpenAI text-embedding-3-large's width): past
    # K1's key caps, so engine="auto" takes K4 over every block, whose
    # routed rows no longer stay in shared memory: each unit's rows are
    # gathered beside its transpose.
    t = time.time()
    base_w, queries_w = make_synthetic(WIDE_N, WIDE_Q, 3072, 256, seed=44)
    qw = torch.from_numpy(queries_w).to(dev)
    gt_w = ground_truth(base_w, queries_w, K, metric="l2", device=dev)
    ivf_w = IVFIndex.build(base_w, nlist=WIDE_NLIST, metric="l2", dtype="int8", pad_block=512,
                           seed=42, max_iter=10, device=dev)
    del base_w
    reset_launches()
    vals_w, ids_w, _ = ivf_w.search_device(qw, K, WIDE_NPROBE)
    torch.cuda.synchronize()
    got = read_launches()
    d3072 = dict(engine=ivf_w.last_engine, launches={"K1": got["K1"], "K4": got["K4"]},
                 spill=int(ivf_w.last_spill), finite=bool(torch.isfinite(vals_w).all()),
                 recall=recall_at_k(ids_w.cpu().numpy(), gt_w, K),
                 ms=cuda_ms(torch, lambda: ivf_w.search_device(qw, K, WIDE_NPROBE), reps=3))
    del ivf_w, queries_w, qw, vals_w, ids_w
    torch.cuda.empty_cache()
    phase("widedim", t0, f"int8 L2 IVFIndex D=3072, N={WIDE_N}, nlist={WIDE_NLIST}, "
          f"search_device(q, {K}, {WIDE_NPROBE}) defaults over {WIDE_Q} queries "
          f"({time.time() - t:.1f}s with the build): {d3072}")
    if not (d3072["engine"] == "pallas" and d3072["launches"]["K4"] >= 1 and d3072["finite"]
            and d3072["recall"] >= 0.95):
        raise AssertionError(f"int8 IVF at D=3072: {d3072}")
    xw = torch.randint(0, 64, (BATCH, 32768), generator=torch.Generator(device=dev).manual_seed(17),
                       device=dev, dtype=torch.int32)  # ties across both segment edges
    xw[::13] = ivf_accum.KMIN
    reset_launches()
    vw, iw = fused_topk.fused_topk(xw, kk)
    k2_w_launches = read_launches()["K2"]
    rvw, riw = fused_topk.fused_topk_reference(xw, kk)
    torch.cuda.synchronize()
    if not torch.equal(vw, rvw) or not torch.equal(iw, riw) or k2_w_launches != 3:
        raise AssertionError(f"K2 at W=32768 differs from its plain version or took "
                             f"{k2_w_launches} launches")
    k2_wide = dict(
        ms=cuda_ms(torch, lambda: fused_topk.fused_topk(xw, kk)),
        plain_ms=cuda_ms(torch, lambda: fused_topk.fused_topk_reference(xw, kk), reps=3),
        lib_ms=cuda_ms(torch, lambda: torch.topk(xw, kk, dim=1)),
        bound=bound(xw.numel() * 4 + BATCH * kk * 8, kk * xw.numel(), OPS32_S))
    phase("widedim", t0, f"K2 [{BATCH}, 32768] int32 k={kk}: equal to its plain version in "
          f"{k2_w_launches} launches (two segments, one merge); ms, plain ms, torch.topk ms and "
          f"bound: {k2_wide}")
    del xw, vw, iw, rvw, riw

    kernels = [
        {"name": "cluster_major_accum_planes", "mode": "int8", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/ivf_accum_planes.cu",
         "replaces": "rag_on_edge_tpu/ops/pallas_ivf_dma.py:371",
         "launches": launches["K1"], "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": None, "prod_ms": k1_prod_ms},
        {"name": "fused_topk", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/fused_topk.cu",
         "replaces": "rag_on_edge_tpu/ops/pallas_topk.py:39",
         "launches": launches["K2"], "max_abs_err": k2_err, "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound"][0], "bound_by": k2["bound"][1],
         "library_ms": k2["lib_ms"], "device_ms": k2["device_ms"],
         "by_width": {w: {key: r[key] for key in ("ms", "device_ms", "lib_ms", "lib_device_ms")}
                      for w, r in k2_widths.items()},
         "w32768": {key: k2_wide[key] for key in ("ms", "plain_ms", "lib_ms")}},
        {"name": "cluster_major_scan_grouped", "mode": "int8", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/ivf_grouped_scan.cu",
         "replaces": "rag_on_edge_tpu/ops/pallas_ivf.py:144",
         "launches": launches["K4"], "max_abs_err": max(k4[n]["err"] for n in k4),
         "ms": k4["recovery"]["ms"], "plain_ms": k4["recovery"]["plain_ms"],
         "bound_ms": k4["recovery"]["bound"][0], "bound_by": k4["recovery"]["bound"][1],
         "library_ms": None, "kernel": "grouped_wgmma_kernel"},
        {"name": "fused_topk_matmul", "mode": "int8", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/bruteforce_fused.cu",
         "replaces": "rag_on_edge_tpu/ops/pallas_bruteforce.py:193",
         "launches": launch_p["K3"],
         "max_abs_err": max(brute["K3 int8-L2 bin128"]["err"], brute["K3 int8-IP exact"]["err"]),
         "ms": brute["K3 int8-L2 bin128"]["ms"], "plain_ms": brute["K3 int8-L2 bin128"]["plain_ms"],
         "bound_ms": brute["K3 int8-L2 bin128"]["bound"][0],
         "bound_by": brute["K3 int8-L2 bin128"]["bound"][1], "library_ms": None,
         "f11": {name: {key: r[key] for key in ("launches", "ms", "plain_ms")} | {
             "bound_ms": r["bound"][0], "bound_by": r["bound"][1]} for name, r in f11.items()}},
        {"name": "fused_topk_accum", "mode": "int8", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/bruteforce_accum.cu",
         "replaces": "rag_on_edge_tpu/ops/pallas_bruteforce_dma.py:212",
         "launches": launch_a["K5"],
         "max_abs_err": max(brute["K5 int8-L2"]["err"], brute["K5 int8-IP"]["err"]),
         "ms": brute["K5 int8-L2"]["ms"], "plain_ms": brute["K5 int8-L2"]["plain_ms"],
         "bound_ms": brute["K5 int8-L2"]["bound"][0], "bound_by": brute["K5 int8-L2"]["bound"][1],
         "library_ms": None},
        {"name": "cluster_major_scan", "mode": "int8", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/ivf_grouped_scan.cu",
         "replaces": "rag_on_edge_tpu/ops/pallas_ivf.py:485",
         "launches": launch_s["K6"], "max_abs_err": max(k6[n]["err"] for n in k6),
         "ms": k6["recovery"]["ms"], "plain_ms": k6["recovery"]["plain_ms"],
         "bound_ms": k6["recovery"]["bound"][0], "bound_by": k6["recovery"]["bound"][1],
         "library_ms": None, "device_ms": k6["recovery"]["device_ms"],
         "dense_ms": k6["dense"]["ms"], "dense_device_ms": k6["dense"]["device_ms"],
         "dense_bound_ms": k6["dense"]["bound"][0]},
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
         "bound_ms": k10_bound[0], "bound_by": k10_bound[1], "library_ms": None,
         "kernel": "grouped_wgmma_kernel", "variants": k10_variants},
        {"name": "_step_probe", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/hw_probe.cu",
         "replaces": "rag_on_edge_tpu/harness/hw_probe.py:111",
         "launches": probe_launches["K11"], "max_abs_err": pc.errs["K11"], "ms": k11["ms"],
         "plain_ms": k11["plain_ms"], "bound_ms": k11["bound"][0], "bound_by": k11["bound"][1],
         "library_ms": None, "kernel": "step_grid_kernel", "kernel_ms": k11["kernel_ms"]},
        {"name": "_stream_probe", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/hw_probe.cu",
         "replaces": "rag_on_edge_tpu/harness/hw_probe.py:177",
         "launches": probe_launches["K12"], "max_abs_err": pc.errs["K12"],
         "ms": k12[False]["ms"], "plain_ms": k12[False]["plain_ms"],
         "bound_ms": k12[False]["bound"][0], "bound_by": k12[False]["bound"][1],
         "library_ms": k12[False]["lib_ms"],
         "product": {mode: {"kernel": "stream_wgmma_kernel", "ms": r["ms"],
                            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                            "bound_by": r["bound"][1], "library_ms": None}
                     for mode, r in (("int8", k12[True]), ("bf16", k12["bf16"]))}},
        {"name": "_dma_probe", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/hw_probe.cu",
         "replaces": "rag_on_edge_tpu/harness/hw_probe.py:273",
         "launches": probe_launches["K13"], "max_abs_err": pc.errs["K13"], "ms": k13["ms"],
         "plain_ms": k13["plain_ms"], "bound_ms": k13["bound"][0], "bound_by": k13["bound"][1],
         "library_ms": k13["lib_ms"]},
        {"name": "_gemm_rate_probe", "route": "cuda",
         "source": "rag_on_edge_tpu_torch/csrc/hw_probe.cu",
         "replaces": "rag_on_edge_tpu/harness/hw_probe.py:351",
         "launches": probe_launches["K14"], "max_abs_err": pc.errs["K14"],
         "ms": k14["int8 mma"]["ms"], "plain_ms": k14["int8 mma"]["plain_ms"],
         "bound_ms": k14["int8 mma"]["bound"][0], "bound_by": k14["int8 mma"]["bound"][1],
         "library_ms": None, "kernel": "gemm_rate_wgmma_kernel",
         "modes": {key: {"ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                         "bound_by": r["bound"][1], "library_ms": None}
                   for key, r in k14.items()}},
    ]
    # K3's fp32 mode: its launches are the whole L2 ground truth's (setup, k=10).
    kernels.append({
        "name": "fused_topk_matmul", "mode": "fp32", "route": "cuda",
        "source": "rag_on_edge_tpu_torch/csrc/bruteforce_fused.cu",
        "replaces": "rag_on_edge_tpu/ops/pallas_bruteforce.py:193", "launches": gt_launches,
        "max_abs_err": k3_f32["gt"]["err"], "ms": k3_f32["gt"]["ms"],
        "plain_ms": k3_f32["gt"]["plain_ms"], "bound_ms": k3_f32["gt"]["bound"][0],
        "bound_by": k3_f32["gt"]["bound"][1], "library_ms": None,
        "gemm_ms": k3_f32["gt"]["gemm_ms"], "k100_ms": k3_f32["gt k=100"]["ms"],
        "coarse_ms": k3_f32["coarse"]["ms"], "coarse_bound_ms": k3_f32["coarse"]["bound"][0],
        "coarse_gemm_ms": k3_f32["coarse"]["gemm_ms"]})
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
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": r["lib_ms"],
                **{x: r[x] for x in ("prod_ms", "kernel", "dense_ms", "dense_bound_ms",
                                     "dense_copy_ms", "pallas_launches", "recovery_ms",
                                     "recovery_bound_ms", "variants") if x in r}})
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
