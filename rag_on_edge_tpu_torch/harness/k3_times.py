"""Time the port's redesigned kernels on one card, at the shapes their
callers give them, beside one PyTorch call of the same product alone, the
bound, and the whole calls they serve:

    python -m rag_on_edge_tpu_torch.harness.k3_times [--kernels ffma k67 k4k10 probes k9] [--reps 5]

``--kernels ffma`` (the default): the fp32 modes of K3, K5 and K1, the
register-tiled FFMA kernels of ``csrc/ffma_tile.cuh``.  K3: one
ground-truth chunk, [1024, 129] x [129, 1M] (SIFT-1M, L2 on the augmented
dimension) at k = 10, 32, 100 and 300; the fused coarse tier at nlist 8192,
[8192, 129] x [129, 8192], k = 4; and the whole 10,000-query L2 ground
truth through ``utils.datasets.ground_truth`` (ten chunks; host copies and
the id transfer included), at k = 10.  K5: an fp32 L2 ``BruteForceIndex``
over SIFT-1M (engine auto: accum), [8192, 129] x [512, 129, 2048] at k = 20
(its rescore pool), beside ``torch.mm`` in 8 column blocks, and one
``search_device(q, 10)`` call.  K1: an fp32 ``IVFIndex`` (the default
dtype; nlist 1024, L2, pad_block 2048, 25 k-means iterations) on one routed
B=8192 batch at nprobe 4, beside ``torch.bmm`` of the per-block product,
and one ``search_device(q, 10, 4)`` call with its defaults.

``--kernels k67``: the float modes (fp32, bf16) of K7 and K6 on that fp32
index and the same index in bf16, one routed B=8192 batch at nprobe 4,
k = 20 (the rescore pool of k = 10):

- K7, ``cluster_major_scan_routed``: the dense walk over all 1176 blocks
  and the batch's first recovery list; beside it K4 (the same dense walk on
  the gathered table), ``torch.bmm`` of the per-block product alone (fp32
  with TF32 off; bf16 into fp32), and one ``_build.pad_rows`` copy of the
  batch to its 16-byte row pitch (what each K7 wrapper call adds: the
  routed engine hands the batch over as the query prep leaves it);
- K6, ``cluster_major_scan``: the index as ``ShardedIVFIndex`` over four
  shards on this card, shard 0's dense walk and the recovery list of the
  shard with the most dropped pairs; ``torch.bmm`` beside the dense walk,
  and one ``pad_rows`` copy of the routed table (what each K6 call would
  add if the table were not written at the pitch);
- the calls: ``search_device(q, 10, 4, engine="pallas_routed")`` and the
  sharded ``search_device(q, 10, 4, mode="cluster", engine="pallas")``, by
  CUDA events and, from ``torch.profiler`` over three calls, the device
  time a call (all kernels, and the scan kernels K7 / K6 alone: the
  sharded call runs its four shards in turn from the host, so its clock
  time is mostly the host's).

``--kernels k4k10``: K4's float modes and K10 in every mode, at the
shapes their callers give them:

- K4 (``cluster_major_scan_grouped``) on the fp32 and bf16 indexes above,
  one routed B=8192 batch at nprobe 4, k = 20: the dense walk
  (``engine="pallas"``) on a routed table at the 16-byte row pitch (read in
  place) and on the contiguous table K1 reads (which the wrapper copies to
  the pitch), beside the build of each table, ``torch.bmm`` of the product
  alone and the bound; the batch's first recovery list (the table
  ``_recover_tables`` gives); and the calls ``search_device(q, 10, 4,
  engine="pallas")`` and ``search_device(q, 10, 4)`` (the default: K1 and
  the recovery pass's K4), by CUDA events and by ``torch.profiler``;
- K10 (``kernel_lab._variant_scan``) at the lab's defaults (B=2048, nprobe
  4, qcap 128, k = 20, 128 bins) in its four variants, on the lab's routing
  built here: int8 on an int8 L2 index of the same corpus (the lab's CLI
  index; its table contiguous, as ``kernel_lab.routed_table`` gives it),
  fp32 and bf16 on the float indexes, the table at the pitch and
  contiguous; each variant's bound.

``--kernels probes``: the tensor-core paths of the hardware probes at the
JAX sizes (``harness/hw_probe.py``), each beside its bound and its plain
version's time:

- K14 (``_gemm_rate_probe``) at (tb, tn) = (256, 2048), d 128, g 2048, in
  int8 on the tensor cores (``unit="mma"``) and on ``__dp4a``, and in bf16,
  with its rate (2·tb·d·tn·g over the time) and the slope rate between g
  512 and 2048 that ``probe_pallas_gemm`` reports;
- K12 (``_stream_probe``) with the product over the 512 MB walk [2048,
  128, 2048] int8 and [1024, 128, 2048] bf16, x [128, 128], fat 1, semantics
  None and "arbitrary", and without it (int8, None);
- K13 (``_dma_probe``) over the int8 2 GiB walk [8192, 128, 2048] at depth
  8.

``--kernels k9``: K9 (``ivf_accum.cluster_major_accum``, the extract
emit, which no search calls) at K1's shapes, one routed B=8192 batch at
nprobe 4, k = 20: int8 IP and int8 L2 with its 4-bit bias rows on an int8
L2 index, fp32 and bf16 on the float indexes; and K4's paths past the
kernels' own selection at the int8 dense walk (bin depths 5, 8 and 16,
nbins 64 and 256; depth 2 beside them), each beside its bound; and K3's
binned int8 mode (``bruteforce_fused.fused_topk_matmul``, IP, [8192,
128] x [128, 1M] random int8, k = 20, tile_n 6144) exact (nbins 0), at
nbins 128 (its table) and at 64 and 96 (its general binning).  K9's
device time by ``torch.profiler``: the whole call and its scan (K1's
``planes_*`` kernels; the rest is the emit).

The probes' times are device times of 10 calls captured in one CUDA graph
(``timing.graph_ms``, as ``hw_probe`` times them: a call's Python costs
more than K14's device time), the median of ``--reps`` such timings.

Bounds (``timing.bound_ms``): the FFMA rate for K3, K5 and K1; for K4, K6,
K7 and K10 the valid columns of the walked blocks, the routed rows and the top-k
written, and the products of each walked block's live routed rows (an
empty slot, a zero row, needs none) at the FFMA rate (fp32), the bf16
tensor-core rate or the int8 one.  Times are medians of CUDA events
(``timing.median_ms``).  A call the kernel (or an older checkout's API)
refuses prints its error instead of a time.  The last line is one JSON object.

The script imports the ``rag_on_edge_tpu_torch`` it finds first on the
path, so with another checkout's root first on ``PYTHONPATH`` it times that
checkout's kernels (one whose ``harness/timing.py`` has ``median_ms``): two
versions are compared within one call on one card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from rag_on_edge_tpu_torch.harness.timing import (BF16_OPS_S, DP4A_OPS_S, INT8_OPS_S, OPS32_S,
                                                  bmm_ms, bound_ms, median_ms, walked_blocks)

K, NPROBE, BATCH, KK = 10, 4, 8192, 20


def _timed(fn, reps: int):
    """:func:`median_ms`, or what refused the call (a checkout whose API or
    kernel does not take it)."""
    try:
        return median_ms(fn, reps)
    except (ValueError, RuntimeError, TypeError) as e:
        return f"refused: {str(e)[:300]}"


def main(argv=None) -> dict:
    from rag_on_edge_tpu_torch.utils.datasets import make_synthetic

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", nargs="+", choices=["ffma", "k67", "k4k10", "probes", "k9"],
                    default=["ffma"])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_times needs a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    out = {"card": card, "torch": torch.__version__}
    if "probes" in args.kernels:
        out["probes"] = _probes(dev, args.reps)
    if set(args.kernels) - {"probes"}:
        base, queries = make_synthetic(1_000_000, 10_000, 128, 4096, seed=42)
    if "ffma" in args.kernels:
        out.update(_ffma(base, queries, dev, args.reps))
    if "k67" in args.kernels:
        out.update(_k67(base, queries, dev, args.reps))
    if "k4k10" in args.kernels:
        out.update(_k4k10(base, queries, dev, args.reps))
    if "k9" in args.kernels:
        out.update(_k9(base, queries, dev, args.reps))
    print(json.dumps(out), flush=True)
    return out


def _probes(dev, reps: int) -> dict:
    """K14 and K12 at the JAX sizes (``--kernels probes``)."""
    from rag_on_edge_tpu_torch.harness import hw_probe
    from rag_on_edge_tpu_torch.harness.timing import graph_ms

    calls = 10

    def gms(fn):
        try:
            return float(np.median([graph_ms(fn, dev, calls=calls) for _ in range(reps)]))
        except (ValueError, RuntimeError, TypeError) as e:
            return f"refused: {str(e)[:300]}"

    gen = torch.Generator(device=dev).manual_seed(20)

    def rand(shape, dtype):
        if dtype == torch.int8:
            return torch.randint(-127, 127, shape, generator=gen, device=dev, dtype=dtype)
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    out = {}
    tb, tn, d, g = 256, 2048, 128, 2048
    x1 = torch.zeros((8, 128), device=dev)
    for dtype, unit, rate in ((torch.int8, "mma", INT8_OPS_S), (torch.int8, "dp4a", DP4A_OPS_S),
                              (torch.bfloat16, "mma", BF16_OPS_S)):
        q, v = rand((tb, d), dtype), rand((d, tn), dtype)
        units = (tb // 128) * (tn // 128)
        nbytes = (q.numel() + v.numel()) * q.element_size() + g * units * 8 * 4 + 4
        row = {"bound_ms": bound_ms(nbytes, 2.0 * tb * d * tn * g, rate)[0]}
        ts = {gg: gms(lambda gg=gg: hw_probe._gemm_rate_probe(x1, q, v, gg, tb, tn, False, unit))
              for gg in (512, g)}
        row["ms"] = ts[g]
        if not any(isinstance(t, str) for t in ts.values()):
            row["tops"] = 2.0 * tb * d * tn * g / (ts[g] * 1e-3) / 1e12
            row["slope_tops"] = 2.0 * tb * d * tn * (g - 512) / ((ts[g] - ts[512]) * 1e-3) / 1e12
        row["plain_ms"] = gms(lambda: hw_probe._gemm_rate_probe_reference(
            x1, q, v, g, tb, tn, False, unit))
        out[f"K14 {_NAME[dtype]} {unit}"] = row
        print(f"K14 {_NAME[dtype]} {unit}", row, flush=True)
        del q, v
    blk, total = 2048, 512 << 20
    for dtype in (torch.int8, torch.bfloat16):
        es = dtype.itemsize
        data = rand((total // (d * blk * es), d, blk), dtype)
        x = rand((128, d), dtype)
        nbytes = data.numel() * es + x.numel() * es + data.shape[0] * 4
        cases = [(True, None), (True, "arbitrary")] + ([(False, None)] if es == 1 else [])
        for gemm, sem in cases:
            row = {"bound_ms": bound_ms(nbytes, 2.0 * 128 * data.numel() if gemm else 0,
                                        INT8_OPS_S if es == 1 else BF16_OPS_S)[0],
                   "ms": gms(lambda: hw_probe._stream_probe(x, data, blk, 1, gemm, sem))}
            if gemm and sem is None:
                row["plain_ms"] = gms(lambda: hw_probe._stream_probe_reference(
                    x, data, blk, 1, gemm, sem))
            name = f"K12 {_NAME[dtype]} {'gemm' if gemm else 'max'} {sem}"
            out[name] = row
            print(name, row, flush=True)
        del data, x
        torch.cuda.empty_cache()
    data = rand((8192, d, blk), torch.int8)
    row = {"bound_ms": bound_ms(data.numel() + 4, 0, INT8_OPS_S)[0],
           "ms": gms(lambda: hw_probe._dma_probe(x1, data, 8))}
    out["K13 int8 depth 8"] = row
    print("K13 int8 depth 8", row, flush=True)
    del data
    torch.cuda.empty_cache()
    return out


_NAME = {torch.int8: "int8", torch.bfloat16: "bf16"}


def _ffma(base, queries, dev, reps: int) -> dict:
    """K3, K5 and K1 fp32 (``--kernels ffma``)."""
    from rag_on_edge_tpu_torch.ops import bruteforce_fused
    from rag_on_edge_tpu_torch.utils.datasets import ground_truth

    bt = torch.cat([torch.from_numpy(base.T.copy()),
                    torch.from_numpy(-0.5 * np.sum(base ** 2, axis=1))[None, :]]).to(dev)
    q = torch.cat([torch.from_numpy(queries[:1024]), torch.ones((1024, 1))], dim=1).to(dev)
    gen = torch.Generator().manual_seed(16)
    cents = torch.randint(0, 142, (128, 8192), generator=gen)
    cents = torch.cat([cents, -0.5 * (cents * cents).sum(0, keepdim=True)]).float().to(dev)
    qc = torch.cat([torch.from_numpy(np.resize(queries, (8192, 128))),
                    torch.ones((8192, 1))], dim=1).to(dev)
    out = {}
    for name, (qx, btx, k) in {"gt k=10": (q, bt, 10), "gt k=32": (q, bt, 32),
                               "gt k=100": (q, bt, 100), "gt k=300": (q, bt, 300),
                               "coarse k=4": (qc, cents, 4)}.items():
        b, d, n = qx.shape[0], btx.shape[0], btx.shape[1]
        row = {"bound_ms": bound_ms(0, 2.0 * b * d * n, OPS32_S)[0],
               "gemm_ms": median_ms(lambda: torch.mm(qx, btx), reps),
               "ms": _timed(lambda: bruteforce_fused.fused_topk_matmul(qx, btx, k), reps)}
        out[name] = row
        print(name, row, flush=True)
    torch.cuda.synchronize()
    t = time.time()
    ground_truth(base, queries, 10, metric="l2", device=dev)
    torch.cuda.synchronize()
    out["gt 10K queries k=10 s"] = time.time() - t
    del bt, q, cents, qc

    q8 = torch.from_numpy(queries[:BATCH]).to(dev)
    for name, part in (("K5", _k5), ("K1", _k1)):
        try:
            out[name] = part(base, q8, reps)
        except (ValueError, RuntimeError) as e:
            out[name] = f"refused: {e}"
        print(f"{name} fp32", out[name], flush=True)
    return out


def _k5(base, q8, reps: int) -> dict:
    """K5 fp32 of an fp32 L2 accum index at B=8192, k = 20, and the call."""
    from rag_on_edge_tpu_torch.models.brute_force import BruteForceIndex
    from rag_on_edge_tpu_torch.ops import bruteforce_accum

    idx = BruteForceIndex(base, metric="l2", dtype="fp32", device=q8.device)
    tiles = idx._arrays["base_tiles"]
    qx = idx._augment(q8)
    kw = dict(group=idx._acc_group, depth=idx._acc_depth)
    n = base.shape[0]
    dp = tiles.shape[1]
    bt = tiles.permute(1, 0, 2).reshape(dp, -1)[:, :n].contiguous()
    step = -(-n // 8)
    row = {"engine": idx.engine, "shape": [list(qx.shape), list(tiles.shape)],
           "bound_ms": bound_ms(0, 2.0 * qx.shape[0] * dp * n, OPS32_S)[0],
           "gemm_ms": sum(median_ms(lambda s=s: torch.mm(qx, bt[:, s:s + step]), reps)
                          for s in range(0, n, step))}
    del bt
    row["ms"] = median_ms(lambda: bruteforce_accum.fused_topk_accum(qx, tiles, n, 20, **kw), reps)
    row["call_ms"] = median_ms(lambda: idx.search_device(q8, 10), reps)
    return row


def _k1(base, q8, reps: int) -> dict:
    """K1 fp32 of the default fp32 IVF index on one routed B=8192 batch at
    nprobe 4, and the default call."""
    from rag_on_edge_tpu_torch.models.ivf import IVFIndex
    from rag_on_edge_tpu_torch.ops import ivf_accum

    idx = IVFIndex.build(base, nlist=1024, metric="l2", pad_block=2048, seed=42, max_iter=25,
                         device=q8.device)
    idx._ensure_kernel_state()
    a = idx._arrays
    qcap = idx._auto_qcap(q8.shape[0], 4)
    _, cq, _, _, _ = idx._route(q8, 4, qcap)
    qb = idx._scan_inputs(q8, cq)[1]
    vt = a["vectors_t"]
    args = (qb, vt, a["block_first"], a["block_last"], a["rows_valid"])
    valid = int(a["rows_valid"].sum())
    row = {"dtype": idx.dtype, "shape": [list(qb.shape), list(vt.shape)],
           "bound_ms": bound_ms(0, 2.0 * qcap * valid * vt.shape[1], OPS32_S)[0],
           "bmm_ms": median_ms(lambda: torch.bmm(qb, vt), reps)}
    row["ms"] = median_ms(lambda: ivf_accum.cluster_major_accum_planes(*args, blk=2048), reps)
    row["call_ms"] = median_ms(lambda: idx.search_device(q8, 10, 4), reps)
    return row



def _k67(base, queries, dev, reps: int) -> dict:
    """K7 and K6 fp32 and bf16, and the calls they serve (``--kernels k67``)."""
    from rag_on_edge_tpu_torch.models.ivf import IVFIndex

    q = torch.from_numpy(queries[:BATCH]).to(dev)
    out = {}
    fidx = IVFIndex.build(base, nlist=1024, metric="l2", pad_block=2048, seed=42, max_iter=25,
                          device=dev)
    arrays = (fidx._centroids_np, fidx._vectors_np, fidx._offsets_np, fidx._reorder_np)
    for mode in ("fp32", "bf16"):
        idx = fidx if mode == "fp32" else IVFIndex.from_arrays(
            *arrays, metric="l2", dtype="bf16", pad_block=2048, config=dict(fidx.config),
            device=dev)
        idx._ensure_kernel_state()
        out[mode] = _k67_mode(idx, q, mode, reps)
        print(mode, out[mode], flush=True)
        del idx
        torch.cuda.empty_cache()
    return out


def _device(fn, calls: int = 3, scan: str = "grouped_") -> dict:
    """Device ms a call of ``fn``: every kernel's, and the scan kernels'
    (names holding ``scan``: the IVF scans ``grouped_*``), from
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    scan_key, total, scan = scan, 0.0, 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        us = getattr(ev, "self_cuda_time_total", 0) if us is None else us
        total += us
        scan += us if scan_key in ev.key else 0.0
    return {"device_ms": total / 1e3 / calls, "scan_device_ms": scan / 1e3 / calls}


_RATE = {"fp32": (4, OPS32_S), "bf16": (2, BF16_OPS_S), "int8": (1, INT8_OPS_S)}


def _live(table):
    """The routed rows of each plane of ``table`` that hold a query (an
    empty slot is a zero row; ``timing.live_rows``) → [planes]."""
    return (table != 0).any(-1).sum(-1)


def _scan_bound(mode, qcap, dp, tabs, live) -> float:
    """K4's, K6's, K7's and K10's bound (ms) over the walk of ``tabs``
    (block_first, block_last, rows_valid): the routed rows of each walked
    block, the valid columns' slab, the top-k of each emitted run; the
    product of each block's ``live`` routed rows with its valid columns (an
    empty slot needs none; every block with rows lies in an emitted run in
    these walks, so this is ``timing.live_products``)."""
    walked, cols = walked_blocks(*tabs)
    runs = int(tabs[1].count_nonzero())
    es, rate = _RATE[mode]
    nbytes = walked * qcap * dp * es + cols * dp * es + runs * qcap * KK * 8
    products = int((live.long() * tabs[2].clamp_min(0).long()).sum())
    return bound_ms(nbytes, 2.0 * dp * products, rate)[0]


def _pad_ms(rows, reps: int):
    """One ``_build.pad_rows`` copy of contiguous ``rows`` to a 16-byte
    row pitch: what a float K6 / K7 wrapper call adds for rows not handed
    over at the pitch."""
    from rag_on_edge_tpu_torch.ops import _build

    rows = rows.contiguous()
    return _timed(lambda: _build.pad_rows(rows, 16 // rows.element_size()), reps)


def _k67_mode(index, q, mode: str, reps: int) -> dict:
    from rag_on_edge_tpu_torch.ops import ivf_scan
    from rag_on_edge_tpu_torch.parallel import ShardedIVFIndex

    a = index._arrays
    vt, dp = a["vectors_t"], a["vectors_t"].shape[1]
    tabs = (a["block_first"], a["block_last"], a["rows_valid"])
    qcap = index._auto_qcap(BATCH, NPROBE)
    probes, cq, _, lossy, _ = index._route(q, NPROBE, qcap)
    qi = index._query_prep(q)[0]
    out = {"qcap": qcap, "shape": [list(qi.shape), list(vt.shape)], "K7 pad_ms": _pad_ms(qi, reps)}
    rb = -(-(vt.shape[0] // 4) // index.CM_GROUP) * index.CM_GROUP

    cqb = cq[a["block_cluster"].long()].unsqueeze(-1).contiguous()
    kw = dict(k=KK, blk=index.PAD_BLOCK, group=index.CM_GROUP)
    qb = index._scan_inputs(q, cq)[1]
    out["K7 dense"] = {"ms": _timed(lambda: ivf_scan.cluster_major_scan_routed(
        qi, cqb, vt, *tabs, **kw), reps),
        "bound_ms": _scan_bound(mode, qcap, dp, tabs, (cqb >= 0).sum((1, 2))),
        "bmm_ms": bmm_ms(qb, vt, reps),
        "K4_ms": _timed(lambda: ivf_scan.cluster_major_scan_grouped(qb, vt, *tabs, **kw), reps)}
    del qb
    rec = index._recover_tables(qi, probes, lossy, None, qcap, rb, routed=True)[0]
    out["K7 recovery"] = {"ms": _timed(lambda: ivf_scan.cluster_major_scan_routed(
        qi, *rec[:5], row_base=rec[6], **kw), reps),
        "bound_ms": _scan_bound(mode, qcap, dp, rec[2:5], (rec[0] >= 0).sum((1, 2))),
        "pairs": int(lossy.sum())}
    del rec
    torch.cuda.empty_cache()

    sh = ShardedIVFIndex(index, [q.device] * 4)
    sh._ensure_cluster_state()
    sa = sh._cm_arrays
    r = sh._cm_route(q, NPROBE, qcap)
    a0 = sa[0]
    dense = (r["qg"], a0["vectors_t"], a0["bc"], a0["bf"], a0["bl"], a0["rv"])
    qb0 = r["qg"][a0["bc"].long()].contiguous()
    out["K6 dense"] = {"ms": _timed(lambda: ivf_scan.cluster_major_scan(
        *dense, k=KK, blk=index.PAD_BLOCK), reps),
        "bound_ms": _scan_bound(mode, qcap, dp, dense[3:6], _live(r["qg"])[a0["bc"].long()]),
        "bmm_ms": bmm_ms(qb0, a0["vectors_t"], reps), "pad_ms": _pad_ms(r["qg"], reps)}
    del qb0
    owned = [int((r["lossy"] & (s_["cluster_shard"][r["probes"].long()] == i)).sum())
             for i, s_ in enumerate(sa)]
    s_rec = max(range(len(sa)), key=lambda i: owned[i])
    rb_sh = max(1, a0["vectors_t"].shape[0] // 4)
    rec = sh._cm_recover_tables(s_rec, r, r["lossy"], None, qcap, rb_sh)[0]
    out["K6 recovery"] = {"ms": _timed(lambda: ivf_scan.cluster_major_scan(
        *rec[:6], k=KK, blk=index.PAD_BLOCK, row_base=rec[7]), reps),
        "bound_ms": _scan_bound(mode, qcap, dp, rec[3:6], _live(rec[0])[rec[2].long()]),
        "shard": s_rec}
    del rec, r
    torch.cuda.empty_cache()

    calls = {"routed call": lambda: index.search_device(q, K, NPROBE, engine="pallas_routed"),
             "sharded pallas call": lambda: sh.search_device(q, K, NPROBE, mode="cluster",
                                                             engine="pallas")}
    for name, fn in calls.items():
        out[name] = {"ms": _timed(fn, reps), **_device(fn)}
    del sh
    torch.cuda.empty_cache()
    return out


def _pitched(rows):
    """A view of ``rows`` [..., D] at a 16-byte row pitch (a copy into a
    zero-padded buffer, made outside any timing)."""
    from rag_on_edge_tpu_torch.ops import _build

    return _build.pad_rows(rows, 16 // rows.element_size())[..., :rows.shape[-1]]


def _k4k10(base, queries, dev, reps: int) -> dict:
    """K4 fp32 and bf16 and K10 in every mode (``--kernels k4k10``)."""
    from rag_on_edge_tpu_torch.models.ivf import IVFIndex

    q = torch.from_numpy(queries[:BATCH]).to(dev)
    out = {}
    idx8 = IVFIndex.build(base, nlist=1024, metric="l2", dtype="int8", pad_block=2048, seed=42,
                          device=dev)
    idx8._ensure_kernel_state()
    out["K10 int8"] = _k10(idx8, queries, "int8", reps)
    print("K10 int8", out["K10 int8"], flush=True)
    del idx8
    torch.cuda.empty_cache()
    fidx = IVFIndex.build(base, nlist=1024, metric="l2", pad_block=2048, seed=42, max_iter=25,
                          device=dev)
    arrays = (fidx._centroids_np, fidx._vectors_np, fidx._offsets_np, fidx._reorder_np)
    for mode in ("fp32", "bf16"):
        idx = fidx if mode == "fp32" else IVFIndex.from_arrays(
            *arrays, metric="l2", dtype="bf16", pad_block=2048, config=dict(fidx.config),
            device=dev)
        idx._ensure_kernel_state()
        out[f"K4 {mode}"] = _k4_mode(idx, q, mode, reps)
        print(f"K4 {mode}", out[f"K4 {mode}"], flush=True)
        out[f"K10 {mode}"] = _k10(idx, queries, mode, reps)
        print(f"K10 {mode}", out[f"K10 {mode}"], flush=True)
        del idx
        torch.cuda.empty_cache()
    return out


def _k4_mode(index, q, mode: str, reps: int) -> dict:
    """K4 on a float index: the dense walk on a pitched and on a contiguous
    table, the first recovery list, and the calls that run it."""
    from rag_on_edge_tpu_torch.ops import ivf_scan

    a = index._arrays
    vt, dp = a["vectors_t"], a["vectors_t"].shape[1]
    tabs = (a["block_first"], a["block_last"], a["rows_valid"])
    qcap = index._auto_qcap(BATCH, NPROBE)
    probes, cq, _, lossy, _ = index._route(q, NPROBE, qcap)
    qi, qb = index._scan_inputs(q, cq)[:2]
    kw = dict(k=KK, blk=index.PAD_BLOCK, group=index.CM_GROUP)
    qb_p = _pitched(qb)
    out = {"qcap": qcap, "shape": [list(qb.shape), list(vt.shape)],
           "bound_ms": _scan_bound(mode, qcap, dp, tabs, _live(qb)), "bmm_ms": bmm_ms(qb, vt, reps),
           "table_ms": _timed(lambda: index._scan_inputs(q, cq), reps),
           "pitched_table_ms": _timed(lambda: index._scan_inputs(q, cq, pitched=True), reps),
           "dense_ms": _timed(lambda: ivf_scan.cluster_major_scan_grouped(qb_p, vt, *tabs, **kw),
                              reps),
           "dense_contiguous_ms": _timed(lambda: ivf_scan.cluster_major_scan_grouped(
               qb, vt, *tabs, **kw), reps)}
    del qb, qb_p
    rb = -(-(vt.shape[0] // 4) // index.CM_GROUP) * index.CM_GROUP
    rec = index._recover_tables(qi, probes, lossy, None, qcap, rb)[0]
    out["recovery"] = {"ms": _timed(lambda: ivf_scan.cluster_major_scan_grouped(
        *rec[:5], row_base=rec[6], **kw), reps),
        "bound_ms": _scan_bound(mode, qcap, dp, rec[2:5], _live(rec[0])),
        "pairs": int(lossy.sum()), "table_pitch": rec[0].stride(1)}
    del rec
    torch.cuda.empty_cache()
    calls = {"pallas call": lambda: index.search_device(q, K, NPROBE, engine="pallas"),
             "default call": lambda: index.search_device(q, K, NPROBE)}
    for name, fn in calls.items():
        out[name] = {"ms": _timed(fn, reps), **_device(fn)}
    return out


def _k10(index, queries, mode: str, reps: int, batch: int = 2048, qcap: int = 128) -> dict:
    """K10's four variants at the lab's defaults on ``index``: int8 on the
    lab's own table, fp32 and bf16 on the same routing built here, at the
    16-byte pitch and contiguous."""
    from rag_on_edge_tpu_torch.harness import kernel_lab
    from rag_on_edge_tpu_torch.models.ivf import invert_probes
    from rag_on_edge_tpu_torch.ops import topk

    a = index._arrays
    vt, dp = a["vectors_t"], a["vectors_t"].shape[1]
    lab_tabs = (vt, a["block_cluster"], a["block_first"], a["block_last"], a["rows_valid"])
    rng = np.random.default_rng(0)
    ql = torch.from_numpy(rng.permuted(np.resize(queries, (batch, queries.shape[1])), axis=0)
                          .astype(np.float32)).to(vt.device)
    _, probes = topk.small_topk(ql @ a["centroids"].T, NPROBE)
    cq, _, _ = invert_probes(probes, index.nlist, qcap)
    rows = index._query_prep(ql)[0]
    qg = torch.where((cq >= 0)[..., None], rows[cq.clamp_min(0).long()],
                     torch.zeros((), dtype=rows.dtype, device=rows.device)).contiguous()
    tables = {"contiguous": qg} if mode == "int8" else {"pitched": _pitched(qg), "contiguous": qg}
    _, cols = walked_blocks(*lab_tabs[2:])
    products = int((_live(qg)[a["block_cluster"].long()].long()
                    * a["rows_valid"].clamp_min(0).long()).sum())
    es, rate = _RATE[mode]
    bc = a["block_cluster"].long()
    windows = {"full": torch.unique(bc[a["block_last"] > 0]).numel(),
               "maxonly": torch.unique(bc).numel(), "fixedout": 1}
    windows["nogate"] = windows["full"]
    out = {}
    for variant in kernel_lab.VARIANTS:
        row = {"bound_ms": bound_ms(cols * dp * es + windows[variant] * qcap * (dp * es + KK * 8),
                                    2.0 * dp * products, rate)[0]}
        for name, table in tables.items():
            row[f"{name} ms"] = _timed(lambda t=table: kernel_lab._variant_scan(
                t, *lab_tabs, KK, index.PAD_BLOCK, 128, variant), reps)
        out[variant] = row
    return out




def _k9(base, queries, dev, reps: int) -> dict:
    """K9 in every mode at K1's shapes, and K4's general selection at the
    int8 dense walk (``--kernels k9``)."""
    from rag_on_edge_tpu_torch.models.ivf import IVFIndex
    from rag_on_edge_tpu_torch.ops import ivf_accum, ivf_scan

    q = torch.from_numpy(queries[:BATCH]).to(dev)
    out = {}
    idx8 = IVFIndex.build(base, nlist=1024, metric="l2", dtype="int8", pad_block=2048, seed=42,
                          device=dev)
    idx8._ensure_kernel_state()
    qcap = idx8._auto_qcap(BATCH, NPROBE)
    cq = idx8._route(q, NPROBE, qcap)[1]
    _, qb, bias, _, _ = idx8._scan_inputs(q, cq)
    a = idx8._arrays
    args = (qb, a["vectors_t"], a["block_first"], a["block_last"], a["rows_valid"])
    blk, d = idx8.PAD_BLOCK, qb.shape[-1]
    walked, cols = walked_blocks(*args[2:])
    last = int(a["block_last"].sum())
    for name, br in (("int8-IP", None), ("int8-L2", ivf_accum.accum_bias_rows(bias,
                                                                             a["rows_valid"]))):
        # Without a row mask (bias rows) every column of a walked block is scored.
        c = cols if br is None else walked * blk
        out[f"K9 {name}"] = {
            "ms": _timed(lambda: ivf_accum.cluster_major_accum(*args, KK, blk=blk,
                                                               bias_rows=br), reps),
            **_device(lambda: ivf_accum.cluster_major_accum(*args, KK, blk=blk, bias_rows=br),
                      scan="planes_"),
            "bound_ms": bound_ms(walked * qcap * d + c * (d + 4 * (br is not None))
                                 + last * qcap * KK * 8, 2.0 * qcap * c * d, INT8_OPS_S)[0]}
        print(f"K9 {name}", out[f"K9 {name}"], flush=True)
    kw = dict(k=KK, blk=blk, group=idx8.CM_GROUP, bias=bias)
    for name, extra in (("depth2", {}), ("depth5", dict(bin_depth=5)),
                        ("depth8", dict(bin_depth=8)), ("depth16", dict(bin_depth=16)),
                        ("nbins64", dict(nbins=64)), ("nbins256", dict(nbins=256))):
        out[f"K4 int8 dense {name}"] = _timed(lambda: ivf_scan.cluster_major_scan_grouped(
            *args, **kw, **extra), reps)
        print(f"K4 int8 dense {name}", out[f"K4 int8 dense {name}"], flush=True)
    del idx8, args, qb
    torch.cuda.empty_cache()
    from rag_on_edge_tpu_torch.ops import bruteforce_fused

    gen = torch.Generator(device=dev).manual_seed(21)
    q8 = torch.randint(-127, 127, (BATCH, 128), generator=gen, device=dev, dtype=torch.int8)
    b8 = torch.randint(-127, 127, (128, 1_000_000), generator=gen, device=dev, dtype=torch.int8)
    for nbins in (0, 128, 64, 96):
        out[f"K3 int8 IP nbins {nbins}"] = _timed(lambda: bruteforce_fused.fused_topk_matmul(
            q8, b8, KK, tile_n=6144, nbins=nbins), reps)
        print(f"K3 int8 IP nbins {nbins}", out[f"K3 int8 IP nbins {nbins}"], flush=True)
    del q8, b8
    torch.cuda.empty_cache()
    fidx = IVFIndex.build(base, nlist=1024, metric="l2", pad_block=2048, seed=42, max_iter=25,
                          device=dev)
    arrays = (fidx._centroids_np, fidx._vectors_np, fidx._offsets_np, fidx._reorder_np)
    for mode in ("fp32", "bf16"):
        idx = fidx if mode == "fp32" else IVFIndex.from_arrays(
            *arrays, metric="l2", dtype="bf16", pad_block=2048, config=dict(fidx.config),
            device=dev)
        idx._ensure_kernel_state()
        qcap = idx._auto_qcap(BATCH, NPROBE)
        cq = idx._route(q, NPROBE, qcap)[1]
        qb = idx._scan_inputs(q, cq)[1]
        a = idx._arrays
        args = (qb, a["vectors_t"], a["block_first"], a["block_last"], a["rows_valid"])
        dp = qb.shape[-1]
        walked, cols = walked_blocks(*args[2:])
        last = int(a["block_last"].sum())
        es, rate = _RATE[mode]
        # K1's bound: the product over every routed slot (K9, as K1, scores
        # its empty slots too).
        out[f"K9 {mode}"] = {
            "ms": _timed(lambda: ivf_accum.cluster_major_accum(*args, KK, blk=blk), reps),
            **_device(lambda: ivf_accum.cluster_major_accum(*args, KK, blk=blk), scan="planes_"),
            "bound_ms": bound_ms((walked * qcap + cols) * dp * es + last * qcap * KK * 8,
                                 2.0 * qcap * cols * dp, rate)[0]}
        print(f"K9 {mode}", out[f"K9 {mode}"], flush=True)
        del idx, args, qb
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
