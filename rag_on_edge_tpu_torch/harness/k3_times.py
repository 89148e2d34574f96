"""Time the fp32 modes of kernels K3, K5 and K1 (the register-tiled FFMA
kernels of ``csrc/ffma_tile.cuh``) on one card at the shapes their callers
give them, beside one PyTorch call of the same product alone (TF32 off)
and the FFMA bound, and the whole calls they serve:

    python -m rag_on_edge_tpu_torch.harness.k3_times [--reps 5]

K3: one ground-truth chunk, [1024, 129] x [129, 1M] (SIFT-1M, L2 on the
augmented dimension) at k = 10, 32, 100 and 300; the fused coarse tier at
nlist 8192, [8192, 129] x [129, 8192], k = 4; and the whole 10,000-query
L2 ground truth through ``utils.datasets.ground_truth`` (ten chunks; host
copies and the id transfer included), at k = 10.  K5: an fp32 L2
``BruteForceIndex`` over SIFT-1M (engine auto: accum), [8192, 129] x [512,
129, 2048] at k = 20 (its rescore pool), beside ``torch.mm`` in 8 column
blocks, and one ``search_device(q, 10)`` call.  K1: an fp32 ``IVFIndex``
(the default dtype; nlist 1024, L2, pad_block 2048, 25 k-means
iterations) on one routed B=8192
batch at nprobe 4, beside ``torch.bmm`` of the per-block product, and one
``search_device(q, 10, 4)`` call with its defaults.  A call the kernel
refuses prints its error instead of a time.  The last line is one JSON
object.

The script imports the ``rag_on_edge_tpu_torch`` it finds first on the
path, so with another checkout's root first on ``PYTHONPATH`` it times that
checkout's K3: two versions are compared within one call on one card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

FFMA_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores, at 700 W


def _ms(fn, reps: int) -> float:
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


def main(argv=None) -> dict:
    from rag_on_edge_tpu_torch.ops import bruteforce_fused
    from rag_on_edge_tpu_torch.utils.datasets import ground_truth, make_synthetic

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_times needs a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    base, queries = make_synthetic(1_000_000, 10_000, 128, 4096, seed=42)
    bt = torch.cat([torch.from_numpy(base.T.copy()),
                    torch.from_numpy(-0.5 * np.sum(base ** 2, axis=1))[None, :]]).to(dev)
    q = torch.cat([torch.from_numpy(queries[:1024]), torch.ones((1024, 1))], dim=1).to(dev)
    gen = torch.Generator().manual_seed(16)
    cents = torch.randint(0, 142, (128, 8192), generator=gen)
    cents = torch.cat([cents, -0.5 * (cents * cents).sum(0, keepdim=True)]).float().to(dev)
    qc = torch.cat([torch.from_numpy(np.resize(queries, (8192, 128))),
                    torch.ones((8192, 1))], dim=1).to(dev)
    out = {"card": card, "torch": torch.__version__}
    for name, (qx, btx, k) in {"gt k=10": (q, bt, 10), "gt k=32": (q, bt, 32),
                               "gt k=100": (q, bt, 100), "gt k=300": (q, bt, 300),
                               "coarse k=4": (qc, cents, 4)}.items():
        b, d, n = qx.shape[0], btx.shape[0], btx.shape[1]
        row = {"bound_ms": 2.0 * b * d * n / FFMA_FLOPS * 1e3,
               "gemm_ms": _ms(lambda: torch.mm(qx, btx), args.reps)}
        try:
            row["ms"] = _ms(lambda: bruteforce_fused.fused_topk_matmul(qx, btx, k), args.reps)
        except (ValueError, RuntimeError) as e:
            row["ms"] = f"refused: {e}"
        out[name] = row
        print(name, row, flush=True)
    torch.cuda.synchronize()
    t = time.time()
    ground_truth(base, queries, 10, metric="l2", device=dev)
    torch.cuda.synchronize()
    out["gt 10K queries k=10 s"] = time.time() - t
    del bt, q, cents, qc

    q8 = torch.from_numpy(queries[:8192]).to(dev)
    for name, part in (("K5", _k5), ("K1", _k1)):
        try:
            out[name] = part(base, q8, args.reps)
        except (ValueError, RuntimeError) as e:
            out[name] = f"refused: {e}"
        print(f"{name} fp32", out[name], flush=True)
    print(json.dumps(out), flush=True)
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
           "bound_ms": 2.0 * qx.shape[0] * dp * n / FFMA_FLOPS * 1e3,
           "gemm_ms": sum(_ms(lambda s=s: torch.mm(qx, bt[:, s:s + step]), reps)
                          for s in range(0, n, step))}
    del bt
    row["ms"] = _ms(lambda: bruteforce_accum.fused_topk_accum(qx, tiles, n, 20, **kw), reps)
    row["call_ms"] = _ms(lambda: idx.search_device(q8, 10), reps)
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
           "bound_ms": 2.0 * qcap * valid * vt.shape[1] / FFMA_FLOPS * 1e3,
           "bmm_ms": _ms(lambda: torch.bmm(qb, vt), reps)}
    row["ms"] = _ms(lambda: ivf_accum.cluster_major_accum_planes(*args, blk=2048), reps)
    row["call_ms"] = _ms(lambda: idx.search_device(q8, 10, 4), reps)
    return row


if __name__ == "__main__":
    main()
