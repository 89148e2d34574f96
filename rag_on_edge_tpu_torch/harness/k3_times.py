"""Time kernel K3's fp32 mode, the exact ground truth and the fused coarse
tier, on one card at the shapes its callers give it, beside ``torch.mm`` of
the same product alone (TF32 off) and the FFMA bound:

    python -m rag_on_edge_tpu_torch.harness.k3_times [--reps 5]

Shapes: one ground-truth chunk, [1024, 129] x [129, 1M] (SIFT-1M, L2 on the
augmented dimension) at k = 10, 32 and 100; the fused coarse tier at nlist
8192, [8192, 129] x [129, 8192], k = 4; and the whole 10,000-query L2
ground truth through ``utils.datasets.ground_truth`` (ten chunks; host
copies and the id transfer included), at k = 10.  A k the kernel refuses
prints its error instead of a time.  The last line is one JSON object.

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
                               "gt k=100": (q, bt, 100), "coarse k=4": (qc, cents, 4)}.items():
        b, d, n = qx.shape[0], btx.shape[0], btx.shape[1]
        row = {"bound_ms": 2.0 * b * d * n / FFMA_FLOPS * 1e3,
               "gemm_ms": _ms(lambda: torch.mm(qx, btx), args.reps)}
        try:
            row["ms"] = _ms(lambda: bruteforce_fused.fused_topk_matmul(qx, btx, k), args.reps)
        except ValueError as e:
            row["ms"] = f"refused: {e}"
        out[name] = row
        print(name, row, flush=True)
    torch.cuda.synchronize()
    t = time.time()
    ground_truth(base, queries, 10, metric="l2", device=dev)
    torch.cuda.synchronize()
    out["gt 10K queries k=10 s"] = time.time() - t
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
