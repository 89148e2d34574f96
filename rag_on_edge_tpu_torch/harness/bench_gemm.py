"""Spatial-GEMM benchmark (counterpart: ``rag_on_edge_tpu/harness/bench_gemm.py``).

The reference's AIE host program's workload: fixed-seed inputs, an
iteration loop with warm-up calls left out, full or sampled verification,
and the time per pass with GFLOPs = 2·M·K·N / time.  The published
workload is GEMM 128×128×N, N = 2048 → 10240, on SIFT-like rows
L2-normalized and scaled; here they go through the same normalize → scale
pipeline to int8 (``utils/preprocess.py``), and the GEMM runs spatially
partitioned over a 2-D device grid (``parallel/spatial_gemm.py``), through
kernel K8 by default (``--pallas``, the JAX flag's name).  One card is a
1×1 grid.  Times are CUDA events on one card (``harness/timing.py``).

Usage::

    python -m rag_on_edge_tpu_torch.harness.bench_gemm -M 128 -K 128 -N 10240 \\
        --dtype int8 --iters 100
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from rag_on_edge_tpu_torch.harness import timing
from rag_on_edge_tpu_torch.parallel.spatial_gemm import (_place, _run, make_mesh_2d,
                                                         spatial_matmul, verify_matmul)
from rag_on_edge_tpu_torch.utils.preprocess import prepare_int8_operands


def _make_inputs(m: int, k: int, n: int, dtype: str, seed: int):
    """Fixed-seed inputs as CPU tensors (the JAX package's numpy draws),
    through the normalize → scale → int8 pipeline for int8 (rows of A and
    columns of B unit-normalized)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 141.0, size=(m, k)).astype(np.float32)  # SIFT range
    b = rng.uniform(0.0, 141.0, size=(k, n)).astype(np.float32)
    if dtype == "int8":
        a_i8, b_i8, _ = prepare_int8_operands(a, b.T, query_row_multiple=1,
                                              base_row_multiple=1)
        return torch.from_numpy(a_i8), torch.from_numpy(b_i8.T.copy())
    if dtype == "bf16":
        return torch.from_numpy(a).to(torch.bfloat16), torch.from_numpy(b).to(torch.bfloat16)
    return torch.from_numpy(a), torch.from_numpy(b)


def _host(x: torch.Tensor) -> np.ndarray:
    return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def run(m: int = 128, k: int = 128, n: int = 10240, dtype: str = "int8",
        rows: int | None = None, cols: int | None = None, iters: int = 100,
        warmup: int = 2, pallas: bool = True, seed: int = 0,
        stack: int = 16, quiet: bool = False, mesh=None) -> dict:
    """The benchmark → its result dict (the JAX package's keys, and the
    device).  ``mesh`` is a rows × cols grid of devices; by default
    :func:`make_mesh_2d` over the CUDA cards, 4×4 from 16 cards, 2×2 from
    4, else 1×1, as the JAX package sizes its mesh from ``jax.devices()``."""
    if mesh is None:
        nd = torch.cuda.device_count()
        rows = rows or (4 if nd >= 16 else (2 if nd >= 4 else 1))
        cols = cols or (4 if nd >= 16 else (2 if nd >= 4 else 1))
        mesh = make_mesh_2d(rows, cols)
    rows, cols = len(mesh), len(mesh[0])
    devices = [d for row in mesh for d in row]
    a, b = _make_inputs(m, k, n, dtype, seed)

    c = spatial_matmul(a, b, mesh, use_pallas_kernel=pallas)
    ok = verify_matmul(_host(a), _host(b), _host(c), seed=seed)

    # The operands are placed on the grid once (the reference syncs its
    # buffers to the device once); each pass is one local product per
    # position and the join.
    a_parts, b_parts = _place(a, b, mesh)
    avg_ms = timing.per_call_ms(lambda: _run(a_parts, b_parts, mesh, pallas), devices,
                                calls=iters, warmup=warmup)
    # Stacked passes: `stack` A tiles per call, one [stack·M, K] GEMM, for
    # the capacity of the device rather than its per-call overhead.
    a_stack = torch.cat([torch.roll(a, i + 1, dims=0) for i in range(stack)])
    s_parts, _ = _place(a_stack, b, mesh)
    reps = max(4, iters // stack)
    stacked_ms = timing.per_call_ms(lambda: _run(s_parts, b_parts, mesh, pallas), devices,
                                    calls=reps, warmup=warmup) / stack
    lat = timing.sync_latency_ms(lambda: _run(a_parts, b_parts, mesh, pallas), devices,
                                 samples=max(1, min(iters, 20)), warmup=warmup)
    flops = 2.0 * m * k * n
    res = {
        "M": m, "K": k, "N": n, "dtype": dtype, "mesh": f"{rows}x{cols}",
        "kernel": "pallas" if pallas else "xla",
        "device": _device_name(devices[0]),
        "verified": bool(ok),
        "avg_us": float(avg_ms * 1e3),
        "stacked_avg_us": float(stacked_ms * 1e3),
        "sync_p50_us": float(np.median(lat) * 1e3),
        "sync_max_us": float(lat.max() * 1e3),
        "gflops_dispatch": float(flops / (avg_ms * 1e-3) / 1e9),
        "gflops_sustained": float(flops / (stacked_ms * 1e-3) / 1e9),
    }
    if not quiet:
        print(f"GEMM {m}x{k}x{n} {dtype} mesh={rows}x{cols} "
              f"({res['kernel']}) on {res['device']} verified={ok}")
        print(f"per pass: {res['avg_us']:.1f} us one call per pass, "
              f"{res['stacked_avg_us']:.1f} us at {stack} passes a call "
              f"(sync round trip p50 {res['sync_p50_us']:.1f} us)")
        print(f"GFLOPs: {res['gflops_dispatch']:.1f} one call per pass, "
              f"{res['gflops_sustained']:.1f} stacked "
              f"(reference AIE: ~100-675/pass, typ. 400-600, int16 4x4 array)")
    return res


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-M", type=int, default=128)
    p.add_argument("-K", type=int, default=128)
    p.add_argument("-N", type=int, default=10240)
    p.add_argument("--dtype", default="int8", choices=["int8", "bf16", "fp32"])
    p.add_argument("--rows", type=int, default=None)
    p.add_argument("--cols", type=int, default=None)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--pallas", action=argparse.BooleanOptionalAction, default=True,
                   help="the local product through kernel K8 (else a plain product)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stack", type=int, default=16,
                   help="passes fused into one call for the stacked number")
    args = p.parse_args(argv)
    run(args.M, args.K, args.N, args.dtype, args.rows, args.cols,
        args.iters, pallas=args.pallas, seed=args.seed, stack=args.stack)


if __name__ == "__main__":
    main()
