"""Score matrices (counterpart: ``rag_on_edge_tpu/ops/distances.py``).

Larger score = better match for both metrics: ``ip`` is q·b, ``l2`` is
``2·q·b − ‖b‖²`` (the row-constant ‖q‖² is dropped).  The GEMM is a plain
``torch.matmul`` in full fp32 (TF32 is off), as the JAX package leaves it
to XLA at ``Precision.HIGHEST``.
"""

from __future__ import annotations

import torch

__all__ = ["base_norms_sq", "mul_sub", "score_matrix", "score_matrix_int8"]

# fp32 holds every integer below 2**24 exactly, so an int8 dot over at most
# this many dimensions (|q·b| <= d·127²) is exact in an fp32 GEMM.
_F32_EXACT_DIM = (1 << 24) // (127 * 127)


def base_norms_sq(base: torch.Tensor) -> torch.Tensor:
    """Per-vector squared L2 norms ‖b‖² (fp32)."""
    b = base.to(torch.float32)
    return (b * b).sum(dim=-1)


def score_matrix(queries: torch.Tensor, base: torch.Tensor, metric: str = "ip",
                 base_norms: torch.Tensor | None = None,
                 compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Scores [B, N] for queries [B, D] against base [N, D], summed in fp32.
    ``compute_dtype`` (e.g. ``torch.bfloat16``) rounds the GEMM inputs
    first; their products are exact in fp32, as the JAX package's
    ``preferred_element_type=f32``."""
    q, b = queries, base
    if compute_dtype is not None:
        q, b = q.to(compute_dtype), b.to(compute_dtype)
    dots = q.to(torch.float32) @ b.to(torch.float32).T
    if metric == "ip":
        return dots
    if metric == "l2":
        if base_norms is None:
            base_norms = base_norms_sq(base)
        return 2.0 * dots - base_norms[None, :]
    raise ValueError(f"unknown metric {metric!r}")


def mul_sub(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x·a − b`` in fp32 with one rounding, as a fused multiply-add gives
    it: XLA contracts the JAX package's ``x * a - b`` into one (checked on
    the CPU backend).  Taken in fp64 and rounded to fp32: the fp64 step is
    exact wherever x·a − b fits 53 bits, as it does for int8 dots (below
    2**24) times a scale, minus a norm within 2**29 of that scale."""
    return (x.to(torch.float64) * a.to(torch.float64) - b.to(torch.float64)).to(torch.float32)


def score_matrix_int8(queries_i8: torch.Tensor, base_i8: torch.Tensor) -> torch.Tensor:
    """Exact int32 inner products [B, N] of int8 queries [B, D] and int8 base
    [N, D].  ``torch.mm`` on int8 returns int8 and wraps, so the CPU sums
    in int32; CUDA has no int32 GEMM, so it sums slices of at most
    ``_F32_EXACT_DIM`` dimensions in fp32 (exact there) and adds them in
    int32."""
    if queries_i8.device.type == "cpu":
        return queries_i8.to(torch.int32) @ base_i8.to(torch.int32).T
    out = None
    for s in range(0, queries_i8.shape[1], _F32_EXACT_DIM):
        part = (queries_i8[:, s:s + _F32_EXACT_DIM].to(torch.float32)
                @ base_i8[:, s:s + _F32_EXACT_DIM].to(torch.float32).T).to(torch.int32)
        out = part if out is None else out + part
    return out
