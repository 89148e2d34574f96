"""Symmetric int8 quantization (counterpart: ``rag_on_edge_tpu/ops/quantize.py``).

    x_i8 = clip(round(x / scale), -127, 127),  scale = max|x| / 127

Rounding is half-to-even in both frameworks, and each step is one fp32
operation in the JAX order, so the int8 values are bit-equal.
"""

from __future__ import annotations

import torch

__all__ = ["calibrate_scale", "quantize_int8", "dequantize"]


def calibrate_scale(x: torch.Tensor, per_row: bool = False) -> torch.Tensor:
    """Symmetric scale(s) so that max|x| maps to 127 (fp32)."""
    if per_row:
        amax = x.abs().amax(dim=-1, keepdim=True)
    else:
        amax = x.abs().amax()
    return torch.clamp_min(amax.to(torch.float32), 1e-12) / 127.0


def quantize_int8(x: torch.Tensor, scale: torch.Tensor | None = None,
                  per_row: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize to symmetric int8 → (values int8, scale); computes the
    calibration scale if not given."""
    if scale is None:
        scale = calibrate_scale(x, per_row=per_row)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize(scores_i32: torch.Tensor, query_scale: torch.Tensor,
               base_scale: torch.Tensor) -> torch.Tensor:
    """int32 inner-product scores [B, N] → fp32, times ``query_scale *
    base_scale`` (that product first, as the JAX package does).
    ``query_scale`` may be per-row [B, 1]; ``base_scale`` must be one
    scalar: a per-row base scale would need an outer product and would
    silently scale the wrong axis when B == N."""
    base_scale = torch.as_tensor(base_scale, dtype=torch.float32, device=scores_i32.device)
    if base_scale.dim() and base_scale.numel() != 1:
        raise ValueError(
            f"base_scale must be scalar (one global base scale); got shape "
            f"{tuple(base_scale.shape)} — per-row base scales need an outer "
            "product with the query scales")
    return scores_i32.to(torch.float32) * (query_scale * base_scale)
