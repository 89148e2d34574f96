"""Symmetric int8 quantization (counterpart: ``rag_on_edge_tpu/ops/quantize.py``).

    x_i8 = clip(round(x / scale), -127, 127),  scale = max|x| / 127

Rounding is half-to-even in both frameworks, and each step is one fp32
operation in the JAX order, so the int8 values are bit-equal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["QuantizedTensor", "calibrate_scale", "calibrate_scale_from_sample",
           "quantize_int8", "dequantize"]

# torch.quantile refuses inputs above this many elements.
_QUANTILE_MAX = 1 << 24


class QuantizedTensor(NamedTuple):
    """``quantize_int8``'s result, as the JAX package's: it unpacks as
    ``values, scale``."""
    values: torch.Tensor  # int8
    scale: torch.Tensor   # f32 scalar (per-tensor) or [rows, 1] (per-row)

    @property
    def shape(self):
        return self.values.shape


def calibrate_scale(x: torch.Tensor, per_row: bool = False) -> torch.Tensor:
    """Symmetric scale(s) so that max|x| maps to 127 (fp32)."""
    if per_row:
        amax = x.abs().amax(dim=-1, keepdim=True)
    else:
        amax = x.abs().amax()
    return torch.clamp_min(amax.to(torch.float32), 1e-12) / 127.0


def calibrate_scale_from_sample(sample: torch.Tensor, percentile: float = 100.0) -> torch.Tensor:
    """Activation calibration from a representative sample: max|sample| at
    ``percentile >= 100``, else its ``percentile``-th percentile with
    linear interpolation (``jnp.percentile``'s default), over 127.  Inputs
    too large for ``torch.quantile`` take the same two order statistics
    from a sort."""
    mag = sample.to(torch.float32).abs().reshape(-1)
    if percentile >= 100.0:
        amax = mag.amax()
    elif mag.numel() <= _QUANTILE_MAX:
        amax = torch.quantile(mag, percentile / 100.0)
    else:
        pos = (mag.numel() - 1) * (percentile / 100.0)
        lo = int(pos)
        srt = torch.sort(mag).values
        hi = min(lo + 1, mag.numel() - 1)
        amax = srt[lo] + (srt[hi] - srt[lo]) * (pos - lo)
    return torch.clamp_min(amax, 1e-12) / 127.0


def quantize_int8(x: torch.Tensor, scale: torch.Tensor | None = None,
                  per_row: bool = False) -> QuantizedTensor:
    """Quantize to symmetric int8 → ``QuantizedTensor(values, scale)``;
    computes the calibration scale if not given."""
    if scale is None:
        scale = calibrate_scale(x, per_row=per_row)
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)
    return QuantizedTensor(q.to(torch.int8), scale)


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
