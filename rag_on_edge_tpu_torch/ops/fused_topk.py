"""Kernel K2: exact wide-row top-k (counterpart: ``rag_on_edge_tpu/ops/pallas_topk.py::fused_topk``).

k max-and-mask passes over each row of ``x`` [B, W], ties to the lowest
position, the JAX kernel's algorithm.  :func:`fused_topk` dispatches on the
device of ``x``: a CPU tensor takes :func:`fused_topk_reference`, a CUDA
tensor launches the Triton kernel in ``csrc/fused_topk_triton.py`` or
raises.
"""

from __future__ import annotations

import importlib.util
import sys

import torch

from rag_on_edge_tpu_torch.ops import _build, topk

__all__ = ["LAUNCHES", "fused_topk", "fused_topk_reference"]

#: Launches of the Triton kernel in this process; the plain version does
#: not count.
LAUNCHES = 0

_KERNEL = None
_BLOCK_B = 4


def _check(x: torch.Tensor, k: int) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be [B, W], got {tuple(x.shape)}")
    b, w = x.shape
    if w % 128 or w < 128:
        raise ValueError(f"W={w} must be a positive multiple of 128")
    if k > w or k < 1:
        raise ValueError(f"k={k} must be in [1, W={w}]")
    if x.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"fused_topk takes int32 or float32, got {x.dtype}")


def fused_topk_reference(x: torch.Tensor, k: int):
    """Plain PyTorch K2 → (vals [B, k], idx [B, k] int32), best first."""
    _check(x, k)
    return topk.extract_topk(x, k)


def _kernel():
    """Load the Triton source once (triton is imported only here)."""
    global _KERNEL
    if _KERNEL is None:
        path = _build.CSRC_DIR / "fused_topk_triton.py"
        spec = importlib.util.spec_from_file_location(
            "rag_on_edge_tpu_torch_fused_topk_triton", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _KERNEL = mod.fused_topk_kernel
    return _KERNEL


def fused_topk(x: torch.Tensor, k: int):
    """Exact top-k along axis 1 of ``x`` [B, W] (int32 or float32; W a
    multiple of 128) → (vals [B, k], idx [B, k] int32 positions), best
    first, ties to the lowest position."""
    global LAUNCHES
    if x.device.type == "cpu":
        return fused_topk_reference(x, k)
    _check(x, k)
    _build.check_inputs("K2", x.device, [x])
    b, w = x.shape
    vals = torch.empty((b, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((b, k), dtype=torch.int32, device=x.device)
    if b:
        w_p2 = 1 << (w - 1).bit_length()
        grid = (-(-b // _BLOCK_B),)
        with torch.cuda.device(x.device):
            _kernel()[grid](x, vals, idx, b, w, K=k, BLOCK_B=_BLOCK_B, W_P2=w_p2,
                            IS_FLOAT=x.dtype == torch.float32, num_warps=4)
        LAUNCHES += 1
    return vals, idx
