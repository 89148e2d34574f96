"""Kernel K2: exact wide-row top-k (counterpart: ``rag_on_edge_tpu/ops/pallas_topk.py::fused_topk``).

k max-and-mask passes over each row of ``x`` [B, W], ties to the lowest
position, the JAX kernel's algorithm.  :func:`fused_topk` dispatches on the
device of ``x``: a CPU tensor takes :func:`fused_topk_reference`, a CUDA
tensor launches the CUDA kernel in ``csrc/fused_topk.cu`` (one warp a row,
the row in shared memory; W up to 16384) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from rag_on_edge_tpu_torch.ops import _build, topk

__all__ = ["LAUNCHES", "fused_topk", "fused_topk_reference"]

#: Launches of the CUDA kernel in this process; the plain version does not
#: count.
LAUNCHES = 0

# The widest row the CUDA kernel holds in a warp's shared memory (64 KB).
_CUDA_W_MAX = 16384

_FN = None


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


def _entry():
    """Build/load ``csrc/fused_topk.cu`` once and declare its C entry."""
    global _FN
    if _FN is None:
        fn = _build.load_library("fused_topk").fused_topk_rows
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def fused_topk(x: torch.Tensor, k: int):
    """Exact top-k along axis 1 of ``x`` [B, W] (int32 or float32; W a
    multiple of 128) → (vals [B, k], idx [B, k] int32 positions), best
    first, ties to the lowest position.  On the card W <= 16384."""
    global LAUNCHES
    if x.device.type == "cpu":
        return fused_topk_reference(x, k)
    _check(x, k)
    _build.check_inputs("K2", x.device, [x])
    b, w = x.shape
    if w > _CUDA_W_MAX:
        raise ValueError(f"the CUDA K2 takes W <= {_CUDA_W_MAX} (one row in a warp's shared "
                         f"memory); got W={w}")
    # The row is copied by one bulk TMA copy from a 16-byte boundary.
    x = _build.aligned(x, 16)
    # One allocation for both outputs, and the device made current inside
    # the C entry: the join calls this once a batch on a host-bound path.
    out = torch.empty((2, b, k), dtype=torch.int32, device=x.device)
    vals, idx = out[0].view(x.dtype), out[1]
    if b:
        err = _entry()(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), b, w, k,
                       int(x.dtype == torch.float32), x.device.index,
                       torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"fused_topk_rows launch failed: CUDA error {err}")
        LAUNCHES += 1
    return vals, idx
