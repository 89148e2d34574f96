"""Kernel K2: exact wide-row top-k (counterpart: ``rag_on_edge_tpu/ops/pallas_topk.py::fused_topk``).

k max-and-mask passes over each row of ``x`` [B, W], ties to the lowest
position, the JAX kernel's algorithm.  :func:`fused_topk` dispatches on the
device of ``x``: a CPU tensor takes :func:`fused_topk_reference`, a CUDA
tensor launches the CUDA kernel in ``csrc/fused_topk.cu`` (one warp a row,
the row in shared memory) or raises.  A row wider than the kernel holds
(16384) goes through :func:`segmented_topk`: the kernel on each segment,
then on the concatenation of the segments' winners.
"""

from __future__ import annotations

import ctypes

import torch

from rag_on_edge_tpu_torch.ops import _build, topk

__all__ = ["LAUNCHES", "fused_topk", "fused_topk_reference", "segmented_topk"]

#: Launches of the CUDA kernel in this process; the plain version does not
#: count.
LAUNCHES = 0

# The widest row the CUDA kernel holds in a warp's shared memory (64 KB):
# a wider row is cut into segments of this width.
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


def segmented_topk(x: torch.Tensor, k: int, topk_fn, seg: int = _CUDA_W_MAX):
    """The top-k of ``x`` [B, W] by ``topk_fn`` (the kernel, or the plain
    version) on rows of at most ``seg`` columns → (vals [B, k], idx [B, k]
    int32), as :func:`fused_topk_reference` returns them.  Past ``seg``
    columns, ``topk_fn`` takes each segment of ``seg`` columns (a view: the
    kernel reads it in place), then, recursively, the concatenation of the
    segments' winners (padded with the fill value to a multiple of 128), and
    the winners' positions map back.  Equal values leave a segment in
    position order and the segments lie in column order, so ties stay on
    the lowest position.  Once a row holds fewer than k values above the
    fill value, the passes over the whole row return the fill value at
    position 0; so does this."""
    b, w = x.shape
    if w <= seg:
        return topk_fn(x, k)
    fill = topk.fill_value(x.dtype)
    vals, pos = [], []
    for s in range(0, w, seg):
        v, i = topk_fn(x[:, s:s + seg], min(k, seg, w - s))
        vals.append(v)
        pos.append(i + s)
    cv, cp = torch.cat(vals, dim=1), torch.cat(pos, dim=1)
    pad = -cv.shape[1] % 128
    if pad:
        cv = torch.nn.functional.pad(cv, (0, pad), value=fill)
        cp = torch.nn.functional.pad(cp, (0, pad))
    if cv.shape[1] >= w:
        raise ValueError(f"k={k} leaves the winners of W={w} in {seg}-column segments no "
                         f"narrower than the row")
    mv, mi = segmented_topk(cv, k, topk_fn, seg)
    idx = torch.gather(cp, 1, mi.long())
    return mv, torch.where(mv == fill, torch.zeros_like(idx), idx)


def _entry():
    """Build/load ``csrc/fused_topk.cu`` once and declare its C entry."""
    global _FN
    if _FN is None:
        fn = _build.load_library("fused_topk").fused_topk_rows
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _launch(x: torch.Tensor, k: int):
    """One launch of the kernel on ``x`` [B, W] (W <= 16384), rows at any
    pitch that keeps them on 16-byte boundaries (a column segment of a wider
    matrix is read in place)."""
    global LAUNCHES
    b, w = x.shape
    if x.stride(1) != 1 or x.stride(0) % 4 or x.data_ptr() % 16:
        x = _build.aligned(x.contiguous(), 16)
    # One allocation for both outputs, and the device made current inside
    # the C entry: the join calls this once a batch on a host-bound path.
    out = torch.empty((2, b, k), dtype=torch.int32, device=x.device)
    vals, idx = out[0].view(x.dtype), out[1]
    if b:
        err = _entry()(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), b, w, k, x.stride(0),
                       int(x.dtype == torch.float32), x.device.index,
                       torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"fused_topk_rows launch failed: CUDA error {err}")
        LAUNCHES += 1
    return vals, idx


def fused_topk(x: torch.Tensor, k: int):
    """Exact top-k along axis 1 of ``x`` [B, W] (int32 or float32; W a
    multiple of 128) → (vals [B, k], idx [B, k] int32 positions), best
    first, ties to the lowest position.  On the card a row wider than 16384
    goes through :func:`segmented_topk`, a launch a segment and one (or
    more) for the merge."""
    if x.device.type == "cpu":
        return fused_topk_reference(x, k)
    _check(x, k)
    _build.check_inputs("K2", x.device, [x])
    return segmented_topk(x, k, _launch)
