"""Kernel K8: the tiled GEMM of the spatial GEMM
(counterpart: ``rag_on_edge_tpu/ops/pallas_matmul.py::tiled_matmul``).

    C[M, N] = A[M, K] @ B[K, N]     int8 → int32 (exact), bf16 → f32, f32 → f32

The TPU kernel runs an (M/bm, N/bn, K/bk) grid and carries an accumulator
over the K steps.  :func:`tiled_matmul` dispatches on the device of its
inputs: CPU tensors take :func:`tiled_matmul_reference`, CUDA tensors
launch ``csrc/tiled_matmul.cu`` (tensor-core ``mma.sync`` tiles for int8
and bf16, FFMA for f32, no TF32) or raise; there is no fallback.  The
launches count in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rag_on_edge_tpu_torch.ops import _build

__all__ = ["LAUNCHES", "tiled_matmul", "tiled_matmul_reference"]

#: Launches of the CUDA kernel K8 in this process; the plain version does
#: not count.  A run that must show it went through the kernel sets it to 0
#: before and reads it after.
LAUNCHES = 0

_DTYPES = (torch.int8, torch.bfloat16, torch.float32)
# int8 products are at most 128² = 2**14 in magnitude, so an fp32 sum over
# at most 2**10 of them is an integer below 2**24: exact in any order.
_I8_EXACT_K = 1024

_FNS: dict[str, object] = {}


def _check(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    """The JAX function's checks (and the dtypes it takes) → the
    accumulator dtype."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"expected A [M, K] and B [K, N], got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: {a.shape[1]} vs {b.shape[0]}")
    if a.dtype != b.dtype:
        raise ValueError(f"dtype mismatch: {a.dtype} vs {b.dtype}")
    if a.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {a.dtype} (int8, bfloat16 or float32)")
    return torch.int32 if a.dtype == torch.int8 else torch.float32


def tiled_matmul_reference(a: torch.Tensor, b: torch.Tensor, bm: int = 256, bn: int = 512,
                           bk: int = 512) -> torch.Tensor:
    """Plain PyTorch K8, as the Pallas body computes it: a loop over K
    tiles of ``min(bk, K)``, each an fp32 product added into an int32
    (int8) or f32 accumulator.  The int8 tiles are cut to at most 1024
    rows of K, which keeps every fp32 partial sum exact.  ``bm`` and ``bn``
    tile only the TPU's grid and change no value here."""
    acc = _check(a, b)
    m, k = a.shape
    n = b.shape[1]
    out = torch.zeros((m, n), dtype=acc, device=a.device)
    step = max(1, min(bk, k))
    if a.dtype == torch.int8:
        step = min(step, _I8_EXACT_K)
    for k0 in range(0, k, step):
        part = a[:, k0:k0 + step].to(torch.float32) @ b[k0:k0 + step].to(torch.float32)
        out += part.to(acc)
    return out


def _kernel(name: str):
    """Build/load the CUDA library once and declare one C entry's types."""
    if name not in _FNS:
        fn = getattr(_build.load_library("tiled_matmul"), f"tiled_matmul_{name}")
        nint = 3 if name == "f32" else 4
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * nint + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def tiled_matmul(a: torch.Tensor, b: torch.Tensor, bm: int = 256, bn: int = 512,
                 bk: int = 512) -> torch.Tensor:
    """K8 with the JAX signature → C [M, N] int32 (int8 inputs) or f32.

    CPU tensors take the plain version.  CUDA tensors (contiguous, on one
    device) launch the kernel, whose tiles are its own (128 x 128 of C, 64
    bytes of K a step; ``bm``/``bn``/``bk`` are the TPU's and are not
    used).  For int8 and bf16 the wrapper zero-pads K to a multiple of 16
    bytes and B's rows to a multiple of 4 bytes where they are not, so the
    kernel's loads are aligned; C is written at [M, N] directly."""
    global LAUNCHES
    acc = _check(a, b)
    dev = a.device
    if dev.type == "cpu":
        if b.device != dev:
            raise ValueError("all K8 inputs must be on one device")
        return tiled_matmul_reference(a, b, bm, bn, bk)
    _build.check_inputs("K8", dev, [a, b])
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=acc, device=dev)
    if a.dtype == torch.float32:
        fn, args = _kernel("f32"), (a, b, m, n, k)
    else:
        es = a.element_size()
        kpad = (-k) % (16 // es)
        npad = (-n) % (4 // es)
        if kpad:
            a = F.pad(a, (0, kpad))
            b = F.pad(b, (0, 0, 0, kpad))
        if npad:
            b = F.pad(b, (0, npad))
        a, b = _build.aligned(a, 16), _build.aligned(b, 4)
        fn = _kernel("i8" if a.dtype == torch.int8 else "bf16")
        args = (a, b, m, n, k + kpad, n + npad)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(args[0].data_ptr(), args[1].data_ptr(), out.data_ptr(), *args[2:], stream)
    if err != 0:
        raise RuntimeError(f"tiled_matmul launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
