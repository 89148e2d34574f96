"""Kernel K8: the tiled GEMM of the spatial GEMM
(counterpart: ``rag_on_edge_tpu/ops/pallas_matmul.py::tiled_matmul``).

    C[M, N] = A[M, K] @ B[K, N]     int8 → int32 (exact), bf16 → f32, f32 → f32

The TPU kernel runs an (M/bm, N/bn, K/bk) grid and carries an accumulator
over the K steps.  :func:`tiled_matmul` dispatches on the device of its
inputs: CPU tensors take :func:`tiled_matmul_reference`, CUDA tensors
launch ``csrc/tiled_matmul.cu`` or raise; there is no fallback.  bf16
runs on ``wgmma`` fed by a TMA ring, int8 on ``mma.sync`` tiles, f32 on a
``cp.async``-pipelined FFMA tile (no TF32, no tensor cores).  The launches
count by mode in ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rag_on_edge_tpu_torch.ops import _build

__all__ = ["LAUNCHES", "kernel_operands", "tiled_matmul", "tiled_matmul_reference"]

#: Launches of the CUDA kernel K8 in this process, by mode (one kernel
#: each); the plain version does not count.  A run that must show it went
#: through the kernel sets them to 0 before and reads them after.
LAUNCHES = {"int8": 0, "bf16": 0, "fp32": 0}

_DTYPES = (torch.int8, torch.bfloat16, torch.float32)
_MODES = {torch.int8: "int8", torch.bfloat16: "bf16", torch.float32: "fp32"}
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


def _kernel(mode: str):
    """Build/load the CUDA library once and declare one mode's C entry."""
    if mode not in _FNS:
        fn = getattr(_build.load_library("tiled_matmul"), f"tiled_matmul_{mode}")
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[mode] = fn
    return _FNS[mode]


def kernel_operands(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A and B as the CUDA kernels take them: K zero-padded so that A's row
    pitch is a multiple of 16 bytes and N so that B's is one of ``b_bytes``,
    A's base 16-byte aligned and B's ``b_bytes``-aligned.  ``b_bytes`` is 16
    for the float modes (TMA's rule for bf16, ``cp.async``'s 16-byte copies
    for f32) and 4 for int8, whose tiles load 16 bytes of A a row but B a
    32-bit word at a time.  The zeros add nothing to the product, so
    ``a' @ b'`` restricted to ``[:, :N]`` is ``a @ b``.  Operands that
    already comply come back as they are."""
    es = a.element_size()
    b_bytes = 4 if a.dtype == torch.int8 else 16
    kpad, npad = (-a.shape[1]) % (16 // es), (-b.shape[1]) % (b_bytes // es)
    if kpad:
        a = F.pad(a, (0, kpad))
        b = F.pad(b, (0, 0, 0, kpad))
    if npad:
        b = F.pad(b, (0, npad))
    return _build.aligned(a, 16), _build.aligned(b, b_bytes)


def tiled_matmul(a: torch.Tensor, b: torch.Tensor, bm: int = 256, bn: int = 512,
                 bk: int = 512) -> torch.Tensor:
    """K8 with the JAX signature → C [M, N] int32 (int8 inputs) or f32.

    CPU tensors take the plain version.  CUDA tensors (contiguous, on one
    device) launch the kernel of their dtype, whose tiles are its own
    (``bm``/``bn``/``bk`` are the TPU's and are not used), on the operands
    :func:`kernel_operands` gives; C is written at [M, N] directly."""
    acc = _check(a, b)
    dev = a.device
    if dev.type == "cpu":
        if b.device != dev:
            raise ValueError("all K8 inputs must be on one device")
        return tiled_matmul_reference(a, b, bm, bn, bk)
    _build.check_inputs("K8", dev, [a, b])
    m, n = a.shape[0], b.shape[1]
    out = torch.empty((m, n), dtype=acc, device=dev)
    mode = _MODES[a.dtype]
    a, b = kernel_operands(a, b)
    fn = _kernel(mode)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, a.shape[1], b.shape[1],
                 stream)
    if err != 0:
        raise RuntimeError(f"tiled_matmul ({mode}) launch failed: CUDA error {err}")
    LAUNCHES[mode] += 1
    return out
