"""Kernel K3: fused brute-force top-k, a streaming score GEMM with a running
per-query selection (counterpart:
``rag_on_edge_tpu/ops/pallas_bruteforce.py::fused_topk_matmul``).

Queries [B, D] are scored against the transposed base ``base_t`` [D, N]::

    scores = dots                         int8 (int32 dots) or fp32 / bf16
    scores = float(dots)·alpha[row] − bias[col]     int8 L2 (f32, rounded
                                          once, as XLA's fused multiply-add)

and columns at or past ``n_valid`` (default N) hold the fill value (the
int32 minimum, or -inf).  The result is the top-k of each row, best first,
ties to the lowest column id:

- ``nbins=0``: exact.
- ``nbins>0``: the columns are cut into tiles of ``tile_n`` (from
  :func:`auto_tile_n` unless given, as the JAX wrapper picks it); within a
  tile only the two best of each strided bin ``col % nbins`` survive
  (:func:`topk.binned_top2`), and the top-k is taken over the survivors of
  all tiles.  Which candidates survive depends on ``tile_n``, so it is
  computed exactly as the JAX wrapper computes it.

Only entries above the fill value carry meaning; the ids of fill entries
(fewer than k valid columns) are unspecified, as K4's are.

:func:`fused_topk_matmul` dispatches on the device of its inputs: CPU
tensors take :func:`fused_topk_matmul_reference`, CUDA tensors launch
``csrc/bruteforce_fused.cu`` (int8, int8 L2, and fp32 or bf16 with queries
and base in one dtype; bf16 on the tensor cores, ``wgmma`` fed by TMA) or
raise.
"""

from __future__ import annotations

import ctypes

import torch

from rag_on_edge_tpu_torch.ops import _build, distances, topk

__all__ = ["LAUNCHES", "auto_tile_n", "fused_topk_matmul", "fused_topk_matmul_reference"]

#: Launches of the CUDA kernel in this process; the plain version does not
#: count.  A run that must show it went through the kernel sets it to 0
#: before and reads it after.
LAUNCHES = 0

# What the CUDA kernel takes: a running top-k of at most 32 per row (one
# per lane of the merging warp), bins of 128 (one per lane of a row group),
# and the query rows resident in shared memory beside the candidate buffers.
_CUDA_K_MAX = 32
_CUDA_NBINS = 128
_CUDA_DIM_MAX = 512
# The bf16 kernel's binned table names a column's chunk within its tile in
# one byte: at most 256 chunks of 128.
_CUDA_BF16_TILE_MAX = 256 * 128
_MODES = {"i8": 0, "i8_l2": 1, "f32": 2}  # bf16 has its own entry

_FN = None
_BF16_FN = None


def auto_tile_n(b: int, n: int, acc_bytes: int = 4, base_bytes: int = 1) -> int:
    """The JAX wrapper's tile width: the largest multiple of 512 (at most
    16384) whose ``b × tile_n`` score tile fits a TPU VMEM budget of 6 MB
    for int8 bases, 3 MB for 2-byte and 2 MB for 4-byte ones.  Kept here
    because it decides which candidates the binned mode keeps."""
    budget = {1: 6 << 20, 2: 3 << 20}.get(base_bytes, 2 << 20)
    t = budget // max(b * acc_bytes, 1)
    t = min(int(t), 16384, max(n, 512))
    return max(512, (t // 512) * 512)


def _resolve(queries, base_t, k, tile_n, tile_b, nbins, alpha, bias):
    """The JAX wrapper's checks and its choice of tile_n → (b, d, n,
    int_path, l2, tile_n)."""
    if (alpha is None) != (bias is None):
        raise ValueError("alpha and bias must be passed together")
    if queries.dim() != 2 or base_t.dim() != 2:
        raise ValueError(f"queries must be [B, D] and base_t [D, N], got "
                         f"{tuple(queries.shape)} and {tuple(base_t.shape)}")
    d, n = base_t.shape
    b = queries.shape[0]
    if queries.shape[1] != d:
        raise ValueError(f"dim mismatch: queries D={queries.shape[1]} vs base D={d}")
    if n < k:
        raise ValueError(f"k={k} > N={n}")
    int_path = base_t.dtype == torch.int8
    if int_path and queries.dtype != torch.int8:
        raise ValueError("int8 base requires int8 queries")
    if not int_path and (base_t.dtype not in (torch.float32, torch.bfloat16)
                         or queries.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"unsupported dtypes {queries.dtype} x {base_t.dtype}")
    l2 = bias is not None
    if l2 and (tuple(alpha.reshape(-1).shape) != (b,) or tuple(bias.reshape(-1).shape) != (n,)):
        raise ValueError(f"alpha must hold B={b} and bias N={n} values")
    if tile_b is None:
        g = 32 if int_path else 8
        tile_b = min(-(-b // g) * g, 256)
    if tile_n is None:
        tile_n = auto_tile_n(tile_b, n, 4, base_t.element_size())
        if alpha is not None and tile_n > 512:
            tile_n -= 512  # the JAX wrapper's L2 VMEM margin
    if nbins and tile_n % nbins:
        raise ValueError(f"tile_n={tile_n} must be a multiple of nbins={nbins}")
    return b, d, n, int_path, l2, tile_n


def fused_topk_matmul_reference(queries, base_t, k, tile_n=None, tile_b=None, nbins=0,
                                n_valid=None, alpha=None, bias=None):
    """Plain PyTorch K3, for every mode the JAX function takes → (vals
    [B, k], ids [B, k] int32).  It scores the whole [B, N] matrix at once;
    the JAX kernel's per-tile merges and its ``improves`` skip are left out,
    as neither changes an entry above the fill value (tiles come in
    ascending id order and ties go to the lowest id)."""
    b, d, n, int_path, l2, tile_n = _resolve(queries, base_t, k, tile_n, tile_b, nbins,
                                             alpha, bias)
    dev = queries.device
    if int_path:
        scores = distances.score_matrix_int8(queries, base_t.T)
    else:
        # bf16 products are exact in fp32, as the kernel's f32 accumulation.
        scores = queries.to(torch.float32) @ base_t.to(torch.float32)
    if l2:
        scores = distances.mul_sub(scores.to(torch.float32),
                                   alpha.to(torch.float32).reshape(-1, 1),
                                   bias.to(torch.float32).reshape(1, -1))
    fill = topk.fill_value(scores.dtype)
    cols = torch.arange(n, device=dev)
    bound = n if n_valid is None else torch.as_tensor(n_valid, device=dev).reshape(())
    scores = torch.where(cols[None, :] < bound, scores, torch.full_like(scores, fill))
    if not nbins:
        return topk.extract_topk(scores, k)
    n_tiles = -(-n // tile_n)
    scores = torch.nn.functional.pad(scores, (0, n_tiles * tile_n - n), value=fill)
    row0 = (torch.arange(n_tiles, dtype=torch.int32, device=dev) * tile_n)[None, :]
    tv, ti = topk.binned_top2(scores.reshape(b, n_tiles, tile_n), row0, tile_n, nbins, fill)
    return topk.extract_topk_ids(tv.reshape(b, -1), ti.reshape(b, -1), k, fill)


def _kernel():
    """Build/load the CUDA library once and declare the C entry's types."""
    global _FN
    if _FN is None:
        fn = _build.load_library("bruteforce_fused").bruteforce_fused_topk
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _bf16_kernel():
    """Build/load the CUDA library once and declare the bf16 entry's types."""
    global _BF16_FN
    if _BF16_FN is None:
        fn = _build.load_library("bruteforce_fused").bruteforce_fused_topk_bf16
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BF16_FN = fn
    return _BF16_FN


def fused_topk_matmul(queries, base_t, k, tile_n=None, tile_b=None, nbins=0,
                      n_valid=None, alpha=None, bias=None):
    """K3 with the JAX signature → (vals [B, k], ids [B, k] int32), best
    first; vals are int32 on the int8 path and f32 in L2 mode and for float
    inputs.  See the module docstring.

    ``n_valid``: optional 1-element int32 tensor, the count of valid
    leading columns (at most N).  ``alpha`` [B] / ``bias`` [N]: the int8 L2
    mode (both or neither).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (int8 ± L2, and fp32 or bf16 with queries
    and base_t in one dtype; nbins 0 or 128, k <= 32, D <= 512) or raise."""
    global LAUNCHES
    dev = queries.device
    if dev.type == "cpu":
        return fused_topk_matmul_reference(queries, base_t, k, tile_n=tile_n, tile_b=tile_b,
                                           nbins=nbins, n_valid=n_valid, alpha=alpha,
                                           bias=bias)
    b, d, n, int_path, l2, tile_n = _resolve(queries, base_t, k, tile_n, tile_b, nbins,
                                             alpha, bias)
    if l2:
        alpha = alpha.to(torch.float32).reshape(-1).contiguous()
        bias = bias.to(torch.float32).reshape(-1).contiguous()
    if n_valid is not None:
        n_valid = torch.as_tensor(n_valid, dtype=torch.int32, device=dev).reshape(1)
    _build.check_inputs("K3", dev, [queries, base_t, alpha if l2 else None,
                                    bias if l2 else None, n_valid])
    if not int_path:
        _build.check_float("K3", queries, base_t, d, _CUDA_DIM_MAX)
    if nbins not in (0, _CUDA_NBINS) or k > _CUDA_K_MAX or d > _CUDA_DIM_MAX:
        raise ValueError(
            f"the CUDA K3 takes nbins 0 or {_CUDA_NBINS}, k <= {_CUDA_K_MAX} and D <= "
            f"{_CUDA_DIM_MAX}; got nbins={nbins}, k={k}, D={d}")
    if int_path:
        mode = "i8_l2" if l2 else "i8"
    else:
        mode = "bf16" if base_t.dtype == torch.bfloat16 else "f32"
    if mode == "bf16" and nbins and tile_n > _CUDA_BF16_TILE_MAX:
        raise ValueError(f"the CUDA K3 takes bf16 binned tiles up to {_CUDA_BF16_TILE_MAX} "
                         f"columns; got tile_n={tile_n}")
    vals = torch.empty((b, k), dtype=torch.int32 if mode == "i8" else torch.float32,
                       device=dev)
    ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    nv_ptr = n_valid.data_ptr() if n_valid is not None else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if mode == "bf16":
            # TMA takes rows of whole 16-byte units: the queries' rows are
            # padded to whole k16 steps (the pad zero), and base_t is copied
            # only where its row pitch is not a multiple of 8 elements.
            ldq, ldb = -(-d // 16) * 16, -(-n // 8) * 8
            qp = torch.nn.functional.pad(queries, (0, ldq - d)).contiguous()
            bp = base_t if ldb == n else torch.nn.functional.pad(base_t, (0, ldb - n))
            bp = _build.aligned(bp, 16)
            err = _bf16_kernel()(qp.data_ptr(), bp.data_ptr(), nv_ptr, vals.data_ptr(),
                                 ids.data_ptr(), b, d, ldq, n, ldb, k, tile_n, nbins, stream)
        else:
            err = _kernel()(queries.data_ptr(), base_t.data_ptr(),
                            alpha.data_ptr() if l2 else None, bias.data_ptr() if l2 else None,
                            nv_ptr, vals.data_ptr(), ids.data_ptr(), b, d, n, k, tile_n, nbins,
                            _MODES[mode], stream)
    if err != 0:
        raise RuntimeError(f"bruteforce_fused_topk launch failed: CUDA error {err}")
    LAUNCHES += 1
    return vals, ids
