"""Kernel K5: brute-force search by packed max-accumulation (counterpart:
``rag_on_edge_tpu/ops/pallas_bruteforce_dma.py::fused_topk_accum``).

The base is block-tiled as ``base_tiles`` [T, D, tile_n] (:func:`tile_base`,
N padded to a multiple of ``tile_n·group``).  The ``tile_n`` lanes of a tile
are the selection bins: bin ``lane`` holds columns ``t·tile_n + lane``.
Per query row, each tile's score is packed into an int32 key whose low
``log2(group)`` bits name the tile within its group::

    key = (dots << shift) | code(t)          int8
    key = (dots << shift) - bias_rows[t]     int8 L2 (rows carry the code)
    key = (monotone_f32(dots) & ~(group-1)) | code(t)     fp32 / bf16

with ``code(t) = group-1-t % group`` (ties go to the earlier tile), and
keys of columns at or past ``n`` set to ``KMIN``.  Keys are max-folded over
each group; the group's best key, its low bits cleared, replaces a bin's
running best when strictly larger (ties keep the earlier group), and its
column is decoded from the code.  Finally one exact top-k over the
``tile_n`` bins, ties to the lowest column, gives (vals [B, k], ids [B, k]):
vals are the running keys shifted back (int32 dot units) on the int8 path
and the truncated f32 scores on the float path.

Per-bin top-1 loses a candidate whenever two of a row's true top-k share a
bin (column mod tile_n); callers rescore.

:func:`fused_topk_accum` dispatches on the device of its inputs: CPU
tensors take :func:`fused_topk_accum_reference`, CUDA tensors launch
``csrc/bruteforce_accum.cu`` (int8 ± bias rows; fp32 or bf16 with queries
and tiles in one dtype; any D; int8 and bf16 on the tensor cores, ``wgmma``
fed by TMA, int8 on the K-major copy of :func:`_build.kmajor_operands`) or
raise.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from rag_on_edge_tpu_torch.ops import _build, distances, topk

__all__ = ["KMIN", "LAUNCHES", "fused_topk_accum", "fused_topk_accum_reference",
           "l2_bias_rows", "tile_base", "tile_norms"]

KMIN = -(2**31) + 1  # the key of a masked column

#: Launches of the CUDA kernel in this process; the plain version does not
#: count.  A run that must show it went through the kernel sets it to 0
#: before and reads it after.
LAUNCHES = 0

# What the CUDA kernel takes: bins in 128-lane chunks, at most 2048 of them
# (the final top-k holds 8 per thread of one 256-thread CTA).
_CUDA_TILE_MAX = 2048

_FN = None
_FLOAT_FN = None
_BF16_FN = None


def tile_base(base_t, tile_n: int, depth: int):
    """[D, N] (a tensor or numpy array) → ([T, D, tile_n] block-tiled tensor
    copy, T); N is padded with zero columns to a multiple of
    ``tile_n·depth`` (masked by ``n``)."""
    base_t = torch.as_tensor(base_t)
    d, n = base_t.shape
    step = tile_n * depth
    pad = (-n) % step
    if pad:
        base_t = torch.nn.functional.pad(base_t, (0, pad))
    t = (n + pad) // tile_n
    return base_t.reshape(d, t, tile_n).permute(1, 0, 2).contiguous(), t


def tile_norms(norms, tile_n: int, group: int, fill: float = 2.0**24) -> np.ndarray:
    """[N] f32 → [T, 1, tile_n] tiled norms, padding filled with ``fill``
    (large and positive: a padded column can never win an L2 selection)."""
    norms = np.asarray(norms, np.float32)
    step = tile_n * group
    pad = (-norms.shape[0]) % step
    if pad:
        norms = np.pad(norms, (0, pad), constant_values=fill)
    return norms.reshape(-1, 1, tile_n)


def l2_bias_rows(norms_tiled: torch.Tensor, alpha, group: int) -> torch.Tensor:
    """Pre-shifted int32 bias rows of the int8 L2 mode, ``round(norms /
    alpha) · group − code(t)``, so that the kernel's pack is a shift and a
    subtraction: ``key = (dots − round(norms/alpha))·group + code``.

    ``norms_tiled`` [T, 1, tile_n] f32 (:func:`tile_norms`), ``alpha`` the
    scalar ``2·sq·sb``.  The quotient is clamped to ``2**30 >> shift``
    BEFORE the int cast, as the JAX package does: the padding fill over a
    small alpha would otherwise overflow int32, and a capped column still
    always loses."""
    t = norms_tiled.shape[0]
    shift = group.bit_length() - 1
    dev = norms_tiled.device
    code = (group - 1) - (torch.arange(t, dtype=torch.int32, device=dev) % group)
    cap = float((1 << 30) >> shift)
    bias = torch.clamp_max(torch.round(norms_tiled / alpha), cap).to(torch.int32)
    return bias * (1 << shift) - code[:, None, None]



def _monotone_key(x: torch.Tensor) -> torch.Tensor:
    """f32 → i32 order-preserving key (IEEE-754 total-order trick)."""
    m = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(m >= 0, m, m ^ 0x7FFFFFFF)


def _key_to_f32(kk: torch.Tensor) -> torch.Tensor:
    m = torch.where(kk >= 0, kk, kk ^ 0x7FFFFFFF)
    return m.contiguous().view(torch.float32)


def _check(queries, base_tiles, n, k, group, depth, bias_rows):
    if base_tiles.dim() != 3:
        raise ValueError(f"base_tiles must be [T, D, tile_n], got {tuple(base_tiles.shape)}")
    n_tiles, d, tile_n = base_tiles.shape
    if group & (group - 1) or group < 2:
        raise ValueError(f"group={group} must be a power of two >= 2")
    if group % depth:
        raise ValueError(f"group={group} must be a multiple of depth={depth}")
    if n_tiles % group:
        raise ValueError(f"n_tiles={n_tiles} must be a multiple of group={group}")
    if queries.dim() != 2 or queries.shape[1] != d:
        raise ValueError(f"dim mismatch: queries {tuple(queries.shape)} vs base D={d}")
    int_path = base_tiles.dtype == torch.int8
    if int_path and queries.dtype != torch.int8:
        raise ValueError("int8 base requires int8 queries")
    if not int_path and base_tiles.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {base_tiles.dtype}")
    l2 = bias_rows is not None
    if l2 and not int_path:
        raise ValueError("bias_rows is the int8-L2 path; float bases fold "
                         "norms into an augmented dimension instead")
    if l2 and (tuple(bias_rows.shape) != (n_tiles, 1, tile_n) or bias_rows.dtype != torch.int32):
        raise ValueError(f"bias_rows must be [{n_tiles}, 1, {tile_n}] int32, got "
                         f"{tuple(bias_rows.shape)} {bias_rows.dtype}")
    return n_tiles, d, tile_n, int_path, l2


def fused_topk_accum_reference(queries, base_tiles, n, k, tile_b=256, group=16, depth=8,
                               bias_rows=None):
    """Plain PyTorch K5, for every mode the JAX function takes → (vals,
    ids), the JAX kernel's fold tile by tile and group by group."""
    n_tiles, d, tile_n, int_path, l2 = _check(queries, base_tiles, n, k, group, depth,
                                              bias_rows)
    dev = queries.device
    b = queries.shape[0]
    shift = group.bit_length() - 1
    lane = torch.arange(tile_n, dtype=torch.int32, device=dev)
    rv = torch.full((b, tile_n), KMIN, dtype=torch.int32, device=dev)
    ri = torch.zeros((b, tile_n), dtype=torch.int32, device=dev)
    for g in range(n_tiles // group):
        acc = torch.full((b, tile_n), KMIN, dtype=torch.int32, device=dev)
        for j in range(group):
            t = g * group + j
            lo = t * tile_n
            if lo >= n:
                continue  # a padded tile: nothing to fold
            code = group - 1 - j
            if int_path:
                key = distances.score_matrix_int8(queries, base_tiles[t].T) * (1 << shift)
                key = key - bias_rows[t] if l2 else key | code
            else:
                dots = queries.to(torch.float32) @ base_tiles[t].to(torch.float32)
                key = (_monotone_key(dots) & ~(group - 1)) | code
            if lo + tile_n > n:
                key = torch.where(lane < n - lo, key, torch.full_like(key, KMIN))
            acc = torch.maximum(acc, key)
        code = acc & (group - 1)
        merge_key = acc ^ code
        col = (g * group + (group - 1) - code) * tile_n + lane
        better = merge_key > rv  # strict: ties keep the earlier group
        rv = torch.where(better, merge_key, rv)
        ri = torch.where(better, col, ri)
    sel = rv >> shift if int_path else rv
    vals, ids = topk.extract_topk_ids(sel, ri, k, KMIN)
    return (vals if int_path else _key_to_f32(vals)), ids


def _kernel():
    """Build/load the CUDA library once and declare the C entry's types."""
    global _FN
    if _FN is None:
        fn = _build.load_library("bruteforce_accum").bruteforce_accum_topk
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _float_kernel():
    """Build/load the CUDA library once and declare the fp32 entry's types."""
    global _FLOAT_FN
    if _FLOAT_FN is None:
        fn = _build.load_library("bruteforce_accum").bruteforce_accum_topk_f
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FLOAT_FN = fn
    return _FLOAT_FN


def _bf16_kernel():
    """Build/load the CUDA library once and declare the bf16 entry's types."""
    global _BF16_FN
    if _BF16_FN is None:
        fn = _build.load_library("bruteforce_accum").bruteforce_accum_topk_bf16
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BF16_FN = fn
    return _BF16_FN


def fused_topk_accum(queries, base_tiles, n, k, tile_b=256, group=16, depth=8,
                     bias_rows=None):
    """K5 with the JAX signature → (vals [B, k], ids [B, k] int32), best
    first; see the module docstring.  ``tile_b`` and ``depth`` shape the TPU
    kernel's pipeline only and do not change the result.  CPU tensors take
    the plain version; CUDA tensors launch the kernel (tile_n a multiple of
    128 up to 2048; int8 ± bias rows, the rows as :func:`l2_bias_rows` makes
    them, or fp32 or bf16 queries and tiles in one dtype; any D) or raise."""
    global LAUNCHES
    dev = queries.device
    if dev.type == "cpu":
        return fused_topk_accum_reference(queries, base_tiles, n, k, tile_b=tile_b,
                                          group=group, depth=depth, bias_rows=bias_rows)
    n_tiles, d, tile_n, int_path, l2 = _check(queries, base_tiles, n, k, group, depth,
                                              bias_rows)
    _build.check_inputs("K5", dev, [queries, base_tiles, bias_rows if l2 else None])
    if tile_n % 128 or tile_n > _CUDA_TILE_MAX:
        raise ValueError(f"the CUDA K5 takes tile_n a multiple of 128 up to {_CUDA_TILE_MAX}; "
                         f"got tile_n={tile_n}")
    if not int_path:
        _build.check_float("K5", queries, base_tiles)
        base_tiles = _build.aligned(base_tiles, 16)  # 16-byte loads along tile_n
    b = queries.shape[0]
    # The per-bin running keys and columns between the two passes.
    rv = torch.empty((b, tile_n), dtype=torch.int32, device=dev)
    ri = torch.empty((b, tile_n), dtype=torch.int32, device=dev)
    vals = torch.empty((b, k), dtype=torch.int32, device=dev)
    ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if int_path:
            qk, tk = (_build.aligned(x, 16) for x in _build.kmajor_operands(queries, base_tiles))
            bias = _build.aligned(bias_rows, 16) if l2 else None
            err = _kernel()(qk.data_ptr(), tk.data_ptr(), bias.data_ptr() if l2 else None,
                            rv.data_ptr(), ri.data_ptr(), vals.data_ptr(), ids.data_ptr(), b,
                            qk.shape[1], tile_n, n, k, group, stream)
        elif base_tiles.dtype == torch.bfloat16:
            # The wgmma kernel takes query rows of whole k16 steps, the pad zero.
            ldq = -(-d // 16) * 16
            qp = torch.nn.functional.pad(queries, (0, ldq - d)).contiguous()
            err = _bf16_kernel()(qp.data_ptr(), base_tiles.data_ptr(), rv.data_ptr(),
                                 ri.data_ptr(), vals.data_ptr(), ids.data_ptr(), b, d, ldq, tile_n,
                                 n, k, group, stream)
        else:
            err = _float_kernel()(queries.data_ptr(), base_tiles.data_ptr(), rv.data_ptr(),
                                  ri.data_ptr(), vals.data_ptr(), ids.data_ptr(), b, d, tile_n,
                                  n, k, group, stream)
    if err != 0:
        raise RuntimeError(f"bruteforce_accum_topk launch failed: CUDA error {err}")
    LAUNCHES += 1
    return (vals if int_path else _key_to_f32(vals)), ids
