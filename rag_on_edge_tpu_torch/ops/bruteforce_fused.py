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
and base in one dtype; int8 and bf16 on the tensor cores, ``wgmma`` fed by
TMA, int8 on the K-major copy of :func:`_build.kmajor_operands`) or
raise.  The fp32 mode runs a register-tiled FFMA kernel over column
splits (:func:`split_plan`), each split's sorted top-k joined by K2
(:func:`merge_splits`); :func:`split_topk_reference` is that
split-and-merge with plain parts.  The fp32 mode keeps 256 a row, the int8
and bf16 modes 32, and a larger k runs in passes of that width
(``_build.by_passes``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from rag_on_edge_tpu_torch.ops import _build, distances, fused_topk, topk

__all__ = ["LAUNCHES", "auto_tile_n", "fused_topk_matmul", "fused_topk_matmul_reference",
           "split_plan", "merge_splits", "split_topk_reference"]

#: Launches of the CUDA kernel in this process; the plain version does not
#: count.  A run that must show it went through the kernel sets it to 0
#: before and reads it after.
LAUNCHES = 0

# A top-k a launch up to 256 long in the fp32 mode (it lives in the output
# buffer) and 32 in the int8 and bf16 modes (one per lane of the inserting
# warp); a larger k runs in passes of that width (_build.by_passes).
_F32_PASS_K = 256
# The int8 and bf16 kernels' binned table names a column's chunk within
# its tile in 16 bits: a tile walks at most 65536 chunks of 128.
_CUDA_BINNED_TILE_MAX = 65536 * 128
# The fp32 mode: each column split at least this many 128-column chunks
# long.
_F32_MIN_CHUNKS = 32

_FNS = {}


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


def general_bins(nbins: int, tile_n: int, n: int, mode: str) -> bool:
    """Whether the CUDA K3 runs ``nbins`` on its general binning: any nbins
    but 0 and 128 (a chunk's columns are not its bins), and 128 on an int8
    or bf16 tile past the table's reach (a column's chunk within its tile in
    16 bits), each (row, bin) keeping its two best of the tile in a slot of
    device memory a CTA (:func:`gen_scratch`).  It takes any ``tile_n`` that
    is a multiple of nbins: a 128-column chunk across two tiles is binned
    once for each."""
    if nbins == 0:
        return False
    return nbins != 128 or (mode != "f32" and min(tile_n, n) > _CUDA_BINNED_TILE_MAX)


def gen_scratch(nbins: int, ctas: int, dev):
    """The general binning's lists: ``ctas`` slots of 64 rows × nbins × 2
    scores (4 bytes: int32 or fp32) and int32 columns → (scores, columns)."""
    n = ctas * 64 * nbins * 2
    return (torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev))


def split_plan(b: int, n: int, tile_n: int, nbins: int, sms: int):
    """The fp32 kernel's column splits → (split_cols, nsplit): as many as
    keep the row tiles (128 rows; 64 binned) x splits within one wave of
    one CTA a multiprocessor (a second, partial wave would idle most of the
    card), each split at least ``_F32_MIN_CHUNKS`` chunks of 128 long, and
    (binned) a whole number of ``tile_n`` tiles and of 128-column chunks, so
    the JAX wrapper's tiles are kept."""
    bm = 64 if nbins else 128
    unit = math.lcm(tile_n, 128) if nbins else 128
    nunits = -(-n // unit)
    want = sms // -(-b // bm)
    nsplit = max(1, min(want, nunits, (-(-n // 128)) // _F32_MIN_CHUNKS))
    per = -(-nunits // nsplit)
    return per * unit, -(-nunits // per)


def merge_splits(vals, ids, k: int, topk_fn):
    """The top-k of a row's per-split lists → (vals [B, k], ids [B, k]):
    ``vals`` / ``ids`` [B, W] hold split s's sorted list at columns s·k ..
    s·k + k - 1 (the fill value past a short list, and past the last split
    to W, a multiple of 128).  ``topk_fn`` is K2 (or its plain version):
    ties go to the lowest position, which is the lowest id, since the
    splits lie in column order and each list in (score desc, id asc)
    order."""
    mv, pos = topk_fn(vals, k)
    return mv, torch.gather(ids, 1, pos.long())


def split_topk_reference(queries, base_t, k, split_cols, tile_n=None, tile_b=None, nbins=0,
                         n_valid=None):
    """The fp32 kernel's split-and-merge with plain parts: the plain K3 on
    each split of ``split_cols`` columns (a multiple of ``tile_n`` when
    binned), written as the kernel writes its lists, then
    :func:`merge_splits` with the plain K2.  Equals
    :func:`fused_topk_matmul_reference` above the fill value."""
    b, d, n, _, _, tile_n = _resolve(queries, base_t, k, tile_n, tile_b, nbins, None, None)
    if nbins and split_cols % tile_n:
        raise ValueError(f"split_cols={split_cols} must be a multiple of tile_n={tile_n}")
    nsplit = -(-n // split_cols)
    width = -(-nsplit * k // 128) * 128
    fill = float("-inf")
    vals = torch.full((b, width), fill, dtype=torch.float32, device=queries.device)
    ids = torch.zeros((b, width), dtype=torch.int32, device=queries.device)
    nv = n if n_valid is None else int(torch.as_tensor(n_valid).reshape(()))
    for s in range(nsplit):
        c0, c1 = s * split_cols, min(n, (s + 1) * split_cols)
        kk = min(k, c1 - c0)
        v, i = fused_topk_matmul_reference(
            queries, base_t[:, c0:c1], kk, tile_n=tile_n, nbins=nbins,
            n_valid=torch.tensor([max(0, min(nv, c1) - c0)], dtype=torch.int32))
        vals[:, s * k:s * k + kk] = v.to(torch.float32)
        ids[:, s * k:s * k + kk] = i + c0
    return merge_splits(vals, ids, k, fused_topk.fused_topk_reference)


# Each mode's C entry: (pointers, ints) before the stream.
_ENTRIES = {"i8": (11, 6), "f32": (9, 11), "bf16": (9, 8)}


def _kernel(mode):
    """Build/load the CUDA library once and declare the entry's types
    (``i8`` takes both int8 modes)."""
    if mode not in _FNS:
        ptrs, ints = _ENTRIES[mode]
        fn = getattr(_build.load_library("bruteforce_fused"), f"bruteforce_fused_topk_{mode}")
        fn.argtypes = [ctypes.c_void_p] * ptrs + [ctypes.c_int] * ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[mode] = fn
    return _FNS[mode]



def fused_topk_matmul(queries, base_t, k, tile_n=None, tile_b=None, nbins=0,
                      n_valid=None, alpha=None, bias=None):
    """K3 with the JAX signature → (vals [B, k], ids [B, k] int32), best
    first; vals are int32 on the int8 path and f32 in L2 mode and for float
    inputs.  See the module docstring.

    ``n_valid``: optional 1-element int32 tensor, the count of valid
    leading columns (at most N).  ``alpha`` [B] / ``bias`` [N]: the int8 L2
    mode (both or neither).  CPU tensors take the plain version; CUDA
    tensors launch the kernel (int8 ± L2, and fp32 or bf16 with queries
    and base_t in one dtype; any nbins and any tile_n that is a multiple of
    it, as the JAX function (:func:`general_bins`); any D; any k, in passes
    of 256 (fp32) or 32 (int8, bf16)) or raise.  The fp32 mode joins its
    column splits with K2."""
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
        _build.check_float("K3", queries, base_t)
    if int_path:
        mode = "i8_l2" if l2 else "i8"
    else:
        mode = "bf16" if base_t.dtype == torch.bfloat16 else "f32"
    gen_on = general_bins(nbins, tile_n, n, mode)
    nv_ptr = n_valid.data_ptr() if n_valid is not None else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if mode == "f32":
            return _build.by_passes(k, lambda kp, bv, bi: _launch_f32(
                queries, base_t, kp, tile_n, nbins, gen_on, nv_ptr, bv, bi, stream),
                _F32_PASS_K)
        if mode == "bf16":
            # TMA takes rows of whole 16-byte units: the queries' rows are
            # padded to whole k16 steps (the pad zero), and base_t is copied
            # only where its row pitch is not a multiple of 8 elements.
            ldq, ldb = -(-d // 16) * 16, -(-n // 8) * 8
            qp = torch.nn.functional.pad(queries, (0, ldq - d)).contiguous()
            bp = base_t if ldb == n else torch.nn.functional.pad(base_t, (0, ldb - n))
            bp = _build.aligned(bp, 16)
            ptrs, ints = (qp.data_ptr(), bp.data_ptr(), nv_ptr), (b, d, ldq, n, ldb)
        else:
            qk, bk = (_build.aligned(x, 16) for x in _build.kmajor_operands(queries, base_t))
            bias = _build.aligned(bias, 16) if l2 else None
            ptrs = (qk.data_ptr(), bk.data_ptr(), alpha.data_ptr() if l2 else None,
                    bias.data_ptr() if l2 else None, nv_ptr)
            ints = (b, qk.shape[1], n)
        vdtype = torch.int32 if mode == "i8" else torch.float32
        # The general binning's lists, alive through the passes.
        scratch = gen_scratch(nbins, -(-b // 64), dev) if gen_on else (None, None)
        gen = tuple(x.data_ptr() if x is not None else None for x in scratch)

        def run(kp, bound_v, bound_i):
            global LAUNCHES
            vals = torch.empty((b, kp), dtype=vdtype, device=dev)
            ids = torch.empty((b, kp), dtype=torch.int32, device=dev)
            err = _kernel("bf16" if mode == "bf16" else "i8")(
                *ptrs, bound_v.data_ptr() if bound_v is not None else None,
                bound_i.data_ptr() if bound_i is not None else None, vals.data_ptr(),
                ids.data_ptr(), *gen, *ints, kp, tile_n, nbins, stream)
            if err != 0:
                raise RuntimeError(f"bruteforce_fused_topk launch failed: CUDA error {err}")
            LAUNCHES += 1
            return vals, ids

        return _build.by_passes(k, run)


def _launch_f32(queries, base_t, k, tile_n, nbins, gen_on, nv_ptr, bound_v, bound_i, stream):
    """One pass of the fp32 kernel (k <= 256, the entries ranked after each
    row's bound where one is given) over its column splits, then K2 over
    the splits' lists (none where one split covers N)."""
    global LAUNCHES
    b, n = queries.shape[0], base_t.shape[1]
    dev = queries.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    split_cols, nsplit = split_plan(b, n, tile_n, nbins, sms)
    # cp.async moves 16-byte pieces: the queries' rows padded to 4 floats.
    qp = _build.aligned(_build.pad_rows(queries, 4), 16)
    width = -(-nsplit * k // 128) * 128
    vals = torch.full((b, width), float("-inf"), dtype=torch.float32, device=dev)
    ids = torch.zeros((b, width), dtype=torch.int32, device=dev)
    # The general binning's lists, alive through the launch.
    scratch = gen_scratch(nbins, -(-b // 64) * nsplit, dev) if gen_on else (None, None)
    gen = tuple(x.data_ptr() if x is not None else None for x in scratch)
    err = _kernel("f32")(qp.data_ptr(), base_t.data_ptr(), nv_ptr,
                         bound_v.data_ptr() if bound_v is not None else None,
                         bound_i.data_ptr() if bound_i is not None else None, vals.data_ptr(),
                         ids.data_ptr(), *gen, b, base_t.shape[0], qp.shape[1], n, n, k, tile_n,
                         nbins, split_cols, nsplit, width, stream)
    if err != 0:
        raise RuntimeError(f"bruteforce_fused_topk launch failed: CUDA error {err}")
    LAUNCHES += 1
    if nsplit == 1:
        return vals[:, :k].contiguous(), ids[:, :k].contiguous()
    return merge_splits(vals, ids, k, fused_topk.fused_topk)
