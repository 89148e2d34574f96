"""Kernels K1 and K9: the cluster-major accum fine scan with the planes emit
and with the extract emit (counterparts:
``rag_on_edge_tpu/ops/pallas_ivf_dma.py::cluster_major_accum_planes`` and
``::cluster_major_accum``).

For every block ``t`` the routed queries ``qg_blocks[t]`` [qcap, D] are
scored against the block's slab ``vectors_t[t]`` [D, blk].  Each score is
packed into an int32 key whose low byte names its block and 128-column
chunk::

    key = (dots << 8) - bias_rows[t]                     int8, L2 (bias rows
                                                          carry the pack)
    key = (dots << 8) | (code(t) << 4) | chunk           int8, no bias
    key = (monotone_f32(dots) & ~255) | ...pack          fp32 / bf16

``code(t) = 15 - t % 16``.  Keys past ``rows_valid[t]`` become ``KMIN``.
They are max-folded over a cluster's blocks, and at the cluster's last
block the kernel writes, per bin ``lane = col % 128``, the largest key
(plane 1) and the largest key different from it (plane 2):
``[nblocks, qcap, planes·128]`` int32.  Only each cluster's ``last_block``
rows are defined.

:func:`cluster_major_accum_planes` dispatches on the device of its inputs:
CPU tensors take :func:`cluster_major_accum_planes_reference`, CUDA
tensors launch ``csrc/ivf_accum_planes.cu`` (int8 ± bias rows up to the
JAX package's caps, 512 and 384; fp32 or bf16, both operands in one dtype,
any D) or raise.  The int8 and
bf16 modes run on ``wgmma`` fed by TMA; they read the routed rows through
:func:`kernel_operands` (D zero-padded to a 16-byte row pitch, TMA's; no
copy where D needs none) and the slab as the index holds it, its d past D
read as zeros up to the kernel's unit of 128 bytes.  The fp32 mode runs on
FFMA.

K9, :func:`cluster_major_accum`, is the older extract emit of the same
scan.  Its key has a 4-bit pack, the block code alone::

    key = (dots << 4) - bias_rows[t]                     int8, L2 (bias rows
                                                          carry the code)
    key = (dots << 4) | code(t)                          int8, no bias
    key = (monotone_f32(dots) & ~15) | code(t)           fp32 / bf16

masked to ``KMIN`` past ``rows_valid[t]`` when ``mask_rows`` (default:
without bias rows, whose fill buries padding).  At a cluster's last block,
per bin, the largest key (and, with ``bin2``, the largest key different
from it) with the lowest 128-column chunk holding it is decoded to a value
(``key >> 4``; the float key itself) and a row, and the exact top-k of those
candidates by (value, lowest row) is written as ``pv`` f32 (-inf where
invalid) and ``pr`` int32 rows, each ``[nblocks, qcap, k]``.  A float
``pv`` is the key turned back into fp32, block code and all: the exact
score with its 4 low key bits replaced, as in the JAX kernel.  The JAX
package has no production caller; its CUDA entries are
``ivf_accum_extract_i8`` and ``ivf_accum_extract_f`` of the same source,
counted in ``ACCUM_LAUNCHES`` (one a call, for its two kernels).  On the
card its scan is K1's, on K1's kernels with K9's key (int8 and bf16 on
``wgmma``, fp32 on the FFMA register tile), each (row, bin) keeping its
planes' chunks beside them; the scan writes every row's decoded candidates
to a ``[2, nblocks, qcap, planes·128]`` int32 scratch, and an emit kernel
takes each row's exact top-k from them, a warp a row.
"""

from __future__ import annotations

import ctypes

import torch

from rag_on_edge_tpu_torch.ops import _build, topk

__all__ = ["CODE_MAX", "INT8_DIM_MAX", "INT8_DIM_MAX_BIAS", "KMIN", "BIAS_FILL", "LAUNCHES",
           "ACCUM_LAUNCHES", "cluster_major_accum_planes",
           "cluster_major_accum_planes_reference", "kernel_operands", "cluster_major_accum",
           "cluster_major_accum_reference", "accum_bias_rows"]

CODE_MAX = 16  # blocks-per-cluster cap (4-bit block code)
# int8 dimension caps: |q·b| <= d·127² must stay below 2**23 after the
# 8-bit shift; the L2 bias path also subtracts rows up to 2**29.
INT8_DIM_MAX = 512
INT8_DIM_MAX_BIAS = 384
KMIN = -(2**31) + 1  # invalid-entry sentinel of the planes
BIAS_FILL = 2**30  # K9's bias row at a padded column: its key sinks below every real one

#: Launches of the CUDA kernels K1 (``LAUNCHES``) and K9 (``ACCUM_LAUNCHES``)
#: in this process; the plain versions do not count.  A run that must show
#: it went through a kernel sets its count to 0 before and reads it after.
LAUNCHES = 0
ACCUM_LAUNCHES = 0

_ENTRIES: dict = {}
_F32_EXACT_DIM = (1 << 24) // (127 * 127)
# What the CUDA K9 takes in int8: D <= 1024, where its key (dots << 4) -
# row (the JAX kernel's, rag_on_edge_tpu/ops/pallas_ivf_dma.py:16), with
# rows clipped to ±2**25 (accum_bias_rows), stays inside int32.
_CUDA_INT8_DIM_MAX = 1024


def _monotone_key(x: torch.Tensor) -> torch.Tensor:
    """f32 → i32 order-preserving key (IEEE-754 total-order trick)."""
    m = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(m >= 0, m, m ^ 0x7FFFFFFF)


def _key_to_f32(kk: torch.Tensor) -> torch.Tensor:
    m = torch.where(kk >= 0, kk, kk ^ 0x7FFFFFFF)
    return m.contiguous().view(torch.float32)


def _dots(qg_blocks, vectors_t, int_path):
    """The per-block products [nblocks, qcap, blk]: exact int32 on the int8
    path, fp32 otherwise."""
    if int_path and qg_blocks.device.type == "cpu":
        # torch.bmm on int8 returns int8 and wraps: upcast, exact in int32.
        return torch.bmm(qg_blocks.to(torch.int32), vectors_t.to(torch.int32))
    if not int_path:
        return torch.bmm(qg_blocks.to(torch.float32), vectors_t.to(torch.float32))
    # No int32 GEMM on CUDA: fp32 with TF32 off is exact for an int8 dot
    # over at most 1040 dimensions (|dots| <= d·127² < 2**24); wider D sums
    # such slices in int32.
    out = None
    for s in range(0, qg_blocks.shape[-1], _F32_EXACT_DIM):
        part = torch.bmm(qg_blocks[..., s:s + _F32_EXACT_DIM].to(torch.float32),
                         vectors_t[:, s:s + _F32_EXACT_DIM].to(torch.float32)).to(torch.int32)
        out = part if out is None else out + part
    return out


def _check(qg_blocks, vectors_t, block_first, block_last, rows_valid, blk,
           bias_rows, planes=True):
    """K1's checks, or with ``planes=False`` K9's (no chunk id and no
    shift by 8 in its key, so neither the blk cap nor the dim caps)."""
    if blk % 128 or blk <= 0 or (planes and blk > 128 * CODE_MAX):
        raise ValueError(f"blk={blk} must be a positive multiple of 128"
                         + (f" and <= {128 * CODE_MAX} (4-bit chunk id)" if planes else ""))
    if qg_blocks.dim() != 3:
        raise ValueError(f"qg_blocks must be [nblocks, qcap, D], got {tuple(qg_blocks.shape)}")
    nblocks, qcap, d = qg_blocks.shape
    if tuple(vectors_t.shape) != (nblocks, d, blk):
        raise ValueError(f"vectors_t must be [nblocks, {d}, {blk}], got "
                         f"{tuple(vectors_t.shape)}")
    for name, tab in (("block_first", block_first), ("block_last", block_last),
                      ("rows_valid", rows_valid)):
        if tuple(tab.shape) != (nblocks,) or tab.dtype != torch.int32:
            raise ValueError(f"{name} must be [nblocks] int32, got "
                             f"{tuple(tab.shape)} {tab.dtype}")
    int_path = vectors_t.dtype == torch.int8
    if int_path != (qg_blocks.dtype == torch.int8):
        raise ValueError("int8 path requires BOTH qg_blocks and vectors_t int8")
    if not int_path and vectors_t.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {vectors_t.dtype}")
    if bias_rows is not None:
        if not int_path:
            raise ValueError("bias_rows is the int8-L2 path")
        if tuple(bias_rows.shape) != (nblocks, 1, blk) or bias_rows.dtype != torch.int32:
            raise ValueError(f"bias_rows must be [nblocks, 1, {blk}] int32, got "
                             f"{tuple(bias_rows.shape)} {bias_rows.dtype}")
    if int_path and planes:
        d_cap = INT8_DIM_MAX_BIAS if bias_rows is not None else INT8_DIM_MAX
        if d > d_cap:
            raise ValueError(
                f"int8 planes path supports dim <= {d_cap}: |q.b| <= d*127^2 "
                f"must fit int32 after the 8-bit key shift; got d={d}")
    return nblocks, qcap, d, int_path


def cluster_major_accum_planes_reference(qg_blocks, vectors_t, block_first,
                                         block_last, rows_valid, blk=2048,
                                         bin2=True, bias_rows=None):
    """Plain PyTorch K1, for every mode the JAX function takes (int8 ± bias,
    fp32 and bf16 monotone keys).  Writes every row; only ``last_block``
    rows carry meaning, as in the kernel."""
    nblocks, qcap, d, int_path = _check(qg_blocks, vectors_t, block_first,
                                        block_last, rows_valid, blk, bias_rows)
    dev = qg_blocks.device
    dots = _dots(qg_blocks, vectors_t, int_path)
    t = torch.arange(nblocks, device=dev, dtype=torch.int32)
    code = (CODE_MAX - 1) - (t & (CODE_MAX - 1))
    cid = torch.arange(blk, device=dev, dtype=torch.int32) >> 7
    pack = (code << 4)[:, None, None] | cid[None, None, :]  # [nblocks, 1, blk]
    if int_path:
        key = dots * 256
        key = key - bias_rows if bias_rows is not None else key | pack
    else:
        key = (_monotone_key(dots) & ~255) | pack
    lane_ok = torch.arange(blk, device=dev)[None, :] < rows_valid[:, None]
    key = torch.where(lane_ok[:, None, :], key, torch.full_like(key, KMIN))
    # Max-fold over each cluster's blocks: block t folds blocks start(t)..t,
    # start(t) = the latest block_first at or before t.
    start = torch.cummax(torch.where(block_first > 0, t, torch.zeros_like(t)), 0).values
    acc = key.clone()
    span = int((t - start).max()) + 1 if nblocks else 1
    for s in range(1, span):
        src = (t - s).clamp_min(0)
        use = (t - s) >= start
        acc = torch.where(use[:, None, None], torch.maximum(acc, key[src]), acc)
    chunks = acc.reshape(nblocks, qcap, blk // 128, 128)
    p1 = chunks.amax(dim=2)
    if not bin2:
        return p1.contiguous()
    rest = torch.where(chunks == p1[:, :, None, :], torch.full_like(chunks, KMIN), chunks)
    return torch.cat([p1, rest.amax(dim=2)], dim=2)


def _entry(name, nptr, nint):
    """A C entry of the CUDA library, built and loaded on first use, its
    types declared once: ``nptr`` pointers, ``nint`` ints and the stream."""
    if name not in _ENTRIES:
        fn = getattr(_build.load_library("ivf_accum_planes"), name)
        fn.argtypes = [ctypes.c_void_p] * nptr + [ctypes.c_int] * nint + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return _ENTRIES[name]


def kernel_operands(qg_blocks):
    """The routed rows as the CUDA K1's int8 and bf16 modes (and K4's and
    K7's int8 modes, ``ivf_scan.int8_operands``) read them: D zero-padded to
    a 16-byte row pitch (TMA's), one copy where D needs it and none
    otherwise (int8 D = 128).  The pad adds zero terms to every dot, so no
    key moves."""
    return _build.pad_rows(qg_blocks, 16 // qg_blocks.element_size())


def cluster_major_accum_planes(qg_blocks, vectors_t, block_first, block_last,
                               rows_valid, blk=2048, bin2=True, bias_rows=None):
    """K1 with the JAX signature → planes ``[nblocks, qcap, planes·128]``
    int32; see the module docstring.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (int8 ± bias rows; fp32 or bf16 with
    both operands in one dtype, any D) or raise."""
    global LAUNCHES
    dev = qg_blocks.device
    if dev.type == "cpu":
        return cluster_major_accum_planes_reference(
            qg_blocks, vectors_t, block_first, block_last, rows_valid,
            blk=blk, bin2=bin2, bias_rows=bias_rows)
    nblocks, qcap, d, int_path = _check(qg_blocks, vectors_t, block_first,
                                        block_last, rows_valid, blk, bias_rows)
    _build.check_inputs("K1", dev, [qg_blocks, vectors_t, block_first, block_last, rows_valid,
                                    bias_rows])
    if not int_path:
        _build.check_float("K1", qg_blocks, vectors_t)
    # TMA (int8, bf16) and the fp32 stage's 16-byte loads need 16-byte bases.
    vectors_t = _build.aligned(vectors_t, 16)
    nplanes = 2 if bin2 else 1
    out = torch.empty((nblocks, qcap, nplanes * 128), dtype=torch.int32, device=dev)
    tabs = (block_first.data_ptr(), block_last.data_ptr(), rows_valid.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if vectors_t.dtype == torch.float32:
            fn = _entry("ivf_accum_planes_f32", 6, 5)
            err = fn(qg_blocks.data_ptr(), vectors_t.data_ptr(), *tabs, out.data_ptr(), nblocks,
                     qcap, d, blk, nplanes, stream)
        else:
            qk = _build.aligned(kernel_operands(qg_blocks), 16)
            shape = (nblocks, qcap, d, qk.shape[-1], blk, nplanes, stream)
            if int_path:
                br = _build.aligned(bias_rows, 16) if bias_rows is not None else None
                err = _entry("ivf_accum_planes_i8", 7, 6)(
                    qk.data_ptr(), vectors_t.data_ptr(), *tabs,
                    br.data_ptr() if br is not None else None, out.data_ptr(), *shape)
            else:
                err = _entry("ivf_accum_planes_bf16", 6, 6)(
                    qk.data_ptr(), vectors_t.data_ptr(), *tabs, out.data_ptr(), *shape)
    if err != 0:
        raise RuntimeError(f"ivf_accum_planes launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def _check_extract(qg_blocks, vectors_t, block_first, block_last, rows_valid, blk, group,
                   depth, bias_rows, mask_rows):
    """K9's checks, in the JAX function's order → (nblocks, qcap, d,
    int_path, mask_rows).  ``group`` and ``depth`` are the TPU's DMA ring
    shapes: they change no result, but the JAX checks on them stay."""
    if group % depth:
        raise ValueError(f"group={group} must be a multiple of depth={depth}")
    if blk % 128:
        raise ValueError(f"blk={blk} must be a multiple of 128")
    if qg_blocks.dim() != 3:
        raise ValueError(f"qg_blocks must be [nblocks, qcap, D], got {tuple(qg_blocks.shape)}")
    nblocks = qg_blocks.shape[0]
    if nblocks % group or nblocks < depth:
        raise ValueError(f"nblocks={nblocks} must be a multiple of group={group} and >= depth")
    nblocks, qcap, d, int_path = _check(qg_blocks, vectors_t, block_first, block_last,
                                        rows_valid, blk, bias_rows, planes=False)
    if mask_rows is None:
        mask_rows = bias_rows is None
    return nblocks, qcap, d, int_path, bool(mask_rows)


def cluster_major_accum_reference(qg_blocks, vectors_t, block_first, block_last, rows_valid,
                                  k, blk=2048, group=8, depth=8, bin2=True, bias_rows=None,
                                  mask_rows=None):
    """Plain PyTorch K9, for every mode the JAX function takes (int8 ± bias
    rows, fp32 and bf16 monotone keys) → (pv, pr).  Rows of blocks that are
    not a cluster's last block hold -inf and 0 (the kernel leaves them
    unwritten)."""
    nblocks, qcap, _, int_path, mask_rows = _check_extract(
        qg_blocks, vectors_t, block_first, block_last, rows_valid, blk, group, depth,
        bias_rows, mask_rows)
    dev = qg_blocks.device
    dots = _dots(qg_blocks, vectors_t, int_path)
    t = torch.arange(nblocks, device=dev, dtype=torch.int32)
    code = ((CODE_MAX - 1) - (t & (CODE_MAX - 1)))[:, None, None]
    if int_path:
        key = dots * 16
        key = key - bias_rows if bias_rows is not None else key | code
    else:
        key = (_monotone_key(dots) & ~(CODE_MAX - 1)) | code
    del dots
    if mask_rows:
        lane_ok = torch.arange(blk, device=dev)[None, :] < rows_valid[:, None]
        key = torch.where(lane_ok[:, None, :], key, torch.full_like(key, KMIN))
    # Max-fold over each cluster's blocks, as K1's plain version, but only
    # for the last blocks, the rows the emit reads.
    start = torch.cummax(torch.where(block_first > 0, t, torch.zeros_like(t)), 0).values
    last = torch.nonzero(block_last).flatten()
    acc = key[last]
    span = int((t - start)[last].max()) + 1 if last.numel() else 1
    for s in range(1, span):
        src = (last - s).clamp_min(0)
        use = (last - s) >= start[last]
        acc = torch.where(use[:, None, None], torch.maximum(acc, key[src]), acc)
    del key
    # Per bin, the top-1 or top-2 with the lowest chunk holding it
    # (_binned_packed_top), decoded to (value, row).
    w = blk // 128
    chunks = acc.reshape(-1, qcap, w, 128)
    chunk_id = torch.arange(w, device=dev, dtype=torch.int32)[:, None]
    lane = torch.arange(128, device=dev, dtype=torch.int32)
    tl = last.to(torch.int32)[:, None, None]
    vals, rows = [], []
    for _ in range(2 if bin2 else 1):
        m = chunks.amax(dim=2)
        cid = torch.where(chunks == m[:, :, None, :], chunk_id, 2**30).amin(dim=2)
        chunks = torch.where(chunks == m[:, :, None, :], torch.full_like(chunks, KMIN), chunks)
        dd = ((tl & (CODE_MAX - 1)) - ((CODE_MAX - 1) - (m & (CODE_MAX - 1)))) & (CODE_MAX - 1)
        invalid = m == KMIN
        vals.append(torch.where(invalid, KMIN, m >> 4 if int_path else m))
        rows.append(torch.where(invalid, 0, (tl - dd) * blk + cid * 128 + lane))
    mv, mi = topk.extract_topk_ids(torch.cat(vals, -1), torch.cat(rows, -1), k, KMIN)
    fv = mv.to(torch.float32) if int_path else _key_to_f32(mv)
    pv = torch.full((nblocks, qcap, k), float("-inf"), dtype=torch.float32, device=dev)
    pr = torch.zeros((nblocks, qcap, k), dtype=torch.int32, device=dev)
    pv[last] = torch.where(mv == KMIN, torch.full_like(fv, float("-inf")), fv)
    pr[last] = mi
    return pv, pr


def accum_bias_rows(bias: torch.Tensor, rows_valid: torch.Tensor) -> torch.Tensor:
    """K9's int8-L2 bias rows, the 4-bit layout its JAX docstring gives:
    ``round(bias) << 4`` minus the block code ``15 - t % 16``, and
    ``BIAS_FILL`` at the padded columns ``col >= rows_valid[t]``, which
    buries them with no row mask.  ``bias`` [nblocks, 1, blk] f32 (``norms / alpha``) →
    [nblocks, 1, blk] int32.  ``round(bias)`` is clipped to ±2**25, so a key
    ``(dots << 4) - row`` stays inside int32 for D <= 1024.  (The planes
    rows of K1 are another layout: shifted by 8, minus code and chunk.)"""
    nblocks, _, blk = bias.shape
    dev = bias.device
    t = torch.arange(nblocks, dtype=torch.int32, device=dev)
    code = (CODE_MAX - 1) - (t & (CODE_MAX - 1))
    br = torch.clamp(torch.round(bias), -(2.0**25), 2.0**25).to(torch.int32)
    rows = br * 16 - code[:, None, None]
    pad = torch.arange(blk, device=dev)[None, None, :] >= rows_valid[:, None, None]
    return torch.where(pad, torch.full_like(rows, BIAS_FILL), rows).contiguous()


def cluster_major_accum(qg_blocks, vectors_t, block_first, block_last, rows_valid, k,
                        blk=2048, group=8, depth=8, bin2=True, bias_rows=None,
                        mask_rows=None):
    """K9 with the JAX signature → (pv [nblocks, qcap, k] f32, pr [nblocks,
    qcap, k] int32 padded row ids); only each cluster's ``last_block`` rows
    are defined.  See the module docstring.  CPU tensors take the plain
    version; CUDA tensors launch the kernels (int8 ± bias rows, D <= 1024;
    fp32 or bf16 in one dtype, no bias rows, any D; any k) or raise.  The
    int8 and bf16 routed rows are read as K1 reads them
    (:func:`kernel_operands`)."""
    global ACCUM_LAUNCHES
    dev = qg_blocks.device
    if dev.type == "cpu":
        return cluster_major_accum_reference(
            qg_blocks, vectors_t, block_first, block_last, rows_valid, k, blk=blk,
            group=group, depth=depth, bin2=bin2, bias_rows=bias_rows, mask_rows=mask_rows)
    nblocks, qcap, d, int_path, mask_rows = _check_extract(
        qg_blocks, vectors_t, block_first, block_last, rows_valid, blk, group, depth,
        bias_rows, mask_rows)
    _build.check_inputs("K9", dev, [qg_blocks, vectors_t, block_first, block_last, rows_valid,
                                    bias_rows])
    if k < 1 or (int_path and d > _CUDA_INT8_DIM_MAX):
        raise ValueError(f"the CUDA K9 takes k >= 1 and int8 D <= {_CUDA_INT8_DIM_MAX} (its "
                         f"(dots << 4) - row key in int32); got k={k}, D={d}")
    if not int_path:
        _build.check_float("K9", qg_blocks, vectors_t)
    # TMA (int8, bf16) and the fp32 ring's 16-byte copies need 16-byte bases.
    vectors_t = _build.aligned(vectors_t, 16)
    q = qg_blocks
    if vectors_t.dtype != torch.float32:
        q = _build.aligned(kernel_operands(qg_blocks), 16)
    nplanes = 2 if bin2 else 1
    pv = torch.empty((nblocks, qcap, k), dtype=torch.float32, device=dev)
    pr = torch.empty((nblocks, qcap, k), dtype=torch.int32, device=dev)
    # The scan's decoded candidates (values, rows), which the emit reads.
    cand = torch.empty((2, nblocks, qcap, nplanes * 128), dtype=torch.int32, device=dev)
    ptrs = (block_first.data_ptr(), block_last.data_ptr(), rows_valid.data_ptr())
    outs = (cand[0].data_ptr(), cand[1].data_ptr(), pv.data_ptr(), pr.data_ptr())
    shape = (nblocks, qcap, d, q.shape[-1], blk, k, nplanes, int(mask_rows))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if int_path:
            name = "ivf_accum_extract_i8"
            br = _build.aligned(bias_rows, 16) if bias_rows is not None else None
            err = _entry(name, 10, 8)(q.data_ptr(), vectors_t.data_ptr(), *ptrs,
                                      br.data_ptr() if br is not None else None, *outs, *shape,
                                      stream)
        else:
            name = "ivf_accum_extract_f"
            err = _entry(name, 9, 9)(q.data_ptr(), vectors_t.data_ptr(), *ptrs, *outs, *shape,
                                     int(vectors_t.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    ACCUM_LAUNCHES += 1
    return pv, pr
