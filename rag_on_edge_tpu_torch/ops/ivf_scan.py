"""Kernels K4, K6 and K7: the cluster-major fine scan with a per-row running
top-k (counterparts: ``rag_on_edge_tpu/ops/pallas_ivf.py::cluster_major_scan_grouped``,
``::cluster_major_scan`` and ``::cluster_major_scan_routed``).

For every block ``j`` the routed queries ``qg_blocks[j]`` [qcap, D] are
scored against the block's slab ``vectors_t[j]`` [D, blk]::

    scores = float(dots) - bias[j]      int8 (dots exact in int32; bias optional)
    scores = dots                       fp32 / bf16 (L2 rides an augmented column)

and set to ``-inf`` past ``rows_valid[j]``.  Per row, each strided bin
``col % nbins`` keeps its ``bin_depth`` best (value, id) with id
``row_base[j] + col`` (:func:`topk.binned_top2`), and those survivors are
merged into a running top-k (:func:`topk.extract_topk_ids`) that resets at
``block_first`` and is written at ``block_last``: ``pv`` f32 and ``pr``
int32, each ``[nblocks, qcap, k]``.  Only ``block_last`` rows are defined,
and ids are compared only where ``pv > -inf``.

:func:`cluster_major_scan_grouped` dispatches on the device of its inputs:
CPU tensors take :func:`cluster_major_scan_grouped_reference`, CUDA tensors
launch ``csrc/ivf_grouped_scan.cu`` (int8, or fp32 or bf16 with both
operands in one dtype and D <= 320; ± bias) or raise.  K6 and K7 do the
same, in the same modes.

K6, :func:`cluster_major_scan`, computes the same walk with the routed
queries and the output indexed by cluster: block ``j`` is scored against
``qg[block_cluster[j]]`` (``qg`` [nlist, qcap, D]) and each run's top-k
goes to row ``block_cluster[t]`` of ``[nlist, qcap, k]``.  Rows of clusters
that end no run are unwritten.  The sharded index runs it over a shard's
block walk and the recovery pass's compacted block list.  Its CUDA entries
(``ivf_cluster_scan_i8`` and ``ivf_cluster_scan_f`` in the same source)
share K4's kernel; its launches count in ``CLUSTER_LAUNCHES``.

K7, :func:`cluster_major_scan_routed`, is K4 with the routing done inside
the kernel: it takes the whole batch ``qi`` [B, D] and, per block, the
routed query indices ``cq_blocks`` [nblocks, qcap, 1] (-1 = empty slot), and
row ``r`` of block ``j`` is ``qi[cq_blocks[j, r]]``, a zero row where that
index lies outside ``[0, B)`` (the TPU kernel's ``onehot(cq) @ qi``, at
HIGHEST precision in the float modes, which returns ``qi`` bit for bit).
No ``[nblocks, qcap, D]`` table is built.  Its CUDA entries are
``ivf_routed_scan_i8`` and ``ivf_routed_scan_f`` of the same source; its
launches count in ``ROUTED_LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch

from rag_on_edge_tpu_torch.ops import _build, topk

__all__ = ["LAUNCHES", "CLUSTER_LAUNCHES", "ROUTED_LAUNCHES", "cluster_major_scan_grouped",
           "cluster_major_scan_grouped_reference", "cluster_major_scan",
           "cluster_major_scan_reference", "cluster_major_scan_routed",
           "cluster_major_scan_routed_reference"]

#: Launches of the CUDA kernel K4 (``LAUNCHES``), K6 (``CLUSTER_LAUNCHES``)
#: and K7 (``ROUTED_LAUNCHES``) in this process; the plain versions do not
#: count.  A run that must show it went through a kernel sets its count to 0
#: before and reads it after.
LAUNCHES = 0
CLUSTER_LAUNCHES = 0
ROUTED_LAUNCHES = 0

_NEG_INF = float("-inf")
# What the CUDA kernel takes: 128 bins (one per lane of a row group), at
# most 32 survivors per row (one per lane of the merging warp), bin depths
# 1-4 (register arrays sized at compile time), and |dots| <= D·127² below
# 2**24 so the fp32 plain version on the card is exact too.
_CUDA_NBINS = 128
_CUDA_K_MAX = 32
_CUDA_DEPTH_MAX = 4
_CUDA_DIM_MAX = 1024

_FNS: dict = {}

# The C entries of csrc/ivf_grouped_scan.cu: (pointer args, int args), the
# stream last.  The float entries take one more int, bf16 (0 or 1).
_ENTRIES = {
    "ivf_grouped_scan_i8": (9, 6), "ivf_grouped_scan_f": (9, 7),
    "ivf_cluster_scan_i8": (10, 7), "ivf_cluster_scan_f": (10, 8),
    "ivf_routed_scan_i8": (10, 7), "ivf_routed_scan_f": (10, 8),
    "ivf_variant_scan_i8": (9, 7), "ivf_variant_scan_f": (9, 8),
}


def _check(qg_blocks, vectors_t, block_first, block_last, rows_valid, k, blk,
           group, nbins, bin_depth, bias, row_base):
    if blk % nbins:
        raise ValueError(f"blk={blk} must be a multiple of nbins={nbins}")
    if qg_blocks.dim() != 3:
        raise ValueError(f"qg_blocks must be [nblocks, qcap, D], got {tuple(qg_blocks.shape)}")
    nblocks, qcap, d = qg_blocks.shape
    if nblocks % group:
        raise ValueError(f"nblocks={nblocks} must be a multiple of group={group}")
    if tuple(vectors_t.shape) != (nblocks, d, blk):
        raise ValueError(f"vectors_t must be [nblocks, {d}, {blk}], got "
                         f"{tuple(vectors_t.shape)}")
    int_path = vectors_t.dtype == torch.int8
    if int_path != (qg_blocks.dtype == torch.int8):
        raise ValueError("int8 path requires BOTH qg_blocks and vectors_t int8")
    if not int_path and vectors_t.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported dtype {vectors_t.dtype}")
    tabs = [("block_first", block_first), ("block_last", block_last),
            ("rows_valid", rows_valid)]
    if row_base is not None:
        tabs.append(("row_base", row_base))
    for name, tab in tabs:
        if tuple(tab.shape) != (nblocks,) or tab.dtype != torch.int32:
            raise ValueError(f"{name} must be [nblocks] int32, got "
                             f"{tuple(tab.shape)} {tab.dtype}")
    if bias is not None and (tuple(bias.shape) != (nblocks, 1, blk)
                             or bias.dtype != torch.float32):
        raise ValueError(f"bias must be [nblocks, 1, {blk}] float32, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if k < 1 or bin_depth < 1:
        raise ValueError(f"k={k} and bin_depth={bin_depth} must be >= 1")
    return nblocks, qcap, d, int_path


def _run_walk(block_first: torch.Tensor, rows_valid: torch.Tensor):
    """The walk over each run of blocks (a ``block_first`` up to the next
    one), through its blocks that hold rows ("live"; the others merge
    nothing) → (pos, prev, last, empty), per block: its position among the
    live blocks of its run, the live block before it in the run (valid
    where pos >= 1), the latest live block of its run at or before it, and
    whether there is none."""
    t = torch.arange(block_first.shape[0], dtype=torch.int64, device=block_first.device)
    start = torch.cummax(torch.where(block_first > 0, t, torch.zeros_like(t)), 0).values
    live = rows_valid > 0
    last = torch.cummax(torch.where(live, t, torch.full_like(t, -1)), 0).values
    prev = torch.cat([t.new_full((1,), -1), last[:-1]])
    n_live = torch.cumsum(live.to(torch.int64), 0)
    pos = (n_live - live.to(torch.int64)) - (n_live[start] - live[start].to(torch.int64))
    return pos, prev, last, last < start


def cluster_major_scan_grouped_reference(qg_blocks, vectors_t, block_first,
                                         block_last, rows_valid, k, blk=2048,
                                         group=4, nbins=128, bin_depth=2,
                                         bias=None, row_base=None):
    """Plain PyTorch K4, for every mode the JAX function takes → (pv, pr).

    The TPU kernel walks the blocks in order; here the walk is batched by
    position: every block merges its survivors into an empty state, then
    each block at position s among the live blocks of its run merges into
    the state left by the live block before it, s = 1, 2, ...  Blocks
    without rows merge nothing and take the state of the latest live block
    of their run.  The TPU kernel's ``improves`` skip is left out: it never
    changes a value above ``-inf`` (block ids rise along a run and ties go
    to the lowest id), only the ids of ``-inf`` fill."""
    nblocks, qcap, d, int_path = _check(qg_blocks, vectors_t, block_first, block_last,
                                        rows_valid, k, blk, group, nbins, bin_depth,
                                        bias, row_base)
    dev = qg_blocks.device
    if row_base is None:
        row_base = torch.arange(nblocks, dtype=torch.int32, device=dev) * blk
    if int_path and dev.type == "cpu":
        # torch.bmm on int8 returns int8 and wraps: upcast, exact in int32.
        scores = torch.bmm(qg_blocks.to(torch.int32),
                           vectors_t.to(torch.int32)).to(torch.float32)
    else:
        # int8 on CUDA: fp32 with TF32 off is exact (|dots| < 2**24).  bf16
        # products are exact in fp32, as the JAX kernel's f32 accumulation.
        scores = torch.bmm(qg_blocks.to(torch.float32), vectors_t.to(torch.float32))
    if bias is not None:
        scores = scores - bias
    cols = torch.arange(blk, device=dev)
    scores = torch.where((cols[None, :] < rows_valid[:, None])[:, None, :], scores,
                         torch.full_like(scores, _NEG_INF))
    tv, ti = topk.binned_top2(scores, row_base[:, None], blk, nbins, _NEG_INF,
                              depth=bin_depth)
    del scores
    # The state a block_first resets to: k fill entries with id 0.
    sv = torch.full((nblocks, qcap, k), _NEG_INF, dtype=torch.float32, device=dev)
    si = torch.zeros((nblocks, qcap, k), dtype=torch.int32, device=dev)
    sv, si = topk.extract_topk_ids(torch.cat([sv, tv], -1), torch.cat([si, ti], -1),
                                   k, _NEG_INF)
    pos, prev, last, empty = _run_walk(block_first, rows_valid)
    pos = torch.where(rows_valid > 0, pos, torch.zeros_like(pos))
    span = int(pos.max()) + 1 if nblocks else 1
    for s in range(1, span):
        at = torch.nonzero(pos == s).flatten()
        mv, mi = topk.extract_topk_ids(torch.cat([sv[prev[at]], tv[at]], -1),
                                       torch.cat([si[prev[at]], ti[at]], -1), k, _NEG_INF)
        sv[at], si[at] = mv, mi
    sv, si = sv[last.clamp_min(0)], si[last.clamp_min(0)]
    sv[empty] = _NEG_INF
    si[empty] = 0
    return sv, si


def _check_cuda_limits(name, nbins, k, bin_depth, d):
    """The shapes the CUDA kernels K4, K6 and K7 take: nbins 128, k <= 32,
    bin_depth <= 4, D <= 1024."""
    if (nbins != _CUDA_NBINS or k > _CUDA_K_MAX or bin_depth > _CUDA_DEPTH_MAX
            or d > _CUDA_DIM_MAX):
        raise ValueError(
            f"the CUDA {name} takes nbins={_CUDA_NBINS}, k <= {_CUDA_K_MAX}, bin_depth <= "
            f"{_CUDA_DEPTH_MAX} and D <= {_CUDA_DIM_MAX}; got nbins={nbins}, k={k}, "
            f"bin_depth={bin_depth}, D={d}")


def entry(name: str):
    """Build/load the CUDA library once and declare one C entry's types
    (K4, K6, K7, and K10 of ``harness/kernel_lab.py``)."""
    if name not in _FNS:
        n_ptr, n_int = _ENTRIES[name]
        fn = getattr(_build.load_library("ivf_grouped_scan"), name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def float_args(name: str, queries, vectors_t, d: int):
    """What a float mode of K4, K6, K7 or K10 adds before its launch: the
    float checks, and the slabs on a 16-byte boundary (the chunk stage loads
    16 bytes along blk) → (vectors_t, the float entry's extra arguments:
    ``(bf16,)``)."""
    _build.check_float(name, queries, vectors_t, d)
    return _build.aligned(vectors_t, 16), (int(vectors_t.dtype == torch.bfloat16),)


def cluster_major_scan_grouped(qg_blocks, vectors_t, block_first, block_last,
                               rows_valid, k, blk=2048, group=4, nbins=128,
                               bin_depth=2, bias=None, row_base=None):
    """K4 with the JAX signature → (pv [nblocks, qcap, k] f32,
    pr [nblocks, qcap, k] int32); see the module docstring.

    ``row_base`` [nblocks] int32 is each block's first row id (default
    ``arange(nblocks)·blk``; the recovery pass gives ``blocks_list·blk``).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (int8 ± bias, nbins 128, k <= 32, bin_depth <= 4, D <= 1024; fp32 or
    bf16 in one dtype, D <= 320) or raise."""
    global LAUNCHES
    dev = qg_blocks.device
    if dev.type == "cpu":
        return cluster_major_scan_grouped_reference(
            qg_blocks, vectors_t, block_first, block_last, rows_valid, k, blk=blk,
            group=group, nbins=nbins, bin_depth=bin_depth, bias=bias, row_base=row_base)
    nblocks, qcap, d, int_path = _check(qg_blocks, vectors_t, block_first, block_last,
                                        rows_valid, k, blk, group, nbins, bin_depth,
                                        bias, row_base)
    if row_base is None:
        row_base = torch.arange(nblocks, dtype=torch.int32, device=dev) * blk
    _build.check_inputs("K4", dev, [qg_blocks, vectors_t, block_first, block_last, rows_valid,
                                    row_base, bias])
    _check_cuda_limits("K4", nbins, k, bin_depth, d)
    flag = ()
    if not int_path:
        vectors_t, flag = float_args("K4", qg_blocks, vectors_t, d)
    pv = torch.empty((nblocks, qcap, k), dtype=torch.float32, device=dev)
    pr = torch.empty((nblocks, qcap, k), dtype=torch.int32, device=dev)
    args = (qg_blocks.data_ptr(), vectors_t.data_ptr(), block_first.data_ptr(),
            block_last.data_ptr(), rows_valid.data_ptr(),
            bias.data_ptr() if bias is not None else None, row_base.data_ptr(),
            pv.data_ptr(), pr.data_ptr(), nblocks, qcap, d, blk, k, bin_depth)
    name = "ivf_grouped_scan_i8" if int_path else "ivf_grouped_scan_f"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(name)(*args, *flag, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES += 1
    return pv, pr


def _check_cluster(qg, vectors_t, block_cluster, block_first, block_last, rows_valid, k,
                   blk, nbins, bin_depth, bias, row_base):
    """K6's checks → (nlist, nblocks, qcap, d, int_path)."""
    if qg.dim() != 3:
        raise ValueError(f"qg must be [nlist, qcap, D], got {tuple(qg.shape)}")
    nlist, qcap, d = qg.shape
    if vectors_t.dim() != 3:
        raise ValueError(f"vectors_t must be [nblocks, {d}, {blk}], got "
                         f"{tuple(vectors_t.shape)}")
    nblocks = vectors_t.shape[0]
    if tuple(block_cluster.shape) != (nblocks,) or block_cluster.dtype != torch.int32:
        raise ValueError(f"block_cluster must be [nblocks] int32, got "
                         f"{tuple(block_cluster.shape)} {block_cluster.dtype}")
    if bias is not None and (bias.numel() != nblocks * blk or bias.dtype != torch.float32):
        raise ValueError(f"bias must be [1, {nblocks * blk}] float32, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    # The rest as K4 checks them (on a shape-only stand-in for the per-block
    # queries), with one block per group.
    per_block = torch.empty((nblocks, qcap, d), dtype=qg.dtype, device="meta")
    _check(per_block, vectors_t, block_first, block_last, rows_valid, k, blk, 1, nbins,
           bin_depth, None, row_base)
    return nlist, nblocks, qcap, d, vectors_t.dtype == torch.int8


def cluster_major_scan_reference(qg, vectors_t, block_cluster, block_first, block_last,
                                 rows_valid, k, blk=512, nbins=128, bin_depth=2, bias=None,
                                 row_base=None):
    """Plain PyTorch K6, for every mode the JAX function takes → (pv, pr).

    K4's plain walk over the per-block queries ``qg[block_cluster]``, its
    ``block_last`` rows then re-indexed by cluster.  The other rows of the
    ``[nlist, qcap, k]`` outputs are left unwritten (``torch.empty``), as
    the JAX kernel leaves them undefined."""
    nlist, nblocks, qcap, d, _ = _check_cluster(qg, vectors_t, block_cluster, block_first,
                                                block_last, rows_valid, k, blk, nbins,
                                                bin_depth, bias, row_base)
    bc = block_cluster.long()
    pv, pr = cluster_major_scan_grouped_reference(
        qg[bc], vectors_t, block_first, block_last, rows_valid, k, blk=blk, group=1,
        nbins=nbins, bin_depth=bin_depth,
        bias=None if bias is None else bias.reshape(nblocks, 1, blk), row_base=row_base)
    out_v = torch.empty((nlist, qcap, k), dtype=torch.float32, device=qg.device)
    out_i = torch.empty((nlist, qcap, k), dtype=torch.int32, device=qg.device)
    t = torch.nonzero(block_last).flatten()
    out_v[bc[t]] = pv[t]
    out_i[bc[t]] = pr[t]
    return out_v, out_i


def cluster_major_scan(qg, vectors_t, block_cluster, block_first, block_last, rows_valid, k,
                       blk=512, nbins=128, bin_depth=2, bias=None, row_base=None):
    """K6 with the JAX signature → (pv [nlist, qcap, k] f32, pr [nlist,
    qcap, k] int32); see the module docstring.

    ``qg`` [nlist, qcap, D] routed queries per cluster; ``vectors_t``
    [nblocks, D, blk]; the four tables [nblocks] int32; ``bias`` [1,
    nblocks·blk] f32 or None; ``row_base`` [nblocks] int32 (default
    ``arange(nblocks)·blk``).  As on the TPU, ``block_cluster`` must be
    constant along a run and a cluster must end at most one run.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (int8 ±
    bias, nbins 128, k <= 32, bin_depth <= 4, D <= 1024; fp32 or bf16 in
    one dtype, D <= 320) or raise."""
    global CLUSTER_LAUNCHES
    dev = qg.device
    if dev.type == "cpu":
        return cluster_major_scan_reference(
            qg, vectors_t, block_cluster, block_first, block_last, rows_valid, k, blk=blk,
            nbins=nbins, bin_depth=bin_depth, bias=bias, row_base=row_base)
    nlist, nblocks, qcap, d, int_path = _check_cluster(
        qg, vectors_t, block_cluster, block_first, block_last, rows_valid, k, blk, nbins,
        bin_depth, bias, row_base)
    if row_base is None:
        row_base = torch.arange(nblocks, dtype=torch.int32, device=dev) * blk
    _build.check_inputs("K6", dev, [qg, vectors_t, block_cluster, block_first, block_last,
                                    rows_valid, row_base, bias])
    _check_cuda_limits("K6", nbins, k, bin_depth, d)
    flag = ()
    if not int_path:
        vectors_t, flag = float_args("K6", qg, vectors_t, d)
    pv = torch.empty((nlist, qcap, k), dtype=torch.float32, device=dev)
    pr = torch.empty((nlist, qcap, k), dtype=torch.int32, device=dev)
    name = "ivf_cluster_scan_i8" if int_path else "ivf_cluster_scan_f"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(name)(qg.data_ptr(), vectors_t.data_ptr(), block_cluster.data_ptr(),
                          block_first.data_ptr(), block_last.data_ptr(), rows_valid.data_ptr(),
                          bias.data_ptr() if bias is not None else None, row_base.data_ptr(),
                          pv.data_ptr(), pr.data_ptr(), nlist, nblocks, qcap, d, blk, k,
                          bin_depth, *flag, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    CLUSTER_LAUNCHES += 1
    return pv, pr


def _check_routed(qi, cq_blocks, vectors_t, block_first, block_last, rows_valid, k, blk,
                  group, nbins, bin_depth, bias, row_base):
    """K7's checks (the JAX function's, then K4's on a shape-only stand-in
    for the routed table) → (nbatch, nblocks, qcap, d, int_path)."""
    if blk % nbins:
        raise ValueError(f"blk={blk} must be a multiple of nbins={nbins}")
    if cq_blocks.dim() != 3 or cq_blocks.shape[2] != 1 or cq_blocks.dtype != torch.int32:
        raise ValueError(f"cq_blocks must be [nblocks, qcap, 1] int32, got "
                         f"{tuple(cq_blocks.shape)} {cq_blocks.dtype}")
    nblocks, qcap, _ = cq_blocks.shape
    if qi.dim() != 2:
        raise ValueError(f"qi must be [B, D], got {tuple(qi.shape)}")
    nbatch, d = qi.shape
    if (qi.dtype == torch.int8) != (vectors_t.dtype == torch.int8):
        raise ValueError("int8 path requires BOTH qi and vectors_t int8")
    per_block = torch.empty((nblocks, qcap, d), dtype=qi.dtype, device="meta")
    _, _, _, int_path = _check(per_block, vectors_t, block_first, block_last, rows_valid, k,
                               blk, group, nbins, bin_depth, bias, row_base)
    return nbatch, nblocks, qcap, d, int_path


def cluster_major_scan_routed_reference(qi, cq_blocks, vectors_t, block_first, block_last,
                                        rows_valid, k, blk=2048, group=4, nbins=128,
                                        bin_depth=2, bias=None, row_base=None):
    """Plain PyTorch K7, for every mode the JAX function takes → (pv, pr).

    The routed table ``qi[cq_blocks]`` (zero rows where an index lies
    outside ``[0, B)``), then K4's plain walk over it.  The TPU kernel's
    one-hot product reproduces ``qi`` bit for bit, so this is the same
    function."""
    nbatch = _check_routed(qi, cq_blocks, vectors_t, block_first, block_last, rows_valid, k,
                           blk, group, nbins, bin_depth, bias, row_base)[0]
    cq = cq_blocks[..., 0]
    hit = (cq >= 0) & (cq < nbatch)
    qg = qi[torch.where(hit, cq, torch.zeros_like(cq)).long()]
    qg = torch.where(hit[..., None], qg, torch.zeros((), dtype=qi.dtype, device=qi.device))
    return cluster_major_scan_grouped_reference(
        qg, vectors_t, block_first, block_last, rows_valid, k, blk=blk, group=group,
        nbins=nbins, bin_depth=bin_depth, bias=bias, row_base=row_base)


def cluster_major_scan_routed(qi, cq_blocks, vectors_t, block_first, block_last, rows_valid,
                              k, blk=2048, group=4, nbins=128, bin_depth=2, bias=None,
                              row_base=None):
    """K7 with the JAX signature → (pv [nblocks, qcap, k] f32, pr [nblocks,
    qcap, k] int32); see the module docstring.

    ``qi`` [B, D] the whole batch; ``cq_blocks`` [nblocks, qcap, 1] int32;
    the rest as :func:`cluster_major_scan_grouped`.  Only ``block_last`` rows
    are defined.  CPU tensors take the plain version; CUDA tensors launch
    the kernel (int8 ± bias, nbins 128, k <= 32, bin_depth <= 4, D <= 1024;
    fp32 or bf16 in one dtype, D <= 320) or raise."""
    global ROUTED_LAUNCHES
    dev = qi.device
    if dev.type == "cpu":
        return cluster_major_scan_routed_reference(
            qi, cq_blocks, vectors_t, block_first, block_last, rows_valid, k, blk=blk,
            group=group, nbins=nbins, bin_depth=bin_depth, bias=bias, row_base=row_base)
    nbatch, nblocks, qcap, d, int_path = _check_routed(
        qi, cq_blocks, vectors_t, block_first, block_last, rows_valid, k, blk, group, nbins,
        bin_depth, bias, row_base)
    if row_base is None:
        row_base = torch.arange(nblocks, dtype=torch.int32, device=dev) * blk
    _build.check_inputs("K7", dev, [qi, cq_blocks, vectors_t, block_first, block_last,
                                    rows_valid, row_base, bias])
    _check_cuda_limits("K7", nbins, k, bin_depth, d)
    flag = ()
    if not int_path:
        # The routed rows are gathered from qi a scalar at a time: only the
        # slabs need the 16-byte boundary.
        vectors_t, flag = float_args("K7", qi, vectors_t, d)
    pv = torch.empty((nblocks, qcap, k), dtype=torch.float32, device=dev)
    pr = torch.empty((nblocks, qcap, k), dtype=torch.int32, device=dev)
    name = "ivf_routed_scan_i8" if int_path else "ivf_routed_scan_f"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = entry(name)(qi.data_ptr(), cq_blocks.data_ptr(), vectors_t.data_ptr(),
                          block_first.data_ptr(), block_last.data_ptr(), rows_valid.data_ptr(),
                          bias.data_ptr() if bias is not None else None, row_base.data_ptr(),
                          pv.data_ptr(), pr.data_ptr(), nbatch, nblocks, qcap, d, blk, k,
                          bin_depth, *flag, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    ROUTED_LAUNCHES += 1
    return pv, pr
