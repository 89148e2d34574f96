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
operands in one dtype; ± bias) or raise.  K6 and K7 do the same, in the
same modes, and so does K10 (``harness/kernel_lab.py``), on the same two
kernels.  The int8 and bf16 modes run on ``grouped_wgmma_kernel``: ``wgmma``
(s8 -> s32, the slab transposed in shared memory; bf16 -> f32, the slab
read as it lies through the transpose-A bit) fed by TMA.  The fp32 modes
run on ``grouped_ffma_kernel``, the FFMA register tile of
``csrc/ffma_tile.cuh``.  Both read the routed rows at a 16-byte row pitch:
int8 with the pad zero (:func:`int8_operands`; no copy at D = 128), the
float modes with any pad (:func:`float_operands`: a view that lies so, as
:func:`routed_table` writes a float table, is read in place).  The kernels
keep a running top-k of 32 a row; a larger k runs in passes of 32
(``_build.by_passes``), each pass given each row's last entry of the one
before as its bound.  The kernels' own selection holds nbins 128 at bin
depths 1-4 (fp32 up to 65536 chunks a block); any other nbins dividing
blk, and any depth, run the general selection (:func:`selection`).

K6, :func:`cluster_major_scan`, computes the same walk with the routed
queries and the output indexed by cluster: block ``j`` is scored against
``qg[block_cluster[j]]`` (``qg`` [nlist, qcap, D]) and each run's top-k
goes to row ``block_cluster[t]`` of ``[nlist, qcap, k]``.  Rows of clusters
that end no run are unwritten.  The sharded index runs it over a shard's
block walk and the recovery pass's compacted block list.  Its CUDA entries
(``ivf_cluster_scan_i8`` and ``ivf_cluster_scan_f`` in the same source)
share K4's kernels; its launches count in ``CLUSTER_LAUNCHES``.

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

from rag_on_edge_tpu_torch.ops import _build, ivf_accum, topk

__all__ = ["LAUNCHES", "CLUSTER_LAUNCHES", "ROUTED_LAUNCHES", "routed_table",
           "cluster_major_scan_grouped",
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
# The kernels' own selection: 128 bins (a chunk's columns) at bin depths 1-4
# (register arrays sized at compile time), fp32 up to 65536 chunks a block
# (the lists keep a chunk in 16 bits).  Other shapes take the general
# selection (:func:`selection`).
_FAST_NBINS = 128
_FAST_DEPTH_MAX = 4
_FAST_FP32_BLK_MAX = 128 * 65536
# The general selection's slots of lists: more than the CTAs of its kernels
# that fit on a multiprocessor at once (the FFMA kernel three, the wgmma
# kernel one), so a CTA that waits for a slot always finds one.
_SLOTS_PER_SM = 4
# The rows of a CTA of the general selection (both kernels).
_GEN_ROWS = 32

_FNS: dict = {}

# The C entries of csrc/ivf_grouped_scan.cu: (pointer args, int args), the
# stream last.  Every entry takes the routed rows' pitch, two pointers, the
# rows' bounds of a later pass, and the general selection's three
# (scratch, locks) and three ints (nbins, keepall, slots); the float
# entries one more int, bf16 (0 or 1).
_ENTRIES = {
    "ivf_grouped_scan_i8": (14, 10), "ivf_grouped_scan_f": (14, 11),
    "ivf_cluster_scan_i8": (15, 11), "ivf_cluster_scan_f": (15, 12),
    "ivf_routed_scan_i8": (15, 11), "ivf_routed_scan_f": (15, 12),
    "ivf_variant_scan_i8": (14, 12), "ivf_variant_scan_f": (14, 13),
}


def routed_table(rows: torch.Tensor, cq: torch.Tensor, blocks: torch.Tensor | None = None,
                 pitched: bool = True) -> torch.Tensor:
    """The routed table of the batch ``rows`` [B, D]: row ``cq[c, s]`` of
    the batch, zero for an empty slot (-1) → [nlist, qcap, D], or with
    ``blocks`` each listed block's cluster's rows, [len(blocks), qcap, D].
    A float table is written at a 16-byte row pitch (a view of a
    zero-padded buffer), which the float wrappers of K4, K6 and K10 read in
    place, so no launch copies it; contiguous with ``pitched=False`` (K1's
    input).  An int8 table is contiguous, since the int8 kernels read the
    pad and their wrappers pad the rows themselves."""
    src = rows
    if pitched and rows.dtype != torch.int8:
        src = _build.pad_rows(rows, 16 // rows.element_size())
    table = torch.where((cq >= 0)[..., None], src[cq.clamp_min(0).long()],
                        torch.zeros((), dtype=rows.dtype, device=rows.device))
    if blocks is not None:
        table = table[blocks.long()]
    return table[..., :rows.shape[-1]]


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


def selection(k: int, blk: int, nbins: int, bin_depth: int, fp32: bool, dev):
    """How the CUDA K4, K6, K7 and K10 select for a call of total ``k`` →
    (depth, keepall, scratch, nslots), the last three the general
    selection's.

    ``depth`` is ``min(bin_depth, blk // nbins)``: a bin holds ``blk //
    nbins`` columns, and a depth at or past that keeps them all, which is
    the same function.  The kernels' own selection takes nbins 128 at
    depths 1-4 (fp32 up to 65536 chunks a block); the rest runs the general
    selection (``csrc/ivf_grouped_scan.cu``, ``GenArgs``): with
    ``keepall`` where ``bin_depth >= min(k, blk // nbins)`` (a column among
    a row's top k of the run has fewer than k better columns in its bin,
    so every such column survives, and the binned walk equals the unbinned
    one), else through per-(row, bin) lists of ``depth`` in ``scratch``
    (scores, columns, lock words), ``nslots`` slots of ``32·nbins·depth``
    entries."""
    depth = min(bin_depth, blk // nbins)
    general = (nbins != _FAST_NBINS or depth > _FAST_DEPTH_MAX
               or (fp32 and blk > _FAST_FP32_BLK_MAX))
    keepall = int(general and bin_depth >= min(k, blk // nbins))
    if not general or keepall:
        return depth, keepall, (None, None, None), 0
    nslots = _SLOTS_PER_SM * torch.cuda.get_device_properties(dev).multi_processor_count
    n = nslots * _GEN_ROWS * nbins * depth
    scratch = (torch.empty(n, dtype=torch.float32, device=dev),
               torch.empty(n, dtype=torch.int32, device=dev),
               torch.zeros(nslots, dtype=torch.int32, device=dev))
    return depth, keepall, scratch, nslots


def gen_pointers(scratch):
    """The general selection's three pointers (None where it takes none)."""
    return tuple(x.data_ptr() if x is not None else None for x in scratch)


def whole_chunks(vectors_t, rows_valid, bias, blk):
    """The kernels walk the slab in chunks of 128 columns: a ``blk`` that is
    not a multiple of 128 (nbins dividing it) is zero-padded to one, with
    ``rows_valid`` clamped to ``blk`` so the pad scores -inf and ``bias``
    padded alike → (vectors_t, rows_valid, bias [nblocks, blk'] or None,
    blk').  Ids and bins are the caller's, from the true ``blk``."""
    if blk % 128 == 0:
        return vectors_t, rows_valid, bias, blk
    vectors_t = _build.pad_rows(vectors_t, 128)
    rows_valid = rows_valid.clamp(max=blk).contiguous()
    if bias is not None:
        bias = _build.pad_rows(bias.reshape(-1, blk), 128)
    return vectors_t, rows_valid, bias, vectors_t.shape[-1]


def _launch_passes(name, k, out_rows, qcap, dev, launch, width=_build.PASS_K):
    """The kernel in passes of ``width``: ``launch(kp, pv, pr, bound_v,
    bound_i, stream)`` fills pv / pr [out_rows, qcap, kp] and returns the
    CUDA error → ((pv, pr) [out_rows, qcap, k], the launches made)."""
    def run(kp, bound_v, bound_i):
        pv = torch.empty((out_rows, qcap, kp), dtype=torch.float32, device=dev)
        pr = torch.empty((out_rows, qcap, kp), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = launch(kp, pv.data_ptr(), pr.data_ptr(),
                         bound_v.data_ptr() if bound_v is not None else None,
                         bound_i.data_ptr() if bound_i is not None else None, stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        return pv, pr

    return _build.by_passes(k, run, width), -(-k // width)


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


def float_operands(name: str, queries, vectors_t):
    """What the float modes of K4, K6, K7 and K10 (bf16 on ``wgmma`` fed by
    TMA, fp32 on the FFMA register tile) read: the routed rows (K4's
    ``qg_blocks``, K6's and K10's ``qg``) or the batch (K7's ``qi``) at a
    16-byte row pitch (:func:`_build.pitched_storage`: read in place where
    they lie so, as :func:`routed_table` writes them; else one zero-padded
    copy), and the slab on a 16-byte base → (queries' storage [..., ldq],
    vectors_t, ldq, bf16)."""
    _build.check_float(name, queries, vectors_t)
    bf16 = int(vectors_t.dtype == torch.bfloat16)
    storage, ldq = _build.pitched_storage(queries)
    return _build.aligned(storage, 16), _build.aligned(vectors_t, 16), ldq, bf16


def int8_operands(queries, vectors_t):
    """What the int8 modes of K4, K6, K7 and K10 (``wgmma`` fed by TMA) read:
    the routed rows (K4's ``qg_blocks``, K6's and K10's ``qg``) or the batch
    (K7's ``qi``) with D
    zero-padded to TMA's 16-byte row pitch (:func:`ivf_accum.kernel_operands`:
    one copy where D needs it, none at D = 128), and both on 16-byte bases.
    The pad adds zero terms to every dot, so no score moves; the kernel
    reads d past the pitch, up to its 128-byte unit, as TMA's zeros."""
    return (_build.aligned(ivf_accum.kernel_operands(queries), 16),
            _build.aligned(vectors_t, 16))


def cluster_major_scan_grouped(qg_blocks, vectors_t, block_first, block_last,
                               rows_valid, k, blk=2048, group=4, nbins=128,
                               bin_depth=2, bias=None, row_base=None):
    """K4 with the JAX signature → (pv [nblocks, qcap, k] f32,
    pr [nblocks, qcap, k] int32); see the module docstring.

    ``row_base`` [nblocks] int32 is each block's first row id (default
    ``arange(nblocks)·blk``; the recovery pass gives ``blocks_list·blk``).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (int8 ± bias, or fp32 or bf16 in one dtype; any nbins dividing blk, any
    bin_depth, as :func:`selection` sets out; any D; k > 32 in passes) or
    raise.  A float ``qg_blocks`` whose rows lie at a 16-byte pitch
    (:func:`routed_table`'s) is read in place."""
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
    depth, keepall, scratch, nslots = selection(k, blk, nbins, bin_depth,
                                                vectors_t.dtype == torch.float32, dev)
    vectors_t, rows_valid, bias, blk = whole_chunks(vectors_t, rows_valid, bias, blk)
    if not int_path:  # qg_blocks read at its row pitch (in place where it lies so)
        qg_blocks, vectors_t, ldq, bf16 = float_operands("K4", qg_blocks, vectors_t)
    _build.check_inputs("K4", dev, [qg_blocks, vectors_t, block_first, block_last, rows_valid,
                                    row_base, bias])
    if int_path:
        # wgmma fed by TMA: the routed rows at TMA's 16-byte row pitch, both
        # operands from 16-byte bases.
        qg_blocks, vectors_t = int8_operands(qg_blocks, vectors_t)
        dims, flag = (d, qg_blocks.shape[-1]), ()
    else:
        dims, flag = (d, ldq), (bf16,)
    name = "ivf_grouped_scan_i8" if int_path else "ivf_grouped_scan_f"
    fn = entry(name)
    head = (qg_blocks.data_ptr(), vectors_t.data_ptr(), block_first.data_ptr(),
            block_last.data_ptr(), rows_valid.data_ptr(),
            bias.data_ptr() if bias is not None else None, row_base.data_ptr())
    gen = gen_pointers(scratch)
    out, n = _launch_passes(name, k, nblocks, qcap, dev, lambda kp, pv, pr, bv, bi, st: fn(
        *head, bv, bi, pv, pr, *gen, nblocks, qcap, *dims, blk, kp, depth, *flag, nbins,
        keepall, nslots, st))
    LAUNCHES += n
    return out


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
    bias, or fp32 or bf16 in one dtype; any nbins dividing blk, any
    bin_depth, as :func:`selection` sets out; any D; k > 32 in passes) or
    raise.  A float ``qg`` whose rows lie at a 16-byte pitch
    (:func:`routed_table`'s) is read in place."""
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
    depth, keepall, scratch, nslots = selection(k, blk, nbins, bin_depth,
                                                vectors_t.dtype == torch.float32, dev)
    vectors_t, rows_valid, bias, blk = whole_chunks(vectors_t, rows_valid, bias, blk)
    if not int_path:  # qg read at its row pitch (in place where it lies so)
        qg, vectors_t, ldq, bf16 = float_operands("K6", qg, vectors_t)
    _build.check_inputs("K6", dev, [qg, vectors_t, block_cluster, block_first, block_last,
                                    rows_valid, row_base, bias])
    if int_path:
        # wgmma fed by TMA: the clusters' routed rows at TMA's 16-byte row
        # pitch, both operands from 16-byte bases.
        qg, vectors_t = int8_operands(qg, vectors_t)
        dims, flag = (d, qg.shape[-1]), ()
    else:
        dims, flag = (d, ldq), (bf16,)
    name = "ivf_cluster_scan_i8" if int_path else "ivf_cluster_scan_f"
    fn = entry(name)
    head = (qg.data_ptr(), vectors_t.data_ptr(), block_cluster.data_ptr(),
            block_first.data_ptr(), block_last.data_ptr(), rows_valid.data_ptr(),
            bias.data_ptr() if bias is not None else None, row_base.data_ptr())
    gen = gen_pointers(scratch)
    out, n = _launch_passes(name, k, nlist, qcap, dev, lambda kp, pv, pr, bv, bi, st: fn(
        *head, bv, bi, pv, pr, *gen, nlist, nblocks, qcap, *dims, blk, kp, depth, *flag, nbins,
        keepall, nslots, st))
    CLUSTER_LAUNCHES += n
    return out


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
    the kernel (int8 ± bias, or fp32 or bf16 in one dtype; any nbins
    dividing blk, any bin_depth, as :func:`selection` sets out; any D; k >
    32 in passes) or raise.  A float ``qi`` whose rows lie at a 16-byte
    pitch is read in place."""
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
    depth, keepall, scratch, nslots = selection(k, blk, nbins, bin_depth,
                                                vectors_t.dtype == torch.float32, dev)
    vectors_t, rows_valid, bias, blk = whole_chunks(vectors_t, rows_valid, bias, blk)
    if not int_path:
        # bf16 gathers the batch in 16-byte pieces, fp32 in 16-byte copies:
        # its rows at a 16-byte pitch (in place where they lie so).
        qi, vectors_t, ldq, bf16 = float_operands("K7", qi, vectors_t)
    _build.check_inputs("K7", dev, [qi, cq_blocks, vectors_t, block_first, block_last,
                                    rows_valid, row_base, bias])
    if int_path:
        # wgmma: the batch gathered in 16-byte pieces (its rows at a 16-byte
        # pitch), the slab by TMA from a 16-byte base.
        qi, vectors_t = int8_operands(qi, vectors_t)
        dims, flag = (d, qi.shape[-1]), ()
    else:
        dims, flag = (d, ldq), (bf16,)
    name = "ivf_routed_scan_i8" if int_path else "ivf_routed_scan_f"
    fn = entry(name)
    head = (qi.data_ptr(), cq_blocks.data_ptr(), vectors_t.data_ptr(),
            block_first.data_ptr(), block_last.data_ptr(), rows_valid.data_ptr(),
            bias.data_ptr() if bias is not None else None, row_base.data_ptr())
    gen = gen_pointers(scratch)
    out, n = _launch_passes(name, k, nblocks, qcap, dev, lambda kp, pv, pr, bv, bi, st: fn(
        *head, bv, bi, pv, pr, *gen, nbatch, nblocks, qcap, *dims, blk, kp, depth, *flag, nbins,
        keepall, nslots, st))
    ROUTED_LAUNCHES += n
    return out
