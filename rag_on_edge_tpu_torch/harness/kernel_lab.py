"""Kernel-variant lab: where the cluster-major scan's time goes
(counterpart: ``rag_on_edge_tpu/harness/kernel_lab.py``), with kernel K10.

It times stripped-down variants of the per-cluster scan (kernel K6) over
the same block walk:

- ``full``     — the scan itself (binned top-2 + running merge);
- ``nogate``   — the merge on every block (no ``improves`` skip);
- ``maxonly``  — the scores and a row-max write only (no selection): the
                 walk's GEMM floor;
- ``fixedout`` — ``maxonly`` into one constant output window (results
                 wrong by design; timing only): against ``maxonly``, the
                 cost of the per-cluster output writes.

:func:`_variant_scan` is K10: CPU tensors take
:func:`_variant_scan_reference`; CUDA tensors launch the fourth pair of
entries of ``csrc/ivf_grouped_scan.cu`` (``ivf_variant_scan_i8`` and
``ivf_variant_scan_f``) or raise.  They run K6's own kernels at bin depth 2
with a compile-time variant: int8 and bf16 on ``grouped_wgmma_kernel``,
fp32 on ``grouped_ffma_kernel``, so ``full`` is the very instance K6 runs.
Its launches count in ``LAUNCHES``.  The lab's own CLI builds an int8
index, as the JAX lab does; the float modes are reached by calling
:func:`routed_table` on a float index and :func:`lab` with its table.

Usage (on the card)::

    python -m rag_on_edge_tpu_torch.harness.kernel_lab --dataset sift \\
        --pad-block 2048 --qcap 128 --variants full maxonly
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from rag_on_edge_tpu_torch.harness import timing
from rag_on_edge_tpu_torch.models.ivf import IVFIndex, invert_probes
from rag_on_edge_tpu_torch.ops import _build, ivf_scan, topk

__all__ = ["LAUNCHES", "VARIANTS", "routed_table", "lab", "main"]

VARIANTS = ("full", "nogate", "maxonly", "fixedout")

#: Launches of the CUDA kernel K10 in this process; the plain version does
#: not count.  A run that must show it went through the kernel sets it to 0
#: before and reads it after.
LAUNCHES = 0

_NEG_INF = float("-inf")


def _check(qg, vectors_t, bc, bf, bl, rv, k, blk, nbins, variant):
    """K6's checks at bin depth 2 and no bias → (nlist, nblocks, qcap, d,
    int_path)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")
    return ivf_scan._check_cluster(qg, vectors_t, bc, bf, bl, rv, k, blk, nbins, 2, None, None)


def _variant_scan_reference(qg, vectors_t, bc, bf, bl, rv, k, blk, nbins, variant):
    """Plain PyTorch K10 → (out_v [nlist, qcap, k] f32, out_i [nlist, qcap,
    k] int32).  What each variant writes:

    - ``full``, ``nogate``: K6's values and ids (bin depth 2, no bias) in
      the windows of clusters that end a run of blocks;
    - ``maxonly``: in the window of each cluster with blocks, the row max
      (over columns below ``rows_valid``) of the cluster's last block in
      the walk, over all k slots, ids 0;
    - ``fixedout``: window 0 holds the row max of the walk's last block.

    Other windows are left unwritten (``torch.empty``), as the TPU kernel
    leaves them undefined."""
    nlist, nblocks, qcap, d, int_path = _check(qg, vectors_t, bc, bf, bl, rv, k, blk, nbins,
                                               variant)
    if variant in ("full", "nogate"):
        return ivf_scan.cluster_major_scan_reference(qg, vectors_t, bc, bf, bl, rv, k, blk=blk,
                                                     nbins=nbins, bin_depth=2)
    dev = qg.device
    out_v = torch.empty((nlist, qcap, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nlist, qcap, k), dtype=torch.int32, device=dev)
    bcl = bc.long()
    t = torch.arange(nblocks, device=dev)
    ok = (bcl >= 0) & (bcl < nlist)
    if variant == "fixedout":
        src = t[-1:][ok[-1:]]
        win = torch.zeros_like(src)
    else:
        last = torch.full((nlist,), -1, dtype=torch.long, device=dev)
        last.scatter_reduce_(0, bcl[ok], t[ok], "amax")
        win = torch.nonzero(last >= 0).flatten()
        src = last[win]
    q, v = qg[bcl[src]], vectors_t[src]
    if int_path and dev.type == "cpu":
        # torch.bmm on int8 returns int8 and wraps: upcast, exact in int32.
        scores = torch.bmm(q.to(torch.int32), v.to(torch.int32)).to(torch.float32)
    else:
        # int8 on CUDA: fp32 with TF32 off is exact (|dots| < 2**24).
        scores = torch.bmm(q.to(torch.float32), v.to(torch.float32))
    cols = torch.arange(blk, device=dev)
    scores = torch.where((cols[None, :] < rv[src][:, None])[:, None, :], scores,
                         torch.full_like(scores, _NEG_INF))
    out_v[win] = scores.amax(dim=-1)[..., None].expand(-1, -1, k)
    out_i[win] = 0
    return out_v, out_i


def _variant_scan(qg, vectors_t, bc, bf, bl, rv, k, blk, nbins, variant):
    """K10 with the JAX signature → (out_v [nlist, qcap, k] f32, out_i
    [nlist, qcap, k] int32); see :func:`_variant_scan_reference`.

    ``qg`` [nlist, qcap, D] routed queries per cluster; ``vectors_t``
    [nblocks, D, blk]; ``bc``/``bf``/``bl``/``rv`` the block tables
    [nblocks] int32.  Ids are ``block·blk + column``.  CPU tensors take the
    plain version; CUDA tensors launch the kernel (int8, or fp32 or bf16 in
    one dtype; any nbins dividing blk: ``full`` and ``nogate`` at nbins
    other than 128 on K6's general selection, ``ivf_scan.selection``,
    ``maxonly`` and ``fixedout`` select nothing; any D; any k: ``full`` and
    ``nogate`` in passes of 32, as K6, ``maxonly`` and ``fixedout`` in one
    launch, their row max written to every slot) or raise.  A float ``qg``
    whose rows lie at a 16-byte pitch (:func:`routed_table`'s) is read in
    place; int8 rows are padded to the pitch as K6's."""
    global LAUNCHES
    nlist, nblocks, qcap, d, int_path = _check(qg, vectors_t, bc, bf, bl, rv, k, blk, nbins,
                                               variant)
    dev = qg.device
    if dev.type == "cpu":
        return _variant_scan_reference(qg, vectors_t, bc, bf, bl, rv, k, blk, nbins, variant)
    row_base = torch.arange(nblocks, dtype=torch.int32, device=dev) * blk
    # K6's selection at JAX's fixed depth 2; maxonly and fixedout select
    # nothing, so their bins change nothing.
    if variant not in ("full", "nogate"):
        nbins = 128
    depth, keepall, scratch, nslots = ivf_scan.selection(
        k, blk, nbins, 2, vectors_t.dtype == torch.float32, dev)
    vectors_t, rv, _, blk = ivf_scan.whole_chunks(vectors_t, rv, None, blk)
    if not int_path:  # qg read at its row pitch (in place where it lies so)
        qg, vectors_t, ldq, bf16 = ivf_scan.float_operands("K10", qg, vectors_t)
    _build.check_inputs("K10", dev, [qg, vectors_t, bc, bf, bl, rv])
    if int_path:  # wgmma fed by TMA: the rows at TMA's 16-byte pitch, the pad zero
        qg, vectors_t = ivf_scan.int8_operands(qg, vectors_t)
        ldq, flag = qg.shape[-1], ()
    else:
        flag = (bf16,)
    name = "ivf_variant_scan_i8" if int_path else "ivf_variant_scan_f"
    fn = ivf_scan.entry(name)
    head = (qg.data_ptr(), vectors_t.data_ptr(), bc.data_ptr(), bf.data_ptr(), bl.data_ptr(),
            rv.data_ptr(), row_base.data_ptr())
    # full and nogate keep a running top-k of 32 a row, so a larger k runs
    # in passes as K6's; maxonly and fixedout write one row max to every slot.
    width = _build.PASS_K if variant in ("full", "nogate") else k
    gen = ivf_scan.gen_pointers(scratch)
    out, n = ivf_scan._launch_passes(name, k, nlist, qcap, dev, lambda kp, pv, pr, bv, bi, st: fn(
        *head, bv, bi, pv, pr, *gen, nlist, nblocks, qcap, d, ldq, blk, kp,
        VARIANTS.index(variant), *flag, nbins, depth, keepall, nslots, st), width)
    LAUNCHES += n
    return out


def routed_table(idx: IVFIndex, queries: np.ndarray, batch: int, nprobe: int,
                 qcap: int) -> torch.Tensor:
    """The lab's one fixed routing, built outside the timed region: a
    seeded shuffle of ``batch`` queries (the dataset's, repeated), their
    top-``nprobe`` centroids by inner product, the probe inversion at
    ``qcap``, and the routed table ``qg`` [nlist, qcap, D'] on the index's
    device (zero rows in empty slots) of the index's query rows: int8
    (``quantize_int8``, as the JAX lab), or fp32 / bf16 with L2's ones
    column, written at the 16-byte pitch the float kernels read in place
    (``ivf_scan.routed_table``)."""
    rng = np.random.default_rng(0)
    q = rng.permuted(np.resize(queries, (batch, queries.shape[1])), axis=0).astype(np.float32)
    q = torch.from_numpy(q).to(idx.device)
    a = idx._arrays
    _, probes = topk.small_topk(q @ a["centroids"].T, nprobe)
    cq, _, _ = invert_probes(probes, idx.nlist, qcap)
    return ivf_scan.routed_table(idx._query_prep(q)[0], cq)


def lab(idx: IVFIndex, qg: torch.Tensor, k: int = 20, nbins: int = 128,
        variants=("full", "nogate", "maxonly"), repeats: int = 8,
        quiet: bool = False) -> dict:
    """Time each variant over the index's block walk → {variant: (ms per
    call, µs per block)}, printed as the JAX lab prints them."""
    a = idx._arrays
    nblocks = a["vectors_t"].shape[0]
    out = {}
    for variant in variants:
        def fn(variant=variant):
            return _variant_scan(qg, a["vectors_t"], a["block_cluster"], a["block_first"],
                                 a["block_last"], a["rows_valid"], k, idx.PAD_BLOCK, nbins,
                                 variant)
        ms = timing.per_call_ms(fn, [qg.device], calls=repeats)
        out[variant] = (ms, ms * 1e3 / nblocks)
        if not quiet:
            print(f"  {variant:<9} {ms:8.2f} ms/call ({ms * 1e3 / nblocks:6.2f} us/block)")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="sift")
    ap.add_argument("--pad-block", type=int, default=2048)
    ap.add_argument("--qcap", type=int, default=128)
    ap.add_argument("--nbins", type=int, default=128)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--nprobe", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=8)
    ap.add_argument("--variants", nargs="+", default=["full", "nogate", "maxonly"])
    args = ap.parse_args(argv)

    from rag_on_edge_tpu_torch.utils.datasets import load_dataset

    ds = load_dataset(args.dataset, gt_k=10)
    idx = IVFIndex.build(ds.base, nlist=None, metric="l2", dtype="int8",
                         pad_block=args.pad_block, seed=42)
    idx._ensure_kernel_state()
    qg = routed_table(idx, ds.queries, args.batch, args.nprobe, args.qcap)
    nblocks = idx._arrays["vectors_t"].shape[0]
    print(f"{args.dataset}: nblocks={nblocks} blk={args.pad_block} "
          f"qcap={args.qcap} k={args.k} nbins={args.nbins}")
    lab(idx, qg, args.k, args.nbins, args.variants, args.repeats)


if __name__ == "__main__":
    main()
