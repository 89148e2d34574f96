"""Sharded search: the database split across a list of devices, queries
replicated, and a merge of the per-shard top-k (counterpart:
``rag_on_edge_tpu/parallel/sharded.py``).

- **Brute force**: base rows are cut into equal shards (the last padded);
  each shard scores its rows (kernel K3 for ``engine="pallas"``, plain torch
  for ``"xla"``), keeps a local top-k, and the merge re-selects k from the
  k·S candidates.
- **IVF**: whole clusters (contiguous ranges, balanced by rows) go to
  shards; the coarse probe and the probe inversion are replicated, each
  shard scans only the probed clusters it owns (cluster mode: kernel K1 or
  K6, the recovery pass through K6; query mode: :func:`fine_scan`), and the
  same merge follows.

The JAX package runs all of this as one ``shard_map`` program.  The port
keeps its single controller: one process drives the list of devices.
Each shard's tensors live on its device and the per-shard work runs in a
Python loop; CUDA launches are asynchronous, so shards on different cards
overlap.  ``all_gather(tiled=True)`` becomes: move each shard's [B, k] to
``devices[0]`` and concatenate in shard order (the order that decides
ties); ``psum`` becomes a sum over shards.  Logical shards may share a
device (the CPU tests run 8 shards on the CPU, ``chip_smoke.py`` runs 4 on
one card).  The merge is the plain function :func:`_gather_merge`, so a
multi-process form can reuse it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from rag_on_edge_tpu_torch.models.ivf import (JOIN_FUSED_MIN, IVFIndex, coarse_arrays_host,
                                              coarse_probes_tiered, coarse_tier, fine_scan,
                                              invert_probes)
from rag_on_edge_tpu_torch.ops import (_build, distances, fused_topk, ivf_accum, ivf_scan,
                                       quantize, topk)
from rag_on_edge_tpu_torch.ops.block_tables import build_block_tables
from rag_on_edge_tpu_torch.ops.bruteforce_fused import fused_topk_matmul

__all__ = ["ShardedBruteForceIndex", "ShardedIVFIndex"]

_NEG_INF = float("-inf")
_INT32_MIN = -(2**31)


def _device_list(devices) -> list[torch.device]:
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a sharded index needs at least one device")
    return devs


def _gather_merge(vals_list: list[torch.Tensor], ids_list: list[torch.Tensor], k: int,
                  dedup: bool = False):
    """The cross-shard join: each shard's [B, k'] candidates go to the first
    shard's device, side by side in shard order ([B, S·k']), and the top k
    are re-selected (ties to the lowest position, as ``lax.top_k``).  With
    ``dedup`` (spilled indexes), a vector that two shards return is counted
    once, and ids are re-masked to -1 wherever the selected value is -inf,
    so killed duplicates do not leak their ids."""
    dev = vals_list[0].device
    vg = torch.cat([v.to(dev) for v in vals_list], dim=1)
    ig = torch.cat([i.to(dev) for i in ids_list], dim=1)
    if dedup:
        vg, ig = topk.dedup_rows_by_id(vg, ig)
    out_v, sel = topk.topk(vg, k)
    out_i = torch.gather(ig, 1, sel.long())
    if dedup:
        out_i = torch.where(out_v > _NEG_INF, out_i, torch.full_like(out_i, -1))
    return out_v, out_i


def _memo_last(fn: Callable):
    """Memoize the most recent shard's result.  Effective only under the
    shard-outer placement loop (:func:`_place_shards`), where every consumer
    of shard s runs before the loop moves to s+1: a one-entry cache then
    shares a shard's expensive slices (the block tables, the compact fp32
    rows) without holding more than one shard's worth of host memory."""
    cache: dict = {}

    def wrapped(s):
        if cache.get("s") != s:
            cache["s"] = s
            cache["v"] = fn(s)
        return cache["v"]

    return wrapped


def _place_shards(devices: list[torch.device], specs: dict) -> list[dict]:
    """Per-shard arrays, placed with one shard-outer loop.

    ``specs`` maps name -> (shape, dtype, fn); ``fn(s)`` gives shard s's
    array (numpy or a tensor) of that shape, which goes straight to
    ``devices[s]`` and takes ``dtype`` there.  Peak host memory is one
    shard's slices."""
    out = []
    for s, dev in enumerate(devices):
        arrays = {}
        for name, (shape, dtype, fn) in specs.items():
            x = fn(s)
            if isinstance(x, np.ndarray):
                x = torch.from_numpy(np.ascontiguousarray(x))
            if tuple(x.shape) != tuple(shape):
                raise AssertionError(f"{name}: shard {s} has shape {tuple(x.shape)}, "
                                     f"not {tuple(shape)}")
            arrays[name] = x.to(dev).to(dtype).contiguous()
        out.append(arrays)
    return out


def _partition_clusters(offsets: np.ndarray, n_shards: int) -> list[tuple[int, int]]:
    """Assign contiguous cluster ranges to shards, balancing row counts.

    Returns per-shard (cluster_lo, cluster_hi).  Contiguity preserves the
    reordered layout's slab property within each shard.
    """
    nlist = len(offsets) - 1
    total = int(offsets[-1])
    bounds = []
    lo = 0
    for s in range(n_shards):
        target = total * (s + 1) / n_shards
        hi = int(np.searchsorted(offsets[1:], target, side="left")) + 1
        hi = max(min(hi, nlist), lo)
        if s == n_shards - 1:
            hi = nlist
        bounds.append((lo, hi))
        lo = hi
    return bounds


class ShardedBruteForceIndex:
    """Exact brute-force search with the base rows sharded over devices.

    dtype "fp32" | "bf16" | "int8": int8 uses one global base scale, so
    shards' raw scores compare before the merge.  engine "pallas" (default:
    each shard runs kernel K3 over its base columns, with its own count of
    valid columns) or "xla" (the shard's score matrix, then a selection).
    rescore: the quantized paths select 2k per shard and re-rank them
    against the shard's fp32 rows before the merge.  On CUDA, K3 takes
    every dtype (int8, fp32 and bf16).  ``mesh`` is the list of devices,
    one shard each (:func:`make_mesh`), under the JAX signature's name.
    """

    def __init__(self, base: np.ndarray, mesh, metric: str = "ip", dtype: str = "bf16",
                 engine: str = "pallas", rescore: bool = False):
        if metric not in ("ip", "l2"):
            raise ValueError(f"unknown metric {metric!r}")
        if dtype not in ("fp32", "bf16", "int8"):
            raise ValueError(f"unknown dtype {dtype!r}")
        if engine not in ("xla", "pallas"):
            raise ValueError(f"unknown engine {engine!r}")
        self.metric = metric
        self.dtype = dtype
        self.engine = engine
        self.rescore = rescore and dtype != "fp32"
        self.devices = _device_list(mesh)
        self.n_shards = len(self.devices)
        self.n, self.dim = base.shape

        # N padded to a shard multiple; padded rows are masked by global
        # index (xla) or the kernel's n_valid (pallas).
        self.rows_per_shard = -(-self.n // self.n_shards)
        rows = self.rows_per_shard
        pad = rows * self.n_shards - self.n
        base_f32 = np.asarray(base, dtype=np.float32)
        base_padded = np.pad(base_f32, ((0, pad), (0, 0)))
        norms = np.sum(base_padded.astype(np.float32) ** 2, axis=1)
        if dtype == "int8":
            self._base_scale = np.float32(max(np.abs(base_f32).max(), 1e-12) / 127.0)
            base_q = np.clip(np.round(base_padded / float(self._base_scale)), -127, 127)
            base_q = base_q.astype(np.int8)
        else:
            self._base_scale = None
            base_q = base_padded
        keep_norms = metric == "l2" or self.rescore
        tdtype = {"int8": torch.int8, "bf16": torch.bfloat16, "fp32": torch.float32}[dtype]

        def base_shard(s):
            piece = base_q[s * rows:(s + 1) * rows]
            if engine != "pallas":
                return piece
            piece = piece.T
            if dtype != "int8" and metric == "l2":
                # L2 by augmentation: q' = [q, 1], b' = [b, -‖b‖²/2].
                piece = np.concatenate([piece, -0.5 * norms[None, s * rows:(s + 1) * rows]],
                                       axis=0)
            return piece

        d_base = self.dim + (engine == "pallas" and dtype != "int8" and metric == "l2")
        specs = {"base": ((d_base, rows) if engine == "pallas" else (rows, self.dim), tdtype,
                          base_shard)}
        if keep_norms:
            specs["norms"] = ((rows,), torch.float32, lambda s: norms[s * rows:(s + 1) * rows])
        if self.rescore:
            specs["base_f32"] = ((rows, self.dim), torch.float32,
                                 lambda s: base_padded[s * rows:(s + 1) * rows])
        self._shards = _place_shards(self.devices, specs)

    def _local_rescore(self, q, sh, vals, ids, k):
        """Exact fp32 re-rank of a shard's 2k candidates (local rows)."""
        safe = ids.long().clamp(0, self.rows_per_shard - 1)
        cand = sh["base_f32"][safe]  # [B, 2k, D]
        scores = torch.bmm(cand, q[:, :, None])[..., 0]
        if self.metric == "l2":
            scores = 2.0 * scores - sh["norms"][safe]
        scores = torch.where(vals > _NEG_INF, scores, torch.full_like(scores, _NEG_INF))
        best_v, sel = topk.small_topk(scores, k)
        return best_v, torch.gather(safe, 1, sel.long()).to(torch.int32)

    def _shard_search(self, s: int, q: torch.Tensor, k: int):
        """Shard s's local top-k (rescored if asked) → (vals [B, k'], global ids)."""
        sh = self._shards[s]
        dev = self.devices[s]
        rows = self.rows_per_shard
        row0 = s * rows
        kk = 2 * k if self.rescore else k
        scale = (torch.tensor(self._base_scale, device=dev)
                 if self._base_scale is not None else None)
        if self.engine == "pallas":
            nv = torch.tensor([min(max(self.n - row0, 0), rows)], dtype=torch.int32, device=dev)
            nbins = 128 if self.rescore else 0
            if self.dtype == "int8":
                qv, qs = quantize.quantize_int8(q, per_row=True)
                if self.metric == "l2":
                    # alpha-rescaled dots minus the local norms, selected in
                    # f32 inside the kernel.
                    alpha = 2.0 * qs.reshape(-1) * scale
                    vals, ids = fused_topk_matmul(qv, sh["base"], kk, nbins=nbins, n_valid=nv,
                                                  alpha=alpha, bias=sh["norms"])
                else:
                    v_i32, ids = fused_topk_matmul(qv, sh["base"], kk, nbins=nbins, n_valid=nv)
                    vals = quantize.dequantize(v_i32, qs, scale)
                    vals = torch.where(v_i32 == _INT32_MIN, torch.full_like(vals, _NEG_INF),
                                       vals)
            else:
                qx = q
                if self.metric == "l2":
                    qx = torch.cat([qx, torch.ones((q.shape[0], 1), dtype=q.dtype, device=dev)],
                                   dim=1)
                qx = qx.to(sh["base"].dtype).contiguous()
                vals, ids = fused_topk_matmul(qx, sh["base"], kk, nbins=nbins, n_valid=nv)
                if self.metric == "l2":
                    vals = 2.0 * vals
        else:
            valid = (row0 + torch.arange(rows, device=dev)) < self.n
            if self.dtype == "int8":
                qv, qs = quantize.quantize_int8(q, per_row=True)
                raw = distances.score_matrix_int8(qv, sh["base"])
                if self.metric == "l2":
                    alpha = 2.0 * qs.reshape(-1) * scale
                    # XLA contracts the JAX package's raw·alpha − norms into one
                    # fused multiply-add; mul_sub rounds once, as it does.
                    scores = distances.mul_sub(raw.to(torch.float32), alpha[:, None],
                                               sh["norms"][None, :])
                    scores = torch.where(valid[None, :], scores,
                                         torch.full_like(scores, _NEG_INF))
                    vals, ids = topk.two_stage_topk(scores, kk)
                else:
                    raw = torch.where(valid[None, :], raw, torch.full_like(raw, _INT32_MIN))
                    v_i32, ids = topk.two_stage_topk(raw, kk)
                    vals = quantize.dequantize(v_i32, qs, scale)
                    vals = torch.where(v_i32 == _INT32_MIN, torch.full_like(vals, _NEG_INF),
                                       vals)
            else:
                scores = distances.score_matrix(
                    q, sh["base"], metric=self.metric, base_norms=sh.get("norms"),
                    compute_dtype=torch.bfloat16 if self.dtype == "bf16" else None)
                scores = torch.where(valid[None, :], scores, torch.full_like(scores, _NEG_INF))
                vals, ids = topk.two_stage_topk(scores, kk)
        ids = ids.to(torch.int32)
        if self.rescore:
            vals, ids = self._local_rescore(q, sh, vals, ids, k)
        return vals, ids + row0

    def search_device(self, queries: torch.Tensor, k: int):
        """Sharded search of one batch → (vals [B, k] f32, ids [B, k] int32),
        on the first device."""
        outs = [self._shard_search(s, queries.to(dev, torch.float32), k)
                for s, dev in enumerate(self.devices)]
        return _gather_merge([o[0] for o in outs], [o[1] for o in outs], k)

    def search(self, queries: np.ndarray, k: int, batch_size: int | None = None):
        """Host API → (ids [Q, k] int32, scores [Q, k] f32); the last batch
        is zero-padded."""
        queries = np.asarray(queries, dtype=np.float32)
        nq = queries.shape[0]
        bs = batch_size or nq
        ids_out = np.empty((nq, k), dtype=np.int32)
        scores_out = np.empty((nq, k), dtype=np.float32)
        for start in range(0, nq, bs):
            chunk = queries[start:start + bs]
            pad = bs - chunk.shape[0]
            if pad:
                chunk = np.pad(chunk, ((0, pad), (0, 0)))
            vals, ids = self.search_device(torch.from_numpy(chunk), k)
            got = bs - pad
            ids_out[start:start + got] = ids.cpu().numpy()[:got]
            scores_out[start:start + got] = vals.cpu().numpy()[:got]
        return ids_out, scores_out


class ShardedIVFIndex:
    """IVF search with whole clusters sharded over devices.

    Built from a single-device :class:`IVFIndex`, whose host arrays and
    kernel slabs it reuses; the coarse quantizer is replicated, the cluster
    slabs are distributed.  ``search_device`` → (scores, ids, n_candidates)
    on the first device, ``search`` → (ids, scores, avg_candidates), as in
    the JAX package.  ``mesh`` is the list of devices, one shard each
    (:func:`make_mesh`), under the JAX signature's name.
    """

    def __init__(self, index: IVFIndex, mesh):
        # Spilled (spill_eps > 0) sources work sharded: duplicates are
        # removed in the in-shard candidate pools and at the cross-shard
        # merge (a vector's two clusters may land on different shards).
        self.spilled = bool(getattr(index, "spilled", False))
        self.devices = _device_list(mesh)
        self.n_shards = len(self.devices)
        self.metric = index.metric
        self.coarse_metric = index.coarse_metric
        self.dtype = index.dtype
        self.nlist = index.nlist
        self.n, self.dim = index.n, index.dim
        self.max_cluster_size = index.max_cluster_size

        # The replicated coarse stage rides the single-device index's tier.
        self._coarse_tier = getattr(index, "_coarse_tier", None) or coarse_tier(index.nlist)
        cents, c_norms = coarse_arrays_host(index._centroids_np, index.coarse_metric,
                                            self._coarse_tier)
        dev0 = self.devices[0]
        self._centroids = cents.to(dev0)
        self._centroid_norms = (torch.from_numpy(c_norms).to(dev0)
                                if c_norms is not None else None)

        self._src_index = index
        self._qm_arrays: list[dict] | None = None  # query-mode per-shard layout
        self._cm_arrays: list[dict] | None = None  # cluster-mode per-shard layout
        self.last_spill: torch.Tensor | None = None  # residual spill of the last cluster call
        self.last_engine: str | None = None  # kernel of the last cluster call

    # ------------------------------------------------------------ helpers

    def _replicate(self, tensors: dict) -> list[dict]:
        """One copy of ``tensors`` per distinct device, listed per shard."""
        copies: dict = {}
        out = []
        for dev in self.devices:
            if dev not in copies:
                copies[dev] = {n: (t.to(dev) if isinstance(t, torch.Tensor) else t)
                               for n, t in tensors.items()}
            out.append(copies[dev])
        return out

    def _probes(self, q: torch.Tensor, nprobe: int) -> torch.Tensor:
        """STAGE 1, replicated: computed once on the first device."""
        return coarse_probes_tiered(
            q, self._centroids,
            self._centroid_norms if self.coarse_metric == "l2" else None,
            min(nprobe, self.nlist), tier=self._coarse_tier, coarse_metric=self.coarse_metric)

    # ------------------------------------------------------------ query mode

    def _ensure_query_state(self) -> None:
        """Per-shard layout of the query-mode scan: unpadded
        cluster-contiguous rows (fp32, or bf16 for a bf16 index) with
        local offsets and sizes per global cluster (0 where not owned)."""
        if self._qm_arrays is not None:
            return
        index = self._src_index
        offsets = index._offsets_np.astype(np.int64)  # [nlist+1]
        sizes = np.diff(offsets).astype(np.int32)
        bounds = _partition_clusters(offsets, self.n_shards)
        rows_max = max(max((int(offsets[hi] - offsets[lo]) for lo, hi in bounds), default=1), 1)

        def cut(s, fill, src, dtype):
            lo, hi = bounds[s]
            r0, r1 = int(offsets[lo]), int(offsets[hi])
            out = np.full((rows_max,) + src.shape[1:], fill, dtype=dtype)
            out[:r1 - r0] = src[r0:r1]
            return out

        vec_cut = _memo_last(lambda s: cut(s, 0, index._vectors_np, np.float32))

        def locals_for(s):
            lo, hi = bounds[s]
            r0 = int(offsets[lo])
            offs = np.zeros(self.nlist, np.int32)
            szs = np.zeros(self.nlist, np.int32)
            offs[lo:hi] = (offsets[lo:hi] - r0).astype(np.int32)
            szs[lo:hi] = sizes[lo:hi]
            return offs, szs

        locals_for = _memo_last(locals_for)
        specs = {
            "vectors": ((rows_max, self.dim),
                        torch.bfloat16 if self.dtype == "bf16" else torch.float32, vec_cut),
            "reorder": ((rows_max,), torch.int32,
                        lambda s: cut(s, -1, index._reorder_np, np.int32)),
            "offs": ((self.nlist,), torch.int32, lambda s: locals_for(s)[0]),
            "sizes": ((self.nlist,), torch.int32, lambda s: locals_for(s)[1]),
        }
        if self.metric == "l2":
            specs["vector_norms"] = (
                (rows_max,), torch.float32,
                lambda s: np.sum(vec_cut(s).astype(np.float32) ** 2, axis=1))
        self._qm_arrays = _place_shards(self.devices, specs)

    def _search_query(self, q: torch.Tensor, k: int, nprobe: int, probe_chunk: int):
        """Query mode: each shard scans its owned probed clusters with
        :func:`fine_scan` (exact fp32), then the merge."""
        probes = self._probes(q, nprobe)
        reps = self._replicate({"q": q, "probes": probes})
        # Spilled indexes scan a deeper local pool: in-shard duplicates take
        # slots until the merge dedups them.
        local_k = 2 * k if self.spilled else k
        vals_l, ids_l, ncand = [], [], None
        for s, a in enumerate(self._qm_arrays):
            r = reps[s]
            pl = r["probes"].long()
            p_offs, p_sizes = a["offs"][pl], a["sizes"][pl]
            part = p_sizes.sum(dim=1).to(self.devices[0])
            ncand = part if ncand is None else ncand + part
            vals, rows = fine_scan(r["q"], a["vectors"], a.get("vector_norms"), p_offs, p_sizes,
                                   k=local_k, probe_chunk=probe_chunk, metric=self.metric,
                                   max_cluster_size=self.max_cluster_size)
            ids = torch.where(vals > _NEG_INF, a["reorder"][rows.long()],
                              torch.full_like(rows, -1)).to(torch.int32)
            vals_l.append(vals)
            ids_l.append(ids)
        out_v, out_i = _gather_merge(vals_l, ids_l, k, dedup=self.spilled)
        return out_v, out_i, ncand.to(torch.int32)

    # ------------------------------------------------------------ cluster mode

    def _ensure_cluster_state(self) -> None:
        """Per-shard block-padded layouts for the cluster-mode kernels.

        The slabs are sliced from the source index's own ``vectors_t``
        (already quantized or augmented, one global int8 scale, so scores
        compare across shards); the block tables carry GLOBAL cluster ids,
        so the replicated routed-query table indexes them directly; the
        fp32 rescore source is compact (unpadded), reached through
        ``crow_map``.  Placed shard by shard (:func:`_place_shards`)."""
        if self._cm_arrays is not None:
            return
        index = self._src_index
        index._ensure_kernel_state()
        blk = index.PAD_BLOCK
        offs_p = index._padded_offsets_np.astype(np.int64)  # padded starts
        sizes = index._sizes_np
        offs_u = index._offsets_np.astype(np.int64)  # [nlist+1] unpadded
        n_padded = index.n_padded
        S = self.n_shards
        bounds = _partition_clusters(np.concatenate([offs_p, [n_padded]]), S)
        row_bounds = [
            (int(offs_p[lo]) if lo < self.nlist else n_padded,
             int(offs_p[hi]) if hi < self.nlist else n_padded)
            for lo, hi in bounds
        ]
        rows_max = max(max(r1 - r0 for r0, r1 in row_bounds), blk)
        rows_max = -(-rows_max // blk) * blk
        # Pad the per-shard block count to a multiple of 8, as the JAX
        # package does for its TPU grids; dummy blocks are rv=0 no-ops.
        nblocks_max = -(-(rows_max // blk) // 8) * 8
        rows_max = nblocks_max * blk
        rows_c_max = max(max(int(offs_u[hi] - offs_u[lo]) for lo, hi in bounds), 1)
        src_vt = index._arrays["vectors_t"]  # [nblocks(+pad), D', blk] on the index's device
        d_aug = src_vt.shape[1]

        def vt_slice(s):
            r0, r1 = row_bounds[s]
            b0, b1 = r0 // blk, r1 // blk
            out = torch.zeros((nblocks_max, d_aug, blk), dtype=src_vt.dtype,
                              device=self.devices[s])
            out[:b1 - b0] = src_vt[b0:b1]
            return out

        def tables(s):
            lo, hi = bounds[s]
            r0 = row_bounds[s][0]
            bc = np.full(nblocks_max, max(hi - 1, 0), np.int32)
            bf = np.zeros(nblocks_max, np.int32)
            bl = np.zeros(nblocks_max, np.int32)
            rv = np.zeros(nblocks_max, np.int32)
            # LOCAL last block per GLOBAL cluster id; unowned clusters read
            # 0 and are gated by `owned` at the join.
            lb = np.zeros(self.nlist, np.int32)
            if hi > lo:
                bcl, bfl, bll, rvl, lbl = build_block_tables(offs_p[lo:hi] - r0, sizes[lo:hi],
                                                             blk)
                nb = len(bcl)
                bc[:nb] = bcl + lo  # local tables, GLOBAL cluster ids
                bf[:nb], bl[:nb], rv[:nb] = bfl, bll, rvl
                lb[lo:hi] = lbl
                # Trailing dummy blocks stay on the last owned cluster with
                # first = last = 0 and no valid rows: no-ops.
            return bc, bf, bl, rv, lb

        def compact(s, src, fill, dtype):
            lo, hi = bounds[s]
            u0, u1 = int(offs_u[lo]), int(offs_u[hi])
            out = np.full((rows_c_max,) + src.shape[1:], fill, dtype)
            out[:u1 - u0] = src[u0:u1]
            return out

        def crow_map(s):
            """LOCAL padded row → LOCAL compact row; padding rows map to 0
            (masked at use)."""
            lo, hi = bounds[s]
            r0, u0 = row_bounds[s][0], int(offs_u[lo])
            out = np.zeros(rows_max, np.int32)
            for c in range(lo, hi):
                sz = int(sizes[c])
                p0 = int(offs_p[c]) - r0
                out[p0:p0 + sz] = np.arange(int(offs_u[c]) - u0, int(offs_u[c]) - u0 + sz,
                                            dtype=np.int32)
            return out

        def norms_padded(s):
            """fp32 norms by LOCAL padded row (the int8-L2 kernel bias)."""
            lo, hi = bounds[s]
            r0 = row_bounds[s][0]
            vc = index._vectors_np
            out = np.zeros(rows_max, np.float32)
            for c in range(lo, hi):
                sz = int(sizes[c])
                p0 = int(offs_p[c]) - r0
                a0 = int(offs_u[c])
                out[p0:p0 + sz] = np.sum(vc[a0:a0 + sz].astype(np.float32) ** 2, axis=1)
            return out

        cluster_shard = np.zeros(self.nlist, dtype=np.int32)
        for s, (lo, hi) in enumerate(bounds):
            cluster_shard[lo:hi] = s

        tables = _memo_last(tables)
        specs = {
            "vectors_t": ((nblocks_max, d_aug, blk), src_vt.dtype, vt_slice),
            "vectors_c": ((rows_c_max, self.dim), torch.float32,
                          lambda s: compact(s, index._vectors_np, 0, np.float32)),
            "crow_map": ((rows_max,), torch.int32, crow_map),
            "reorder_c": ((rows_c_max,), torch.int32,
                          lambda s: compact(s, index._reorder_np, -1, np.int32)),
        }
        for name, i in (("bc", 0), ("bf", 1), ("bl", 2), ("rv", 3)):
            specs[name] = ((nblocks_max,), torch.int32, lambda s, i=i: tables(s)[i])
        specs["lb"] = ((self.nlist,), torch.int32, lambda s: tables(s)[4])
        if self.dtype == "int8" and self.metric == "l2":
            specs["norms_pad"] = ((rows_max,), torch.float32, norms_padded)
        specs["cluster_shard"] = ((self.nlist,), torch.int32, lambda s: cluster_shard)
        specs["sizes"] = ((self.nlist,), torch.int32, lambda s: sizes)
        self._cm_base_scale = getattr(index, "_base_scale", None)
        self._cm_arrays = _place_shards(self.devices, specs)
        # The accum engine's layout gates, as the single-device auto pick:
        # whole clusters live on one shard, so the spans are unchanged.
        self._cm_accum_ok = (
            index._cm_max_nb <= ivf_accum.CODE_MAX
            and blk <= 128 * ivf_accum.CODE_MAX
            and index.dim <= index._accum_dim_cap()
        )

    def _cm_route(self, q: torch.Tensor, nprobe: int, qcap: int, stage: str = "full"):
        """The replicated stages on the first device: coarse probe,
        inversion, the lossy pairs, candidate counts, and the query prep
        (int8: one per-batch query scale, ``alpha = sq·sb``, doubled for L2;
        float: a ones column for L2) with the routed table ``qg``; float
        rows at a 16-byte row pitch (``ivf_scan.routed_table``).  ``stage``
        (``profile_sharded``'s prefixes) returns early: "coarse" the probes,
        "invert" (cq, slot, lossy); else the dict of all of it."""
        sizes = self._cm_arrays[0]["sizes"]
        probes = self._probes(q, nprobe)
        if stage == "coarse":
            return probes
        cq, slot, _ = invert_probes(probes, self.nlist, qcap)
        # Dropped pairs on empty clusters lose nothing and are not spill.
        p_sizes = sizes[probes.long()]
        lossy = (slot < 0) & (p_sizes > 0)
        if stage == "invert":
            return cq, slot, lossy
        alpha = None
        if self.dtype == "int8":
            qrow, sq = quantize.quantize_int8(q)
            alpha = sq * torch.tensor(self._cm_base_scale, dtype=torch.float32, device=q.device)
            if self.metric == "l2":
                alpha = 2.0 * alpha
        else:
            qrow = q
            if self.metric == "l2":
                qrow = torch.cat([qrow, torch.ones((q.shape[0], 1), dtype=q.dtype,
                                                   device=q.device)], dim=-1)
            qrow = qrow.to(self._cm_arrays[0]["vectors_t"].dtype)
        qg = ivf_scan.routed_table(qrow, cq)
        return dict(q=q, probes=probes, slot=slot, lossy=lossy, qrow=qrow, qg=qg, alpha=alpha,
                    spill=lossy.sum().to(torch.int32),
                    ncand=p_sizes.sum(dim=1).to(torch.int32))

    def _cm_recover_tables(self, s, r, todo, bias, rq, rb):
        """The inputs of one recovery pass on shard s: the ``todo`` pairs
        re-inverted into a fresh routed table (the rest go to a sentinel
        cluster whose row is cut off), and the active clusters' LOCAL blocks
        compacted, in storage order, into a list of ``rb`` blocks that K6
        walks with ``row_base = block·blk``; its outputs stay indexed by
        global cluster.  A cluster is covered iff its last real block made
        the list.  → ((qg, vectors_t, bc, bf, bl, rv, bias, row_base) for
        K6, slot2 [B, P], cluster_inc [nlist] bool)."""
        a = self._cm_arrays[s]
        dev = self.devices[s]
        blk = self._src_index.PAD_BLOCK
        nlist = self.nlist
        probes, qrow = r["probes"], r["qrow"]
        vecs_t, bc, bf, bl, rv = a["vectors_t"], a["bc"], a["bf"], a["bl"], a["rv"]
        bcl = bc.long()
        nblocks_local = vecs_t.shape[0]
        blk_ids = torch.where(rv > 0, torch.arange(nblocks_local, dtype=torch.int32, device=dev),
                              torch.full_like(rv, -1))
        last_blk = torch.full((nlist,), -1, dtype=torch.int32, device=dev).scatter_reduce(
            0, bcl, blk_ids, reduce="amax")
        probes2 = torch.where(todo, probes, torch.full_like(probes, nlist))
        cq2, slot2, _ = invert_probes(probes2, nlist + 1, rq)
        cq2 = cq2[:nlist]
        active_c = cq2[:, 0] >= 0
        active_b = active_c[bcl] & (rv > 0)
        rank = torch.cumsum(active_b.to(torch.int32), 0) - 1
        order = torch.argsort((~active_b).to(torch.int32), stable=True)
        blocks_list = order[:rb]
        inc_b = active_b & (rank < rb)
        inc_list = inc_b[blocks_list]
        cluster_inc = active_c & (last_blk >= 0) & inc_b[last_blk.clamp_min(0).long()]
        qg2 = ivf_scan.routed_table(qrow, cq2)
        bias2 = None
        if bias is not None:
            bias2 = bias.reshape(nblocks_local, blk)[blocks_list].reshape(1, -1)
        # The output is indexed by cluster, and a cluster must end at most
        # one run: the excluded tail (inactive blocks, table dummies) is
        # parked on the last included block's cluster, a continuation of its
        # run with no rows.
        bls = bc[blocks_list]
        n_inc = inc_list.to(torch.int64).sum()
        bc2 = torch.where(inc_list, bls, bls.index_select(0, (n_inc - 1).clamp_min(0)[None]))

        def listed(tab):
            x = tab[blocks_list]
            return torch.where(inc_list, x, torch.zeros_like(x))

        scan = (qg2, vecs_t[blocks_list].contiguous(), bc2.contiguous(), listed(bf), listed(bl),
                listed(rv), bias2, (blocks_list * blk).to(torch.int32))
        return scan, slot2, cluster_inc

    def _cm_recover(self, s, r, owned, bias, k, rq, rb, rp):
        """The recovery pass on shard s: ``rp`` passes, each placing through
        K6 the pairs the ones before left (:meth:`_cm_recover_tables`) →
        (extra (vals [B, E], rows [B, E]) in kernel units, -inf where not
        placed; the residual todo [B, P])."""
        pl = r["probes"].long()
        b = pl.shape[0]
        blk = self._src_index.PAD_BLOCK
        ev, er = [], []
        todo = r["lossy"]
        for _ in range(rp):
            scan, slot2, cluster_inc = self._cm_recover_tables(s, r, todo, bias, rq, rb)
            pv2, pr2 = ivf_scan.cluster_major_scan(*scan[:6], k=k, blk=blk, bias=scan[6],
                                                   row_base=scan[7])
            placed = (slot2 >= 0) & cluster_inc[pl]
            ok2 = todo & placed & owned  # todo already implies a non-empty cluster
            sl2 = slot2.clamp_min(0).long()
            gv2 = pv2[pl, sl2]
            ev.append(torch.where(ok2[..., None], gv2, torch.full_like(gv2, _NEG_INF))
                      .reshape(b, -1))
            er.append(pr2[pl, sl2].reshape(b, -1))
            todo = todo & ~placed
        return (torch.cat(ev, dim=1), torch.cat(er, dim=1)), todo

    def _cm_shard(self, s, r, k, rq, rb, rp, engine, stage: str = "full"):
        """Shard s's cluster-mode search → (vals [B, k], ids [B, k], its
        residual spill or None without recovery).  ``stage``
        (``profile_sharded``'s prefixes) returns early: "kernel" the scan's
        output (K1's planes, or K6's (pv, pr)) before any recovery pass,
        "join" the shard's top-kk (vals, padded rows), "rescore" its
        rescored (vals, ids)."""
        a = self._cm_arrays[s]
        dev = self.devices[s]
        blk = self._src_index.PAD_BLOCK
        probes, slot, alpha, q = r["probes"], r["slot"], r["alpha"], r["q"]
        pl = probes.long()
        b = probes.shape[0]
        kk = 2 * k
        ck = kk  # full-depth per-cluster emit (IVFIndex._auto_cluster_k)
        vecs_t = a["vectors_t"]
        owned = a["cluster_shard"][pl] == s
        bias = None
        if alpha is not None and self.metric == "l2":
            bias = (a["norms_pad"] / alpha)[None, :]

        pv = pr = pp = None
        if engine == "pallas_accum":
            # K1 over the shard's walk with per-block routed queries; the
            # selection happens at the join.
            nblocks_local = vecs_t.shape[0]
            bias_rows = None
            if bias is not None:
                # Pre-shifted planes bias, as the single-device index builds
                # it: (round(norms/alpha) << 8) − ((code << 4) | chunk id).
                cmax = ivf_accum.CODE_MAX
                code = (cmax - 1) - (torch.arange(nblocks_local, dtype=torch.int32,
                                                  device=dev) % cmax)
                cidc = torch.arange(blk, dtype=torch.int32, device=dev) >> 7
                pack = (code << 4)[:, None] | cidc[None, :]
                br = torch.clamp(torch.round(bias.reshape(nblocks_local, 1, blk)),
                                 -(2.0**21), 2.0**21).to(torch.int32)
                bias_rows = (br * 256 - pack[:, None, :]).contiguous()
            qb = r["qg"][a["bc"].long()].contiguous()
            pp = ivf_accum.cluster_major_accum_planes(qb, vecs_t, a["bf"], a["bl"], a["rv"],
                                                      blk=blk, bin2=True, bias_rows=bias_rows)
        else:
            pv, pr = ivf_scan.cluster_major_scan(r["qg"], vecs_t, a["bc"], a["bf"], a["bl"],
                                                 a["rv"], k=ck, blk=blk, bias=bias)
        if stage == "kernel":
            return pp if pp is not None else (pv, pr)
        extra, spill = None, None
        if rq and rb:
            extra, todo = self._cm_recover(s, r, owned, bias, ck, rq, rb, rp)
            spill = (todo & owned).sum()

        def units(x):  # kernel scores → true-score units; -inf stays -inf
            if alpha is not None:
                return alpha * x
            return 2.0 * x if self.metric == "l2" else x

        if pv is not None:
            pv = units(pv)
        if extra is not None:
            extra = (units(extra[0]), extra[1])

        # Join over locally owned, recorded, non-empty pairs only.
        ok = (slot >= 0) & owned & (a["sizes"][pl] > 0)
        sl = slot.clamp_min(0).long()
        if engine == "pallas_accum":
            # The planes join and row decode of the single-device
            # _cm_finish_planes, per shard, from each cluster's LOCAL last block.
            kmin = ivf_accum.KMIN
            cmax = ivf_accum.CODE_MAX
            w = pp.shape[2]
            tl = a["lb"][pl].clamp_min(0)
            flat = (tl.long() * pp.shape[1] + sl).reshape(-1)
            gp = pp.reshape(-1, w)[flat].reshape(b, -1, w)
            gp = torch.where(ok[..., None], gp, torch.full_like(gp, kmin))
            pool = gp.shape[1] * w
            if b * pool >= JOIN_FUSED_MIN:
                vals_p, selp = fused_topk.fused_topk(gp.reshape(b, pool), min(kk, pool))
            else:
                vals_p, selp = topk.small_topk(gp.reshape(b, pool), min(kk, pool))
            valid = vals_p > kmin
            pi = selp // w
            lane = (selp % w) & 127
            cid = vals_p & (cmax - 1)
            codeb = (vals_p >> 4) & (cmax - 1)
            tsel = torch.gather(tl, 1, pi.long())
            dd = ((tsel & (cmax - 1)) - ((cmax - 1) - codeb)) & (cmax - 1)
            gr = (tsel - dd) * blk + cid * 128 + lane
            if alpha is not None:
                gv = alpha * (vals_p >> 8).to(torch.float32)
            else:
                gv = ivf_accum._key_to_f32(vals_p)
                if self.metric == "l2":
                    gv = 2.0 * gv  # augmented scores are l2_score / 2
            gv = torch.where(valid, gv, torch.full_like(gv, _NEG_INF))
            gr = torch.where(valid, gr, torch.zeros_like(gr))
        else:
            gv = pv[pl, sl]
            gv = torch.where(ok[..., None], gv, torch.full_like(gv, _NEG_INF)).reshape(b, -1)
            gr = pr[pl, sl].reshape(b, -1)
        if extra is not None:
            gv = torch.cat([gv, extra[0]], dim=1)
            gr = torch.cat([gr, extra[1]], dim=1)
        best_v, sel = topk.small_topk(gv, min(kk, gv.shape[1]))
        best_r = torch.gather(gr, 1, sel.long())
        if stage == "join":
            return best_v, best_r
        # Rows under -inf may be unwritten kernel output: zeroed before any
        # lookup.  Then the exact fp32 rescore of the local candidates
        # against the shard's compact rows, through crow_map.
        best_r = torch.where(best_v > _NEG_INF, best_r, torch.zeros_like(best_r))
        crow_map, vecs_c = a["crow_map"], a["vectors_c"]
        bsz, kp = best_r.shape
        safe = best_r.clamp(0, crow_map.shape[0] - 1).reshape(-1).long()
        crow = crow_map[safe].clamp(0, vecs_c.shape[0] - 1).long()
        cand = vecs_c[crow].reshape(bsz, kp, -1)
        scores = torch.bmm(cand, q[:, :, None])[..., 0]
        if self.metric == "l2":
            scores = 2.0 * scores - (cand * cand).sum(dim=-1)
        scores = torch.where(best_v > _NEG_INF, scores, torch.full_like(scores, _NEG_INF))
        pool_ids = a["reorder_c"][crow].reshape(bsz, kp)
        if self.spilled:
            # In-shard dedup: a vector spilled into two clusters of this
            # shard reaches the pool twice with the same fp32 score.
            scores, pool_ids = topk.dedup_rows_by_id(scores, pool_ids)
        best_v, sel2 = topk.small_topk(scores, k)
        ids = torch.where(best_v > _NEG_INF, torch.gather(pool_ids, 1, sel2.long()),
                          torch.full_like(sel2, -1))
        if stage == "rescore":
            return best_v, ids
        return best_v, ids.to(torch.int32), spill

    def _search_cluster(self, q, k, nprobe, qcap, rq, rb, rp, engine, stage: str = "full"):
        """The cluster-mode call → (vals, ids, ncand, spill).  ``stage``, one
        of ``profile_sharded.STAGES``, ends the call after that prefix and
        returns what it computed: the replicated route's output (coarse,
        invert, route), or each shard's (kernel, join, rescore), for the
        caller to synchronize on; "full" is the whole call."""
        r0 = self._cm_route(q, nprobe, qcap, stage)
        if stage in ("coarse", "invert", "route"):
            return r0
        reps = self._replicate(r0)
        outs = [self._cm_shard(s, reps[s], k, rq, rb, rp, engine, stage)
                for s in range(self.n_shards)]
        if stage != "full":
            return outs
        vals_l = [v for v, _, _ in outs]
        ids_l = [i for _, i, _ in outs]
        spills = [sp.to(self.devices[0]) for _, _, sp in outs if sp is not None]
        out_v, out_i = _gather_merge(vals_l, ids_l, k, dedup=self.spilled)
        spill = torch.stack(spills).sum() if spills else r0["spill"]
        return out_v, out_i, r0["ncand"], spill.to(torch.int32)

    # ------------------------------------------------------------ policy

    def _auto_probe_chunk(self, batch: int) -> int:
        return self._src_index._auto_probe_chunk(batch)

    def _auto_qcap(self, batch: int, nprobe: int) -> int:
        return self._src_index._auto_qcap(batch, nprobe)

    # ------------------------------------------------------------ API

    def search_device(self, queries: torch.Tensor, k: int, nprobe: int,
                      probe_chunk: int | None = None, mode: str = "query",
                      qcap: int | None = None, recover: bool | None = None,
                      recover_qcap: int | None = None, recover_blocks: int | None = None,
                      recover_passes: int | None = None, engine: str = "auto"):
        """Search one batch → (scores [B, k] f32, ids [B, k] int32,
        n_candidates [B] int32), on the first device.

        mode "query": per-shard :func:`fine_scan` (exact fp32).  mode
        "cluster": per-shard cluster-major kernels (binned, then the fp32
        rescore), the batch-scale path.  ``engine`` (cluster mode): "auto"
        takes the accum engine (K1, then the planes join) where the layout
        allows it, else "pallas" (K6).  ``recover``: the spilled-pair
        recovery pass per shard through K6 (default: where the source
        index's policy turns it on); ``recover_blocks`` defaults to a
        quarter of a shard's blocks.  ``last_spill`` holds the pairs still
        dropped after it, summed over shards."""
        q = queries.to(self.devices[0], torch.float32)
        b = q.shape[0]
        if mode == "cluster":
            self._ensure_cluster_state()
            if engine == "auto":
                engine = "pallas_accum" if self._cm_accum_ok else "pallas"
            elif engine == "pallas_accum" and not self._cm_accum_ok:
                raise ValueError(
                    "engine='pallas_accum' layout limits not met (cluster block span, "
                    "pad_block, or int8 dim cap) — use engine='pallas'")
            elif engine not in ("pallas", "pallas_accum"):
                raise ValueError(f"unknown sharded cluster engine {engine!r}")
            if recover is None:
                recover = self._src_index._auto_recover(b, nprobe)
            qcap = qcap or self._auto_qcap(b, nprobe)
            rq = rb = 0
            rp = 1
            if recover:
                nblocks_local = self._cm_arrays[0]["vectors_t"].shape[0]
                rq = recover_qcap or qcap
                rb = min(recover_blocks or max(1, nblocks_local // 4), nblocks_local)
                rp = recover_passes or self._src_index._auto_recover_passes(b, nprobe, rq)
            vals, ids, ncand, spill = self._search_cluster(q, k, nprobe, qcap, rq, rb, rp,
                                                           engine)
            self.last_spill = spill
            self.last_engine = engine
            return vals, ids, ncand
        if mode != "query":
            raise ValueError(f"unknown mode {mode!r}")
        self._ensure_query_state()
        pc = probe_chunk or self._auto_probe_chunk(b)
        return self._search_query(q, k, nprobe, pc)

    def search(self, queries: np.ndarray, k: int, nprobe: int = 16,
               batch_size: int | None = None, mode: str = "query", engine: str = "auto"):
        """Host API → (ids [Q, k] int32, scores [Q, k] f32, avg_candidates);
        the last batch is zero-padded."""
        queries = np.asarray(queries, dtype=np.float32)
        nq = queries.shape[0]
        bs = batch_size or nq
        ids_out = np.empty((nq, k), dtype=np.int32)
        scores_out = np.empty((nq, k), dtype=np.float32)
        total_cand = 0
        for start in range(0, nq, bs):
            chunk = queries[start:start + bs]
            pad = bs - chunk.shape[0]
            if pad:
                chunk = np.pad(chunk, ((0, pad), (0, 0)))
            vals, ids, ncand = self.search_device(torch.from_numpy(chunk), k, nprobe,
                                                  mode=mode, engine=engine)
            got = bs - pad
            ids_out[start:start + got] = ids.cpu().numpy()[:got]
            scores_out[start:start + got] = vals.cpu().numpy()[:got]
            total_cand += int(ncand.cpu().numpy()[:got].sum())
        return ids_out, scores_out, total_cand / nq
