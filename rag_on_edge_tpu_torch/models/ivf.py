"""IVF (inverted-file) approximate k-NN index in PyTorch (counterpart:
``rag_on_edge_tpu/models/ivf.py``), with both of the JAX package's search
modes.

The batch-scale path is the cluster-major mode with its defaults:
``engine="auto"``, which resolves to the accum engine with the planes emit
(``pallas_accum``) where the index allows it and to the grouped engine
(``pallas``) otherwise, the spilled-pair recovery pass
where the auto policy turns it on, and the fp32 rescore.  It runs in six
stages:

1. coarse probe: a GEMM against the centroids (fp32, or bf16 inputs for
   the mid nlist tier) and a top-nprobe, or kernel K3
   (``ops/bruteforce_fused.py``) from nlist 8192 (:func:`coarse_probes_tiered`);
2. probe inversion into a fixed-capacity cluster→query table
   (:func:`invert_probes`);
3. query prep: int8 query quantization and the L2 bias
   (:meth:`IVFIndex._query_prep`), and the per-block routed query gather
   (:meth:`IVFIndex._scan_inputs`) for every engine but ``pallas_routed``;
4. fine scan: kernel K1 (``ops/ivf_accum.py``), or kernel K4
   (``ops/ivf_scan.py``) for the grouped engine, or kernel K7 (same
   module), which gathers the routed queries inside the kernel, for the
   routed engine; then, where pairs were dropped past the routing
   capacity, the recovery pass rescans only their clusters with K4 (K7
   under the routed engine) (:meth:`IVFIndex._recover`);
5. join: each (query, probe) pair's planes (K1) or top-k (K4) are
   gathered; for the planes, kernel K2 (``ops/fused_topk.py``) selects the
   top-kk of the pool once B·pool reaches ``8 << 20``, and rows are
   decoded from the keys;
6. rescore: exact fp32 re-ranking, and padded rows back to original ids.

The cluster mode's ``engine="xla"`` replaces stages 4-5 with a plain
per-cluster scan of the block-padded fp32 copy (:meth:`IVFIndex._scan_xla`).
The query-major mode (small batches: ``mode="auto"`` picks it below one
padded database of gathered rows, :meth:`IVFIndex._pick_mode`) probes the
coarse quantizer and scans each query's probed clusters with
:func:`fine_scan`, plain torch as in the JAX package, where it is XLA; the
sharded index's query mode shares it (``parallel/sharded.py``).

The device is explicit (``device=``, default ``"cuda"``), never detected.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from rag_on_edge_tpu_torch.models import kmeans as kmeans_mod
from rag_on_edge_tpu_torch.ops import (bruteforce_fused, distances, fused_topk, ivf_accum,
                                       ivf_scan, quantize, topk)
from rag_on_edge_tpu_torch.ops.block_tables import build_block_tables
from rag_on_edge_tpu_torch.utils import metrics

__all__ = ["IVFIndex", "invert_probes", "fine_scan", "coarse_tier", "coarse_arrays_host",
           "coarse_probes_tiered"]

_NEG_INF = float("-inf")

# Coarse probing tiers by nlist.  These thresholds were measured on a TPU
# v5e and are kept for parity with the JAX package, not tuned for the H100.
COARSE_BF16_MIN_NLIST = 512
COARSE_FUSED_MIN_NLIST = 8192
# Join selection switches to kernel K2 at B·pool >= this many entries
# (the JAX package's TPU-measured crossover, kept for parity).
JOIN_FUSED_MIN = 8 << 20


def coarse_tier(nlist: int, *, bf16_min: int | None = None,
                fused_min: int | None = None) -> str:
    """The coarse-probing tier of an nlist: "fp32", "bf16" or "fused"."""
    if nlist >= (fused_min if fused_min is not None else COARSE_FUSED_MIN_NLIST):
        return "fused"
    if nlist >= (bf16_min if bf16_min is not None else COARSE_BF16_MIN_NLIST):
        return "bf16"
    return "fp32"


def coarse_arrays_host(centroids: np.ndarray, coarse_metric: str,
                       tier: str) -> tuple[torch.Tensor, np.ndarray | None]:
    """Tier-appropriate host centroid arrays ``(cents, c_norms)`` (cents a
    CPU tensor):

    - "fused": centroids transposed [D(+1), nlist], L2 folded in by an
      augmented ``-0.5·‖c‖²`` row (ranking-equivalent); no norms.
    - "bf16": bf16 centroids and fp32 norms (L2 only).
    - "fp32": fp32 centroids and norms (L2 only)."""
    c = np.asarray(centroids, dtype=np.float32)
    if tier == "fused":
        ct = c.T
        if coarse_metric == "l2":
            ct = np.concatenate([ct, -0.5 * np.sum(ct * ct, axis=0, keepdims=True)], axis=0)
        return torch.from_numpy(np.ascontiguousarray(ct)), None
    norms = np.sum(c * c, axis=1) if coarse_metric == "l2" else None
    ct = torch.from_numpy(c.copy())
    return (ct.to(torch.bfloat16) if tier == "bf16" else ct), norms


def coarse_probes_tiered(q: torch.Tensor, cents: torch.Tensor,
                         c_norms: torch.Tensor | None, nprobe: int, *,
                         tier: str, coarse_metric: str) -> torch.Tensor:
    """STAGE 1: coarse centroid scores and top-nprobe → probes [B, P] int32.
    The fused tier is kernel K3 (exact fp32) over the transposed, augmented
    centroids of :func:`coarse_arrays_host`, with a ones column on the
    queries for L2; only its ids are used.  The bf16 tier rounds the GEMM
    inputs to bf16 and sums in fp32, as the JAX package's
    ``preferred_element_type=f32`` does."""
    if tier == "fused":
        qx = q
        if coarse_metric == "l2":
            qx = torch.cat([q, torch.ones((q.shape[0], 1), dtype=q.dtype, device=q.device)],
                           dim=1)
        return bruteforce_fused.fused_topk_matmul(qx.contiguous(), cents, nprobe)[1]
    if tier == "bf16":
        s = q.to(torch.bfloat16).to(torch.float32) @ cents.to(torch.float32).T
        if coarse_metric == "l2":
            s = 2.0 * s - c_norms[None, :]
        return topk.small_topk(s, nprobe)[1]
    s = distances.score_matrix(q, cents, metric=coarse_metric, base_norms=c_norms)
    return topk.small_topk(s, nprobe)[1]


def invert_probes(probes: torch.Tensor, nlist: int, qcap: int):
    """Invert the query→cluster probe map into cluster→query lists: a
    stable sort by cluster, the rank within each cluster, and a scatter
    into a fixed-capacity table that drops pairs past ``qcap``.

    probes: [B, P] int32 cluster ids (distinct within a row).
    Returns (cluster_queries [nlist, qcap] int32 query index or -1,
             slot [B, P] int32 slot in the cluster's list or -1 if dropped,
             spill — the number of dropped pairs, a 0-d int32 tensor)."""
    b, p = probes.shape
    dev = probes.device
    flat_c = probes.reshape(-1).long()
    flat_q = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(p)
    order = torch.argsort(flat_c, stable=True)
    c_s = flat_c[order]
    q_s = flat_q[order]
    counts = torch.zeros(nlist, dtype=torch.long, device=dev)
    counts.scatter_add_(0, flat_c, torch.ones_like(flat_c))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(b * p, dtype=torch.long, device=dev) - starts[c_s]
    kept = rank < qcap
    # Overflowing pairs land in a spare column that is cut off after the
    # scatter: the drop needs no host sync.
    table = torch.full((nlist, qcap + 1), -1, dtype=torch.int32, device=dev)
    table.view(-1).scatter_(0, c_s * (qcap + 1) + rank.clamp_max(qcap), q_s)
    cluster_queries = table[:, :qcap].contiguous()
    slot_sorted = torch.where(kept, rank, torch.full_like(rank, -1)).to(torch.int32)
    slot = torch.empty(b * p, dtype=torch.int32, device=dev)
    slot[order] = slot_sorted
    return cluster_queries, slot.reshape(b, p), (~kept).sum().to(torch.int32)


def fine_scan(q: torch.Tensor, vectors: torch.Tensor, vector_norms: torch.Tensor | None,
              p_offs: torch.Tensor, p_sizes: torch.Tensor, k: int, probe_chunk: int,
              metric: str, max_cluster_size: int, compute_dtype: torch.dtype | None = None,
              row_map: torch.Tensor | None = None):
    """Scan the probed cluster slabs with a running top-k, query-major (the
    JAX package's ``fine_scan``; plain torch, as there it is XLA).

    q: [B, D] f32.  vectors: [N, D] cluster-contiguous rows (fp32, or bf16,
    whose products are exact in fp32), or, with ``row_map``, an unpadded
    fp32 array reached through it: ``row_map`` maps padded rows to rows of
    ``vectors`` (-1 for padding rows, clipped to 0; their scores are masked
    by size anyway).  p_offs / p_sizes: [B, P] int32 start row and size of
    each probed cluster (size 0 masks the probe).  Each chunk of
    ``probe_chunk`` probes gathers ``max_cluster_size`` rows per probe,
    scores them in fp32 (with ``compute_dtype`` bf16: both operands rounded
    to bf16 first, the products summed in fp32), keeps its top k (a stable
    descending sort, as ``lax.top_k``) and merges it into the running top k
    (:func:`topk.merge_topk`).  Returns (vals [B, k] f32, rows [B, k] int32
    padded rows in both forms; rows of -inf entries are meaningless)."""
    b = q.shape[0]
    dev = q.device
    n_rows = row_map.shape[0] if row_map is not None else vectors.shape[0]
    nprobe = p_offs.shape[1]
    arange_s = torch.arange(max_cluster_size, dtype=torch.int32, device=dev)
    qf = q.to(torch.float32)
    if compute_dtype is not None:
        qf = qf.to(compute_dtype).to(torch.float32)

    def chunk(best_v, best_i, offs_c, sizes_c):
        rows = (offs_c[..., None] + arange_s).clamp(0, n_rows - 1)  # [B, pc, S]
        valid = arange_s[None, None, :] < sizes_c[..., None]
        src = rows.long() if row_map is None else row_map[rows.long()].clamp_min(0).long()
        cand = vectors[src]  # [B, pc, S, D] slab gather
        if compute_dtype is not None:
            cand = cand.to(compute_dtype)
        scores = torch.einsum("bpsd,bd->bps", cand.to(torch.float32), qf)
        if metric == "l2":
            scores = 2.0 * scores - vector_norms[rows.long()]
        scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
        flat_scores = scores.reshape(b, -1)
        kk = min(k, flat_scores.shape[1])
        v, idx = topk.topk(flat_scores, kk)
        i = torch.gather(rows.reshape(b, -1), 1, idx.long())
        if kk < k:
            v = torch.nn.functional.pad(v, (0, k - kk), value=_NEG_INF)
            i = torch.nn.functional.pad(i, (0, k - kk))
        return topk.merge_topk(best_v, best_i, v, i, k=k)

    pc = min(probe_chunk, nprobe)
    pad = (-nprobe) % pc
    if pad:
        p_offs = torch.nn.functional.pad(p_offs, (0, pad))
        p_sizes = torch.nn.functional.pad(p_sizes, (0, pad))
    best_v = torch.full((b, k), _NEG_INF, dtype=torch.float32, device=dev)
    best_i = torch.zeros((b, k), dtype=torch.int32, device=dev)
    for c in range(0, nprobe + pad, pc):
        best_v, best_i = chunk(best_v, best_i, p_offs[:, c:c + pc], p_sizes[:, c:c + pc])
    return best_v, best_i


class IVFIndex:
    """IVF index with cluster-contiguous storage and cluster-major search.

    Construct with :meth:`build`, :meth:`load` or :meth:`from_arrays`.
    Tensors live in ``self._arrays`` on ``self.device``; numpy host copies
    (``_centroids_np``, ``_vectors_np``, ``_offsets_np``, ``_reorder_np``)
    are what :meth:`save` writes.
    """

    PAD_BLOCK_DEFAULT = 512  # cluster slabs padded to this row multiple
    CM_GROUP = 4  # blocks per group of kernel K4; recovery block lists round up to it
    COARSE_BF16_MIN_NLIST = COARSE_BF16_MIN_NLIST
    COARSE_FUSED_MIN_NLIST = COARSE_FUSED_MIN_NLIST

    def __init__(
        self,
        centroids: np.ndarray,
        vectors_reordered: np.ndarray,
        cluster_offsets: np.ndarray,
        reorder_to_original: np.ndarray,
        metric: str = "ip",
        dtype: str = "fp32",
        coarse_metric: str = "l2",
        pad_block: int | None = None,
        store: str = "padded",
        config: dict | None = None,
        device: str | torch.device = "cuda",
    ):
        if metric not in ("ip", "l2"):
            raise ValueError(f"unknown metric {metric!r}")
        if coarse_metric not in ("ip", "l2"):
            raise ValueError(f"unknown coarse_metric {coarse_metric!r}")
        if dtype not in ("fp32", "bf16", "int8"):
            raise ValueError(
                f"unknown dtype {dtype!r} (fine scan supports fp32/bf16/int8)")
        if store not in ("padded", "compact"):
            raise ValueError(f"unknown store {store!r} ('padded' | 'compact')")
        self.device = torch.device(device)
        self.store = store
        self.metric = metric
        self.coarse_metric = coarse_metric
        self.dtype = dtype
        self.nlist = int(centroids.shape[0])
        self.n, self.dim = vectors_reordered.shape
        sizes = np.diff(cluster_offsets).astype(np.int32)
        self.max_cluster_size = int(sizes.max())
        self.PAD_BLOCK = int(pad_block or (config or {}).get("pad_block")
                             or self.PAD_BLOCK_DEFAULT)
        self.max_cluster_padded = int(-(-self.max_cluster_size // self.PAD_BLOCK)
                                      * self.PAD_BLOCK)
        self.config = config or {}
        self.config.update({
            "n_vectors": self.n,
            "n_clusters": self.nlist,
            "dim": self.dim,
            "reordered": True,
            "metric": metric,
            "coarse_metric": coarse_metric,
            "dtype": dtype,
            "pad_block": self.PAD_BLOCK,
            "cluster_size_min": int(sizes.min()),
            "cluster_size_avg": float(sizes.mean()),
            "cluster_size_max": int(sizes.max()),
        })

        self._centroids_np = np.asarray(centroids, dtype=np.float32)
        self._vectors_np = np.asarray(vectors_reordered, dtype=np.float32)
        self._offsets_np = np.asarray(cluster_offsets, dtype=np.int32)
        self._reorder_np = np.asarray(reorder_to_original, dtype=np.int32)
        # Spilled indexes store some base vectors twice; the rescore stage
        # dedups by original id.
        self.n_base = int(self._reorder_np.max()) + 1 if self.n else 0
        self.spilled = self.n > self.n_base
        self.config["n_vectors"] = self.n_base
        self.config["n_rows_stored"] = self.n

        # Block-padded layout: every cluster slab padded to a multiple of
        # PAD_BLOCK rows (padding rows are zero and masked by size).
        pb = self.PAD_BLOCK
        padded_sizes = -(-sizes // pb) * pb
        padded_offsets = np.zeros(self.nlist + 1, dtype=np.int64)
        np.cumsum(padded_sizes, out=padded_offsets[1:])
        self.n_padded = int(padded_offsets[-1])
        self._padded_offsets_np = padded_offsets[:-1].astype(np.int32)
        self._sizes_np = sizes
        vec_padded = self._vec_padded_host()
        reorder_padded = np.full(self.n_padded, -1, dtype=np.int32)
        for c in range(self.nlist):
            src0, src1 = int(cluster_offsets[c]), int(cluster_offsets[c + 1])
            dst0 = int(padded_offsets[c])
            reorder_padded[dst0 : dst0 + (src1 - src0)] = self._reorder_np[src0:src1]

        dev = self.device
        arrays: dict[str, torch.Tensor] = {
            "centroids": torch.from_numpy(self._centroids_np.copy()).to(dev),
            "offsets": torch.from_numpy(self._padded_offsets_np.copy()).to(dev),
            "sizes": torch.from_numpy(sizes.copy()).to(dev),
            "reorder": torch.from_numpy(reorder_padded).to(dev),
        }
        # The one fp32 copy on the device: unpadded, in ORIGINAL order, read
        # through the padded-row → original-id map by the rescore.
        orig = np.empty((self.n_base, self.dim), dtype=np.float32)
        orig[self._reorder_np] = self._vectors_np
        arrays["vectors_f32"] = torch.from_numpy(orig).to(dev)
        if coarse_metric == "l2":
            arrays["centroid_norms"] = distances.base_norms_sq(arrays["centroids"])
        if metric == "l2":
            # Padded-row norms, on the host with numpy exactly as the JAX
            # package computes them, so the int8 bias rows are bit-equal.
            arrays["vector_norms"] = torch.from_numpy(
                np.sum(vec_padded.astype(np.float32) ** 2, axis=1)).to(dev)
        self._coarse_tier = coarse_tier(
            self.nlist, bf16_min=self.COARSE_BF16_MIN_NLIST,
            fused_min=self.COARSE_FUSED_MIN_NLIST)
        if self._coarse_tier != "fp32":
            tc, _ = coarse_arrays_host(self._centroids_np, coarse_metric, self._coarse_tier)
            key = "centroids_t" if self._coarse_tier == "fused" else "centroids_bf16"
            arrays[key] = tc.to(dev)
        self._arrays = arrays
        if store == "compact":
            self._build_kernel_state(vec_padded)
        del vec_padded

        # Dropped (query, cluster) pairs of the most recent cluster-major
        # search (a 0-d device tensor, no sync until read), and the engine
        # that served it.
        self.last_spill: torch.Tensor | None = None
        self.last_engine: str | None = None
        self.last_mode: str | None = None

    @classmethod
    def from_arrays(cls, centroids, vectors_reordered, cluster_offsets,
                    reorder_to_original, metric: str = "ip", dtype: str = "fp32",
                    pad_block: int | None = None, config: dict | None = None,
                    device: str | torch.device = "cuda",
                    store: str = "padded") -> "IVFIndex":
        """An index over another index's arrays (for example the JAX
        package's ``_centroids_np``, ``_vectors_np``, ``_offsets_np``,
        ``_reorder_np`` and ``config``); ``coarse_metric`` comes from the
        config, which is copied."""
        config = dict(config or {})
        return cls(centroids, vectors_reordered, cluster_offsets,
                   reorder_to_original, metric=metric, dtype=dtype,
                   coarse_metric=config.get("coarse_metric", "l2"),
                   pad_block=pad_block, store=store, config=config, device=device)

    # ------------------------------------------------------------------ build

    @classmethod
    def build(
        cls,
        base: np.ndarray,
        nlist: int | None = None,
        metric: str = "ip",
        dtype: str = "fp32",
        coarse_metric: str = "l2",
        pad_block: int | None = None,
        store: str = "padded",
        seed: int = 42,
        max_iter: int = 100,
        kmeans_init: str = "kmeans++",
        kmeans_checkpoint: str | None = None,
        spill_eps: float = 0.0,
        centroids: np.ndarray | None = None,
        device: str | torch.device = "cuda",
    ) -> "IVFIndex":
        """Train the coarse quantizer on ``device`` and lay out clusters
        contiguously.  ``spill_eps > 0`` stores a second copy of each vector
        whose second-nearest centroid is within ``(1+spill_eps)·d1²``.
        ``kmeans_checkpoint``: a path for k-means' per-step checkpoint, from
        which a long build resumes (:func:`kmeans_mod.kmeans`)."""
        base = np.asarray(base, dtype=np.float32)
        n = base.shape[0]
        nlist = kmeans_mod.default_nlist(n, nlist)
        if centroids is not None:
            centroids = np.asarray(centroids, dtype=np.float32)
            if centroids.shape != (nlist, base.shape[1]):
                raise ValueError(
                    f"centroids shape {centroids.shape} != ({nlist}, {base.shape[1]})")
            assign = None
            if spill_eps <= 0.0:
                assign = kmeans_mod.assign_clusters(
                    torch.from_numpy(base).to(device),
                    torch.from_numpy(centroids).to(device)).cpu().numpy()
        else:
            centroids, assign = kmeans_mod.kmeans(
                base, nlist, seed=seed, max_iter=max_iter, init=kmeans_init,
                checkpoint=kmeans_checkpoint, device=device)

        ids_all = np.arange(n, dtype=np.int64)
        cl_all = None if assign is None else assign.astype(np.int64)
        n_spilled = 0
        if spill_eps > 0.0:
            # Primary and spill assignments from the same (final) centroids.
            a1, a2, d1, d2 = kmeans_mod.assign_top2(base, centroids, device=device)
            cl_all = a1.astype(np.int64)
            boundary = np.where(d2 <= (1.0 + float(spill_eps)) * d1)[0]
            n_spilled = int(boundary.shape[0])
            ids_all = np.concatenate([ids_all, boundary])
            cl_all = np.concatenate([cl_all, a2[boundary].astype(np.int64)])

        order = np.argsort(cl_all, kind="stable")
        vectors_reordered = base[ids_all[order]]
        counts = np.bincount(cl_all, minlength=nlist)
        offsets = np.zeros(nlist + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        rng = np.random.default_rng(seed)
        take = min(8192, n)
        probe_skew = cls.measure_probe_skew(
            centroids, base[rng.choice(n, take, replace=False)],
            coarse_metric=coarse_metric)
        return cls(
            centroids, vectors_reordered, offsets.astype(np.int32),
            ids_all[order].astype(np.int32), metric=metric, dtype=dtype,
            coarse_metric=coarse_metric, pad_block=pad_block, store=store,
            config={"seed": seed, "kmeans_max_iter": max_iter,
                    "kmeans_init": kmeans_init,
                    "spill_eps": float(spill_eps), "n_spilled": n_spilled,
                    "probe_skew": probe_skew, "probe_skew_sample": int(take)},
            device=device,
        )

    # ------------------------------------------------------------ kernel state

    def _vec_padded_host(self) -> np.ndarray:
        """The block-padded fp32 layout [n_padded, D], rebuilt on the host."""
        vec = np.zeros((self.n_padded, self.dim), dtype=np.float32)
        for c in range(self.nlist):
            s0, s1 = int(self._offsets_np[c]), int(self._offsets_np[c + 1])
            d0 = int(self._padded_offsets_np[c])
            vec[d0 : d0 + (s1 - s0)] = self._vectors_np[s0:s1]
        return vec

    def _ensure_padded_f32(self) -> None:
        """Add the block-padded fp32 copy [n_padded, D] on first use: only
        the cluster mode's ``engine="xla"`` reads it (a contiguous window per
        cluster), so no other path pays its padding."""
        if "vectors" not in self._arrays:
            self._arrays["vectors"] = torch.from_numpy(self._vec_padded_host()).to(self.device)

    def _ensure_kernel_state(self) -> None:
        """Add the block-tiled slabs and block tables on first use (the
        compact store builds them at construction)."""
        if "vectors_t" not in self._arrays:
            self._build_kernel_state(self._vec_padded_host())

    def _build_kernel_state(self, vec: np.ndarray) -> None:
        """vec: [Npad, D] fp32 block-padded host array (consumed here)."""
        blk = self.PAD_BLOCK
        if self.dtype == "int8":
            # Symmetric per-tensor int8; L2 rides the bias rows at search
            # time.
            sb = max(float(np.abs(vec).max()), 1e-12) / 127.0
            self._base_scale = sb
            vec = np.clip(np.round(vec / sb), -127, 127).astype(np.int8)
        elif self.metric == "l2":
            # L2 via augmentation: b' = [b, -‖b‖²/2], queries get a ones
            # column; scores come out as l2_score / 2.
            vec = np.concatenate(
                [vec, -0.5 * np.sum(vec * vec, axis=1, keepdims=True)], axis=1)
        vec_t = np.ascontiguousarray(vec.reshape(-1, blk, vec.shape[1]).transpose(0, 2, 1))
        bc, bf, bl, rv, lb = build_block_tables(self._padded_offsets_np, self._sizes_np, blk)
        # Pad to a multiple of 8 blocks with no-op dummy blocks attached to
        # the LAST cluster (first = last = 0, no valid rows), as the JAX
        # package does.
        padg = (-vec_t.shape[0]) % 8
        if padg:
            vec_t = np.pad(vec_t, ((0, padg), (0, 0), (0, 0)))
            bc = np.pad(bc, (0, padg), constant_values=max(self.nlist - 1, 0))
            bf, bl, rv = (np.pad(x, (0, padg)) for x in (bf, bl, rv))
        dev = self.device
        vt = torch.from_numpy(vec_t)
        if self.dtype == "bf16":
            vt = vt.to(torch.bfloat16)
        self._arrays["vectors_t"] = vt.to(dev)
        for name, tab in (("block_cluster", bc), ("block_first", bf),
                          ("block_last", bl), ("rows_valid", rv), ("last_block", lb)):
            self._arrays[name] = torch.from_numpy(np.ascontiguousarray(tab, np.int32)).to(dev)
        sizes = self._sizes_np
        self._cm_max_nb = int(np.max(-(-sizes // blk))) if len(sizes) else 0

    # ------------------------------------------------------------ search stages

    def _coarse_probes(self, q: torch.Tensor, nprobe: int) -> torch.Tensor:
        """STAGE 1 over whichever tier layout the index holds."""
        a = self._arrays
        if "centroids_t" in a:
            return coarse_probes_tiered(q, a["centroids_t"], None, nprobe, tier="fused",
                                        coarse_metric=self.coarse_metric)
        if "centroids_bf16" in a:
            return coarse_probes_tiered(q, a["centroids_bf16"], a.get("centroid_norms"),
                                        nprobe, tier="bf16", coarse_metric=self.coarse_metric)
        return coarse_probes_tiered(q, a["centroids"], a.get("centroid_norms"),
                                    nprobe, tier=self._coarse_tier,
                                    coarse_metric=self.coarse_metric)

    def _route(self, q: torch.Tensor, nprobe: int, qcap: int):
        """STAGES 1-2 → (probes [B, P], cq [nlist, qcap], slot [B, P],
        lossy [B, P] bool, n_candidates [B]).  A lossy pair was dropped
        past ``qcap`` and its cluster holds rows (an empty cluster loses
        nothing); their count is the spill."""
        sizes = self._arrays["sizes"]
        probes = self._coarse_probes(q, nprobe)
        p_sizes = sizes[probes.long()]
        cq, slot, _ = invert_probes(probes, self.nlist, qcap)
        lossy = (slot < 0) & (p_sizes > 0)
        return probes, cq, slot, lossy, p_sizes.sum(dim=1).to(torch.int32)

    def _query_prep(self, q: torch.Tensor):
        """STAGE 3 without the routed table → (qi [B, D'] the kernel-ready
        batch, bias [nblocks, 1, blk] f32 or None, alpha or None).

        int8: per-batch symmetric query scale ``sq``; for L2,
        ``alpha = 2·sq·sb`` and ``bias = norms/alpha`` (kernels K4 and K7
        subtract it from the scores), each step one fp32 op in the JAX
        package's order.  fp32/bf16: ``qi`` is the batch (with a ones column
        for L2) in the slab dtype."""
        a = self._arrays
        nblocks = a["vectors_t"].shape[0]
        blk = self.PAD_BLOCK
        alpha = bias = None
        if self.dtype == "int8":
            qi, sq = quantize.quantize_int8(q)
            alpha = sq * torch.tensor(self._base_scale, dtype=torch.float32, device=q.device)
            if self.metric == "l2":
                alpha = 2.0 * alpha
                norms = a["vector_norms"]
                pad = nblocks * blk - norms.shape[0]
                if pad:
                    norms = torch.nn.functional.pad(norms, (0, pad))
                bias = (norms / alpha).reshape(nblocks, 1, blk)
        else:
            qi = q
            if self.metric == "l2":
                qi = torch.cat([qi, torch.ones((q.shape[0], 1), dtype=qi.dtype,
                                               device=q.device)], dim=1)
            qi = qi.to(a["vectors_t"].dtype)
        return qi, bias, alpha

    def _scan_inputs(self, q: torch.Tensor, cq: torch.Tensor, pitched: bool = False):
        """STAGE 3 → (qi, qb [nblocks, qcap, D'] routed queries per block,
        bias, bias_rows [nblocks, 1, blk] int32 or None, alpha); ``qi``,
        ``bias`` and ``alpha`` as :meth:`_query_prep`.  The bias rows of
        kernel K1 are ``(round(bias) clipped to ±2**21) << 8`` minus the
        block and chunk pack, as the JAX package makes them.  ``qb`` is
        contiguous (K1 reads it so), or with ``pitched`` (the grouped
        engine: K4 alone reads it) a float ``qb`` lies at the 16-byte row
        pitch K4 reads in place."""
        qi, bias, alpha = self._query_prep(q)
        bias_rows = None
        if bias is not None:
            nblocks, _, blk = bias.shape
            t = torch.arange(nblocks, dtype=torch.int32, device=q.device)
            code = (ivf_accum.CODE_MAX - 1) - (t % ivf_accum.CODE_MAX)
            cidc = torch.arange(blk, dtype=torch.int32, device=q.device) >> 7
            pack = (code << 4)[:, None] | cidc[None, :]
            br = torch.clamp(torch.round(bias), -(2.0**21), 2.0**21).to(torch.int32)
            bias_rows = (br * 256 - pack[:, None, :]).contiguous()
        qb = ivf_scan.routed_table(qi, cq, self._arrays["block_cluster"], pitched)
        return qi, qb, bias, bias_rows, alpha

    def _scan(self, qb: torch.Tensor, bias_rows: torch.Tensor | None,
              bin_depth: int = 2) -> torch.Tensor:
        """STAGE 4: kernel K1 → planes [nblocks, qcap, planes·128]."""
        a = self._arrays
        return ivf_accum.cluster_major_accum_planes(
            qb, a["vectors_t"], a["block_first"], a["block_last"], a["rows_valid"],
            blk=self.PAD_BLOCK, bin2=bin_depth >= 2, bias_rows=bias_rows)

    def _score_units(self, pv: torch.Tensor, alpha) -> torch.Tensor:
        """K4 scores back to true-score units: ``alpha·pv`` for int8, ``2·pv``
        for augmented L2 (its scores are l2_score / 2); -inf stays -inf."""
        if alpha is not None:
            return alpha * pv
        return 2.0 * pv if self.metric == "l2" else pv

    def _scan_grouped(self, qb: torch.Tensor, bias: torch.Tensor | None, kk: int,
                      alpha, bin_depth: int = 2):
        """STAGE 4, grouped engine: kernel K4 over the dense block walk →
        (pv, pr) [nblocks, qcap, kk] in true-score units."""
        a = self._arrays
        pv, pr = ivf_scan.cluster_major_scan_grouped(
            qb, a["vectors_t"], a["block_first"], a["block_last"], a["rows_valid"],
            k=kk, blk=self.PAD_BLOCK, group=self.CM_GROUP, bias=bias, bin_depth=bin_depth)
        return self._score_units(pv, alpha), pr

    def _scan_routed(self, qi: torch.Tensor, cq: torch.Tensor, bias: torch.Tensor | None,
                     kk: int, alpha, bin_depth: int = 2):
        """STAGE 4, routed engine: kernel K7 over the dense block walk, the
        routed queries gathered inside the kernel from ``qi`` through
        ``cq[block_cluster]`` → (pv, pr) [nblocks, qcap, kk] in true-score
        units.  The JAX package pads ``qi`` to a multiple of 128 rows for
        the TPU's tiling; no index in ``cq`` points at a pad row, so the
        port passes the batch as it is."""
        a = self._arrays
        cq_blocks = cq[a["block_cluster"].long()].unsqueeze(-1).contiguous()
        pv, pr = ivf_scan.cluster_major_scan_routed(
            qi, cq_blocks, a["vectors_t"], a["block_first"], a["block_last"], a["rows_valid"],
            k=kk, blk=self.PAD_BLOCK, group=self.CM_GROUP, bias=bias, bin_depth=bin_depth)
        return self._score_units(pv, alpha), pr

    def _recover_tables(self, qi, probes, todo, bias, qcap2: int, cap_blocks: int,
                        routed: bool = False):
        """The inputs of one recovery pass: a second, sparse K4 walk (K7
        with ``routed``) over only the clusters that still have ``todo``
        pairs (the JAX package's ``_cm_recover``).

        The todo pairs are re-inverted into a fresh routed table (the rest
        go to a sentinel cluster whose row is discarded), and the active
        clusters' blocks are compacted, in storage order, into a list of
        ``cap_blocks`` blocks that K4 walks with ``row_base = block·blk``.
        A cluster is covered iff its last block made the list; blocks past
        the list's active prefix get zero tables and are no-ops.  A float
        table lies at the 16-byte row pitch K4 reads in place
        (``ivf_scan.routed_table``).
        Returns ((qg, vectors_t, block_first, block_last, rows_valid, bias,
        row_base) for K4, slot2 [B, P], cluster_inc [nlist] bool,
        cluster_pos [nlist] — the row of each cluster's result).  With
        ``routed`` the first input is K7's ``cq_blocks`` [cap_blocks, qcap2,
        1], the listed blocks' rows of the fresh table, and no routed query
        table is gathered."""
        a = self._arrays
        bc_t = a["block_cluster"].long()
        lb = a["last_block"].long()
        probes2 = torch.where(todo, probes, torch.full_like(probes, self.nlist))
        cq2, slot2, _ = invert_probes(probes2, self.nlist + 1, qcap2)
        cq2 = cq2[: self.nlist]
        active_c = cq2[:, 0] >= 0
        active_b = active_c[bc_t] & (a["rows_valid"] > 0)
        rank = torch.cumsum(active_b.to(torch.int32), 0) - 1
        order = torch.argsort((~active_b).to(torch.int32), stable=True)
        blocks_list = order[:cap_blocks]
        inc_b = active_b & (rank < cap_blocks)
        inc_list = inc_b[blocks_list]
        cluster_pos = rank[lb].clamp(0, cap_blocks - 1)
        cluster_inc = active_c & inc_b[lb]

        def listed(name):
            tab = a[name][blocks_list]
            return torch.where(inc_list, tab, torch.zeros_like(tab))

        if routed:
            first = cq2[bc_t[blocks_list]].unsqueeze(-1).contiguous()
        else:
            first = ivf_scan.routed_table(qi, cq2, bc_t[blocks_list])
        scan = (first, a["vectors_t"][blocks_list],
                listed("block_first"), listed("block_last"), listed("rows_valid"),
                None if bias is None else bias[blocks_list],
                (blocks_list * self.PAD_BLOCK).to(torch.int32))
        return scan, slot2, cluster_inc, cluster_pos

    def _recover(self, qi, probes, lossy, bias, alpha, k: int, qcap2: int,
                 cap_blocks: int, passes: int, bin_depth: int = 2, routed: bool = False):
        """STAGE 4b: ``passes`` recovery passes, each placing the pairs the
        ones before left, through K4 (K7 with ``routed``) → (extra (vals
        [B, E], rows [B, E]) to join, in true-score units, -inf where not
        placed; the residual todo [B, P])."""
        b = probes.shape[0]
        ev, er = [], []
        todo = lossy
        for _ in range(passes):
            scan, slot2, cluster_inc, cluster_pos = self._recover_tables(
                qi, probes, todo, bias, qcap2, cap_blocks, routed)
            kw = dict(k=k, blk=self.PAD_BLOCK, group=self.CM_GROUP, bias=scan[5],
                      row_base=scan[6], bin_depth=bin_depth)
            if routed:
                pv2, pr2 = ivf_scan.cluster_major_scan_routed(qi, *scan[:5], **kw)
            else:
                pv2, pr2 = ivf_scan.cluster_major_scan_grouped(*scan[:5], **kw)
            pv2 = self._score_units(pv2, alpha)
            placed = (slot2 >= 0) & cluster_inc[probes.long()]
            ok2 = todo & placed  # todo already implies a non-empty cluster
            flat2 = (cluster_pos[probes.long()] * qcap2 + slot2.clamp_min(0)).reshape(-1)
            gv2 = pv2.reshape(-1, k)[flat2].reshape(b, -1, k)
            gr2 = pr2.reshape(-1, k)[flat2].reshape(b, -1, k)
            ev.append(torch.where(ok2[..., None], gv2, torch.full_like(gv2, _NEG_INF))
                      .reshape(b, -1))
            er.append(gr2.reshape(b, -1))
            todo = todo & ~placed
        return (torch.cat(ev, dim=1), torch.cat(er, dim=1)), todo

    def _join_pool(self, probes: torch.Tensor, slot: torch.Tensor,
                   pp: torch.Tensor) -> torch.Tensor:
        """STAGE 5a: gather each (query, probe) pair's planes → the pool
        [B, P·W] int32; dropped pairs and empty clusters read as KMIN."""
        a = self._arrays
        b = probes.shape[0]
        qcap, w = pp.shape[1], pp.shape[2]
        pl = probes.long()
        tl = a["last_block"][pl]
        ok = (slot >= 0) & (a["sizes"][pl] > 0)
        flat = (tl.long() * qcap + slot.clamp_min(0).long()).reshape(-1)
        gp = pp.reshape(-1, w)[flat].reshape(b, -1, w)
        gp = torch.where(ok[..., None], gp, torch.full_like(gp, ivf_accum.KMIN))
        return gp.reshape(b, -1)

    def _cm_finish(self, queries, probes, slot, pv, pr, k, kk, rescore, extra=None,
                   by_block=True):
        """STAGES 5-6 of the grouped engine: gather each (query, probe)
        pair's K4 top-k from its cluster's last block (``by_block``; the
        xla engine's ``pv`` is indexed by cluster), join the recovery
        pass's ``extra`` candidates, top-kk, then rescore and map back to
        original ids → (scores [B, k], ids [B, k])."""
        a = self._arrays
        b = probes.shape[0]
        pl = probes.long()
        ok = (slot >= 0) & (a["sizes"][pl] > 0)
        qcap, ck = pv.shape[1], pv.shape[2]
        row = a["last_block"][pl].long() if by_block else pl
        flat = (row * qcap + slot.clamp_min(0).long()).reshape(-1)
        gv = pv.reshape(-1, ck)[flat].reshape(b, -1, ck)
        gr = pr.reshape(-1, ck)[flat].reshape(b, -1)
        gv = torch.where(ok[..., None], gv, torch.full_like(gv, _NEG_INF)).reshape(b, -1)
        if extra is not None:
            gv = torch.cat([gv, extra[0]], dim=1)
            gr = torch.cat([gr, extra[1]], dim=1)
        best_v, sel = topk.small_topk(gv, min(kk, gv.shape[1]))
        return self._finish_rows(queries, best_v, torch.gather(gr, 1, sel.long()), k, rescore)

    def _finish_rows(self, queries, best_v, best_r, k, rescore):
        """STAGE 6: the rescore (or the top k as they are) and the map of
        padded rows to original ids; -inf entries get id -1.  Rows under
        -inf may be unwritten kernel output and are zeroed before any
        lookup."""
        best_r = torch.where(best_v > _NEG_INF, best_r, torch.zeros_like(best_r))
        if rescore:
            best_v, best_r = self._rescore_rows(queries, best_v, best_r, k)
        else:
            best_v, best_r = best_v[:, :k], best_r[:, :k]
        ids = torch.where(best_v > _NEG_INF, self._arrays["reorder"][best_r.long()],
                          torch.full_like(best_r, -1))
        return best_v, ids.to(torch.int32)

    def _cm_finish_planes(self, queries, probes, slot, pp, k, kk, rescore, alpha,
                          extra=None):
        """STAGES 5-6: join, top-kk of the pool (K2 once B·pool >=
        ``JOIN_FUSED_MIN``), row decode from the keys, the recovery pass's
        ``extra`` candidates joined and top-kk again, then the rescore and
        the map back to original ids → (scores [B, k], ids [B, k])."""
        a = self._arrays
        blk = self.PAD_BLOCK
        cmax = ivf_accum.CODE_MAX
        w = pp.shape[2]
        gp = self._join_pool(probes, slot, pp)
        b, pool = gp.shape
        kp = min(kk, pool)
        if b * pool >= JOIN_FUSED_MIN:
            vals_p, sel = fused_topk.fused_topk(gp, kp)
        else:
            vals_p, sel = topk.small_topk(gp, kp)
        valid = vals_p > ivf_accum.KMIN
        # Row decode: the key's low byte holds (block code, chunk id); the
        # pool position holds (probe, lane).
        pi = sel // w
        lane = (sel % w) & 127
        cid = vals_p & (cmax - 1)
        codeb = (vals_p >> 4) & (cmax - 1)
        tsel = torch.gather(a["last_block"][probes.long()], 1, pi.long())
        d = ((tsel & (cmax - 1)) - ((cmax - 1) - codeb)) & (cmax - 1)
        best_r = (tsel - d) * blk + cid * 128 + lane
        if alpha is not None:
            best_v = alpha * (vals_p >> 8).to(torch.float32)
        else:
            best_v = ivf_accum._key_to_f32(vals_p)
            if self.metric == "l2":
                best_v = 2.0 * best_v  # augmented scores are l2_score / 2
        best_v = torch.where(valid, best_v, torch.full_like(best_v, _NEG_INF))
        if extra is not None:
            gv = torch.cat([best_v, extra[0]], dim=1)
            gr = torch.cat([best_r, extra[1]], dim=1)
            best_v, sel2 = topk.small_topk(gv, kk)
            best_r = torch.gather(gr, 1, sel2.long())
        return self._finish_rows(queries, best_v, best_r, k, rescore)

    def _rescore_rows(self, queries, vals, rows, k):
        """Exact fp32 re-ranking of candidate padded rows → (scores [B, k],
        rows [B, k]); spilled indexes dedup by original id first."""
        a = self._arrays
        b, kp = rows.shape
        safe = rows.clamp(0, a["reorder"].shape[0] - 1).long()
        orig = a["reorder"][safe.reshape(-1)].clamp_min(0)
        cand = a["vectors_f32"][orig.long()].reshape(b, kp, -1)
        scores = torch.bmm(cand, queries.to(torch.float32)[:, :, None])[..., 0]
        if self.metric == "l2":
            scores = 2.0 * scores - (cand * cand).sum(dim=-1)
        scores = torch.where(vals > _NEG_INF, scores, torch.full_like(scores, _NEG_INF))
        if self.spilled:
            scores, _, rows = topk.dedup_rows_by_id(scores, orig.reshape(b, kp), payload=rows)
        best_v, sel = topk.small_topk(scores, k)
        return best_v, torch.gather(rows, 1, sel.long())

    def _scan_xla(self, q: torch.Tensor, cq: torch.Tensor, ck: int,
                  budget_bytes: int = 256 << 20):
        """STAGE 4, the cluster mode's xla engine (the JAX package's
        per-cluster scan): each cluster's routed fp32 queries against the
        ``max_cluster_padded`` rows of the block-padded fp32 copy from its
        start (clamped so the window stays inside the array; the rows and
        their validity follow the clamped start), ``2·s − ‖b‖²`` for L2,
        masked by offset and by ``cq >= 0``, and a top-``ck`` per cluster →
        (pv, pr) [nlist, qcap, ck], true-score units, padded rows.  The JAX
        package scans one cluster a step; here clusters go in batches whose
        window gather and scores stay within ``budget_bytes``."""
        a = self._arrays
        vec = a["vectors"]
        dev = q.device
        n_pad, d = vec.shape
        smax = self.max_cluster_padded
        qcap = cq.shape[1]
        kc = min(ck, smax)
        offs, sizes = a["offsets"].long(), a["sizes"].long()
        start = offs.clamp_max(max(n_pad - smax, 0))
        arange_s = torch.arange(smax, device=dev)
        routed = cq >= 0
        qg = torch.where(routed[..., None], q[cq.clamp_min(0).long()],
                         torch.zeros((), dtype=q.dtype, device=dev))
        step = max(1, budget_bytes // ((smax * d + qcap * smax) * 4))
        pv = torch.full((self.nlist, qcap, ck), _NEG_INF, dtype=torch.float32, device=dev)
        pr = torch.zeros((self.nlist, qcap, ck), dtype=torch.int32, device=dev)
        for c0 in range(0, self.nlist, step):
            c1 = min(c0 + step, self.nlist)
            rows = start[c0:c1, None] + arange_s  # [C, S]
            scores = torch.bmm(qg[c0:c1], vec[rows].transpose(1, 2))  # [C, qcap, S]
            if self.metric == "l2":
                scores = 2.0 * scores - a["vector_norms"][rows][:, None, :]
            off = rows - offs[c0:c1, None]
            valid = ((off >= 0) & (off < sizes[c0:c1, None]))[:, None, :] \
                & routed[c0:c1, :, None]
            scores = torch.where(valid, scores, torch.full_like(scores, _NEG_INF))
            v, idx = topk.iterative_topk(scores.reshape(-1, smax), kc)
            r = torch.gather(rows[:, None, :].expand(-1, qcap, -1), 2,
                             idx.reshape(c1 - c0, qcap, kc).long())
            pv[c0:c1, :, :kc] = v.reshape(c1 - c0, qcap, kc)
            pr[c0:c1, :, :kc] = r.to(torch.int32)
        return pv, pr

    def _search_query(self, q: torch.Tensor, k: int, nprobe: int, probe_chunk: int,
                      rescore: bool):
        """The query-major search (the JAX package's ``_search_impl``) →
        (scores [B, k] f32, ids [B, k] int32, n_candidates [B] int32): the
        coarse probes, :func:`fine_scan` over the unpadded fp32 copy through
        the padded-row map (bf16 products for a bf16 index), the optional
        fp32 rescore of 2k, and the map back to original ids."""
        a = self._arrays
        kk = min(2 * k, self.n) if rescore else k
        nprobe = min(nprobe, self.nlist)
        probes = self._coarse_probes(q, nprobe).long()
        p_offs, p_sizes = a["offsets"][probes], a["sizes"][probes]
        n_candidates = p_sizes.sum(dim=1).to(torch.int32)
        best_v, best_i = fine_scan(
            q, a["vectors_f32"], a.get("vector_norms"), p_offs, p_sizes, k=kk,
            probe_chunk=probe_chunk, metric=self.metric,
            max_cluster_size=self.max_cluster_size,
            compute_dtype=torch.bfloat16 if self.dtype == "bf16" else None,
            row_map=a["reorder"])
        if rescore:
            best_v, best_i = self._rescore_rows(q, best_v, best_i, k)
        ids = torch.where(best_v > _NEG_INF, a["reorder"][best_i.long()],
                          torch.full_like(best_i, -1))
        return best_v, ids.to(torch.int32), n_candidates

    # ------------------------------------------------------------ policy

    def _auto_probe_chunk(self, batch: int, budget_bytes: int = 256 << 20) -> int:
        """Probes per query-major chunk: the slab gather of one chunk,
        ``B × max_cluster_size × D`` values, stays within the budget."""
        bytes_per_probe = batch * self.max_cluster_size * self.dim * (
            2 if self.dtype == "bf16" else 4)
        return max(1, budget_bytes // max(bytes_per_probe, 1))

    def _auto_qcap(self, batch: int, nprobe: int, capacity_factor: float = 8.0) -> int:
        """MoE-style capacity: ~capacity_factor x the mean cluster load,
        rounded up to 128, capped at min(batch, 256)."""
        mean_load = batch * min(nprobe, self.nlist) / self.nlist
        cap = int(-(-capacity_factor * mean_load // 128) * 128)
        return max(128, min(batch, 256, cap))

    def _accum_dim_cap(self) -> int:
        """Max dim the planes engine's int8 packed keys support."""
        if self.dtype != "int8":
            return 1 << 30
        return (ivf_accum.INT8_DIM_MAX_BIAS if self.metric == "l2"
                else ivf_accum.INT8_DIM_MAX)

    def _auto_cluster_k(self, k: int, rescore: bool, rescore_k: int | None) -> int:
        """Per-cluster candidate depth kk: the full rescore pool."""
        return min(rescore_k or 2 * k, self.n) if rescore else k

    _SKEW_NPROBES = (1, 2, 4, 8, 16, 32)

    @staticmethod
    def measure_probe_skew(centroids: np.ndarray, sample: np.ndarray,
                           coarse_metric: str = "l2",
                           nprobes: tuple = _SKEW_NPROBES) -> dict:
        """Hottest-cluster probe-load FRACTION per nprobe on a vector sample
        (host numpy): ``frac[np] = max cluster load / S``."""
        c = np.asarray(centroids, dtype=np.float32)
        s = np.asarray(sample, dtype=np.float32)
        nlist = c.shape[0]
        scores = s @ c.T
        if coarse_metric == "l2":
            scores = 2.0 * scores - np.sum(c * c, axis=1)[None, :]
        nps = sorted({min(int(p), nlist) for p in nprobes})
        pmax = nps[-1]
        if pmax >= nlist:
            top = np.argsort(-scores, axis=1)[:, :pmax]
        else:
            part = np.argpartition(-scores, pmax, axis=1)[:, :pmax]
            rows = np.arange(s.shape[0])[:, None]
            top = part[rows, np.argsort(-scores[rows, part], axis=1)]
        return {str(p): round(float(
            np.bincount(top[:, :p].ravel(), minlength=nlist).max()
            / s.shape[0]), 6) for p in nps}

    def _probe_skew_table(self) -> dict:
        """The build-time skew table, or one measured now on a seeded sample
        of the stored vectors (and kept in ``config``)."""
        tab = self.config.get("probe_skew")
        if not tab:
            rng = np.random.default_rng(int(self.config.get("seed", 42)))
            take = min(8192, self.n)
            sel = rng.choice(self.n, take, replace=False)
            tab = self.measure_probe_skew(self._centroids_np, self._vectors_np[sel],
                                          coarse_metric=self.coarse_metric)
            self.config["probe_skew"] = tab
            self.config["probe_skew_sample"] = int(take)
        return tab

    def _est_max_load(self, batch: int, nprobe: int) -> float:
        """Expected hottest-cluster load of a batch, from the measured skew
        table with log-nprobe interpolation; where no table can be read or
        measured (a malformed or empty table, too few rows to sample), the
        JAX package's fallback: the mean load times ``clip(nlist / 256, 8,
        32)``."""
        nprobe = min(nprobe, self.nlist)
        try:
            tab = self._probe_skew_table()
            nps = np.array(sorted(int(p) for p in tab), dtype=np.float64)
            fracs = np.array([tab[str(int(p))] for p in nps])
            if nprobe <= nps[-1]:
                frac = float(np.interp(np.log2(nprobe), np.log2(nps), fracs))
            else:
                frac = min(1.0, float(fracs[-1]) * nprobe / float(nps[-1]))
            return min(float(batch), frac * batch)
        except (ValueError, KeyError, IndexError, TypeError):
            mean_load = batch * nprobe / self.nlist
            skew = float(np.clip(self.nlist / 256.0, 8.0, 32.0))
            return min(float(batch), skew * mean_load)

    def _auto_recover(self, batch: int, nprobe: int) -> bool:
        """Whether the JAX package would engage its spilled-pair recovery
        pass: the estimated hottest-cell overflow past qcap exceeds
        max(batch/256, 8)."""
        qcap = self._auto_qcap(batch, nprobe)
        overflow = self._est_max_load(batch, nprobe) - qcap
        return qcap < batch and overflow > max(batch / 256.0, 8.0)

    def _auto_recover_passes(self, batch: int, nprobe: int, recover_qcap: int,
                             max_passes: int = 8) -> int:
        """Recovery passes sized so that qcap + passes·recover_qcap reaches
        the estimated hottest-cell load, clipped to [1, max_passes]."""
        need = self._est_max_load(batch, nprobe) - self._auto_qcap(batch, nprobe)
        return int(np.clip(-(-need // max(recover_qcap, 1)), 1, max_passes))

    def required_qcap(self, queries, nprobe: int, multiple: int = 32) -> int:
        """The smallest routing capacity that drops no pair of this batch:
        its hottest cluster's probe load, rounded up to ``multiple`` (one
        coarse pass and a host sync)."""
        q = torch.as_tensor(np.asarray(queries, dtype=np.float32)).to(self.device)
        probes = self._coarse_probes(q, min(nprobe, self.nlist))
        loads = torch.bincount(probes.reshape(-1).long(), minlength=self.nlist)
        need = int(loads.max())
        return max(multiple, -(-need // multiple) * multiple)

    def _pick_mode(self, batch: int, nprobe: int) -> str:
        qm_rows = batch * min(nprobe, self.nlist) * (self.n_padded / self.nlist)
        return "cluster" if qm_rows >= self.n_padded else "query"

    def memory_report(self) -> dict[str, int]:
        """Device bytes per index array and their ``"TOTAL"``; the kernel
        state and the xla engine's padded copy count once they exist."""
        return metrics.memory_report(self._arrays)

    # ------------------------------------------------------------------ API

    def search_device(
        self,
        queries: torch.Tensor,
        k: int,
        nprobe: int,
        probe_chunk: int | None = None,
        mode: str = "auto",
        qcap: int | None = None,
        engine: str = "auto",
        rescore: bool | None = None,
        recover: bool | None = None,
        recover_qcap: int | None = None,
        recover_blocks: int | None = None,
        recover_passes: int | None = None,
        bin_depth: int = 2,
        rescore_k: int | None = None,
        cluster_k: int | None = None,
    ):
        """Search a batch on the index's device → (scores [B, k] f32,
        ids [B, k] int32, n_candidates [B] int32).  The parameters take the
        JAX package's positions.

        probe_chunk: probes per query-major chunk (default
            :meth:`_auto_probe_chunk`: one chunk's slab gather within 256 MB).
        mode: "auto" (:meth:`_pick_mode`: "query" below one padded database
            of gathered rows, else "cluster"; "cluster" on a compact store)
            | "query" — :func:`fine_scan` over each query's probed clusters,
            exact fp32 (bf16 products for a bf16 index) | "cluster".
        engine (cluster mode): "auto" (pallas_accum where the index's layout
            allows it, else pallas) | "pallas_accum" — the accum fine scan
            (kernel K1) with the planes join (kernel K2); clusters of at
            most 16 blocks | "pallas" — the grouped fine scan (kernel K4)
            over a gathered routed table | "pallas_routed" — the same scan
            with the routing inside the kernel (kernel K7), so no routed
            table is built; never picked by "auto" | "xla" — a plain
            per-cluster scan of the block-padded fp32 copy
            (:meth:`_scan_xla`), built on first use.  The names are the JAX
            package's.
        rescore: fp32 re-ranking of ``rescore_k`` (default 2k) candidates.
            Default, as in the JAX package: on for bf16 and int8 indexes,
            for spilled ones, and for the cluster mode's kernel engines
            (their selection is binned); off for an fp32 index in query mode
            or with ``engine="xla"`` (exact already).
        recover: the spilled-pair recovery pass (kernel K4, K7 under the
            routed engine, over only the clusters that dropped routing
            pairs, :meth:`_recover`); the kernel engines only.
            Default: on where the estimated hottest-cell overflow past qcap
            is large (:meth:`_auto_recover`).  ``last_spill`` holds the
            pairs still dropped after it.
        recover_qcap / recover_blocks: capacity of each recovery pass
            (default qcap, and nblocks/4 rounded up to ``CM_GROUP``).
        recover_passes: recovery passes, each placing the pairs the ones
            before left (default :meth:`_auto_recover_passes`).
        cluster_k: per-cluster emit depth of the cluster-mode scans
            (default: the rescore pool, :meth:`_auto_cluster_k`).  As in the
            JAX package it is raised to ``ceil(pool / nprobe)``, so the join
            pool still holds ``pool`` candidates, and capped at the pool.
        """
        b = queries.shape[0]
        if self.store == "compact" and mode == "auto":
            mode = "cluster"
        if mode == "auto":
            mode = self._pick_mode(b, nprobe)
        if mode not in ("query", "cluster"):
            raise ValueError(f"unknown mode {mode!r}")
        if engine not in ("auto", "pallas", "pallas_accum", "pallas_routed", "xla"):
            raise ValueError(f"unknown engine {engine!r}")
        if rescore is None:
            rescore = (self.dtype in ("bf16", "int8") or (mode == "cluster" and engine != "xla")
                       or self.spilled)  # spilled indexes dedup in the rescore stage
        q = queries.to(self.device, torch.float32)
        if mode == "query":
            self.last_engine = "xla"
            self.last_mode = mode
            pc = probe_chunk or self._auto_probe_chunk(b)
            return self._search_query(q, k, nprobe, pc, rescore)
        if engine == "xla":
            if recover:
                raise ValueError("recover requires a pallas cluster engine")
            self._ensure_padded_f32()
            recover = False
        else:
            self._ensure_kernel_state()
            # The accum engine's packed key holds a 4-bit block code, a 4-bit
            # chunk id and dots << 8.
            eligible = (self._cm_max_nb <= ivf_accum.CODE_MAX
                        and self.PAD_BLOCK <= 128 * ivf_accum.CODE_MAX
                        and self.dim <= self._accum_dim_cap())
            if engine == "auto":
                engine = "pallas_accum" if eligible else "pallas"
            elif engine == "pallas_accum" and not eligible:
                raise ValueError(
                    f"engine='pallas_accum' needs clusters of at most {ivf_accum.CODE_MAX} "
                    f"blocks, pad_block <= {128 * ivf_accum.CODE_MAX} and dim <= "
                    f"{self._accum_dim_cap()}; this index has {self._cm_max_nb}-block "
                    f"clusters, pad_block {self.PAD_BLOCK} and dim {self.dim} — use "
                    "engine='pallas'")
            if recover is None:
                recover = self._auto_recover(b, nprobe)
        kk = self._auto_cluster_k(k, rescore, rescore_k)
        # The per-cluster emit depth (JAX: ck); the pool after the join is kk.
        ck = kk
        if cluster_k is not None:
            ck = min(max(cluster_k, -(-kk // min(nprobe, self.nlist))), kk)
        nprobe = min(nprobe, self.nlist)
        qcap = qcap or self._auto_qcap(b, nprobe)
        probes, cq, slot, lossy, ncand = self._route(q, nprobe, qcap)
        if engine == "xla":
            pv, pr = self._scan_xla(q, cq, ck)
            vals, ids = self._cm_finish(q, probes, slot, pv, pr, k, kk, rescore, by_block=False)
            self.last_spill = lossy.sum().to(torch.int32)
            self.last_engine = engine
            self.last_mode = mode
            return vals, ids, ncand
        routed = engine == "pallas_routed"
        if routed:
            qi, bias, alpha = self._query_prep(q)
            pv, pr = self._scan_routed(qi, cq, bias, ck, alpha, bin_depth)
        else:
            qi, qb, bias, bias_rows, alpha = self._scan_inputs(q, cq,
                                                               pitched=engine == "pallas")
            if engine == "pallas_accum":
                pp = self._scan(qb, bias_rows, bin_depth)
            else:
                pv, pr = self._scan_grouped(qb, bias, ck, alpha, bin_depth)
        extra, todo = None, lossy
        if recover:
            nblocks = self._arrays["vectors_t"].shape[0]
            rq = recover_qcap or qcap
            rb = min(recover_blocks or max(1, nblocks // 4), nblocks)
            rb = -(-rb // self.CM_GROUP) * self.CM_GROUP
            rp = recover_passes or self._auto_recover_passes(b, nprobe, rq)
            extra, todo = self._recover(qi, probes, lossy, bias, alpha, ck, rq, rb, rp,
                                        bin_depth, routed)
        if engine == "pallas_accum":
            vals, ids = self._cm_finish_planes(q, probes, slot, pp, k, kk, rescore, alpha,
                                               extra=extra)
        else:
            vals, ids = self._cm_finish(q, probes, slot, pv, pr, k, kk, rescore, extra=extra)
        self.last_spill = todo.sum().to(torch.int32)
        self.last_engine = engine
        self.last_mode = mode
        return vals, ids, ncand

    def search_stream_device(self, query_stream: torch.Tensor, k: int, nprobe: int,
                             probe_chunk: int | None = None, mode: str = "query"):
        """A stack of micro-batches [M, B, D] → (scores [M, B, k], ids [M,
        B, k], n_candidates [M, B]).  Mode "query": M independent
        query-major searches, rescored only on a spilled index (where the
        rescore dedups), as the JAX package's stream does.  Mode "cluster":
        the stream flattened into one cluster-mode batch of M·B queries."""
        m, b2, d = query_stream.shape
        if mode == "cluster":
            v, i, c = self.search_device(query_stream.reshape(m * b2, d), k, nprobe,
                                         mode="cluster")
            return v.reshape(m, b2, k), i.reshape(m, b2, k), c.reshape(m, b2)
        pc = probe_chunk or self._auto_probe_chunk(b2)
        qs = query_stream.to(self.device, torch.float32)
        outs = [self._search_query(qs[j], k, nprobe, pc, self.spilled) for j in range(m)]
        return tuple(torch.stack(x) for x in zip(*outs))

    def search(self, queries: np.ndarray, k: int, nprobe: int = 16,
               batch_size: int | None = None, mode: str = "auto",
               engine: str = "auto", rescore: bool | None = None,
               recover: bool | None = None):
        """Host API → (ids [Q, k] int32, scores [Q, k] f32, avg_candidates).
        A short last batch is padded by cyclic repeat of its own rows (a
        block of identical pad rows would all probe the same cells and
        crowd real pairs out of the routing capacity)."""
        queries = np.asarray(queries, dtype=np.float32)
        nq = queries.shape[0]
        bs = batch_size or nq
        ids_out = np.empty((nq, k), dtype=np.int32)
        scores_out = np.empty((nq, k), dtype=np.float32)
        total_cand = 0
        for start in range(0, nq, bs):
            chunk = queries[start : start + bs]
            pad = bs - chunk.shape[0]
            if pad:
                chunk = np.resize(chunk, (bs, chunk.shape[1]))
            vals, ids, ncand = self.search_device(
                torch.from_numpy(chunk).to(self.device), k, nprobe, mode=mode,
                engine=engine, rescore=rescore, recover=recover)
            got = bs - pad
            ids_out[start : start + got] = ids.cpu().numpy()[:got]
            scores_out[start : start + got] = vals.cpu().numpy()[:got]
            total_cand += int(ncand.cpu().numpy()[:got].sum())
        return ids_out, scores_out, total_cand / nq

    def compile(self, batch_size: int, k: int, nprobe: int, mode: str = "auto",
                engine: str = "auto", recover: bool | None = None,
                recover_passes: int | None = None) -> None:
        """One warm call on a zero batch of ``batch_size`` queries: it builds
        every kernel that shape reaches and the state it needs (PyTorch has
        no program to compile ahead)."""
        dummy = torch.zeros((batch_size, self.dim), dtype=torch.float32, device=self.device)
        self.search_device(dummy, k, nprobe, mode=mode, engine=engine, recover=recover,
                           recover_passes=recover_passes)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ persistence

    _FILES = {
        "centroids": "centroids.npy",
        "vectors": "vectors_reordered.npy",
        "offsets": "cluster_offsets.npy",
        "reorder": "reorder_to_original.npy",
        "sizes": "cluster_sizes.npy",
        "config": "ivf_config.json",
    }

    def save(self, index_dir: str) -> None:
        """Write the artifact set the JAX package's ``save`` writes."""
        os.makedirs(index_dir, exist_ok=True)
        np.save(os.path.join(index_dir, self._FILES["centroids"]), self._centroids_np)
        np.save(os.path.join(index_dir, self._FILES["vectors"]), self._vectors_np)
        np.save(os.path.join(index_dir, self._FILES["offsets"]), self._offsets_np)
        np.save(os.path.join(index_dir, self._FILES["reorder"]), self._reorder_np)
        np.save(os.path.join(index_dir, self._FILES["sizes"]),
                np.diff(self._offsets_np).astype(np.int32))
        with open(os.path.join(index_dir, self._FILES["config"]), "w") as f:
            json.dump(self.config, f, indent=2)

    @classmethod
    def load(cls, index_dir: str, store: str = "padded",
             device: str | torch.device = "cuda") -> "IVFIndex":
        """Load an artifact set: the reordered set :meth:`save` writes, or
        the scattered set (original-order ``vectors.npy`` and
        ``cluster_indices.npy``), reordered here."""
        with open(os.path.join(index_dir, cls._FILES["config"])) as f:
            config = json.load(f)
        reordered_path = os.path.join(index_dir, cls._FILES["vectors"])
        if os.path.exists(reordered_path):
            vectors = np.load(reordered_path)
            reorder = np.load(os.path.join(index_dir, cls._FILES["reorder"]))
        else:
            original = np.load(os.path.join(index_dir, "vectors.npy"))
            reorder = np.load(os.path.join(index_dir, "cluster_indices.npy"))
            vectors = original[reorder]
        return cls(
            np.load(os.path.join(index_dir, cls._FILES["centroids"])),
            vectors,
            np.load(os.path.join(index_dir, cls._FILES["offsets"])),
            reorder,
            metric=config.get("metric", "ip"),
            dtype=config.get("dtype", "fp32"),
            coarse_metric=config.get("coarse_metric", "l2"),
            store=store,
            config=config,
            device=device,
        )
