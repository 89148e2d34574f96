"""Exact (or int8-quantized) brute-force k-NN index in PyTorch
(counterpart: ``rag_on_edge_tpu/models/brute_force.py``).

Three engines, the JAX package's:

- ``"xla"``: the whole [B, N] score matrix in plain torch, then a
  selection strategy (``select``);
- ``"pallas"``: kernel K3 (``ops/bruteforce_fused.py``), a streaming GEMM
  with a running top-k, exact unless the rescore asks for its binned mode;
- ``"accum"``: kernel K5 (``ops/bruteforce_accum.py``), packed
  max-accumulation with one candidate per (column mod tile_n) bin.

``engine="auto"`` takes accum once N >= 100,000, xla below.  Precision
paths: ``"fp32"`` (exact), ``"bf16"`` (bf16 GEMM inputs, fp32 sums) and
``"int8"`` (symmetric int8, int32 dots; L2 ranks on ``alpha·dots −
‖b‖²``).  ``rescore`` re-ranks a ``rescore_depth·k`` pool by exact fp32
scores; it is on by default for the accum engine only.

The index state is built from ``base`` deterministically, array for array
as the JAX index builds its ``_arrays``, on ``device`` (default
``"cuda"``).  On CUDA both kernels run every dtype (int8, fp32 and bf16),
so the defaults (``dtype="bf16"``, the accum engine once N >= 100,000)
run on the card.  Return order is the JAX package's:
:meth:`search_device` → (scores, ids), :meth:`search` → (ids, scores).
"""

from __future__ import annotations

import numpy as np
import torch

from rag_on_edge_tpu_torch.ops import bruteforce_accum as bf_accum
from rag_on_edge_tpu_torch.ops import distances, quantize, topk
from rag_on_edge_tpu_torch.ops.bruteforce_fused import fused_topk_matmul

__all__ = ["BruteForceIndex"]

_SELECT_FNS = {
    "exact": lambda s, k: topk.topk(s, k),
    "two_stage": lambda s, k: topk.two_stage_topk(s, k),
    "iterative": lambda s, k: topk.iterative_topk(s, k),
    "auto": lambda s, k: (
        topk.iterative_topk(s, k) if k <= 32 else topk.two_stage_topk(s, k)
    ),
    "approx": lambda s, k: topk.approx_topk(s, k),
}


class BruteForceIndex:
    """Brute-force search over a base matrix; see the module docstring.

    Parameters
    ----------
    base : [N, D] float32 database vectors (numpy).
    metric : "ip" (inner product) or "l2".
    dtype : "fp32" | "bf16" | "int8" compute path.
    select : "auto" | "exact" | "two_stage" | "iterative" | "approx"
        k-selection of the xla engine.
    engine : "auto" | "xla" | "pallas" | "accum".
    rescore : exact fp32 re-ranking of a ``rescore_depth·k`` pool (at
        least k+1, at most N).  Default: on for the accum engine only.
    rescore_depth : pool depth of the rescore, >= 1.
    device : where the index state lives and the search runs.
    """

    def __init__(
        self,
        base: np.ndarray,
        metric: str = "ip",
        dtype: str = "bf16",
        select: str = "auto",
        engine: str = "auto",
        rescore: bool | None = None,
        rescore_depth: int = 2,
        device: str | torch.device = "cuda",
    ):
        if metric not in ("ip", "l2"):
            raise ValueError(f"unknown metric {metric!r}")
        if dtype not in ("fp32", "bf16", "int8"):
            raise ValueError(f"unknown dtype {dtype!r}")
        if select not in _SELECT_FNS:
            raise ValueError(f"unknown select {select!r}")
        if engine not in ("auto", "xla", "pallas", "accum"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "auto":
            engine = "accum" if base.shape[0] >= 100_000 else "xla"
            if engine == "accum" and dtype == "int8" and base.shape[1] > 4096:
                # int32 packed-key headroom: |q.b| <= d*127^2 must clear the
                # group-code shift; wider vectors take the exact fused kernel.
                engine = "pallas"
        if engine == "accum" and dtype == "int8" and base.shape[1] > 4096:
            raise ValueError(
                "engine='accum' int8 path supports dim <= 4096 (int32 "
                "packed-key headroom: |q.b| <= d*127^2 must clear the "
                f"group-code shift); got dim={base.shape[1]} — use "
                "engine='pallas'"
            )

        self.metric = metric
        self.dtype = dtype
        self.select = select
        self.engine = engine
        # The accum engine's binned selection is approximate, so it rescores
        # by default, for every dtype.
        self.rescore = engine == "accum" if rescore is None else bool(rescore)
        if rescore_depth < 1:
            raise ValueError(f"rescore_depth must be >= 1, got {rescore_depth}")
        self.rescore_depth = int(rescore_depth)
        self.n, self.dim = base.shape
        self.device = torch.device(device)

        def put(x: torch.Tensor) -> torch.Tensor:
            return x.contiguous().to(self.device)

        base_f32 = torch.from_numpy(np.ascontiguousarray(base, dtype=np.float32))
        arrays: dict[str, torch.Tensor] = {}
        if self.rescore:
            arrays["base_f32"] = put(base_f32)
            if metric == "l2":
                arrays["rescore_norms"] = put(distances.base_norms_sq(base_f32))
        # Accum-engine tiling (the JAX package's constants): wide tiles for
        # large bases; the group is the packed key's low-bit code width.
        self._acc_tile_n = 2048 if self.n >= 128_000 else 512
        self._acc_group = 32 if self.n >= 512_000 else 8
        self._acc_depth = 8 if dtype == "int8" else 4
        if dtype == "int8":
            qv, scale = quantize.quantize_int8(base_f32)
            arrays["base_scale"] = put(scale)
            if engine == "accum":
                tiles, _ = bf_accum.tile_base(qv.T, self._acc_tile_n, self._acc_group)
                arrays["base_tiles"] = put(tiles)
                if metric == "l2":
                    norms = distances.base_norms_sq(base_f32)
                    self._max_norm = float(norms.max()) if norms.numel() else 0.0
                    arrays["norms_tiled"] = put(torch.from_numpy(bf_accum.tile_norms(
                        norms.numpy(), self._acc_tile_n, self._acc_group)))
            elif engine == "pallas":
                arrays["base_t"] = put(qv.T)
            else:
                arrays["base"] = put(qv)
            if metric == "l2" and engine != "accum":
                # Norms bias: l2 = alpha·dots − ‖b‖² with alpha = 2·sq·sb.
                arrays["base_norms"] = put(distances.base_norms_sq(base_f32))
        elif engine in ("accum", "pallas"):
            # Both kernels compute inner products; L2 folds in by augmentation:
            # q' = [q, 1], b' = [b, -‖b‖²/2], q'·b' = (2q·b - ‖b‖²) / 2.
            bt = base_f32.T
            if metric == "l2":
                bt = torch.cat([bt, -0.5 * distances.base_norms_sq(base_f32)[None, :]], dim=0)
            bt = bt.to(torch.bfloat16) if dtype == "bf16" else bt
            if engine == "accum":
                bt, _ = bf_accum.tile_base(bt, self._acc_tile_n, self._acc_group)
                arrays["base_tiles"] = put(bt)
            else:
                arrays["base_t"] = put(bt)
        else:
            arrays["base"] = put(base_f32.to(torch.bfloat16) if dtype == "bf16" else base_f32)
            if metric == "l2":
                arrays["base_norms"] = put(distances.base_norms_sq(base_f32))
        self._arrays = arrays

    # ------------------------------------------------------------------ impl

    def _augment(self, queries: torch.Tensor) -> torch.Tensor:
        """The float kernels' query side: a ones column for L2, then the
        compute dtype."""
        if self.metric == "l2":
            queries = torch.cat([queries, torch.ones((queries.shape[0], 1),
                                                     dtype=queries.dtype,
                                                     device=queries.device)], dim=1)
        return queries.to(torch.bfloat16) if self.dtype == "bf16" else queries

    def _search_pallas(self, queries: torch.Tensor, k: int):
        """Kernel K3: exact, or binned (128 bins) when a rescore follows."""
        a = self._arrays
        nbins = 128 if self.rescore else 0
        if self.dtype == "int8":
            qv, qs = quantize.quantize_int8(queries, per_row=True)
            if self.metric == "l2":
                alpha = 2.0 * qs.reshape(-1) * a["base_scale"]
                # vals already in true 2q·b − ‖b‖² units (f32)
                return fused_topk_matmul(qv, a["base_t"], k, nbins=nbins, alpha=alpha,
                                         bias=a["base_norms"])
            vals_i32, ids = fused_topk_matmul(qv, a["base_t"], k, nbins=nbins)
            return quantize.dequantize(vals_i32, qs, a["base_scale"]), ids
        vals, ids = fused_topk_matmul(self._augment(queries), a["base_t"], k, nbins=nbins)
        return (2.0 * vals if self.metric == "l2" else vals), ids

    def _search_accum(self, queries: torch.Tensor, k: int):
        """Kernel K5.  int8 L2: one global query scale, so the integer bias
        ``round(norms/alpha)`` is row-independent; it grows as the query
        scale shrinks, and the host :meth:`search` refuses scales whose keys
        would overflow int32."""
        a = self._arrays
        tiles = a["base_tiles"]
        g, d = self._acc_group, self._acc_depth
        if k > self._acc_tile_n:
            # tile_n bins hold one candidate each; a deeper pool repeats bins.
            raise ValueError(
                f"engine='accum' supports k (and the 2k rescore pool) up "
                f"to its {self._acc_tile_n} selection bins; got pool {k} — "
                "use engine='pallas' or 'xla' for very deep top-k"
            )
        if self.dtype == "int8":
            if self.metric == "l2":
                qv, qs = quantize.quantize_int8(queries, per_row=False)
                alpha = 2.0 * qs * a["base_scale"]
                bias_rows = bf_accum.l2_bias_rows(a["norms_tiled"], alpha, g)
                vals, ids = bf_accum.fused_topk_accum(qv, tiles, self.n, k, group=g, depth=d,
                                                      bias_rows=bias_rows)
                return vals.to(torch.float32) * alpha, ids
            qv, qs = quantize.quantize_int8(queries, per_row=True)
            vals, ids = bf_accum.fused_topk_accum(qv, tiles, self.n, k, group=g, depth=d)
            return quantize.dequantize(vals, qs, a["base_scale"]), ids
        vals, ids = bf_accum.fused_topk_accum(self._augment(queries), tiles, self.n, k,
                                              group=g, depth=d)
        return (2.0 * vals if self.metric == "l2" else vals), ids

    def _rescore_exact(self, queries: torch.Tensor, cand_ids: torch.Tensor, k: int):
        """Exact fp32 scores of the candidates [B, k'] and the top k of
        them.  Candidate ids are clamped into range for the gather, as a JAX
        gather clamps (only fill entries can be out of range)."""
        a = self._arrays
        safe = cand_ids.long().clamp(0, self.n - 1)
        cand = a["base_f32"][safe]  # [B, k', D]
        scores = torch.bmm(cand, queries.to(torch.float32)[:, :, None])[..., 0]
        if self.metric == "l2":
            scores = 2.0 * scores - a["rescore_norms"][safe]
        vals, sel = topk.topk(scores, k)
        return vals, torch.gather(cand_ids, 1, sel.long())

    def _search_impl(self, queries: torch.Tensor, k: int):
        """queries [B, D] f32 on the device → (scores [B, k] f32, ids [B, k]
        int32)."""
        a = self._arrays
        kq = min(max(self.rescore_depth * k, k + 1), self.n) if self.rescore else k
        if self.engine in ("pallas", "accum"):
            fn = self._search_pallas if self.engine == "pallas" else self._search_accum
            vals, ids = fn(queries, kq)
            if self.rescore:
                vals, ids = self._rescore_exact(queries, ids, k)
            return vals.to(torch.float32), ids.to(torch.int32)
        sel = _SELECT_FNS[self.select]
        if self.dtype == "int8":
            qv, qs = quantize.quantize_int8(queries, per_row=True)
            raw = distances.score_matrix_int8(qv, a["base"])
            if self.metric == "l2":
                alpha = 2.0 * qs.reshape(-1) * a["base_scale"]
                scores = distances.mul_sub(raw.to(torch.float32), alpha[:, None],
                                           a["base_norms"][None, :])
                vals, ids = sel(scores, kq)
            else:
                vals_i32, ids = sel(raw, kq)
                vals = quantize.dequantize(vals_i32, qs, a["base_scale"])
        else:
            scores = distances.score_matrix(
                queries, a["base"], metric=self.metric, base_norms=a.get("base_norms"),
                compute_dtype=torch.bfloat16 if self.dtype == "bf16" else None)
            vals, ids = sel(scores, kq)
        if self.rescore:
            vals, ids = self._rescore_exact(queries, ids, k)
        return vals, ids.to(torch.int32)

    # ------------------------------------------------------------------ API

    def memory_report(self) -> dict[str, int]:
        """Device bytes per index array plus ``"TOTAL"``."""
        from rag_on_edge_tpu_torch.utils.metrics import memory_report

        return memory_report(self._arrays)

    def search_device(self, queries: torch.Tensor, k: int):
        """Search one batch on the index's device → (scores [B, k] f32,
        ids [B, k] int32); inputs and outputs stay on the device."""
        return self._search_impl(queries.to(self.device, torch.float32), k)

    def search_stream_device(self, query_stream: torch.Tensor, k: int):
        """Stream mode: a stack of micro-batches [M, B, D] → (scores
        [M, B, k], ids [M, B, k]), one batch after another as ``lax.map``
        runs them."""
        outs = [self.search_device(q, k) for q in query_stream]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])

    def search(self, queries: np.ndarray, k: int, batch_size: int | None = None):
        """Host API: numpy queries [Q, D] → (ids [Q, k] int32, scores [Q, k]
        f32), in batches of ``batch_size`` (default all), the last one
        zero-padded."""
        queries = np.asarray(queries, dtype=np.float32)
        nq = queries.shape[0]
        if batch_size is not None and batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if nq == 0:
            return (np.empty((0, k), np.int32), np.empty((0, k), np.float32))
        if self.engine == "accum" and self.dtype == "int8" and self.metric == "l2":
            # Packed-key headroom of the int8 L2 accum engine: the bias
            # round(norms/alpha), alpha = 2*sq*sb, explodes when the queries
            # are far smaller than the base.  Checkable here, on the host.
            base_scale = float(self._arrays["base_scale"])
            sq = max(float(np.abs(queries).max()), 1e-12) / 127.0
            alpha = 2.0 * sq * base_scale
            shift = self._acc_group.bit_length() - 1
            max_key = (self.dim * 127 * 127 + self._max_norm / alpha) * (1 << shift)
            if max_key >= 2.0**31:
                raise ValueError(
                    "engine='accum' int8-L2 packed keys would overflow "
                    f"int32 for this query/base scale ratio (max|q|="
                    f"{np.abs(queries).max():.3g} vs base scale "
                    f"{base_scale:.3g}) — use "
                    "engine='pallas' (exact norms-bias kernel) or rescale"
                )
        bs = batch_size or nq
        ids_out = np.empty((nq, k), dtype=np.int32)
        scores_out = np.empty((nq, k), dtype=np.float32)
        for start in range(0, nq, bs):
            chunk = queries[start : start + bs]
            pad = bs - chunk.shape[0]
            if pad:
                chunk = np.pad(chunk, ((0, pad), (0, 0)))
            vals, ids = self.search_device(torch.from_numpy(chunk), k)
            got = bs - pad
            ids_out[start : start + got] = ids.cpu().numpy()[:got]
            scores_out[start : start + got] = vals.cpu().numpy()[:got]
        return ids_out, scores_out

    def compile(self, batch_size: int, k: int) -> None:
        """Warm-up: one search of a zero batch, which builds the kernels."""
        self.search_device(torch.zeros((batch_size, self.dim)), k)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
