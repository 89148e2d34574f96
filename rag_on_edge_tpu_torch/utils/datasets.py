"""Synthetic SIFT corpora, their on-disk cache, and exact ground truth
(counterpart: ``rag_on_edge_tpu/utils/datasets.py``).

``make_synthetic`` is a byte-for-byte copy of the JAX package's generator
(seeded numpy), so both packages search the same corpus without a
download.  ``ground_truth`` is the brute-force reference in torch: fp32
GEMMs (TF32 is off, see the package ``__init__``) and ties broken by the
lower id, as the JAX package's ``ground_truth`` does.  Once a chunk's
[query_chunk, N] score matrix would pass 2 GiB it takes kernel K3 in its
exact fp32 mode instead (``_ground_truth_fused``), the JAX package's rule.

:func:`load_dataset` reads and writes the JAX package's cache: the same
root (``RAG_EDGE_TPU_DATA``, else ``data/`` at the repository root), the
same file names and formats (``utils/io.py``) and the same synthesis
manifest, so both packages share ``data/<name>``.  Ground truth it has to
compute goes through :func:`ground_truth` on ``device``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from rag_on_edge_tpu_torch.ops import topk
from rag_on_edge_tpu_torch.ops.bruteforce_fused import fused_topk_matmul
from rag_on_edge_tpu_torch.utils import io

__all__ = ["Dataset", "DATASET_SPECS", "DEFAULT_DATA_ROOT", "load_dataset", "make_synthetic",
           "ground_truth"]

DEFAULT_DATA_ROOT = os.environ.get(
    "RAG_EDGE_TPU_DATA", os.path.join(os.path.dirname(__file__), "..", "..", "data")
)

# name -> (n_base, n_queries, dim, n_clusters_for_synthesis)
DATASET_SPECS: dict[str, tuple[int, int, int, int]] = {
    "siftsmall": (10_000, 100, 128, 64),
    "sift": (1_000_000, 10_000, 128, 4096),
    "sift10m": (10_000_000, 10_000, 128, 16384),
    "unit": (2_048, 32, 128, 16),
}


@dataclass
class Dataset:
    name: str
    base: np.ndarray  # [N, dim] float32
    queries: np.ndarray  # [Q, dim] float32
    ground_truth_ip: np.ndarray | None = None  # [Q, K] int32, inner-product ranking
    ground_truth_l2: np.ndarray | None = None  # [Q, K] int32, L2 ranking
    gt_k: int = 100
    meta: dict = field(default_factory=dict)

    @property
    def dim(self) -> int:
        return int(self.base.shape[1])

    def gt(self, metric: str) -> np.ndarray | None:
        return self.ground_truth_l2 if metric == "l2" else self.ground_truth_ip


def make_synthetic(
    n_base: int,
    n_queries: int,
    dim: int = 128,
    n_clusters: int = 64,
    seed: int = 42,
) -> tuple[np.ndarray, np.ndarray]:
    """SIFT-like base and query vectors: cluster centers uniform in
    [10, 110], Gaussian noise (σ=18) clipped to [0, 141] and rounded;
    queries are base points plus noise (σ=10)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(10.0, 110.0, size=(n_clusters, dim))
    assign = rng.integers(0, n_clusters, size=n_base)
    base = centers[assign] + rng.normal(0.0, 18.0, size=(n_base, dim))
    base = np.clip(np.round(base), 0.0, 141.0).astype(np.float32)

    q_src = rng.integers(0, n_base, size=n_queries)
    queries = base[q_src] + rng.normal(0.0, 10.0, size=(n_queries, dim))
    queries = np.clip(np.round(queries), 0.0, 141.0).astype(np.float32)
    return base, queries


def ground_truth(
    base: np.ndarray | torch.Tensor,
    queries: np.ndarray | torch.Tensor,
    k: int,
    metric: str = "ip",
    chunk: int = 262_144,
    query_chunk: int = 1_024,
    backend: str = "auto",
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Exact top-k neighbour ids [Q, k] int32, best first, ties to the
    lower id, with the JAX package's positions (``device`` last).
    ``metric="ip"`` ranks by descending inner product, ``metric="l2"`` by
    ascending squared distance (scored as ``2·q·b − ‖b‖²``; the row-constant
    ‖q‖² is dropped).  The base stays on ``device``; queries go through in
    chunks of ``query_chunk`` rows, each scored against ``chunk`` base
    columns at a time with a top-k merge across them.

    ``backend``: ``"numpy"`` always takes that chunked path; ``"auto"``
    takes kernel K3 instead once a chunk's [query_chunk, N] score matrix
    would pass 2 GiB (``N·query_chunk·4 > 2 << 30``), the JAX package's
    rule.  The port has no JAX backend, so ``"jax"`` raises."""
    if metric not in ("ip", "l2"):
        raise ValueError(f"unknown metric {metric!r}")
    if backend == "jax":
        raise ValueError("backend='jax': the PyTorch port has no JAX backend; "
                         "use 'auto' or 'numpy'")
    if backend not in ("auto", "numpy"):
        raise ValueError(f"unknown backend {backend!r} ('auto' | 'numpy')")
    if backend == "auto" and base.shape[0] * query_chunk * 4 > (2 << 30):
        return _ground_truth_fused(np.asarray(base), np.asarray(queries), k, metric,
                                   query_chunk, device)
    b = torch.as_tensor(base, dtype=torch.float32).to(device)
    q_all = torch.as_tensor(queries, dtype=torch.float32)
    n = b.shape[0]
    k = min(k, n)
    norms = (b * b).sum(dim=1) if metric == "l2" else None
    out = np.empty((q_all.shape[0], k), dtype=np.int32)
    for s in range(0, q_all.shape[0], query_chunk):
        q = q_all[s:s + query_chunk].to(device)
        best_v = best_i = None
        for c0 in range(0, n, chunk):
            scores = q @ b[c0:c0 + chunk].T
            if metric == "l2":
                scores = 2.0 * scores - norms[None, c0:c0 + chunk]
            vals, ids = topk.iterative_topk(scores, min(k, scores.shape[1]))
            ids = ids + c0
            if best_v is None:
                best_v, best_i = vals, ids
            else:
                # Earlier chunks hold lower ids and come first: ties stay low.
                best_v, best_i = topk.merge_topk(best_v, best_i, vals, ids, k)
        out[s:s + q.shape[0]] = best_i.cpu().numpy()
    return out


def _ground_truth_fused(base: np.ndarray, queries: np.ndarray, k: int, metric: str,
                        query_chunk: int, device: str | torch.device = "cuda") -> np.ndarray:
    """Exact ground truth through kernel K3 (``fused_topk_matmul``) in fp32
    exact mode, ties to the lowest id; the [B, N] score matrix never
    exists.  L2 ranks by augmentation: q' = [q, 1], b' = [b, -‖b‖²/2], so
    q'·b' is a monotone per-row map of the L2 score (on integer-valued data
    every such score is exact in fp32)."""
    bt = np.ascontiguousarray(base.astype(np.float32).T)  # [D, N]
    if metric == "l2":
        bt = np.concatenate(
            [bt, -0.5 * np.sum(base.astype(np.float32) ** 2, axis=1)[None, :]], axis=0)
    bt_dev = torch.from_numpy(bt).to(device)
    del bt
    out = np.empty((len(queries), k), dtype=np.int32)
    for qs in range(0, len(queries), query_chunk):
        q = queries[qs : qs + query_chunk].astype(np.float32)
        if metric == "l2":
            q = np.concatenate([q, np.ones((len(q), 1), np.float32)], axis=1)
        _, ids = fused_topk_matmul(torch.from_numpy(q).to(device), bt_dev, k)
        out[qs : qs + len(q)] = ids.cpu().numpy()[: len(q)]
    return out


def _paths(root: str, name: str) -> dict[str, str]:
    d = os.path.join(root, name)
    return {
        "dir": d,
        "base": os.path.join(d, f"{name}_base.fvecs"),
        "query": os.path.join(d, f"{name}_query.fvecs"),
        "gt_ip": os.path.join(d, f"{name}_groundtruth_ip.ivecs"),
        "gt_l2": os.path.join(d, f"{name}_groundtruth_l2.ivecs"),
        # Standard TEXMEX name (L2 ranking), used if a real dataset is dropped in.
        "gt_texmex": os.path.join(d, f"{name}_groundtruth.ivecs"),
    }


def load_dataset(
    name: str,
    root: str | None = None,
    gt_k: int = 100,
    compute_gt: bool = True,
    device: str | torch.device = "cuda",
) -> Dataset:
    """Load a dataset by name, synthesizing and caching it as fvecs/ivecs
    if absent; missing or too-narrow ground truth is computed on ``device``
    and cached."""
    if name not in DATASET_SPECS:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(DATASET_SPECS)}")
    root = root or DEFAULT_DATA_ROOT
    n_base, n_queries, dim, n_clusters = DATASET_SPECS[name]
    p = _paths(root, name)

    synth_marker = os.path.join(p["dir"], f"{name}_synth.json")
    if not (os.path.exists(p["base"]) and os.path.exists(p["query"])):
        os.makedirs(p["dir"], exist_ok=True)
        base, queries = make_synthetic(n_base, n_queries, dim, n_clusters)
        io.write_fvecs(p["base"], base)
        io.write_fvecs(p["query"], queries)
        with open(synth_marker, "w") as f:
            json.dump({"n_base": n_base, "n_queries": n_queries,
                       "dim": dim, "synthetic": True}, f)
    else:
        base = io.read_fvecs(p["base"])
        queries = io.read_fvecs(p["query"])
        # Files synthesized here (the manifest is present) are checked
        # against it: a write cut short can leave a truncated file that
        # still parses on a record boundary.  Files without it are real
        # datasets dropped in: any self-consistent shape is accepted.
        if os.path.exists(synth_marker):
            with open(synth_marker) as f:
                expect = json.load(f)
            if (base.shape != (expect["n_base"], expect["dim"])
                    or queries.shape != (expect["n_queries"], expect["dim"])):
                raise ValueError(
                    f"cached synthetic {name} files do not match their "
                    f"manifest (base {base.shape} vs "
                    f"({expect['n_base']}, {expect['dim']}), queries "
                    f"{queries.shape}) — a truncated write; delete "
                    f"{p['dir']} to re-synthesize"
                )
        elif base.shape[1] != queries.shape[1]:
            raise ValueError(
                f"{name}: base dim {base.shape[1]} != query dim "
                f"{queries.shape[1]}"
            )

    gt_ip = gt_l2 = None
    if compute_gt:
        if os.path.exists(p["gt_ip"]):
            gt_ip = io.read_ivecs(p["gt_ip"])
            if gt_ip.shape[1] < gt_k:
                gt_ip = None  # a narrower cache: recompute at the asked depth
        if os.path.exists(p["gt_l2"]):
            gt_l2 = io.read_ivecs(p["gt_l2"])
            if gt_l2.shape[1] < gt_k:
                gt_l2 = None
        elif os.path.exists(p["gt_texmex"]):
            # A real TEXMEX ground truth (L2) holds even when narrower than
            # gt_k; gt_k is clamped to it below.
            gt_l2 = io.read_ivecs(p["gt_texmex"])
        if gt_ip is None:
            gt_ip = ground_truth(base, queries, gt_k, metric="ip", device=device)
            io.write_ivecs(p["gt_ip"], gt_ip)
        if gt_l2 is None:
            gt_l2 = ground_truth(base, queries, gt_k, metric="l2", device=device)
            io.write_ivecs(p["gt_l2"], gt_l2)
        gt_k = min(gt_k, gt_ip.shape[1], gt_l2.shape[1])

    return Dataset(
        name=name,
        base=base,
        queries=queries,
        ground_truth_ip=gt_ip,
        ground_truth_l2=gt_l2,
        gt_k=gt_k,
        meta={"n_base": n_base, "n_queries": n_queries, "dim": dim},
    )
