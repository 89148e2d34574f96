"""k-means (Lloyd's algorithm) for the IVF coarse quantizer
(counterpart: ``rag_on_edge_tpu/models/kmeans.py``).

The assignment step is an fp32 GEMM (TF32 off) with argmin ties to the
lowest centroid; the update step sums each cluster with ``index_add_``.
``init="kmeans++"`` D²-samples by Gumbel-max from a seeded
``torch.Generator``, so its centroids differ from the JAX package's (which
draws from ``jax.random``).  ``init="sample"`` takes its init rows from
numpy exactly as the JAX package does, so the two can be held together.
"""

from __future__ import annotations

import numpy as np
import torch

from rag_on_edge_tpu_torch.ops import topk

__all__ = ["kmeans", "assign_clusters", "assign_top2", "default_nlist"]


def default_nlist(n_vectors: int, requested: int | None = None) -> int:
    """Cap nlist at n/10, falling back to max(16, n/100)."""
    if requested is not None and requested <= n_vectors // 10:
        return requested
    if requested is not None:
        return max(16, n_vectors // 100)
    return max(16, min(1024, n_vectors // 100))


def assign_clusters(x: torch.Tensor, centroids: torch.Tensor,
                    chunk: int = 131_072) -> torch.Tensor:
    """Nearest-centroid (squared-L2) assignment, chunked over rows → [N]
    int32; ties go to the lowest centroid index."""
    c_norms = (centroids * centroids).sum(dim=1)
    out = []
    for lo in range(0, x.shape[0], chunk):
        dots = x[lo:lo + chunk] @ centroids.T
        out.append(torch.argmin(c_norms[None, :] - 2.0 * dots, dim=1).to(torch.int32))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int32, device=x.device)


def _lloyd_step(x: torch.Tensor, centroids: torch.Tensor, chunk: int):
    """One assign-then-update step → (new centroids, assignment, max shift²).
    Empty clusters keep their centroid."""
    assign = assign_clusters(x, centroids, chunk=chunk)
    nlist, d = centroids.shape
    sums = torch.zeros((nlist, d), dtype=torch.float32, device=x.device)
    sums.index_add_(0, assign.long(), x)
    counts = torch.zeros(nlist, dtype=torch.float32, device=x.device)
    counts.index_add_(0, assign.long(), torch.ones_like(assign, dtype=torch.float32))
    new = torch.where(counts[:, None] > 0,
                      sums / torch.clamp_min(counts[:, None], 1.0), centroids)
    shift = ((new - centroids) ** 2).sum(dim=1).max()
    return new, assign, shift


def _kmeanspp_select(xs: torch.Tensor, first_idx: int, gen: torch.Generator,
                     nlist: int) -> torch.Tensor:
    """D²-sampling over ``xs`` [ns, D]: each round draws the next centroid
    with probability proportional to the squared distance to the nearest
    chosen one, as a Gumbel-max over log(min_d)."""
    ns, d = xs.shape
    x_norms = (xs * xs).sum(dim=1)
    cents = torch.zeros((nlist, d), dtype=torch.float32, device=xs.device)
    c = xs[first_idx]
    cents[0] = c
    min_d = torch.clamp_min(x_norms - 2.0 * (xs @ c) + (c * c).sum(), 0.0)
    for i in range(1, nlist):
        u = torch.rand(ns, generator=gen, device=xs.device).clamp_(1e-20, 1.0 - 1e-7)
        g = -torch.log(-torch.log(u))
        idx = torch.argmax(torch.log(torch.clamp_min(min_d, 1e-30)) + g)
        c = xs[idx]
        cents[i] = c
        dist = torch.clamp_min(x_norms - 2.0 * (xs @ c) + (c * c).sum(), 0.0)
        min_d = torch.minimum(min_d, dist)
    return cents


def kmeans(x: np.ndarray | torch.Tensor, nlist: int, seed: int = 42,
           max_iter: int = 100, tol: float = 1e-4, chunk: int = 131_072,
           init: str = "kmeans++", init_sample: int = 262_144,
           checkpoint: str | None = None,
           device: str | torch.device = "cuda") -> tuple[np.ndarray, np.ndarray]:
    """Train k-means on ``device`` → (centroids [nlist, D] f32, assignment
    [N] i32) as numpy.  The assignment is against the centroids before the
    last update, as in the JAX package.  Stops early once the largest
    squared centroid shift falls below ``tol``.  ``checkpoint`` sits where
    the JAX package takes it; resuming from one is not ported yet."""
    if checkpoint is not None:
        raise NotImplementedError(
            "kmeans(checkpoint=) resume is not ported yet — ROADMAP Queue 1 item 6")
    x = torch.as_tensor(np.asarray(x, dtype=np.float32)).to(device)
    n = x.shape[0]
    if nlist > n:
        raise ValueError(f"nlist={nlist} > n_vectors={n}")
    if init not in ("kmeans++", "sample"):
        raise ValueError(f"unknown init {init!r} ('kmeans++' | 'sample')")
    rng = np.random.default_rng(seed)
    if init == "kmeans++":
        ns = min(n, max(init_sample, 2 * nlist))
        if ns < n:
            idx = np.sort(rng.choice(n, size=ns, replace=False))
            xs = x[torch.as_tensor(idx, device=x.device)]
        else:
            xs = x
        gen = torch.Generator(device=x.device).manual_seed(seed)
        centroids = _kmeanspp_select(xs, int(rng.integers(ns)), gen, nlist)
    else:
        init_idx = rng.choice(n, size=nlist, replace=False)
        centroids = x[torch.as_tensor(np.sort(init_idx), device=x.device)]
    assign = None
    for _ in range(max_iter):
        centroids, assign, shift = _lloyd_step(x, centroids, chunk)
        if float(shift) < tol:
            break
    if assign is None:
        assign = assign_clusters(x, centroids, chunk=chunk)
    return centroids.cpu().numpy(), assign.cpu().numpy()


def assign_top2(x: np.ndarray | torch.Tensor, centroids: np.ndarray | torch.Tensor,
                chunk: int | None = None, device: str | torch.device = "cuda"):
    """Nearest-2 centroids under squared L2 → (a1, a2 [N] i32, d1, d2 [N]
    f32 squared distances) as numpy; ties to the lower centroid index."""
    x = torch.as_tensor(np.asarray(x, dtype=np.float32)).to(device)
    cents = torch.as_tensor(np.asarray(centroids, dtype=np.float32)).to(device)
    if chunk is None:
        chunk = min(131_072, max(16_384, (1 << 28) // max(1, cents.shape[0])))
    cn = (cents * cents).sum(dim=1)
    outs = [[], [], [], []]
    for lo in range(0, x.shape[0], chunk):
        xc = x[lo:lo + chunk]
        d = (xc * xc).sum(dim=1, keepdim=True) - 2.0 * (xc @ cents.T) + cn[None, :]
        negd, idx = topk.iterative_topk(-d, 2)
        parts = (idx[:, 0], idx[:, 1], torch.clamp_min(-negd[:, 0], 0.0),
                 torch.clamp_min(-negd[:, 1], 0.0))
        for acc, p in zip(outs, parts):
            acc.append(p.cpu().numpy())
    a1, a2, d1, d2 = (np.concatenate(o) for o in outs)
    return a1.astype(np.int32), a2.astype(np.int32), d1, d2
