"""k-means (Lloyd's algorithm) for the IVF coarse quantizer
(counterpart: ``rag_on_edge_tpu/models/kmeans.py``).

The assignment step is an fp32 GEMM (TF32 off) with argmin ties to the
lowest centroid; the update step sums each cluster as the JAX package does,
by a one-hot GEMM over chunks of 8192 rows, so a run is bit-reproducible on
one device (``index_add_`` on CUDA adds with float atomics, in no fixed
order), which the checkpoint's exact replay needs.  ``init="kmeans++"``
D²-samples by Gumbel-max from a seeded ``torch.Generator``, so its
centroids differ from the JAX package's (which draws from ``jax.random``).
``init="sample"`` takes its init rows from numpy exactly as the JAX
package does, so the two can be held together.  ``checkpoint=`` writes and
reads the JAX package's file: an ``.npz`` of ``centroids``,
``prev_centroids``, ``next_iter``, ``seed`` and ``done``.
"""

from __future__ import annotations

import os

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
    Each cluster's sum is a one-hot [nlist, uc] x [uc, D] GEMM over chunks
    of uc rows, added chunk by chunk: a fixed order of additions, so two runs
    on one device give the same bits.  Empty clusters keep their centroid."""
    assign = assign_clusters(x, centroids, chunk=chunk)
    nlist, d = centroids.shape
    uc = min(8192, x.shape[0])
    ids = torch.arange(nlist, dtype=torch.int32, device=x.device)[:, None]
    sums = torch.zeros((nlist, d), dtype=torch.float32, device=x.device)
    for lo in range(0, x.shape[0], uc):
        onehot = (assign[None, lo:lo + uc] == ids).to(torch.float32)
        sums += onehot @ x[lo:lo + uc]
    counts = torch.bincount(assign.long(), minlength=nlist).to(torch.float32)
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
    squared centroid shift falls below ``tol``.

    ``checkpoint``: a path; the centroids are saved after every step
    (atomically, through a ``.tmp`` file) and a run resumes from the file
    where it exists, holds this shape and seed, and the five keys.  A run
    resumed on the same device replays the uninterrupted run's centroids
    bit for bit; a file marked ``done`` (converged within ``tol``) stops
    iteration, and one resumed past its last step replays that step from
    the stored previous centroids, so (centroids, assignment) equal the
    uninterrupted run's.  The caller owns invalidation: the path should
    name the build (nlist, seed, data), as ``build_or_load_index`` does."""
    x = torch.as_tensor(np.asarray(x, dtype=np.float32)).to(device)
    n = x.shape[0]
    if nlist > n:
        raise ValueError(f"nlist={nlist} > n_vectors={n}")
    if init not in ("kmeans++", "sample"):
        raise ValueError(f"unknown init {init!r} ('kmeans++' | 'sample')")
    it0 = 0
    centroids = prev_centroids = None
    done = False
    if checkpoint is not None and os.path.exists(checkpoint):
        ck = np.load(checkpoint)
        if ({"centroids", "prev_centroids", "next_iter", "seed", "done"} <= set(ck.files)
                and ck["centroids"].shape == (nlist, x.shape[1])
                and int(ck["seed"]) == seed):
            centroids = torch.from_numpy(np.asarray(ck["centroids"], np.float32)).to(x.device)
            prev_centroids = torch.from_numpy(
                np.asarray(ck["prev_centroids"], np.float32)).to(x.device)
            it0 = int(ck["next_iter"])
            done = bool(ck["done"])
    if centroids is None:
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
    if done:
        it0 = max_iter  # the checkpointed run converged: no further step
    for it in range(it0, max_iter):
        prev_centroids = centroids
        centroids, assign, shift = _lloyd_step(x, centroids, chunk)
        converged = float(shift) < tol
        if checkpoint is not None:
            _save_checkpoint(checkpoint, centroids.cpu().numpy(), it + 1, seed,
                             prev_centroids.cpu().numpy(), converged)
        if converged:
            break
    if assign is None and prev_centroids is None:  # max_iter 0: no step
        assign = assign_clusters(x, centroids, chunk=chunk)
    elif assign is None:
        # Resumed past the last step: replay it from the previous centroids,
        # so (centroids, assignment) come out as the uninterrupted run's.
        centroids, assign, _ = _lloyd_step(x, prev_centroids, chunk)
    return centroids.cpu().numpy(), assign.cpu().numpy()


def _save_checkpoint(path: str, centroids: np.ndarray, next_iter: int, seed: int,
                     prev_centroids: np.ndarray, done: bool) -> None:
    """Write the loop state as the JAX package does: ``prev_centroids`` lets
    a resume replay the last step, ``done`` marks a converged run."""
    tmp = f"{path}.tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:  # a handle, so savez appends no .npz
        np.savez(f, centroids=centroids, next_iter=next_iter, seed=seed,
                 prev_centroids=prev_centroids, done=done)
    os.replace(tmp, path)


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
