"""k-selection over score matrices (counterpart: ``rag_on_edge_tpu/ops/topk.py``).

Selection is by k max-and-mask passes, the JAX package's algorithm
(``iterative_topk`` and ``pallas_bruteforce._extract_topk``): each pass
takes the row max, the LOWEST position holding it, and masks that position
to the fill value.  ``torch.topk`` does not promise that tie order, and a
stable sort differs once a row holds only fill values: the passes then
return position 0 again and again, where a sort would walk 0, 1, 2, ...
Where the JAX package calls ``lax.top_k`` (``topk``, ``two_stage_topk``,
``approx_topk``, ``merge_topk``) the port takes a stable descending sort,
which is what ``lax.top_k`` returns, fill rows included.
"""

from __future__ import annotations

import torch

__all__ = ["fill_value", "extract_topk", "extract_topk_ids", "binned_top2",
           "iterative_topk", "small_topk", "dedup_rows_by_id", "topk",
           "two_stage_topk", "approx_topk", "merge_topk"]

_BIG_ID = 2**30  # larger than any row id: the "no candidate" id of a min


def fill_value(dtype: torch.dtype):
    """The mask value of a pass: the dtype's minimum for integers, -inf for
    floats."""
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def extract_topk(scores: torch.Tensor, k: int):
    """k max-and-mask passes over ``scores`` [B, W] → (vals [B, k],
    idx [B, k] int32), best first, ties to the lowest position.  The plain
    form of ``pallas_bruteforce._extract_topk`` with column ids
    ``0..W-1``."""
    fill = fill_value(scores.dtype)
    b, w = scores.shape
    col = torch.arange(w, device=scores.device, dtype=torch.int32).expand(b, w)
    big = torch.tensor(2**30, device=scores.device, dtype=torch.int32)
    s = scores.clone()
    vals, ids = [], []
    for _ in range(k):
        m = s.amax(dim=1, keepdim=True)
        idx = torch.where(s == m, col, big).amin(dim=1, keepdim=True)
        vals.append(m)
        ids.append(idx)
        s.scatter_(1, idx.long(), fill)
    return torch.cat(vals, dim=1), torch.cat(ids, dim=1)


def extract_topk_ids(scores: torch.Tensor, col_ids: torch.Tensor, k: int, fill):
    """``pallas_bruteforce._extract_topk``: k max-and-mask passes over the
    last axis of ``scores`` [..., T] with ids ``col_ids`` [..., T] →
    (vals [..., k], ids [..., k]).  Each pass takes the max, the LOWEST id
    holding it, and masks every position with that id to ``fill``.  Ids
    must be unique where a value is above ``fill``; once only fill values
    are left, the passes return the lowest remaining id again and again."""
    big = torch.tensor(_BIG_ID, dtype=col_ids.dtype, device=col_ids.device)
    s = scores
    vals, ids = [], []
    for _ in range(k):
        m = s.amax(dim=-1, keepdim=True)
        idx = torch.where(s == m, col_ids, big).amin(dim=-1, keepdim=True)
        vals.append(m)
        ids.append(idx)
        s = torch.where(col_ids == idx, torch.full_like(s, fill), s)
    return torch.cat(vals, dim=-1), torch.cat(ids, dim=-1)


def binned_top2(sc: torch.Tensor, row0, tile_w: int, nbins: int, fill, depth: int = 2):
    """``pallas_bruteforce.binned_top2``: the top-``depth`` of every strided
    bin ``col % nbins`` of ``sc[..., :tile_w]`` → (vals [..., depth·nbins],
    ids [..., depth·nbins] int32), pass-major (all bins' best, then all
    bins' second, ...).  A column's id is ``row0 + col``; ``row0`` is an
    int or an int32 tensor that broadcasts against ``sc.shape[:-1]``.  Ties
    go to the lowest id, and each later pass masks the winner by id."""
    lead = sc.shape[:-1]
    w = tile_w // nbins
    s = sc[..., :tile_w].reshape(*lead, w, nbins)
    r0 = torch.as_tensor(row0, dtype=torch.int32, device=sc.device)
    rc = torch.arange(tile_w, dtype=torch.int32, device=sc.device).reshape(w, nbins)
    rc = rc + r0[..., None, None]
    big = torch.tensor(_BIG_ID, dtype=torch.int32, device=sc.device)
    vals, ids = [], []
    for _ in range(depth):
        bmax = s.amax(dim=-2)
        bid = torch.where(s == bmax[..., None, :], rc, big).amin(dim=-2)
        vals.append(bmax)
        ids.append(bid)
        s = torch.where(rc == bid[..., None, :], torch.full_like(s, fill), s)
    return torch.cat(vals, dim=-1), torch.cat(ids, dim=-1)


def iterative_topk(scores: torch.Tensor, k: int):
    """Exact top-k by k max-and-mask passes (``topk.iterative_topk``);
    k > W pads with the fill value and position 0."""
    w = scores.shape[-1]
    vals, ids = extract_topk(scores, min(k, w))
    if k > w:
        pad = k - w
        vals = torch.cat([vals, vals.new_full((vals.shape[0], pad),
                                              fill_value(scores.dtype))], dim=1)
        ids = torch.cat([ids, ids.new_zeros((ids.shape[0], pad))], dim=1)
    return vals, ids


def small_topk(scores: torch.Tensor, k: int):
    """``topk.small_topk``: the passes for k <= 32, else a stable
    descending sort (``lax.top_k`` breaks ties to the lowest index too)."""
    if k <= 32:
        return iterative_topk(scores, k)
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)


def topk(scores: torch.Tensor, k: int, ids: torch.Tensor | None = None):
    """Exact top-k along the last axis (``topk.topk``, i.e. ``lax.top_k``)
    → (vals, idx int32), best first, ties to the lowest index: a stable
    descending sort.  ``idx`` is mapped through ``ids`` if given (the same
    shape as ``scores``, or 1-D of length N)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    if ids is not None:
        return vals, ids[idx] if ids.dim() == 1 else torch.gather(ids, -1, idx)
    return vals, idx.to(torch.int32)


def two_stage_topk(scores: torch.Tensor, k: int, block: int = 4096):
    """Exact top-k by per-block top-k then a top-k of the block winners
    (``topk.two_stage_topk``); the global top-k lies in the union of the
    blocks' top-k sets, and both stages keep ties to the lowest index."""
    *lead, n = scores.shape
    if n <= max(block, 2 * k):
        return topk(scores, k)
    pad = (-n) % block
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=fill_value(scores.dtype))
    nb = (n + pad) // block
    kb = min(k, block)
    b_vals, b_idx = topk(scores.reshape(*lead, nb, block), kb)
    offs = (torch.arange(nb, dtype=torch.int32, device=scores.device) * block)[:, None]
    b_gids = (b_idx + offs).reshape(*lead, nb * kb)
    vals, sel = topk(b_vals.reshape(*lead, nb * kb), k)
    return vals, torch.gather(b_gids, -1, sel.long())


def approx_topk(scores: torch.Tensor, k: int, recall_target: float = 0.95):
    """``topk.approx_topk`` (``lax.approx_max_k``), integer scores cast to
    fp32 first (exact below 2**24).  On the CPU, where the JAX package's
    tests run, ``approx_max_k`` returns exactly what ``lax.top_k`` returns,
    ties included, so this is the exact selection with ties to the lowest
    index; ``recall_target`` is accepted and has no effect."""
    if not scores.dtype.is_floating_point:
        scores = scores.to(torch.float32)
    return topk(scores, k)


def merge_topk(vals_a: torch.Tensor, ids_a: torch.Tensor, vals_b: torch.Tensor,
               ids_b: torch.Tensor, k: int | None = None):
    """The best k (default: as many as ``vals_a`` holds) of the union of two
    per-row top-k sets (``topk.merge_topk``); ties go to the earlier
    position, ``a`` before ``b``."""
    k = k or vals_a.shape[-1]
    out_vals, sel = topk(torch.cat([vals_a, vals_b], dim=-1), k)
    return out_vals, torch.gather(torch.cat([ids_a, ids_b], dim=-1), -1, sel.long())


def dedup_rows_by_id(vals: torch.Tensor, ids: torch.Tensor,
                     payload: torch.Tensor | None = None,
                     sentinel_base: int = 1 << 30):
    """Keep only the best-scoring copy of each id per row
    (``topk.dedup_rows_by_id``): rows are sorted by (id asc, val desc) and
    every later copy of an id is masked to -inf.  Invalid slots (-inf) get
    unique sentinel ids past ``sentinel_base``.  Returns id-sorted
    ``(vals, ids[, payload])``; float scores only."""
    if not vals.dtype.is_floating_point:
        raise TypeError(
            f"dedup_rows_by_id needs float scores (-inf invalid-sentinel "
            f"semantics); got {vals.dtype}")
    b, m = vals.shape
    valid = vals > float("-inf")
    key = torch.where(
        valid, ids.to(torch.int32),
        sentinel_base + torch.arange(m, device=vals.device, dtype=torch.int32))
    # Two stable sorts give the lexicographic (key asc, val desc) order.
    o1 = torch.sort(vals, dim=1, descending=True, stable=True).indices
    k1 = torch.gather(key, 1, o1)
    o2 = torch.sort(k1, dim=1, stable=True).indices
    order = torch.gather(o1, 1, o2)
    key_s = torch.gather(key, 1, order)
    vals_s = torch.gather(vals, 1, order)
    ids_s = torch.gather(ids, 1, order)
    dup = torch.cat([torch.zeros((b, 1), dtype=torch.bool, device=vals.device),
                     key_s[:, 1:] == key_s[:, :-1]], dim=1)
    vals_s = torch.where(dup, torch.full_like(vals_s, float("-inf")), vals_s)
    if payload is None:
        return vals_s, ids_s
    return vals_s, ids_s, torch.gather(payload, 1, order)
