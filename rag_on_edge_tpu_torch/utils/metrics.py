"""Recall and index memory (counterpart: ``rag_on_edge_tpu/utils/metrics.py``).

``recall_at_k`` is a copy of the numpy original: importing it from the JAX
package would pull in jax through that package's ``__init__``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["recall_at_k", "memory_report"]


def recall_at_k(predicted: np.ndarray, ground_truth: np.ndarray, k: int) -> float:
    """Set-overlap recall@k: |pred[:k] ∩ gt[:k]| / k, averaged over queries."""
    pred = np.asarray(predicted)
    gt = np.asarray(ground_truth)
    if gt.shape[1] < k or pred.shape[1] < k:
        raise ValueError(
            f"recall@{k} needs >= {k} columns; got predicted "
            f"{pred.shape} vs ground truth {gt.shape} — recompute the "
            f"ground truth at depth >= {k}"
        )
    if gt.shape[0] != pred.shape[0]:
        raise ValueError(
            f"row mismatch: {pred.shape[0]} predictions vs "
            f"{gt.shape[0]} ground-truth rows"
        )
    pred, gt = pred[:, :k], gt[:, :k]
    hits = 0
    for p_row, g_row in zip(pred, gt):
        hits += len(np.intersect1d(p_row, g_row, assume_unique=False))
    return hits / (pred.shape[0] * k)


def memory_report(arrays: dict[str, torch.Tensor]) -> dict[str, int]:
    """Bytes per named index array plus a ``"TOTAL"`` entry."""
    sizes = {name: a.numel() * a.element_size() for name, a in arrays.items()}
    sizes["TOTAL"] = sum(sizes.values())
    return sizes
