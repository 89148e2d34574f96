"""Benchmark metrics: recall, latency statistics, operational intensity,
index memory, and the reports the harnesses write (counterpart:
``rag_on_edge_tpu/utils/metrics.py``).

Everything but ``memory_report`` is a copy of the numpy original: importing
it from the JAX package would pull in jax through that package's
``__init__``.  The reports keep the JAX package's schemas:

- ``results.txt``: per-query top-k rows ``Query i: (idx, score) ...``;
- ``metrics.txt``: ``=== Section ===`` blocks of lines;
- sweep CSVs: ``dataset,batch,qps,gflops,avg_ms,p95_ms,p99_ms`` (brute
  force) and
  ``dataset,nprobe,top_k,recall,qps,avg_ms,p50_ms,p95_ms,p99_ms,avg_candidates,reduction``
  (IVF).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["recall_at_k", "LatencyStats", "PhaseTiming", "write_results_txt",
           "write_metrics_txt", "append_sweep_csv", "operational_intensity", "memory_report"]


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


@dataclass
class LatencyStats:
    """mean/std/min/max/P50/P95/P99 over a list of per-event latencies (ms)."""

    mean: float
    std: float
    min: float
    max: float
    p50: float
    p95: float
    p99: float
    count: int

    @classmethod
    def from_samples(cls, samples_ms) -> "LatencyStats":
        s = np.asarray(samples_ms, dtype=np.float64)
        if s.size == 0:
            return cls(0, 0, 0, 0, 0, 0, 0, 0)
        return cls(
            mean=float(s.mean()),
            std=float(s.std()),
            min=float(s.min()),
            max=float(s.max()),
            p50=float(np.percentile(s, 50)),
            p95=float(np.percentile(s, 95)),
            p99=float(np.percentile(s, 99)),
            count=int(s.size),
        )

    def lines(self, label: str) -> list[str]:
        return [
            f"{label} latency (ms): mean={self.mean:.4f} std={self.std:.4f} "
            f"min={self.min:.4f} max={self.max:.4f}",
            f"{label} percentiles (ms): P50={self.p50:.4f} P95={self.p95:.4f} "
            f"P99={self.p99:.4f} (n={self.count})",
        ]


@dataclass
class PhaseTiming:
    """Per-phase wall-clock accumulation (phase → total seconds)."""

    phases: dict[str, float] = field(default_factory=dict)

    def add(self, phase: str, seconds: float) -> None:
        self.phases[phase] = self.phases.get(phase, 0.0) + seconds

    @property
    def total(self) -> float:
        return sum(self.phases.values())

    def breakdown_lines(self) -> list[str]:
        total = self.total or 1.0
        return [
            f"  {name}: {secs * 1e3:.3f} ms ({100.0 * secs / total:.1f}%)"
            for name, secs in self.phases.items()
        ]


def operational_intensity(batch: int, dim: int, n_docs: int,
                          dtype_bytes: int = 1) -> dict[str, float]:
    """FLOPs/byte of the batched score GEMM [B,D]x[D,N], the doc matrix read
    once per batch (so the intensity grows with the batch)."""
    flops = 2.0 * batch * dim * n_docs
    bytes_moved = dtype_bytes * (batch * dim + dim * n_docs + batch * n_docs)
    return {"flops": flops, "bytes": float(bytes_moved), "oi": flops / bytes_moved}


def write_results_txt(path: str, ids: np.ndarray, scores: np.ndarray) -> None:
    """Per-query top-k rows, ``Query i: (idx, score) ...``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i, (row_ids, row_scores) in enumerate(zip(ids, scores)):
            pairs = " ".join(f"({int(j)}, {float(s):.4f})" for j, s in zip(row_ids, row_scores))
            f.write(f"Query {i}: {pairs}\n")


def write_metrics_txt(path: str, sections: dict[str, list[str]]) -> None:
    """Sectioned metrics report: ``=== title ===``, its lines, a blank line."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for title, lines in sections.items():
            f.write(f"=== {title} ===\n")
            for line in lines:
                f.write(line + "\n")
            f.write("\n")


def append_sweep_csv(path: str, header: str, row: str) -> None:
    """Append one sweep point, writing the header if the file is new."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    new = not os.path.exists(path)
    with open(path, "a") as f:
        if new:
            f.write(header.rstrip("\n") + "\n")
        f.write(row.rstrip("\n") + "\n")


def memory_report(arrays: dict[str, torch.Tensor]) -> dict[str, int]:
    """Bytes per named index array plus a ``"TOTAL"`` entry."""
    sizes = {name: a.numel() * a.element_size() for name, a in arrays.items()}
    sizes["TOTAL"] = sum(sizes.values())
    return sizes
