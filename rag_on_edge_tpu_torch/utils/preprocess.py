"""Dataset preprocessing for fixed-point GEMM operands
(counterpart: ``rag_on_edge_tpu/utils/preprocess.py``, copied because
importing it would import jax).

The reference's AIE flow row-L2-normalizes SIFT with an 1e-8 guard, scales
it to a fixed-point type and zero-pads the rows to the tile grid.  Here the
operands are int8, scaled so that a unit-norm row spans the int8 range.
"""

from __future__ import annotations

import numpy as np

__all__ = ["l2_normalize", "pad_to_multiple", "prepare_int8_operands"]


def l2_normalize(x: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Row-wise L2 normalization."""
    x = np.asarray(x, dtype=np.float32)
    return x / (np.linalg.norm(x, axis=1, keepdims=True) + eps)


def pad_to_multiple(x: np.ndarray, multiple: int) -> np.ndarray:
    """Zero-pad rows to a multiple; returns x if already aligned."""
    pad = (-x.shape[0]) % multiple
    if not pad:
        return x
    return np.pad(x, ((0, pad), (0, 0)))


def prepare_int8_operands(
    queries: np.ndarray,
    base: np.ndarray,
    query_row_multiple: int = 32,
    base_row_multiple: int = 256,
):
    """Normalize → scale → pad, int8 → (a_int8 [Mpad, D], b_int8 [Npad, D],
    scale) with ``scale = 1/127`` per unit-norm row: inner products of the
    int8 operands are ``(q·b) / scale²`` up to rounding."""
    a = l2_normalize(queries)
    b = l2_normalize(base)
    scale = np.float32(1.0 / 127.0)
    a_i8 = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
    b_i8 = np.clip(np.round(b / scale), -127, 127).astype(np.int8)
    return (
        pad_to_multiple(a_i8, query_row_multiple),
        pad_to_multiple(b_i8, base_row_multiple),
        scale,
    )
