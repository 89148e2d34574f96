"""Vector-dataset file formats: .fvecs / .ivecs / .bvecs
(counterpart: ``rag_on_edge_tpu/utils/io.py``, copied because importing it
would import jax).

The TEXMEX ``.fvecs``/``.ivecs`` format stores, per vector, a little-endian
``int32`` dimension header followed by ``dim`` payload values (float32 or
int32); ``.bvecs`` the same header and ``dim`` uint8 values.  Both packages
read and write the same files, so they share one ``data/`` cache.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["read_fvecs", "write_fvecs", "read_ivecs", "write_ivecs", "read_bvecs"]


def _read_vecs(path: str | os.PathLike, payload_dtype: np.dtype) -> np.ndarray:
    """Read a TEXMEX *vecs file into a ``[n, dim]`` array of ``payload_dtype``."""
    raw = np.fromfile(path, dtype=np.int32)
    if raw.size == 0:
        return np.empty((0, 0), dtype=payload_dtype)
    dim = int(raw[0])
    if dim <= 0:
        raise ValueError(f"{path}: invalid vector dimension {dim}")
    if raw.size % (dim + 1) != 0:
        raise ValueError(
            f"{path}: file size {raw.size} int32 words is not a multiple of "
            f"dim+1 = {dim + 1}; truncated or mixed-dimension file"
        )
    mat = raw.reshape(-1, dim + 1)
    if not np.all(mat[:, 0] == dim):
        raise ValueError(f"{path}: inconsistent per-vector dimension headers")
    return mat[:, 1:].view(payload_dtype).copy()


def read_fvecs(path: str | os.PathLike, max_vectors: int | None = None) -> np.ndarray:
    """Read an ``.fvecs`` file → float32 ``[n, dim]``."""
    out = _read_vecs(path, np.dtype(np.float32))
    return out[:max_vectors] if max_vectors is not None else out


def read_ivecs(path: str | os.PathLike, max_vectors: int | None = None) -> np.ndarray:
    """Read an ``.ivecs`` file (e.g. ground-truth neighbor ids) → int32 ``[n, dim]``."""
    out = _read_vecs(path, np.dtype(np.int32))
    return out[:max_vectors] if max_vectors is not None else out


def read_bvecs(path: str | os.PathLike, max_vectors: int | None = None) -> np.ndarray:
    """Read a ``.bvecs`` file (uint8 payload, int32 dim header) → uint8 ``[n, dim]``."""
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size == 0:
        return np.empty((0, 0), dtype=np.uint8)
    dim = int(np.frombuffer(raw[:4].tobytes(), dtype=np.int32)[0])
    rec = dim + 4
    if dim <= 0 or raw.size % rec != 0:
        raise ValueError(f"{path}: invalid or truncated bvecs (dim={dim})")
    recs = raw.reshape(-1, rec)
    # Every record's header is checked: a mixed-dim file whose size happens
    # to divide the record length would otherwise interleave headers into
    # the payload.
    headers = recs[:, :4].copy().view(np.int32).reshape(-1)
    if not (headers == dim).all():
        bad = int(np.argmax(headers != dim))
        raise ValueError(
            f"{path}: inconsistent bvecs dim header at record {bad}: "
            f"{int(headers[bad])} != {dim}"
        )
    mat = recs[:, 4:]
    return (mat[:max_vectors] if max_vectors is not None else mat).copy()


def _write_vecs(path: str | os.PathLike, arr: np.ndarray, payload_dtype: np.dtype) -> None:
    arr = np.ascontiguousarray(arr, dtype=payload_dtype)
    if arr.ndim != 2:
        raise ValueError(f"expected [n, dim] array, got shape {arr.shape}")
    n, dim = arr.shape
    out = np.empty((n, dim + 1), dtype=np.int32)
    out[:, 0] = dim
    out[:, 1:] = arr.view(np.int32)
    out.tofile(path)


def write_fvecs(path: str | os.PathLike, arr: np.ndarray) -> None:
    """Write float32 ``[n, dim]`` as ``.fvecs``."""
    _write_vecs(path, arr, np.dtype(np.float32))


def write_ivecs(path: str | os.PathLike, arr: np.ndarray) -> None:
    """Write int32 ``[n, dim]`` as ``.ivecs``."""
    _write_vecs(path, arr, np.dtype(np.int32))
