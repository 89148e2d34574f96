"""Persistent compiled units (counterpart: ``rag_on_edge_tpu/utils/cache.py``).

The JAX package turns on JAX's persistent compilation cache, so each XLA
program is compiled once and reloaded afterwards, as the reference reloads
its QNN context binaries.  The port compiles nothing at run time but its
CUDA kernels, and ``ops._build`` already keeps each one as a library named
by the hash of its sources in ``BUILD_DIR``: that directory is the cache.
"""

from __future__ import annotations

from pathlib import Path

from rag_on_edge_tpu_torch.ops import _build

__all__ = ["enable_compilation_cache"]


def enable_compilation_cache(cache_dir: str | None = None) -> str:
    """Create the kernel-library cache (``ops._build.BUILD_DIR``) and return
    its path (idempotent).  ``cache_dir`` keeps the JAX signature: the
    libraries are always built in ``BUILD_DIR``, so any other directory is
    refused."""
    path = _build.BUILD_DIR
    if cache_dir is not None and Path(cache_dir).resolve() != path.resolve():
        raise ValueError(f"the port's kernel libraries are built in {path}, not {cache_dir}")
    path.mkdir(parents=True, exist_ok=True)
    return str(path)
