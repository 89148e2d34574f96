"""ctypes binding for the native exact-search oracle (counterpart:
``rag_on_edge_tpu/runtime/oracle.py``).

The reference's ``cpu/cpu_baseline.cpp`` is a standalone binary; here the
native oracle (``cpu_oracle.cpp``, and the CLI ``cpu_oracle_main.cpp``) is
compiled by ``g++`` on first use into the port's build directory
(``ops._build.BUILD_DIR``), under a name that carries a hash of its sources
and flags, as the kernel libraries are, and driven from Python; a NumPy
fallback answers where no C++ toolchain is found.  It runs on the CPU by
nature: it is the ground truth that does not come from the port's kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from rag_on_edge_tpu_torch.ops import _build

__all__ = ["oracle_search", "native_available", "build_library", "build_binary"]

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "cpu_oracle.cpp"
_MAIN_SRC = _HERE / "cpu_oracle_main.cpp"
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fopenmp"]
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_failed = False


def _target(name: str, suffix: str, sources: list[Path], extra: list[str]) -> Path:
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)
                            + " ".join(_FLAGS + extra).encode()).hexdigest()[:16]
    return _build.BUILD_DIR / f"{name}-{digest}{suffix}"


def _compile(target: Path, sources: list[Path], extra: list[str], force: bool) -> str | None:
    """``g++`` the sources into ``target`` unless it exists (or ``force``);
    retried without OpenMP for toolchains that lack libgomp.  The output is
    written beside the target and renamed, so a cut build never leaves a
    half-written file under its name."""
    if target.exists() and not force:
        return str(target)
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=target.parent)
    os.close(fd)
    try:
        cmd = ["g++", *_FLAGS, *extra, *map(str, sources), "-o", tmp]
        for attempt in (cmd, [c for c in cmd if c != "-fopenmp"]):
            try:
                subprocess.run(attempt, check=True, capture_output=True, text=True)
            except (subprocess.CalledProcessError, FileNotFoundError):
                continue
            os.chmod(tmp, 0o755)
            os.replace(tmp, target)
            return str(target)
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_library(force: bool = False) -> str | None:
    """Compile cpu_oracle.cpp → ``libcpu_oracle-<hash>.so`` in the build
    directory.  Returns the path or None."""
    extra = ["-shared", "-fPIC"]
    return _compile(_target("libcpu_oracle", ".so", [_SRC], extra), [_SRC], extra, force)


def build_binary(force: bool = False) -> str | None:
    """Compile the standalone ``cpu_oracle`` CLI binary (the reference's
    cpu_baseline executable with its documented argv contract:
    ``cpu_oracle <base.fvecs> <query.fvecs> <top_k> [results_dir] [metric]``,
    writing ``results_dir/results.txt``).  Returns the path or None."""
    sources = [_MAIN_SRC, _SRC]
    return _compile(_target("cpu_oracle", "", sources, []), sources, [], force)


def _load() -> ctypes.CDLL | None:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = build_library()
        if path is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(path)
        lib.oracle_search.restype = ctypes.c_int
        lib.oracle_search.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ]
        lib.oracle_abi_version.restype = ctypes.c_int
        lib.oracle_abi_version.argtypes = []
        if lib.oracle_abi_version() != 1:
            _build_failed = True
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _numpy_fallback(queries, base, k, metric, query_chunk: int = 512):
    """Chunked exact search: bounded memory (a full [Q, N] score matrix is
    40 GB at 10K x 1M — the chunk keeps it to query_chunk rows)."""
    ids_out = np.empty((queries.shape[0], k), np.int32)
    scores_out = np.empty((queries.shape[0], k), np.float32)
    base_norms = (np.sum(base.astype(np.float32) ** 2, axis=1)[None, :]
                  if metric == "l2" else None)
    for q0 in range(0, queries.shape[0], query_chunk):
        scores = queries[q0:q0 + query_chunk] @ base.T
        if base_norms is not None:
            scores = 2.0 * scores - base_norms
        order = np.lexsort(
            (np.broadcast_to(np.arange(base.shape[0]), scores.shape), -scores),
            axis=1,
        )
        ids = order[:, :k].astype(np.int32)
        ids_out[q0:q0 + query_chunk] = ids
        scores_out[q0:q0 + query_chunk] = np.take_along_axis(
            scores, ids, axis=1).astype(np.float32)
    return ids_out, scores_out


def oracle_search(
    queries: np.ndarray, base: np.ndarray, k: int, metric: str = "ip"
) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k via the native oracle → (ids [Q,k] i32, scores [Q,k] f32).

    Scores follow the unified larger-is-better convention
    (ip: q·b; l2: -(‖b‖²-2q·b)).
    """
    if metric not in ("ip", "l2"):
        raise ValueError(f"unknown metric {metric!r}")
    queries = np.ascontiguousarray(queries, dtype=np.float32)
    base = np.ascontiguousarray(base, dtype=np.float32)
    nq, d = queries.shape
    n, d2 = base.shape
    if d != d2:
        raise ValueError(f"dim mismatch: queries {d} vs base {d2}")
    k = int(k)
    if not (0 < k <= n):
        raise ValueError(f"k={k} out of range (1..{n})")

    lib = _load()
    if lib is None:
        return _numpy_fallback(queries, base, k, metric)

    ids = np.empty((nq, k), dtype=np.int32)
    scores = np.empty((nq, k), dtype=np.float32)
    rc = lib.oracle_search(
        queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nq,
        base.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, d,
        k, 0 if metric == "ip" else 1,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise RuntimeError(f"oracle_search failed with code {rc}")
    return ids, scores
