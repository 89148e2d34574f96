"""Build and load the CUDA kernels on first use, and check what their
wrappers hand them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
alone into ``build/rag_on_edge_tpu_torch/lib<name>-<hash>.so`` under the
repository root, then loaded with ``ctypes``.  The file name carries a
hash of the source, the shared ``csrc/*.cuh`` headers and the flags, so
an edited source or header is rebuilt and a stale library is never
loaded.  No PyTorch headers are included: a build takes seconds, not
minutes.

:func:`check_inputs` is the one rule for which inputs a kernel wrapper
refuses before it launches; each wrapper checks its kernel's own shape
limits beside the call, and :func:`aligned` gives a kernel that loads
wide words a base pointer it can take.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "FLOAT_DIM_MAX", "load_library",
           "check_inputs", "check_float", "aligned"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "rag_on_edge_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# The float stage of csrc/ivf_stage.cuh (K1, K4-K7, K9, K10 and K5) holds a
# [D, 128] chunk and 32 query rows as fp32 in the 227 KB of shared memory a
# CTA may have.
FLOAT_DIM_MAX = 320

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc" if os.path.exists("/usr/local/cuda/bin/nvcc") else None)
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its hashed library is missing, load it
    once per process, and return the ``ctypes`` handle."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC_DIR / f"{name}.cu"
    # The shared headers are part of every build's input.
    inputs = [src, *sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in inputs)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{name}-{digest}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # Build beside the target and rename, so a concurrent or cut-off
        # build never leaves a half-written library under the final name.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}) for {src}:\n{res.stderr}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(lib_path))
    _LIBS[name] = lib
    return lib


def check_inputs(name: str, dev, tensors) -> None:
    """What every kernel wrapper refuses on the card: a device that is not
    CUDA, and inputs (``None`` skipped) that are not contiguous on ``dev``.
    There is no fallback to the plain version: the wrapper raises."""
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for x in tensors:
        if x is None:
            continue
        if x.device != dev:
            raise ValueError(f"all {name} inputs must be on one device")
        if not x.is_contiguous():
            raise ValueError(f"{name} inputs must be contiguous")


def check_float(name: str, queries, base, d: int, d_max: int = FLOAT_DIM_MAX) -> None:
    """What a kernel's float modes take on the card: fp32 or bf16 queries
    and base in one dtype (the kernel widens both the same way), and
    ``D <= d_max``."""
    if queries.dtype != base.dtype or d > d_max:
        raise ValueError(f"the CUDA {name} takes fp32 or bf16 operands in one dtype and "
                         f"D <= {d_max}; got {queries.dtype} x {base.dtype}, D={d}")


def aligned(x, nbytes: int):
    """``x``, or a copy of it whose storage starts on an ``nbytes`` boundary
    (a view into a larger tensor may start anywhere)."""
    return x if x.data_ptr() % nbytes == 0 else x.clone()
