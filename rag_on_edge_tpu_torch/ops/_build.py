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
limits beside the call, :func:`aligned` gives a kernel that loads wide
words a base pointer it can take, and :func:`pad_rows`,
:func:`pitched_storage`, :func:`kmajor` and :func:`kmajor_operands` the row
pitch and the K-major layout TMA and 8-bit ``wgmma`` take.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "load_library",
           "check_inputs", "check_float", "aligned", "pad_rows", "pitched_storage",
           "kmajor", "kmajor_operands", "PASS_K", "by_passes"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "rag_on_edge_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# The widest running top-k the kernels that hold it one entry a lane keep
# (K3's int8 and bf16 modes, K4, K6, K7, K10): a larger k runs in passes.
PASS_K = 32

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


def check_float(name: str, queries, base) -> None:
    """What a kernel's float modes take on the card: fp32 or bf16 queries
    and base in one dtype (the kernel widens both the same way)."""
    if queries.dtype != base.dtype:
        raise ValueError(f"the CUDA {name} takes fp32 or bf16 operands in one dtype; got "
                         f"{queries.dtype} x {base.dtype}")


def pad_rows(x, multiple: int):
    """``x`` contiguous with its last dimension zero-padded to a multiple of
    ``multiple`` elements (one copy at most: none where ``x`` is contiguous
    and needs no pad)."""
    width = x.shape[-1]
    pad = -width % multiple
    if not pad:
        return x.contiguous()
    out = x.new_zeros((*x.shape[:-1], width + pad))
    out[..., :width] = x
    return out


def pitched_storage(x):
    """The rows of ``x`` [..., D] as TMA and 16-byte copies read them →
    (``storage`` [..., ldq] contiguous, ``ldq``), ``storage[..., :D]`` being
    ``x`` and ``ldq`` elements a multiple of 16 bytes.  Where ``x`` already
    lies so (a contiguous tensor whose ``D`` fills the pitch, or a view of
    the first ``D`` columns of one, on a 16-byte base) nothing is copied
    and the pad is whatever the buffer holds: the kernels read only the
    first ``D`` elements of a row.  Else one copy, :func:`pad_rows`."""
    mult = 16 // x.element_size()
    d = x.shape[-1]
    if x.dim() >= 2 and x.numel() and x.stride(-1) == 1:
        ldq = x.stride(-2)
        nested = all(x.stride(i) == ldq * math.prod(x.shape[i + 1:-1])
                     for i in range(x.dim() - 2))
        last = x.storage_offset() + math.prod(x.shape[:-1]) * ldq
        if (ldq >= d and ldq % mult == 0 and nested and x.data_ptr() % 16 == 0
                and last * x.element_size() <= x.untyped_storage().nbytes()):
            return x.as_strided((*x.shape[:-1], ldq), x.stride()), ldq
    storage = pad_rows(x, mult)
    return storage, storage.shape[-1]


def kmajor(x, multiple: int):
    """An int8 ``[..., D, N]`` array transposed to ``[..., N, D']``,
    contiguous, with D' = D rounded up to ``multiple`` and the pad zero.
    Where N is a multiple of 8 and the storage 8-byte aligned, the copy moves
    8-byte words (8 columns each) first and then bytes within each 8 x D'
    block: on the card that is faster than one strided byte copy."""
    *lead, d, n = x.shape
    if n % 8 or not x.is_contiguous() or x.data_ptr() % 8:
        return pad_rows(x.transpose(-1, -2), multiple)
    words = x.view(torch.int64).transpose(-1, -2).contiguous()  # [..., N/8, D]
    blocks = words.view(torch.int8).view(*lead, n // 8, d, 8).transpose(-1, -2)
    return pad_rows(blocks, multiple).view(*lead, n, -1)


def kmajor_operands(queries, base):
    """The int8 ``wgmma`` kernels' operands (K3 and K5): the queries [B, ldq]
    and ``base`` [..., D, N] transposed K-major, [..., N, ldq], ``ldq`` = D
    rounded up to 16 with the pad zero (TMA's 16-byte row pitch).  8-bit
    ``wgmma`` operands have no transpose bit, so both sides must lie K-major;
    the copy is made on each call, and the indexes keep only the JAX layout."""
    return pad_rows(queries, 16), kmajor(base, 16)


def aligned(x, nbytes: int):
    """``x``, or a copy of it whose storage starts on an ``nbytes`` boundary
    (a view into a larger tensor may start anywhere)."""
    return x if x.data_ptr() % nbytes == 0 else x.clone()


def by_passes(k: int, run, width: int = PASS_K):
    """The exact top-k of a kernel that keeps at most ``width`` a row, in
    passes: ``run(kp, bound_v, bound_i)`` → (vals [..., kp], ids [..., kp])
    returns the best ``kp`` entries ranked after each row's bound (none on
    the first pass: both None), and each pass takes the last entry of the
    one before as its bound.  The passes' lists, joined on the last axis,
    are the top-k, ties to the lowest id; a row that runs out of entries
    above the fill value returns fill values from then on."""
    vals, ids = [], []
    bound_v = bound_i = None
    for p0 in range(0, k, width):
        v, i = run(min(width, k - p0), bound_v, bound_i)
        vals.append(v)
        ids.append(i)
        bound_v, bound_i = v[..., -1].contiguous(), i[..., -1].contiguous()
    if len(vals) == 1:
        return vals[0], ids[0]
    return torch.cat(vals, dim=-1), torch.cat(ids, dim=-1)
