"""Spatially partitioned GEMM over a 2-D grid of devices
(counterpart: ``rag_on_edge_tpu/parallel/spatial_gemm.py``).

The JAX package rebuilds the reference's AMD Versal AIE tiled GEMM (an
array of cores, A broadcast along each row, B along each column, K local
to each core) as a 2-D ``jax.sharding.Mesh``: A row-sharded, B
column-sharded, one local product per device, and C left sharded over
(rows, cols), so the join needs no collective.

The port keeps its single controller, as the sharded indexes do
(``parallel/mesh.py``): a mesh is a ``rows × cols`` nested list of
``torch.device``s, and logical positions may share a device (for example
``[[cuda:0] * 2] * 2``).  A is cut into ``rows`` row slices and B into
``cols`` column slices; mesh position (i, j) computes A_i @ B_j on its
device, through kernel K8 (``ops/tiled_matmul.py``) with
``use_pallas_kernel=True`` or a plain product otherwise, and C is
assembled in mesh order on the first position's device.

The plain product matches the JAX package's XLA product: int8 through an
fp64 product, exact for any K (every int8 dot is an integer below 2**53;
``torch.mm`` on int8 wraps, and on int32 is not implemented on CUDA),
floats in fp32 with TF32 off, as ``Precision.HIGHEST``.

:func:`verify_matmul` is the reference host program's check (full, or 1000
sampled entries past 2**30 multiply-adds), copied because importing the
JAX module would import jax.
"""

from __future__ import annotations

import numpy as np
import torch

from rag_on_edge_tpu_torch.ops.tiled_matmul import tiled_matmul
from rag_on_edge_tpu_torch.parallel.mesh import make_mesh

__all__ = ["make_mesh_2d", "spatial_matmul", "verify_matmul"]

_FULL_VERIFY_MAX_ELEMS = 2**30  # M*N*K threshold of the reference's host program


def make_mesh_2d(rows: int, cols: int, device_type: str = "cuda") -> list[list[torch.device]]:
    """The first ``rows·cols`` devices of ``device_type`` as a rows × cols
    grid (:func:`make_mesh`'s devices, row by row).  Raises past the device
    count, and where there is none: there is no fall-back to another
    device type.  Positions may also share a device: pass a grid such as
    ``[[torch.device("cuda:0")] * 2] * 2``."""
    devs = make_mesh(rows * cols, device_type=device_type)
    return [devs[r * cols:(r + 1) * cols] for r in range(rows)]


def _shape(mesh) -> tuple[int, int]:
    rows, cols = len(mesh), len(mesh[0]) if mesh else 0
    if rows == 0 or cols == 0 or any(len(r) != cols for r in mesh):
        raise ValueError("mesh must be a non-empty rows x cols grid of devices")
    return rows, cols


def _place(a: torch.Tensor, b: torch.Tensor, mesh):
    """A's row slices (one per mesh row) and B's column slices (one per
    mesh column), copied to every device that uses them →
    (a_parts[i][j], b_parts[i][j]), each contiguous."""
    rows, cols = _shape(mesh)
    m, n = a.shape[0], b.shape[1]
    ms, ns = m // rows, n // cols
    a_parts = [[a[i * ms:(i + 1) * ms].to(mesh[i][j]).contiguous() for j in range(cols)]
               for i in range(rows)]
    b_parts = [[b[:, j * ns:(j + 1) * ns].to(mesh[i][j]).contiguous() for j in range(cols)]
               for i in range(rows)]
    return a_parts, b_parts


def _local_product(a: torch.Tensor, b: torch.Tensor, use_pallas_kernel: bool) -> torch.Tensor:
    if use_pallas_kernel:
        return tiled_matmul(a, b)
    if a.dtype == torch.int8:
        return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)
    return a.to(torch.float32) @ b.to(torch.float32)


def _run(a_parts, b_parts, mesh, use_pallas_kernel: bool) -> torch.Tensor:
    """One local product per mesh position, then C in mesh order on the
    first position's device."""
    rows, cols = _shape(mesh)
    out = mesh[0][0]
    blocks = [[_local_product(a_parts[i][j], b_parts[i][j], use_pallas_kernel)
               for j in range(cols)] for i in range(rows)]
    if rows == 1 and cols == 1:
        return blocks[0][0]
    return torch.cat([torch.cat([blk.to(out) for blk in row], dim=1) for row in blocks], dim=0)


def spatial_matmul(a: torch.Tensor, b: torch.Tensor, mesh, use_pallas_kernel: bool = False
                   ) -> torch.Tensor:
    """C = A[M, K] @ B[K, N] spatially partitioned over ``mesh`` → C on
    ``mesh[0][0]``.

    int8 inputs accumulate in int32, floats in f32.  M and N must be
    divisible by the mesh's rows and columns (pad upstream)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"contraction mismatch: {k} vs {k2}")
    rows, cols = _shape(mesh)
    if m % rows:
        raise ValueError(f"M={m} must be divisible by the mesh's {rows} rows")
    if n % cols:
        raise ValueError(f"N={n} must be divisible by the mesh's {cols} cols")
    return _run(*_place(a, b, mesh), mesh, use_pallas_kernel)


def verify_matmul(a: np.ndarray, b: np.ndarray, c: np.ndarray, seed: int = 0,
                  samples: int = 1000, rtol: float = 1e-4, atol: float = 1e-2) -> bool:
    """Full (up to 2**30 multiply-adds) or stochastic verification against
    an fp64 product, with a fixed seed for the sampled positions."""
    m, k = a.shape
    n = b.shape[1]
    af, bf = a.astype(np.float64), b.astype(np.float64)
    if m * n * k <= _FULL_VERIFY_MAX_ELEMS:
        expect = af @ bf
        return np.allclose(np.asarray(c, dtype=np.float64), expect, rtol=rtol, atol=atol)
    rng = np.random.default_rng(seed)
    ii = rng.integers(0, m, samples)
    jj = rng.integers(0, n, samples)
    for i, j in zip(ii, jj):
        if not np.isclose(float(c[i, j]), float(af[i] @ bf[:, j]), rtol=rtol, atol=atol):
            return False
    return True
