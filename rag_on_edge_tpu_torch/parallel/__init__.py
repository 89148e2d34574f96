"""Sharded search and the spatial GEMM over lists and grids of devices
(counterpart: ``rag_on_edge_tpu/parallel``)."""

from rag_on_edge_tpu_torch.parallel.mesh import make_mesh
from rag_on_edge_tpu_torch.parallel.sharded import ShardedBruteForceIndex, ShardedIVFIndex
from rag_on_edge_tpu_torch.parallel.spatial_gemm import (make_mesh_2d, spatial_matmul,
                                                         verify_matmul)

__all__ = ["make_mesh", "make_mesh_2d", "spatial_matmul", "verify_matmul",
           "ShardedBruteForceIndex", "ShardedIVFIndex"]
