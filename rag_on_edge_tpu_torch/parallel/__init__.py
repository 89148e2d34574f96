"""Sharded search over a list of devices (counterpart: ``rag_on_edge_tpu/parallel``)."""

from rag_on_edge_tpu_torch.parallel.mesh import make_mesh
from rag_on_edge_tpu_torch.parallel.sharded import ShardedBruteForceIndex, ShardedIVFIndex

__all__ = ["make_mesh", "ShardedBruteForceIndex", "ShardedIVFIndex"]
