"""The serving runtime of the port (counterpart: ``rag_on_edge_tpu/runtime``):
the micro-batching executor in front of a device search function."""

from rag_on_edge_tpu_torch.runtime.executor import BatchingExecutor, SliceFuture

__all__ = ["BatchingExecutor", "SliceFuture"]
