"""The serving runtime of the port (counterpart: ``rag_on_edge_tpu/runtime``):
the micro-batching executor in front of a device search function, and the
native exact-search oracle on the CPU (``oracle``, ``cpu_oracle.cpp``)."""

from rag_on_edge_tpu_torch.runtime.executor import BatchingExecutor, SliceFuture
from rag_on_edge_tpu_torch.runtime.oracle import oracle_search

__all__ = ["BatchingExecutor", "SliceFuture", "oracle_search"]
