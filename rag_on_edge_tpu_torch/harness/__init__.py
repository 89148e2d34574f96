"""Harnesses of the port (counterpart: ``rag_on_edge_tpu/harness``): the
spatial-GEMM benchmark (``bench_gemm``), the kernel-variant lab
(``kernel_lab``, kernel K10) and their device timing (``timing``)."""
