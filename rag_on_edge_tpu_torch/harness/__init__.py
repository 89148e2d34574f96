"""Harnesses of the port (counterpart: ``rag_on_edge_tpu/harness``): the
spatial-GEMM benchmark (``bench_gemm``), the kernel-variant lab
(``kernel_lab``, kernel K10), the hardware probes (``hw_probe``, kernels
K11-K14; ``python -m rag_on_edge_tpu_torch.harness.hw_probe``) and their
device timing (``timing``)."""
