"""Harnesses of the port (counterpart: ``rag_on_edge_tpu/harness``): the
IVF benchmark and its index cache (``bench_ivf``, ``build_or_load_index``),
the brute-force benchmark (``bench_bruteforce``), the serving benchmark
(``bench_executor``, saturated and open loop, and its serialized-cycle
probe ``relay_cycle_probe``), the sweeps (``sweep``, ``sweep10m``), the
per-stage profilers (``profile_ivf``, ``profile_sharded``), the skew and
recovery harnesses (``qcap_calib``, ``recover_sweep``, ``recover_lab``),
the transfer probe and the gated serving run (``relay_probe``,
``serve_hunt``), the pre-build of every benchmark artifact (``warmup``),
the spatial-GEMM benchmark (``bench_gemm``), the kernel-variant lab
(``kernel_lab``, kernel K10), the hardware probes (``hw_probe``, kernels
K11-K14; ``python -m rag_on_edge_tpu_torch.harness.hw_probe``) and their
device timing and the JAX timing protocol (``timing``); and the times of
kernel K3's fp32 mode at its callers' shapes (``k3_times``), which the JAX
package does not have."""
