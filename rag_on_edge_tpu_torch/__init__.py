"""rag_on_edge_tpu_torch — the PyTorch/CUDA port of ``rag_on_edge_tpu``.

Same layout as the JAX package, so each module's counterpart is easy to
find:

- ``utils``  — synthetic SIFT corpora, the dataset cache shared with the
  JAX package (``load_dataset``, ``io``), exact ground truth, recall, the
  int8 GEMM operands (``preprocess``) and the kernel-library cache
  (``cache``).
- ``ops``    — quantization, distances, top-k, block tables, and the
  hand-written Hopper kernels with their plain PyTorch versions, all in
  CUDA C++: the IVF scan kernels (``ivf_accum``, ``ivf_scan``,
  ``fused_topk``), the brute-force kernels (``bruteforce_fused``,
  ``bruteforce_accum``) and the spatial GEMM's tiled GEMM
  (``tiled_matmul``).
- ``models`` — k-means (with its per-step checkpoint and resume), the
  cluster-major ``IVFIndex`` and the ``BruteForceIndex``.
- ``runtime`` — the serving executor (``BatchingExecutor``): single
  queries in, fixed batches through a device search function, pipelined;
  and the native exact-search oracle on the CPU (``oracle``, C++ through
  ``ctypes``).
- ``parallel`` — ``make_mesh`` and the sharded indexes
  (``ShardedBruteForceIndex``, ``ShardedIVFIndex``): one process drives a
  list of devices, one shard each; ``make_mesh_2d`` and
  ``spatial_matmul``, the GEMM over a grid of devices.
- ``harness`` — the IVF, brute-force and serving benchmarks
  (``bench_ivf`` with the index cache ``build_or_load_index``,
  ``bench_bruteforce``, ``bench_executor``), the sweeps, the per-stage
  profilers (single and sharded), the skew and recovery harnesses, the
  transfer probe, the gated serving run and ``warmup``, the spatial-GEMM
  benchmark (``bench_gemm``), the
  kernel-variant lab (``kernel_lab``, its kernel K10 in CUDA C++) and the
  hardware probes (``hw_probe``, kernels K11-K14 in CUDA C++: the card's
  per-step and launch costs, streaming and async-copy GB/s, and the
  mma.sync and __dp4a matrix rates).
- ``csrc``   — the kernel sources, built on first use by ``ops._build``.

The port imports torch and numpy, never jax.
"""

import torch

# Synthetic SIFT scores are integers below 2**24, so the fp32 GEMMs of the
# coarse tier, the rescore and the ground truth are exact only when each
# product and sum is taken in full fp32.  TF32 keeps ~10 mantissa bits and
# would flip near-tie rankings, so it is turned off for matmuls and cuDNN.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from rag_on_edge_tpu_torch.models.brute_force import BruteForceIndex  # noqa: E402
from rag_on_edge_tpu_torch.models.ivf import IVFIndex  # noqa: E402
from rag_on_edge_tpu_torch.parallel import (ShardedBruteForceIndex,  # noqa: E402
                                            ShardedIVFIndex, make_mesh)

__all__ = ["BruteForceIndex", "IVFIndex", "ShardedBruteForceIndex", "ShardedIVFIndex",
           "make_mesh", "__version__"]
