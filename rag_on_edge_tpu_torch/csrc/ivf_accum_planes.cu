// Kernel K1 of the IVF search path: the cluster-major fine scan with packed
// accumulation, emitting per-lane-bin top-2 "planes" of packed int32 keys.
//
// Replaces the TPU kernel rag_on_edge_tpu/ops/pallas_ivf_dma.py,
// cluster_major_accum_planes (its _kernel with planes=True, and _plane_max).
//
// What it computes, for each cluster's LAST block t and each routed query
// row r of that block:
//   key(b, r, col) = dots(b, r, col) * 256 - bias[b, col]          (int8 L2)
//                  | dots(b, r, col) * 256 + ((15 - b % 16) << 4 | col / 128)
//   masked to KMIN where col >= rows_valid[b],
//   folded by max over the cluster's blocks b (first block .. t),
//   then per bin (lane = col % 128) the largest key (plane 1) and the
//   largest key different from it (plane 2), written to out[t, r, :].
// Rows of blocks that are not a cluster's last block are not written.
//
// What bounds it on the H100: integer multiply-adds.  At the SIFT-1M slice
// (about 1.1K blocks of 2048 rows, 256 routed rows, D = 128) the scan is
// 7.4e10 int8 MACs against 0.3 GB of slabs, about 250 MACs per byte read:
// with dp4a (4 MACs per instruction, no tensor cores) the instruction rate
// is the limit, not the 3.35 TB/s of device memory.
//
// Design (simple first; wgmma and TMA are later work):
// - one CTA of 256 threads per (last block, 32-row tile of the routed
//   rows): two row groups of 16 rows x 128 lanes that share each staged
//   chunk.  CTAs on other blocks exit at once.  Thread = (group, bin lane).
// - the chunk loop (128 columns at a time) is outside, the cluster's
//   block loop inside it, so the running max over blocks and the two
//   planes stay in registers (3 x 16 ints a thread); the TPU kernel's
//   [qcap, blk] accumulator is never needed.
// - each block's [D, 128] chunk is staged in shared memory transposed, one
//   packed column per lane at an odd word stride (no bank conflicts on
//   the reads), from coalesced 32-bit loads transposed with __byte_perm;
//   the query rows sit beside it and are read as 16-byte broadcasts.
// - dot products are __dp4a on packed int8 words, exact in int32.  The
//   staging and the dot loop are shared with K4 (ivf_stage.cuh).
// - keys are built on the unsigned bit pattern: (u32)dots << 8 is defined
//   for negative dots and gives the same bits as JAX's shift_left and
//   torch's int32 arithmetic.  The wrapper bounds D so that it never wraps.
#include <cstdint>
#include <cuda_runtime.h>

#include "ivf_stage.cuh"

namespace {

constexpr int LANES = 128;                   // bin width: threads of one row group
constexpr int ROWS = 16;                     // routed query rows per row group
constexpr int GROUPS = 2;                    // row groups per CTA (share one staged chunk)
constexpr int THREADS = LANES * GROUPS;
constexpr int CODE_MAX = 16;                 // block codes (4 bits)
constexpr int32_t KMIN = -2147483647;        // -(2**31) + 1: invalid entry

__global__ void __launch_bounds__(THREADS)
accum_planes_i8_kernel(const int8_t* __restrict__ qg,          // [nblocks, qcap, d]
                       const int8_t* __restrict__ vec,         // [nblocks, d, blk]
                       const int32_t* __restrict__ block_first,  // [nblocks]
                       const int32_t* __restrict__ block_last,   // [nblocks]
                       const int32_t* __restrict__ rows_valid,   // [nblocks]
                       const int32_t* __restrict__ bias,       // [nblocks, blk] or null
                       int32_t* __restrict__ out,              // [nblocks, qcap, nplanes*128]
                       int qcap, int d, int blk, int nplanes, int qstride) {
  const int t = blockIdx.x;
  if (block_last[t] == 0) return;
  const int lane = threadIdx.x % LANES;
  const int group = threadIdx.x / LANES;
  const int r0 = (blockIdx.y * GROUPS + group) * ROWS;  // this group's first row
  const int cstride = qstride + 1;  // odd word stride: conflict-free column reads

  extern __shared__ int4 smem4[];
  int32_t* q_s = reinterpret_cast<int32_t*>(smem4);   // [GROUPS*ROWS][qstride] words
  int8_t* q_b = reinterpret_cast<int8_t*>(smem4);
  int32_t* col_s = q_s + GROUPS * ROWS * qstride;     // [LANES][cstride] words
  const int32_t* my_q = q_s + group * ROWS * qstride;

  int tb = t;  // the cluster's first block
  while (tb > 0 && block_first[tb] == 0) --tb;
  const int nb = t - tb + 1;
  const int nchunks = blk / LANES;
  const int cta_r0 = blockIdx.y * GROUPS * ROWS;

  int32_t p1[ROWS], p2[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) p1[r] = p2[r] = KMIN;

  for (int c = 0; c < nchunks; ++c) {
    const int col = c * LANES + lane;
    int32_t m[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) m[r] = KMIN;

    for (int b = tb; b <= t; ++b) {
      stage_chunk<THREADS>(vec + (size_t)b * d * blk + c * LANES, d, blk, qstride, col_s, cstride);
      // The routed rows change only with the block: load them once for a
      // one-block cluster, per block otherwise.
      if (c == 0 || nb > 1)
        stage_queries<THREADS>(qg + (size_t)b * qcap * d, qcap, d, cta_r0, GROUPS * ROWS,
                               qstride, q_b);
      __syncthreads();

      int32_t acc[ROWS];
      dot_rows<ROWS>(col_s + lane * cstride, my_q, qstride, acc);

      const bool valid = col < rows_valid[b];
      const uint32_t pack = (uint32_t)(((CODE_MAX - 1) - (b & (CODE_MAX - 1))) << 4 | c);
      const uint32_t sub = bias != nullptr ? (uint32_t)bias[(size_t)b * blk + col] : 0u;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const uint32_t shifted = (uint32_t)acc[r] << 8;
        const int32_t key = valid ? (int32_t)(bias != nullptr ? shifted - sub : shifted | pack)
                                  : KMIN;
        m[r] = max(m[r], key);
      }
      __syncthreads();  // col_s / q_s are rewritten next
    }

    // Running top-2 per bin; plane 2 is the largest key DIFFERENT from
    // plane 1 (_plane_max masks every entry equal to plane 1).
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int32_t x = m[r];
      if (x > p1[r]) {
        p2[r] = p1[r];
        p1[r] = x;
      } else if (x != p1[r] && x > p2[r]) {
        p2[r] = x;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r0 + r >= qcap) break;
    int32_t* o = out + ((size_t)t * qcap + r0 + r) * (size_t)(nplanes * LANES);
    o[lane] = p1[r];
    if (nplanes == 2) o[LANES + lane] = p2[r];
  }
}

}  // namespace

// C entry for ctypes.  Launches on `stream`, allocates nothing, and returns
// cudaGetLastError() (0 = launched).  `bias` may be null (no-bias mode).
extern "C" int ivf_accum_planes_i8(const void* qg, const void* vec, const void* block_first,
                                   const void* block_last, const void* rows_valid,
                                   const void* bias, void* out, int nblocks, int qcap, int d,
                                   int blk, int nplanes, void* stream) {
  if (nblocks == 0 || qcap == 0) return 0;
  const int qstride = ((d + 3) / 4 + 3) / 4 * 4;  // words per row, multiple of 4
  const size_t smem =
      (size_t)(GROUPS * ROWS * qstride + LANES * (qstride + 1)) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(accum_planes_i8_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)nblocks, (unsigned)((qcap + GROUPS * ROWS - 1) / (GROUPS * ROWS)));
  accum_planes_i8_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(qg), static_cast<const int8_t*>(vec),
      static_cast<const int32_t*>(block_first), static_cast<const int32_t*>(block_last),
      static_cast<const int32_t*>(rows_valid), static_cast<const int32_t*>(bias),
      static_cast<int32_t*>(out), qcap, d, blk, nplanes, qstride);
  return (int)cudaGetLastError();
}
