// Kernel K5 of the brute-force search: packed max-accumulation over a
// block-tiled base, one candidate per (column mod tile_n) bin, then one
// exact top-k over the bins.
//
// Replaces the TPU kernel rag_on_edge_tpu/ops/pallas_bruteforce_dma.py,
// fused_topk_accum (its _accum_kernel, with _extract_topk from
// pallas_bruteforce.py).
//
// What it computes, for each query row r and bin lane < tile_n:
//   key(t) = (u32)dot(q[r], tiles[t][:, lane]) << shift - (u32)bias[t][lane]  (int8 L2)
//          | (u32)dot << shift | (group - 1 - t % group)                      (int8)
//          | (monotone(fp32 dot) & ~(group - 1)) | (group - 1 - t % group)    (fp32, bf16)
//   KMIN where t * tile_n + lane >= n; shift = log2(group);
//   acc(g) = the max of key(t) over the tiles t of group g;
//   the bin's running (key, column): acc(g) with its low shift bits cleared
//   replaces it when strictly larger, with column (g*group + group-1-code) *
//   tile_n + lane, code = acc(g)'s low bits (ties go to the earlier tile
//   within a group and to the earlier group across them);
// then the top-k of the row's tile_n bins by (key >> shift desc, column
// asc), each winner masked by its column, as _extract_topk does; the float
// modes compare the keys as they are (no shift), and the wrapper decodes
// them to fp32 scores with their low log2(group) bits ceded.  Float L2 has
// no bias rows: it rides an augmented dimension held in the tiles.
//
// What bounds it on the H100: multiply-adds, as for K3 (B = 8192, D = 128,
// N = 1M: 1.07e12 MACs against a 128 MB base; __dp4a, no tensor cores; the
// float modes fp32 FMAs, 32 ms at the 67 TFLOP/s peak).  The fold and the
// final top-k add a few instructions per score and a 128 MB round trip of
// the per-bin state.
//
// Design (simple first; wgmma and TMA are later work):
// - pass 1: one CTA of 256 threads per (32 query rows, 128 bins): two row
//   groups of 16 rows x 128 lanes, thread = (group, bin).  It walks every
//   tile holding a valid column, staging the tile's [D, 128] chunk at its
//   bins transposed in shared memory and scoring it with __dp4a (K1's
//   staging and dot loop, ivf_stage.cuh).  The group accumulator and the
//   bin's running key and column live in registers (3 x 16 ints a thread),
//   so no CTA needs another's state; it writes the running keys and
//   columns, [B, tile_n] each.  Padded tiles are skipped (their keys would
//   all be KMIN).  fp32 and bf16: the same walk with K1's float stage
//   (query rows and chunk as fp32, bf16 widened on load, fmaf in d order).
// - pass 2: one CTA of 256 threads per row takes the exact top-k over the
//   row's tile_n bins: 8 bins a thread in registers, k passes of a CTA
//   argmax by (value desc, column asc) with warp shuffles and one shared-
//   memory step.  Ties go to the lowest column, not the lowest position,
//   so K2 (lowest position) is not used.
// - keys are built on the unsigned bit pattern: (u32)dot << shift is
//   defined for negative dots and gives the bits of JAX's shift_left.
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "ivf_stage.cuh"

namespace {

constexpr int LANES = 128;               // bins per CTA: one per lane of a row group
constexpr int ROWS = 16;                 // query rows per row group
constexpr int GROUPS = 2;                // row groups per CTA (share one staged chunk)
constexpr int THREADS = LANES * GROUPS;
constexpr int CTA_ROWS = ROWS * GROUPS;
constexpr int32_t KMIN = -2147483647;    // -(2**31) + 1: a masked column
constexpr int EPT = 8;                   // bins per thread in pass 2 (tile_n <= 2048)
constexpr unsigned FULL = 0xffffffffu;

// E: the element type, int8_t, or float / __nv_bfloat16 (the float modes,
// with no bias rows).
template <typename E>
__global__ void __launch_bounds__(THREADS)
accum_bins_kernel(const E* __restrict__ q,             // [b, d]
                  const E* __restrict__ tiles,         // [T, d, tile_n]
                  const int32_t* __restrict__ bias,    // [T, tile_n] or null
                  int32_t* __restrict__ rv_out,        // [b, tile_n]
                  int32_t* __restrict__ ri_out,        // [b, tile_n]
                  int b, int d, int tile_n, int n, int group, int shift, int qstride) {
  const int lane = threadIdx.x % LANES;
  const int grp = threadIdx.x / LANES;
  const int bin = blockIdx.x * LANES + lane;
  const int cta_r0 = blockIdx.y * CTA_ROWS;
  const int cstride = qstride + 1;  // int8: odd word stride, conflict-free column reads
  constexpr bool INT8 = std::is_same_v<E, int8_t>;

  // Query rows [CTA_ROWS][qstride] words (int8: 4 dims a word; float: one
  // fp32), then the chunk (int8: [LANES][cstride] words; float:
  // [qstride][LANES] fp32).
  extern __shared__ int4 smem4[];
  int32_t* q_s = reinterpret_cast<int32_t*>(smem4);
  int32_t* col_s = q_s + CTA_ROWS * qstride;
  const int32_t* my_q = q_s + grp * ROWS * qstride;
  if constexpr (INT8)
    stage_queries<THREADS>(q, b, d, cta_r0, CTA_ROWS, qstride, reinterpret_cast<int8_t*>(q_s));
  else
    stage_queries_f<THREADS>(q, b, d, cta_r0, CTA_ROWS, qstride, reinterpret_cast<float*>(q_s));

  int32_t rv[ROWS], ri[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    rv[r] = KMIN;
    ri[r] = 0;
  }
  const int t_live = (n + tile_n - 1) / tile_n;  // tiles holding a valid column
  const uint32_t low = (uint32_t)(group - 1);

  for (int g0 = 0; g0 < t_live; g0 += group) {
    int32_t acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = KMIN;
    for (int j = 0; j < group && g0 + j < t_live; ++j) {
      const int t = g0 + j;
      __syncthreads();  // the previous chunk's reads are done
      const E* vsrc = tiles + (size_t)t * d * tile_n + blockIdx.x * LANES;
      const bool valid = t * tile_n + bin < n;
      const uint32_t code = low - (uint32_t)j;
      if constexpr (INT8) {
        stage_chunk<THREADS>(vsrc, d, tile_n, qstride, col_s, cstride);
        __syncthreads();
        int32_t dots[ROWS];
        dot_rows<ROWS>(col_s + lane * cstride, my_q, qstride, dots);
        const uint32_t sub = bias != nullptr ? (uint32_t)bias[(size_t)t * tile_n + bin] : 0u;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const uint32_t shifted = (uint32_t)dots[r] << shift;
          const int32_t key = valid ? (int32_t)(bias != nullptr ? shifted - sub : shifted | code)
                                    : KMIN;
          acc[r] = max(acc[r], key);
        }
      } else {
        stage_chunk_f<THREADS>(vsrc, d, tile_n, qstride, reinterpret_cast<float*>(col_s));
        __syncthreads();
        float dots[ROWS];
        dot_rows_f<ROWS>(reinterpret_cast<const float*>(col_s), lane,
                         reinterpret_cast<const float*>(my_q), qstride, dots);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int32_t key = valid ? (int32_t)(((uint32_t)monotone_key(dots[r]) & ~low) | code)
                                    : KMIN;
          acc[r] = max(acc[r], key);
        }
      }
    }
    // Unpack the group's best key and fold it into the bin's running best.
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const uint32_t code = (uint32_t)acc[r] & low;
      const int32_t merge_key = (int32_t)((uint32_t)acc[r] ^ code);
      if (merge_key > rv[r]) {  // strict: ties keep the earlier group
        rv[r] = merge_key;
        ri[r] = (g0 + (int)(low - code)) * tile_n + bin;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = cta_r0 + grp * ROWS + r;
    if (row >= b) break;
    rv_out[(size_t)row * tile_n + bin] = rv[r];
    ri_out[(size_t)row * tile_n + bin] = ri[r];
  }
}

// (v, i) ranks before (bv, bi): larger value, then lower column.
__device__ __forceinline__ bool better(int32_t v, int i, int32_t bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(THREADS)
extract_kernel(const int32_t* __restrict__ rv, const int32_t* __restrict__ ri,
               int32_t* __restrict__ out_v, int32_t* __restrict__ out_i, int tile_n, int k,
               int shift) {
  __shared__ int32_t wv[THREADS / 32], wi[THREADS / 32];
  __shared__ int32_t best_v, best_i;
  const int row = blockIdx.x;
  const int wl = threadIdx.x % 32, warp = threadIdx.x / 32;
  int32_t cv[EPT];
  int ci[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int p = e * THREADS + threadIdx.x;
    // Bins past tile_n never win: the fill value and a column above all.
    cv[e] = p < tile_n ? rv[(size_t)row * tile_n + p] >> shift : KMIN;
    ci[e] = p < tile_n ? ri[(size_t)row * tile_n + p] : INT32_MAX;
  }
  for (int pass = 0; pass < k; ++pass) {
    int32_t bv = cv[0];
    int bi = ci[0];
#pragma unroll
    for (int e = 1; e < EPT; ++e)
      if (better(cv[e], ci[e], bv, bi)) {
        bv = cv[e];
        bi = ci[e];
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int32_t v2 = __shfl_xor_sync(FULL, bv, off);
      const int i2 = __shfl_xor_sync(FULL, bi, off);
      if (better(v2, i2, bv, bi)) {
        bv = v2;
        bi = i2;
      }
    }
    if (wl == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = wl < THREADS / 32 ? wv[wl] : KMIN;
      bi = wl < THREADS / 32 ? wi[wl] : INT32_MAX;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int32_t v2 = __shfl_xor_sync(FULL, bv, off);
        const int i2 = __shfl_xor_sync(FULL, bi, off);
        if (better(v2, i2, bv, bi)) {
          bv = v2;
          bi = i2;
        }
      }
      if (wl == 0) {
        best_v = bv;
        best_i = bi;
        out_v[(size_t)row * k + pass] = bv;
        out_i[(size_t)row * k + pass] = bi;
      }
    }
    __syncthreads();
    const int win = best_i;
    // Mask every bin holding the winner's column, as _extract_topk masks
    // by id (the fill value, so it can still win once only fill is left).
#pragma unroll
    for (int e = 0; e < EPT; ++e)
      if (ci[e] == win) cv[e] = KMIN;
    __syncthreads();  // best_i / wv are rewritten by the next pass
  }
}

template <typename E>
int launch_accum(const void* q, const void* tiles, const void* bias, void* rv, void* ri,
                 void* out_v, void* out_i, int b, int d, int tile_n, int n, int k, int group,
                 cudaStream_t s) {
  if (b == 0) return 0;
  constexpr bool INT8 = std::is_same_v<E, int8_t>;
  int shift = 0;
  while ((1 << shift) < group) ++shift;
  const int qstride = stage_row_words<E>(d);
  const size_t smem = ((size_t)CTA_ROWS * qstride + stage_chunk_words<E>(qstride))
                      * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        accum_bins_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid1((unsigned)(tile_n / LANES), (unsigned)((b + CTA_ROWS - 1) / CTA_ROWS));
  accum_bins_kernel<E><<<grid1, THREADS, smem, s>>>(
      static_cast<const E*>(q), static_cast<const E*>(tiles),
      static_cast<const int32_t*>(bias), static_cast<int32_t*>(rv), static_cast<int32_t*>(ri),
      b, d, tile_n, n, group, shift, qstride);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // The float keys are compared as they are: their low bits are ceded.
  extract_kernel<<<(unsigned)b, THREADS, 0, s>>>(
      static_cast<const int32_t*>(rv), static_cast<const int32_t*>(ri),
      static_cast<int32_t*>(out_v), static_cast<int32_t*>(out_i), tile_n, k, INT8 ? shift : 0);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries for ctypes.  Each launches both passes on `stream`, allocates
// nothing, and returns cudaGetLastError() (0 = launched).  rv / ri are
// [b, tile_n] int32 scratch.  The wrapper guarantees tile_n a multiple of
// 128 up to 2048, group a power of two >= 2 dividing T = n_tiles, and d <=
// 1024 (int8) or <= 320 (float).
// int8: `bias` may be null (no-bias mode).
extern "C" int bruteforce_accum_topk(const void* q, const void* tiles, const void* bias,
                                     void* rv, void* ri, void* out_v, void* out_i, int b,
                                     int d, int tile_n, int n, int k, int group, void* stream) {
  return launch_accum<int8_t>(q, tiles, bias, rv, ri, out_v, out_i, b, d, tile_n, n, k, group,
                              static_cast<cudaStream_t>(stream));
}

// fp32 (bf16 = 0) or bf16 (bf16 = 1) q and tiles, no bias rows; tiles
// 16-byte aligned.  out_v holds the keys (the wrapper decodes them).
extern "C" int bruteforce_accum_topk_f(const void* q, const void* tiles, void* rv, void* ri,
                                       void* out_v, void* out_i, int b, int d, int tile_n,
                                       int n, int k, int group, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_accum<__nv_bfloat16>(q, tiles, nullptr, rv, ri, out_v, out_i, b, d,
                                            tile_n, n, k, group, s)
              : launch_accum<float>(q, tiles, nullptr, rv, ri, out_v, out_i, b, d, tile_n, n,
                                    k, group, s);
}
