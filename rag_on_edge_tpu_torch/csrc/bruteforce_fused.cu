// Kernel K3 of the brute-force search: a streaming [B, D] x [D, N] score GEMM
// with a running per-row top-k, so the [B, N] score matrix never exists.
//
// Replaces the TPU kernel rag_on_edge_tpu/ops/pallas_bruteforce.py,
// fused_topk_matmul (its _kernel, with _extract_topk and binned_top2).
//
// What it computes, for each query row r and base column col < n_bound
// (n_bound = min(*n_valid, n), or n):
//   score = int32 dot(q[r], base_t[:, col])                      (mode I8)
//         = float(dot) * alpha[r] - bias[col], rounded once       (mode I8_L2)
//         = fp32 dot, summed in d order with fused multiply-adds (mode F32;
//           mode BF16 the same on bf16 operands widened to fp32, exact)
//   and then the top-k of the row by (score desc, col asc):
//   - nbins = 0: over all columns (exact);
//   - nbins = 128: over the survivors of each tile of tile_n columns, the
//     two best (score desc, col asc) of every bin col % 128 within the tile.
//   Entries past the last valid score hold the fill value (INT32_MIN or
//   -inf) and an unspecified id.
//
// What bounds it on the H100: integer multiply-adds.  At the SIFT-1M slice
// (B = 8192, D = 128, N = 1M, int8) the GEMM is 1.07e15 MACs against a
// 128 MB base: about 8,000 MACs per byte read.  With __dp4a (4 MACs per
// instruction, no tensor cores) the instruction rate is the limit, far
// above the 3.35 TB/s of device memory.  The fp32 mode (exact ground truth,
// the fused coarse tier) and the bf16 mode (the brute-force index's bf16
// pallas engine) are bound by fp32 FMAs the same way.
//
// Design (simple first; wgmma and TMA are later work):
// - one CTA of 256 threads per 32 query rows: two row groups of 16 rows x
//   128 lanes, thread = (group, lane), walking all N columns 128 at a time.
//   The query rows stay in shared memory for the whole walk.
// - int8: each [D, 128] chunk is staged transposed, one packed column per
//   lane, and scored with __dp4a, as in K1 (ivf_stage.cuh); fp32 and bf16:
//   the chunk is staged as fp32 in slices of 32 d-rows (bf16 widened on
//   load) and scored with fmaf.
// - selection by threshold: each row's running top-k (k <= 32) sits in
//   shared memory, and each thread keeps the row's k-th value in a
//   register.  Only a score above it can enter (an equal one comes from a
//   later column, a higher id, and loses), so it is appended to the row's
//   candidate buffer (256 entries; a warp-aggregated atomicAdd).  Once a
//   buffer may overflow on the next chunk, one warp per row merges it into
//   the top-k: k passes of a warp argmax by (score desc, id asc) with
//   shuffles, as in K4.  After the first chunks the threshold is high and
//   few scores pass it.  This per-row test is the per-row form of the TPU
//   kernel's `improves` skip.
// - binned: each thread keeps, per row, its bin's two best (score, chunk)
//   of the current tile in registers (strict >, so an equal, later score
//   lands behind); at the tile's end the survivors above the threshold go
//   to the buffer and are merged.  tile_n is the JAX wrapper's, so the same
//   candidates survive; the walk itself is 128 columns at a time.
// - I8_L2 scores are one __fmaf_rn(dot, alpha, -bias): XLA contracts the
//   JAX kernel's `dots * alpha - bias` into a fused multiply-add, and the
//   plain version rounds once too, so the scores are bit-equal to both.
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "ivf_stage.cuh"

namespace {

constexpr int LANES = 128;               // columns per chunk: one per lane of a row group
constexpr int ROWS = 16;                 // query rows per row group
constexpr int GROUPS = 2;                // row groups per CTA
constexpr int THREADS = LANES * GROUPS;
constexpr int WARPS = THREADS / 32;
constexpr int CTA_ROWS = ROWS * GROUPS;
constexpr int K_MAX = 32;                // running top-k width in shared memory
constexpr int BUF = 2 * LANES;           // candidate buffer per row: one tile's bin survivors
constexpr int PER_LANE = BUF / 32;
constexpr int DS = 32;                   // fp32 d-rows staged per slice
constexpr unsigned FULL = 0xffffffffu;

enum Mode { I8 = 0, I8_L2 = 1, F32 = 2, BF16 = 3 };

__device__ __forceinline__ int32_t fill_of(int32_t) { return INT32_MIN; }
__device__ __forceinline__ float fill_of(float) { return -INFINITY; }

// (v, i) ranks before (bv, bi): larger score, then lower id.
template <typename T>
__device__ __forceinline__ bool better(T v, int i, T bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Stage columns col0..col0+127 of the int8 base_t [d, n] (row stride n) as
// one packed column per lane (word j holds d-rows 4j..4j+3), zero past d
// and past n.  Full, word-aligned chunks take K1's coalesced staging.
__device__ void stage_chunk_i8(const int8_t* __restrict__ base, int d, int n, int col0,
                               int qstride, int32_t* col_s, int cstride) {
  if (col0 + LANES <= n && (n & 3) == 0) {
    stage_chunk<THREADS>(base + col0, d, n, qstride, col_s, cstride);
    return;
  }
  for (int task = threadIdx.x; task < LANES * qstride; task += THREADS) {
    const int l = task % LANES, j = task / LANES, col = col0 + l;
    uint32_t w = 0;
    if (col < n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 4 * j + i;
        if (e < d) w |= (uint32_t)(uint8_t)base[(size_t)e * n + col] << (8 * i);
      }
    }
    col_s[l * cstride + j] = (int32_t)w;
  }
}

// Merge each row's candidate buffer into its running top-k: one warp per
// row, k passes of a warp argmax by (score desc, id asc).  Candidate ids
// are fresh columns, so a winner is removed by (value, id).  Clears the
// row's count.
template <typename T>
__device__ void merge_rows(T* run_v, int32_t* run_i, const T* buf_v, const int32_t* buf_i,
                           int* cnt, int k) {
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  const T FILL = fill_of(T());
  for (int rr = warp; rr < CTA_ROWS; rr += WARPS) {
    const int c = cnt[rr];
    if (c == 0) continue;  // uniform in the warp
    T* sv = run_v + rr * K_MAX;
    int32_t* si = run_i + rr * K_MAX;
    T cv[PER_LANE];
    int ci[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int e = i * 32 + wl;
      cv[i] = e < c ? buf_v[rr * BUF + e] : FILL;
      ci[i] = e < c ? buf_i[rr * BUF + e] : INT32_MAX;
    }
    T ov = wl < k ? sv[wl] : FILL;
    int oi = wl < k ? si[wl] : INT32_MAX;
    __syncwarp();
    for (int p = 0; p < k; ++p) {
      T bv = ov;
      int bi = oi;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i)
        if (better(cv[i], ci[i], bv, bi)) {
          bv = cv[i];
          bi = ci[i];
        }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const T v2 = __shfl_xor_sync(FULL, bv, off);
        const int i2 = __shfl_xor_sync(FULL, bi, off);
        if (better(v2, i2, bv, bi)) {
          bv = v2;
          bi = i2;
        }
      }
      // Only fill left: slots p.. of the old state held fill already (any
      // real entry would have won first).  bv is the same in every lane.
      if (bv == FILL) break;
      if (wl == 0) {
        sv[p] = bv;
        si[p] = bi;
      }
      if (ov == bv && oi == bi) ov = FILL;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i)
        if (cv[i] == bv && ci[i] == bi) cv[i] = FILL;
    }
    __syncwarp();
    if (wl == 0) cnt[rr] = 0;
  }
}

// Append `push` entries (v, id) of the lanes of one warp to row rr's
// buffer with one atomicAdd per warp; sets *flag once the buffer could
// overflow on the next chunk.  Every lane of the warp calls it.
template <typename T>
__device__ __forceinline__ void push_warp(bool push, T v, int id, int rr, T* buf_v,
                                          int32_t* buf_i, int* cnt, int* flag) {
  const unsigned m = __ballot_sync(FULL, push);
  if (m == 0) return;
  const int wl = threadIdx.x % 32, leader = __ffs(m) - 1;
  int base = 0;
  if (wl == leader) {
    base = atomicAdd(&cnt[rr], __popc(m));
    if (base + __popc(m) > BUF - LANES) *flag = 1;
  }
  base = __shfl_sync(FULL, base, leader);
  if (push) {
    const int slot = base + __popc(m & ((1u << wl) - 1u));
    buf_v[rr * BUF + slot] = v;
    buf_i[rr * BUF + slot] = id;
  }
}

// Two CTAs per SM: without the cap the binned L2 variant takes 188
// registers a thread and runs one CTA per SM, 1.5x slower at B = 8192.
template <typename T, int MODE, bool BINNED>
__global__ void __launch_bounds__(THREADS, 2)
fused_topk_kernel(const void* __restrict__ qv,        // [b, d] int8, f32 or bf16
                  const void* __restrict__ basev,     // [d, n] int8, f32 or bf16
                  const float* __restrict__ alpha,    // [b] (I8_L2)
                  const float* __restrict__ bias,     // [n] (I8_L2)
                  const int32_t* __restrict__ n_valid,  // [1] or null
                  T* __restrict__ out_v,              // [b, k]
                  int32_t* __restrict__ out_i,        // [b, k]
                  int b, int d, int n, int k, int tile_n, int qstride) {
  const T FILL = fill_of(T());
  constexpr bool FLOAT = MODE == F32 || MODE == BF16;
  using TIn = std::conditional_t<MODE == BF16, __nv_bfloat16, float>;  // float modes' operands
  const int lane = threadIdx.x % LANES;
  const int group = threadIdx.x / LANES;
  const int cta_r0 = blockIdx.x * CTA_ROWS;
  const int r0 = group * ROWS;  // this group's first row within the CTA

  extern __shared__ int4 smem4[];
  T* run_v = reinterpret_cast<T*>(smem4);                          // [CTA_ROWS][K_MAX]
  int32_t* run_i = reinterpret_cast<int32_t*>(run_v + CTA_ROWS * K_MAX);
  T* buf_v = reinterpret_cast<T*>(run_i + CTA_ROWS * K_MAX);       // [CTA_ROWS][BUF]
  int32_t* buf_i = reinterpret_cast<int32_t*>(buf_v + CTA_ROWS * BUF);
  int* cnt = reinterpret_cast<int*>(buf_i + CTA_ROWS * BUF);        // [CTA_ROWS]
  int* flag = cnt + CTA_ROWS;                                       // [4] (keeps 16-byte alignment)
  int32_t* q_s = flag + 4;                 // int8: [CTA_ROWS][qstride] words; f32: floats
  int32_t* col_s = q_s + CTA_ROWS * qstride;  // int8: [LANES][qstride+1] words; f32: [DS][LANES]
  const int cstride = qstride + 1;

  for (int i = threadIdx.x; i < CTA_ROWS * K_MAX; i += THREADS) {
    run_v[i] = FILL;
    run_i[i] = 0;
  }
  if (threadIdx.x < CTA_ROWS) cnt[threadIdx.x] = 0;
  if (threadIdx.x == 0) *flag = 0;
  if constexpr (FLOAT) {
    stage_queries_f<THREADS>(static_cast<const TIn*>(qv), b, d, cta_r0, CTA_ROWS, qstride,
                             reinterpret_cast<float*>(q_s));
  } else {
    stage_queries<THREADS>(static_cast<const int8_t*>(qv), b, d, cta_r0, CTA_ROWS, qstride,
                           reinterpret_cast<int8_t*>(q_s));
  }

  float al[ROWS];
  T thr[ROWS];
  bool live[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = cta_r0 + r0 + r;
    live[r] = row < b;
    al[r] = (MODE == I8_L2 && live[r]) ? alpha[row] : 1.0f;
    thr[r] = FILL;
  }
  T tv[BINNED ? ROWS : 1][2];
  int tc[BINNED ? ROWS : 1][2];
  if constexpr (BINNED) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      tv[r][0] = tv[r][1] = FILL;
      tc[r][0] = tc[r][1] = 0;
    }
  }

  const int n_bound = n_valid != nullptr ? min(*n_valid, n) : n;
  const int nchunks = (n + LANES - 1) / LANES;
  const int tile_chunks = tile_n / LANES;

  for (int c = 0; c < nchunks; ++c) {
    const int col = c * LANES + lane;
    T x[ROWS];
    if constexpr (FLOAT) {
      const TIn* base = static_cast<const TIn*>(basev);
      const float* qf = reinterpret_cast<const float*>(q_s) + r0 * qstride;
      float* cf = reinterpret_cast<float*>(col_s);
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
      for (int d0 = 0; d0 < qstride; d0 += DS) {
        for (int i = threadIdx.x; i < DS * LANES; i += THREADS) {
          const int e = d0 + i / LANES, cc = c * LANES + i % LANES;
          cf[i] = (e < d && cc < n) ? widen(base[(size_t)e * n + cc]) : 0.0f;
        }
        __syncthreads();
        const int lim = min(DS, qstride - d0);
        for (int i = 0; i < lim; i += 4) {
          const float c0 = cf[i * LANES + lane], c1 = cf[(i + 1) * LANES + lane];
          const float c2 = cf[(i + 2) * LANES + lane], c3 = cf[(i + 3) * LANES + lane];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float4 q4 = *reinterpret_cast<const float4*>(qf + r * qstride + d0 + i);
            acc[r] = fmaf(q4.x, c0, acc[r]);
            acc[r] = fmaf(q4.y, c1, acc[r]);
            acc[r] = fmaf(q4.z, c2, acc[r]);
            acc[r] = fmaf(q4.w, c3, acc[r]);
          }
        }
        __syncthreads();  // the slice is restaged next
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) x[r] = (T)acc[r];
    } else {
      stage_chunk_i8(static_cast<const int8_t*>(basev), d, n, c * LANES, qstride, col_s,
                     cstride);
      __syncthreads();
      int32_t acc[ROWS];
      dot_rows<ROWS>(col_s + lane * cstride, q_s + r0 * qstride, qstride, acc);
      const float bc = (MODE == I8_L2 && col < n) ? bias[col] : 0.0f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if constexpr (MODE == I8_L2)
          x[r] = (T)__fmaf_rn(__int2float_rn(acc[r]), al[r], -bc);
        else
          x[r] = (T)acc[r];
      }
    }
    const bool valid = col < n_bound;

    bool merge;
    if constexpr (BINNED) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const T v = valid ? x[r] : FILL;
        if (v > tv[r][0]) {
          tv[r][1] = tv[r][0];
          tc[r][1] = tc[r][0];
          tv[r][0] = v;
          tc[r][0] = c;
        } else if (v > tv[r][1]) {
          tv[r][1] = v;
          tc[r][1] = c;
        }
      }
      merge = (c + 1) % tile_chunks == 0 || c == nchunks - 1;  // the tile's end
      if (merge) {
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            push_warp(live[r] && tv[r][j] > thr[r], tv[r][j], tc[r][j] * LANES + lane,
                      r0 + r, buf_v, buf_i, cnt, flag);
            tv[r][j] = FILL;
            tc[r][j] = 0;
          }
      }
      __syncthreads();
    } else {
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        push_warp(live[r] && valid && x[r] > thr[r], x[r], col, r0 + r, buf_v, buf_i, cnt,
                  flag);
      __syncthreads();
      merge = *flag != 0 || c == nchunks - 1;
    }
    if (merge) {  // uniform in the CTA
      merge_rows(run_v, run_i, buf_v, buf_i, cnt, k);
      __syncthreads();
      if (threadIdx.x == 0) *flag = 0;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) thr[r] = run_v[(r0 + r) * K_MAX + k - 1];
    }
  }

  for (int i = threadIdx.x; i < CTA_ROWS * k; i += THREADS) {
    const int r = i / k, p = i % k;
    if (cta_r0 + r >= b) continue;
    out_v[(size_t)(cta_r0 + r) * k + p] = run_v[r * K_MAX + p];
    out_i[(size_t)(cta_r0 + r) * k + p] = run_i[r * K_MAX + p];
  }
}

template <typename T, int MODE, bool BINNED>
int launch(const void* q, const void* base, const void* alpha, const void* bias,
           const void* n_valid, void* out_v, void* out_i, int b, int d, int n, int k,
           int tile_n, cudaStream_t stream) {
  // Words (int8: 4 dims) or floats per staged query row, a multiple of 4.
  constexpr bool FLOAT = MODE == F32 || MODE == BF16;
  const int qstride = FLOAT ? (d + 3) / 4 * 4 : ((d + 3) / 4 + 3) / 4 * 4;
  const size_t col = FLOAT ? (size_t)DS * LANES : (size_t)LANES * (qstride + 1);
  const size_t smem = ((size_t)CTA_ROWS * (K_MAX + BUF) * 2 + CTA_ROWS + 4
                       + (size_t)CTA_ROWS * qstride + col) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(fused_topk_kernel<T, MODE, BINNED>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((b + CTA_ROWS - 1) / CTA_ROWS));
  fused_topk_kernel<T, MODE, BINNED><<<grid, THREADS, smem, stream>>>(
      q, base, static_cast<const float*>(alpha), static_cast<const float*>(bias),
      static_cast<const int32_t*>(n_valid), static_cast<T*>(out_v),
      static_cast<int32_t*>(out_i), b, d, n, k, tile_n, qstride);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int launch_binned(bool binned, const void* q, const void* base, const void* alpha,
                  const void* bias, const void* n_valid, void* out_v, void* out_i, int b,
                  int d, int n, int k, int tile_n, cudaStream_t s) {
  return binned ? launch<T, MODE, true>(q, base, alpha, bias, n_valid, out_v, out_i, b, d, n,
                                        k, tile_n, s)
                : launch<T, MODE, false>(q, base, alpha, bias, n_valid, out_v, out_i, b, d,
                                         n, k, tile_n, s);
}

}  // namespace

// C entry for ctypes.  Launches on `stream`, allocates nothing, and returns
// cudaGetLastError() (0 = launched).  mode: 0 int8 (int32 out), 1 int8 L2
// (alpha [b], bias [n]; f32 out), 2 fp32 and 3 bf16 (q and base_t both of
// that type; f32 out).  `n_valid` may be null.
// The wrapper guarantees 1 <= k <= 32, k <= n, nbins 0 or 128, tile_n a
// multiple of 128, and d <= 512.
extern "C" int bruteforce_fused_topk(const void* q, const void* base_t, const void* alpha,
                                     const void* bias, const void* n_valid, void* out_v,
                                     void* out_i, int b, int d, int n, int k, int tile_n,
                                     int nbins, int mode, void* stream) {
  if (b == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool binned = nbins != 0;
  switch (mode) {
    case I8: return launch_binned<int32_t, I8>(binned, q, base_t, alpha, bias, n_valid, out_v,
                                               out_i, b, d, n, k, tile_n, s);
    case I8_L2: return launch_binned<float, I8_L2>(binned, q, base_t, alpha, bias, n_valid,
                                                   out_v, out_i, b, d, n, k, tile_n, s);
    case F32: return launch_binned<float, F32>(binned, q, base_t, alpha, bias, n_valid, out_v,
                                               out_i, b, d, n, k, tile_n, s);
    case BF16: return launch_binned<float, BF16>(binned, q, base_t, alpha, bias, n_valid,
                                                 out_v, out_i, b, d, n, k, tile_n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
