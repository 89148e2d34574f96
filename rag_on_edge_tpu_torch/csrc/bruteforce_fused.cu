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
//         = fp32 dot, summed in d order with fused multiply-adds (mode F32)
//         = fp32 dot of bf16 operands on the tensor cores (mode BF16)
//   and then the top-k of the row by (score desc, col asc):
//   - nbins = 0: over all columns (exact);
//   - nbins = 128: over the survivors of each tile of tile_n columns, the
//     two best (score desc, col asc) of every bin col % 128 within the tile.
//   Entries past the last valid score hold the fill value (INT32_MIN or
//   -inf) and an unspecified id.
//
// What bounds it on the H100: multiply-adds.  At the SIFT-1M slice
// (B = 8192, D = 128, N = 1M, int8) the GEMM is 1.07e15 MACs against a
// 128 MB base: about 8,000 MACs per byte read.  With __dp4a (4 MACs per
// instruction, no tensor cores) the instruction rate is the limit, far
// above the 3.35 TB/s of device memory.  The fp32 mode (exact ground truth,
// the fused coarse tier) is bound by fp32 FMAs the same way.  The bf16
// mode (the brute-force index's bf16 pallas engine) runs the tensor cores:
// 2.1 ms at 989 TFLOP/s for [8192, 129] x [129, 1M]; it also streams the
// base from L2 once per 64-row block (33 GB at B = 8192): with the ring the
// binned table leaves room for (six 16 KB stages), that stream, and not the
// tensor cores, sets the pace.
//
// Design of the int8 and fp32 modes (fused_topk_kernel):
// - one CTA of 256 threads per 32 query rows: two row groups of 16 rows x
//   128 lanes, thread = (group, lane), walking all N columns 128 at a time.
//   The query rows stay in shared memory for the whole walk.
// - int8: each [D, 128] chunk is staged transposed, one packed column per
//   lane, and scored with __dp4a, as in K1 (ivf_stage.cuh); fp32: the chunk
//   is staged in slices of 32 d-rows and scored with fmaf.
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
// Design of the bf16 mode (fused_wgmma_kernel, hopper_mma.cuh):
// - one CTA of 160 threads per 64 query rows: one consumer warpgroup and
//   one producer warp.  The rows (zero-padded to a multiple of 16 by the
//   wrapper) are loaded once by TMA and stay in shared memory; the producer
//   streams base_t's [64 d, 128 columns] boxes through a ring (rows past D
//   and columns past N arrive as zeros), and each 128-column chunk is four
//   wgmma.m64n128k16 (bf16 -> f32) a box into 64 registers a thread, one
//   commit group a box, one group in flight.  As in K5's bf16 mode, only
//   wgmma writes the accumulators (scale-d 0 starts a chunk), the selection
//   reads a copy made after the chunk's groups retired, and every box takes
//   four k16 steps: otherwise ptxas serializes the groups (C7520).  The
//   selection does not overlap the warpgroup's next product (that too
//   serializes them); a 64-row block keeps the binned table below in the
//   227 KB a CTA may have.
// - the selection reads the chunk's scores in registers.  Warp w owns rows
//   16w..16w+15 of the block (their top-k lists in shared memory, k <= 32,
//   lane l holding entry l), so no other warp touches them.  Each thread
//   tests its 64 scores against its two rows' k-th values (one compare a
//   score); only a warp holding a passer leaves that path.  Exact mode:
//   each passer is inserted into its row's list by the warp (the count of
//   better entries is its rank; the tail shifts down one lane), ties by
//   (score desc, id asc), so the order of insertion does not matter; the
//   test uses the thresholds of the chunk's start.  Binned mode: a thread
//   owns the same 64 (row, bin) pairs in every chunk, and keeps each
//   pair's two best passers (score, chunk) of the current tile in shared
//   memory (strict >); at the tile's end the warp inserts them.  This is
//   exact: the threshold only moves at tile ends, and a bin's top two among
//   its passers are its top two wherever they pass.
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"
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

enum Mode { I8 = 0, I8_L2 = 1, F32 = 2 };  // 3, bf16: bruteforce_fused_topk_bf16

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
fused_topk_kernel(const void* __restrict__ qv,        // [b, d] int8 or f32
                  const void* __restrict__ basev,     // [d, n] int8 or f32
                  const float* __restrict__ alpha,    // [b] (I8_L2)
                  const float* __restrict__ bias,     // [n] (I8_L2)
                  const int32_t* __restrict__ n_valid,  // [1] or null
                  T* __restrict__ out_v,              // [b, k]
                  int32_t* __restrict__ out_i,        // [b, k]
                  int b, int d, int n, int k, int tile_n, int qstride) {
  const T FILL = fill_of(T());
  constexpr bool FLOAT = MODE == F32;
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
    stage_queries_f<THREADS>(static_cast<const float*>(qv), b, d, cta_r0, CTA_ROWS, qstride,
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
      const float* base = static_cast<const float*>(basev);
      const float* qf = reinterpret_cast<const float*>(q_s) + r0 * qstride;
      float* cf = reinterpret_cast<float*>(col_s);
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
      for (int d0 = 0; d0 < qstride; d0 += DS) {
        for (int i = threadIdx.x; i < DS * LANES; i += THREADS) {
          const int e = d0 + i / LANES, cc = c * LANES + i % LANES;
          cf[i] = (e < d && cc < n) ? base[(size_t)e * n + cc] : 0.0f;
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
  constexpr bool FLOAT = MODE == F32;
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

// ------------------------------------------------- bf16: wgmma fed by TMA

constexpr int G_ROWS = 64;                 // query rows per CTA: one consumer warpgroup
constexpr int G_BN = 128;                  // columns per chunk (one m64n128 fragment)
constexpr int G_THREADS = 160;             // + one producer warp
constexpr int G_BOX = 64 * 128;            // one [64 rows, 64 bf16] swizzled box, 8 KB
constexpr int G_STAGE = 2 * G_BOX;         // [64 d, 128 columns]: two boxes
constexpr int G_STAGES_MAX = 8;
constexpr int G_SMEM_MAX = 232448 - 1024;  // the opt-in limit less the static barriers
constexpr int G_TOPK = G_ROWS * K_MAX;     // entries of the rows' top-k lists
constexpr int G_TABLE = 2 * 64 * 128;      // binned: [slot][entry][thread] of the tile

// Insert (v, id) into one row's top-k list (lane l < k holds entry l, best
// first; ids in it differ from id): the entries better than (v, id) are the
// first `pos`, so the tail from pos shifts down one lane.  Every lane calls it.
__device__ __forceinline__ void insert_row(float* lv, int32_t* li, int k, float v, int id,
                                           int lane) {
  const float cv = lane < k ? lv[lane] : -INFINITY;
  const int ci = lane < k ? li[lane] : INT32_MAX;
  const int pos = __popc(__ballot_sync(FULL, lane < k && better(cv, ci, v, id)));
  const float uv = __shfl_up_sync(FULL, cv, 1);
  const int ui = __shfl_up_sync(FULL, ci, 1);
  if (lane >= pos && lane < k) {
    lv[lane] = lane == pos ? v : uv;
    li[lane] = lane == pos ? id : ui;
  }
  __syncwarp();
}

// q [b, ldq] bf16 (ldq = d rounded up to 16, the pad zero) through `tq`,
// base_t [d, n] at a row pitch of ldb through `tb`; f32 scores out.  CTA i
// takes rows 64 i .. 64 i + 63.  Stage j of the ring holds box j % kb (64
// d-rows) of chunk j / kb.
template <bool BINNED>
__global__ void __launch_bounds__(G_THREADS, 1)
fused_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tb,
                   const int32_t* __restrict__ n_valid, float* __restrict__ out_v,
                   int32_t* __restrict__ out_i, int b, int ldq, int n, int k, int tile_n,
                   int stages) {
  extern __shared__ uint8_t g_smem[];
  __shared__ __align__(8) uint64_t full[G_STAGES_MAX], empty[G_STAGES_MAX], abar;
  const uint32_t base = (smem_u32(g_smem) + 1023u) & ~1023u;
  const int kb = (ldq + 63) / 64;  // 64-d boxes a chunk
  const uint32_t a_s = base, ring = base + kb * G_BOX;
  float* lv = reinterpret_cast<float*>(g_smem + (base - smem_u32(g_smem)) + kb * G_BOX +
                                       stages * G_STAGE);  // [64 rows][K_MAX]
  int32_t* li = reinterpret_cast<int32_t*>(lv + G_TOPK);
  float* tv = reinterpret_cast<float*>(li + G_TOPK);       // binned: scores
  uint8_t* tc = reinterpret_cast<uint8_t*>(tv + G_TABLE);  // binned: chunk in the tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (int)blockIdx.x * G_ROWS;
  const int nchunks = (n + G_BN - 1) / G_BN;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx; the TMA bytes complete it
      mbar_init(&empty[s], 128);  // every consumer thread
    }
    mbar_init(&abar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < G_TOPK; i += G_THREADS) {
    lv[i] = -INFINITY;
    li[i] = 0;
  }
  if (BINNED)
    for (int i = threadIdx.x; i < G_TABLE; i += G_THREADS) tv[i] = -INFINITY;
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      mbar_expect_tx(&abar, kb * G_BOX);
      for (int j = 0; j < kb; ++j) tma_load_2d(a_s + j * G_BOX, &tq, 64 * j, row0, &abar);
      const int total = nchunks * kb;
      for (int q = 0; q < total; ++q) {
        const int s = q % stages, c = q / kb, j = q % kb;
        if (q >= stages) mbar_wait(&empty[s], (unsigned)((q / stages - 1) & 1));
        mbar_expect_tx(&full[s], G_STAGE);
        tma_load_2d(ring + s * G_STAGE, &tb, G_BN * c, 64 * j, &full[s]);
        tma_load_2d(ring + s * G_STAGE + G_BOX, &tb, G_BN * c + 64, 64 * j, &full[s]);
      }
    }
    return;
  }

  // Consumers: fragment entry i of this thread is row rl + 8 h(i), h(i) =
  // (i / 2) % 2, of the block and column 8 (i / 4) + cl + i % 2 of the chunk.
  const int t = threadIdx.x;
  const int rl = 16 * warp + (lane >> 2), cl = 2 * (lane & 3);
  const int n_bound = n_valid != nullptr ? min(*n_valid, n) : n;
  const int tile_chunks = BINNED ? tile_n / G_BN : 1;
  float d[64], e[64];
  float thr[2] = {-INFINITY, -INFINITY};  // the rows' k-th values
  uint64_t dirty = 0;                     // binned: entries with a passer this tile
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;

  // The product of chunk c into d, asynchronously: the chunk's first step
  // starts from zero (scale-d 0), one group a box, and each box released
  // once the next box's group is issued and its own has retired.
  auto issue = [&](int c) {
    for (int j = 0; j < kb; ++j) {
      const int q = c * kb + j, s = q % stages;
      mbar_wait_loop(&full[s], (unsigned)((q / stages) & 1));
      const uint32_t sa = a_s + j * G_BOX, sb = ring + s * G_STAGE;
      fence_acc(d);
      wgmma_fence();
      // A: 128-byte rows, 8-row groups 1 KB apart, a k16 step 32 bytes along
      // the row.  B: 128-byte d rows, a k16 step 16 rows (2 KB), the two
      // 64-column boxes 8 KB apart.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k16(d, gmma_desc(sa + kk * 32, 16, 1024),
                         gmma_desc(sb + kk * 2048, G_BOX, 1024), j + kk);
      wgmma_commit();
      fence_acc(d);
      wgmma_wait<1>();
      fence_acc(d);
      if (j > 0) mbar_arrive(&empty[(q - 1) % stages]);
    }
  };
  // Chunk c's product is done: release its last box and copy it to e.
  auto retire = [&](int c) {
    wgmma_wait<0>();
    fence_acc(d);
    mbar_arrive(&empty[(c * kb + kb - 1) % stages]);
    copy_acc(d, e);
  };
  // The selection of chunk c from its copy e.  Entry i passes when above
  // its row's threshold and before n_bound (columns past it hold the fill
  // value).
  auto select = [&](int c) {
    const int col0 = c * G_BN, lim = n_bound - col0;
    auto passes = [&](int i) {
      return e[i] > thr[(i / 2) % 2] && 8 * (i / 4) + cl + i % 2 < lim;
    };
    bool any = false;
#pragma unroll
    for (int i = 0; i < 64; ++i) any |= passes(i);
    if (__any_sync(FULL, any)) {
      if constexpr (!BINNED) {
        // Every passer against the chunk's starting thresholds, inserted by
        // the warp; the insertion itself decides, so a tie stays exact.
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          unsigned m = __ballot_sync(FULL, passes(i));
          while (m) {
            const int src = __ffs(m) - 1;
            m &= m - 1;
            const float v = __shfl_sync(FULL, e[i], src);
            const int r = 16 * warp + (src >> 2) + 8 * ((i / 2) % 2);
            insert_row(lv + r * K_MAX, li + r * K_MAX, k, v,
                       col0 + 8 * (i / 4) + 2 * (src & 3) + i % 2, lane);
          }
        }
        thr[0] = lv[rl * K_MAX + k - 1];
        thr[1] = lv[(rl + 8) * K_MAX + k - 1];
      } else {
        const uint8_t cidx = (uint8_t)(c % tile_chunks);
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (passes(i)) {
            const int e0 = i * 128 + t, e1 = (64 + i) * 128 + t;
            const float v0 = tv[e0];
            if (e[i] > v0) {  // strict: an equal, later score lands behind
              tv[e1] = v0;
              tc[e1] = tc[e0];
              tv[e0] = e[i];
              tc[e0] = cidx;
            } else if (e[i] > tv[e1]) {
              tv[e1] = e[i];
              tc[e1] = cidx;
            }
            dirty |= 1ull << i;
          }
      }
    }
    if (BINNED && ((c + 1) % tile_chunks == 0 || c == nchunks - 1)) {
      // The tile's end: insert every pair's survivors, one at a time.
      const int tile0 = (c / tile_chunks) * tile_n;
      for (;;) {
        const unsigned m = __ballot_sync(FULL, dirty != 0);
        if (m == 0) break;
        const int src = __ffs(m) - 1;
        int i = 0, c0 = 0, c1 = 0;
        float v0 = 0.0f, v1 = 0.0f;
        if (lane == src) {
          i = __ffsll((long long)dirty) - 1;
          dirty &= dirty - 1;
          const int e0 = i * 128 + t, e1 = (64 + i) * 128 + t;
          v0 = tv[e0];
          v1 = tv[e1];
          c0 = tc[e0];
          c1 = tc[e1];
          tv[e0] = tv[e1] = -INFINITY;
        }
        i = __shfl_sync(FULL, i, src);
        v0 = __shfl_sync(FULL, v0, src);
        v1 = __shfl_sync(FULL, v1, src);
        c0 = __shfl_sync(FULL, c0, src);
        c1 = __shfl_sync(FULL, c1, src);
        const int r = 16 * warp + (src >> 2) + 8 * ((i / 2) % 2);
        const int cb = tile0 + 8 * (i / 4) + 2 * (src & 3) + i % 2;
        insert_row(lv + r * K_MAX, li + r * K_MAX, k, v0, cb + G_BN * c0, lane);
        if (v1 > -INFINITY) insert_row(lv + r * K_MAX, li + r * K_MAX, k, v1, cb + G_BN * c1, lane);
      }
      thr[0] = lv[rl * K_MAX + k - 1];
      thr[1] = lv[(rl + 8) * K_MAX + k - 1];
    }
  };

  // Per chunk: the product, then the selection from its copy (a selection
  // beside the next chunk's product has ptxas serialize the groups).
  mbar_wait_loop(&abar, 0);
  for (int c = 0; c < nchunks; ++c) {
    issue(c);
    retire(c);
    select(c);
  }

  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + 16 * warp + r;
    if (row < b && lane < k) {
      out_v[(size_t)row * k + lane] = lv[(16 * warp + r) * K_MAX + lane];
      out_i[(size_t)row * k + lane] = li[(16 * warp + r) * K_MAX + lane];
    }
  }
}

template <bool BINNED>
int launch_wgmma(const void* q, const void* base, const void* n_valid, void* out_v,
                 void* out_i, int b, int d, int ldq, int n, int ldb, int k, int tile_n,
                 cudaStream_t stream) {
  static const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tb;
  if (const int e = bf16_map(encode, &tq, q, b, ldq, ldq, G_ROWS)) return e;
  if (const int e = bf16_map(encode, &tb, base, d, n, ldb, 64)) return e;
  const int kb = (ldq + 63) / 64;
  const int fixed = 1024 + kb * G_BOX + 2 * G_TOPK * 4 + (BINNED ? G_TABLE * 5 : 0);
  const int stages = min(G_STAGES_MAX, (G_SMEM_MAX - fixed) / G_STAGE);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = fixed + stages * G_STAGE;
  if (const cudaError_t e = cudaFuncSetAttribute(
          fused_wgmma_kernel<BINNED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return (int)e;
  fused_wgmma_kernel<BINNED><<<(unsigned)((b + G_ROWS - 1) / G_ROWS), G_THREADS, smem, stream>>>(
      tq, tb, static_cast<const int32_t*>(n_valid), static_cast<float*>(out_v),
      static_cast<int32_t*>(out_i), b, ldq, n, k, tile_n, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry for ctypes.  Launches on `stream`, allocates nothing, and returns
// cudaGetLastError() (0 = launched).  mode: 0 int8 (int32 out), 1 int8 L2
// (alpha [b], bias [n]; f32 out), 2 fp32 (q and base_t both fp32; f32 out);
// mode 3, bf16, has its own entry below.  `n_valid` may be null.
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
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 mode (3): q [b, ldq] bf16 with ldq = d rounded up to a multiple
// of 16 (the pad zero), base_t [d, n] bf16 at a row pitch of ldb elements
// (a multiple of 8), both 16-byte aligned; f32 out.  Same guarantees as
// above; `n_valid` may be null.
extern "C" int bruteforce_fused_topk_bf16(const void* q, const void* base_t, const void* n_valid,
                                          void* out_v, void* out_i, int b, int d, int ldq, int n,
                                          int ldb, int k, int tile_n, int nbins, void* stream) {
  if (b == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return nbins != 0 ? launch_wgmma<true>(q, base_t, n_valid, out_v, out_i, b, d, ldq, n, ldb, k,
                                         tile_n, s)
                    : launch_wgmma<false>(q, base_t, n_valid, out_v, out_i, b, d, ldq, n, ldb,
                                          k, tile_n, s);
}
