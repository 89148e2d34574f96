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
// 128 MB base: about 8,000 MACs per byte read.  The int8 and bf16 modes run
// the tensor cores (1.1 ms at 1,979 T int8 ops/s; 2.1 ms at 989 bf16
// TFLOP/s for [8192, 129] x [129, 1M]); each also streams the base from L2
// once per 64-row block (16 GB int8, 33 GB bf16 at B = 8192) through the
// TMA ring the binned table leaves room for, and runs its selection after
// each chunk's product on the same warpgroup: those, and not the tensor
// cores, set the pace.  The fp32 mode (exact ground truth, the fused coarse
// tier) is bound by fp32 FMAs.
//
// Design of the fp32 mode (fused_topk_kernel):
// - one CTA of 256 threads per 32 query rows: two row groups of 16 rows x
//   128 lanes, thread = (group, lane), walking all N columns 128 at a time.
//   The query rows stay in shared memory for the whole walk; the chunk is
//   staged in slices of 32 d-rows and scored with fmaf.
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
// Design of the bf16 and int8 modes (fused_wgmma_kernel, hopper_mma.cuh):
// - one CTA of 160 threads per 64 query rows: one consumer warpgroup and
//   one producer warp.  The rows (zero-padded to a multiple of 16 by the
//   wrapper) are loaded once by TMA and stay in shared memory; the producer
//   streams the base through a ring of 16 KB stages, one [128 d, 128
//   columns] chunk of 128 bytes of d a stage (rows past D and columns past
//   N arrive as zeros): bf16 two [64 d, 64 columns] boxes of base_t as it
//   lies, N-contiguous (wgmma's transpose bit); int8 one [128 columns, 128
//   d] box of the wrapper's K-major copy [N, ldq] (8-bit wgmma operands
//   have no transpose bit: the wrapper transposes base_t with one torch copy
//   a call, ~0.4 ms at SIFT-1M on the H100 (_build.kmajor, PERF.md section
//   6), and keeps no second copy).  Each 128-column
//   chunk is four wgmma a stage into 64 registers a thread (bf16
//   m64n128k16 -> f32, int8 m64n128k32 s8 -> s32), one commit group a stage,
//   one group in flight.  Only wgmma writes the accumulators (scale-d 0
//   starts a chunk), the selection reads a copy made after the chunk's
//   groups retired, and every stage takes four k-steps: otherwise ptxas
//   serializes the groups (C7520).  The selection does not overlap the
//   warpgroup's next product (that too serializes them); a 64-row block
//   keeps the binned table below in the 227 KB a CTA may have.
// - I8_L2 scores are one __fmaf_rn(float(dot), alpha, -bias): XLA contracts
//   the JAX kernel's `dots * alpha - bias` into a fused multiply-add, and
//   the plain version rounds once too, so the scores are bit-equal to both.
//   The chunk's 128 bias words ride in the stage of its last box (one more
//   TMA box on the same barrier); the copy is converted in place, then the
//   stage is released.  I8 compares the int32 sums themselves.
// - the selection reads the chunk's scores in registers.  Warp w owns rows
//   16w..16w+15 of the block (their top-k lists in shared memory, k <= 32,
//   lane l holding entry l), so no other warp touches them.  Each thread
//   tests its two rows' maxima (a tree of its 32 scores each) against their
//   k-th values; only a warp holding a passer leaves that path, and there
//   eight groups of eight scores are tested, a group without a passer
//   costing one branch.  The chunk is one warpgroup's work between two
//   products, and each of its four warps gates the next product, so this
//   path and the ring's stage and parity (counters, no division) are kept
//   short: they, not the tensor cores, set the pace.  Exact mode:
//   each passer is inserted into its row's list by the warp (the count of
//   better entries is its rank; the tail shifts down one lane), ties by
//   (score desc, id asc), so the order of insertion does not matter; the
//   test uses the thresholds of the chunk's start.  Binned mode: a thread
//   owns the same 64 (row, bin) pairs in every chunk, and keeps each
//   pair's two best passers (score, chunk) of the current tile in shared
//   memory (strict >; the chunk in 16 bits, so a tile walks up to 65536
//   chunks); at the tile's end the warp inserts them.  This is
//   exact: the threshold only moves at tile ends, and a bin's top two among
//   its passers are its top two wherever they pass.
// - ring depth: the ring takes as many 16 KB stages as fit beside the
//   binned table.  An int8 stage holds a whole 128-d chunk, so at D = 128 the
//   ring holds six chunks (bf16: five stages, 1.7 chunks at D = 129); two
//   int8 stages ran within a few percent of seven (PERF.md section 7).
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

__device__ __forceinline__ int32_t fill_of(int32_t) { return INT32_MIN; }
__device__ __forceinline__ float fill_of(float) { return -INFINITY; }

// (v, i) ranks before (bv, bi): larger score, then lower id.
template <typename T>
__device__ __forceinline__ bool better(T v, int i, T bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Merge each row's candidate buffer into its running top-k: one warp per
// row, k passes of a warp argmax by (score desc, id asc).  Candidate ids
// are fresh columns, so a winner is removed by (value, id).  Clears the
// row's count.
__device__ void merge_rows(float* run_v, int32_t* run_i, const float* buf_v,
                           const int32_t* buf_i, int* cnt, int k) {
  using T = float;
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  const T FILL = -INFINITY;
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
__device__ __forceinline__ void push_warp(bool push, float v, int id, int rr, float* buf_v,
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

// Two CTAs per SM: the cap keeps the binned variant at two CTAs an SM.
template <bool BINNED>
__global__ void __launch_bounds__(THREADS, 2)
fused_topk_kernel(const float* __restrict__ q,           // [b, d]
                  const float* __restrict__ base,        // [d, n]
                  const int32_t* __restrict__ n_valid,   // [1] or null
                  float* __restrict__ out_v,             // [b, k]
                  int32_t* __restrict__ out_i,           // [b, k]
                  int b, int d, int n, int k, int tile_n, int qstride) {
  const float FILL = -INFINITY;
  const int lane = threadIdx.x % LANES;
  const int group = threadIdx.x / LANES;
  const int cta_r0 = blockIdx.x * CTA_ROWS;
  const int r0 = group * ROWS;  // this group's first row within the CTA

  extern __shared__ int4 smem4[];
  float* run_v = reinterpret_cast<float*>(smem4);                  // [CTA_ROWS][K_MAX]
  int32_t* run_i = reinterpret_cast<int32_t*>(run_v + CTA_ROWS * K_MAX);
  float* buf_v = reinterpret_cast<float*>(run_i + CTA_ROWS * K_MAX);  // [CTA_ROWS][BUF]
  int32_t* buf_i = reinterpret_cast<int32_t*>(buf_v + CTA_ROWS * BUF);
  int* cnt = reinterpret_cast<int*>(buf_i + CTA_ROWS * BUF);        // [CTA_ROWS]
  int* flag = cnt + CTA_ROWS;                                       // [4] (keeps 16-byte alignment)
  float* q_s = reinterpret_cast<float*>(flag + 4);                  // [CTA_ROWS][qstride]
  float* cf = q_s + CTA_ROWS * qstride;                             // [DS][LANES]

  for (int i = threadIdx.x; i < CTA_ROWS * K_MAX; i += THREADS) {
    run_v[i] = FILL;
    run_i[i] = 0;
  }
  if (threadIdx.x < CTA_ROWS) cnt[threadIdx.x] = 0;
  if (threadIdx.x == 0) *flag = 0;
  stage_queries_f<THREADS>(q, b, d, cta_r0, CTA_ROWS, qstride, q_s);

  float thr[ROWS];
  bool live[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    live[r] = cta_r0 + r0 + r < b;
    thr[r] = FILL;
  }
  float tv[BINNED ? ROWS : 1][2];
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
    float x[ROWS];
    const float* qf = q_s + r0 * qstride;
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
    for (int r = 0; r < ROWS; ++r) x[r] = acc[r];
    const bool valid = col < n_bound;

    bool merge;
    if constexpr (BINNED) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float v = valid ? x[r] : FILL;
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

template <bool BINNED>
int launch_f32(const void* q, const void* base, const void* n_valid, void* out_v, void* out_i,
               int b, int d, int n, int k, int tile_n, cudaStream_t stream) {
  // Floats per staged query row, a multiple of 4.
  const int qstride = (d + 3) / 4 * 4;
  const size_t smem = ((size_t)CTA_ROWS * (K_MAX + BUF) * 2 + CTA_ROWS + 4
                       + (size_t)CTA_ROWS * qstride + (size_t)DS * LANES) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(fused_topk_kernel<BINNED>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((b + CTA_ROWS - 1) / CTA_ROWS));
  fused_topk_kernel<BINNED><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(base),
      static_cast<const int32_t*>(n_valid), static_cast<float*>(out_v),
      static_cast<int32_t*>(out_i), b, d, n, k, tile_n, qstride);
  return (int)cudaGetLastError();
}

// ---------------------------------------- bf16 and int8: wgmma fed by TMA

enum GMode { G_BF16 = 0, G_I8 = 1, G_I8_L2 = 2 };

constexpr int G_ROWS = 64;                 // query rows per CTA: one consumer warpgroup
constexpr int G_BN = 128;                  // columns per chunk (one m64n128 fragment)
constexpr int G_THREADS = 160;             // + one producer warp
constexpr int G_BOX = 64 * 128;            // one [64 rows, 128 bytes] swizzled box, 8 KB
constexpr int G_STAGE = 2 * G_BOX;         // bf16 [64 d, 128 columns]; int8 [128 columns, 128 d]
constexpr int G_BIAS = G_BN * 4;           // int8 L2: a chunk's 128 bias words
constexpr int G_STAGES_BF16 = 8;
constexpr int G_STAGES_MAX = 16;
constexpr int G_SMEM_MAX = 232448 - 1024;  // the opt-in limit less the static barriers
constexpr int G_TOPK = G_ROWS * K_MAX;     // entries of the rows' top-k lists
constexpr int G_TABLE = 2 * 64 * 128;      // binned: [slot][entry][thread] of the tile
constexpr int G_TABLE_BYTES = G_TABLE * 6; // a 4-byte score and a 2-byte chunk an entry

// Insert (v, id) into one row's top-k list (lane l < k holds entry l, best
// first; ids in it differ from id): the entries better than (v, id) are the
// first `pos`, so the tail from pos shifts down one lane.  Every lane calls it.
template <typename T>
__device__ __forceinline__ void insert_row(T* lv, int32_t* li, int k, T v, int id, int lane) {
  const T cv = lane < k ? lv[lane] : fill_of(T());
  const int ci = lane < k ? li[lane] : INT32_MAX;
  const int pos = __popc(__ballot_sync(FULL, lane < k && better(cv, ci, v, id)));
  const T uv = __shfl_up_sync(FULL, cv, 1);
  const int ui = __shfl_up_sync(FULL, ci, 1);
  if (lane >= pos && lane < k) {
    lv[lane] = lane == pos ? v : uv;
    li[lane] = lane == pos ? id : ui;
  }
  __syncwarp();
}

// q [b, ldq] (ldq = d rounded up to 16, the pad zero) through `tq`.  bf16:
// base_t [d, n] at a row pitch of ldb through `tb`, f32 scores out; int8:
// the K-major base [n, ldq] through `tb`, (L2) alpha [b] and the bias [n]
// through `tbias`, int32 (I8) or f32 (I8_L2) scores out.  CTA i takes rows
// 64 i .. 64 i + 63.  The ring holds the chunks' 128-byte boxes in turn
// (kb a chunk: 64 d in bf16, 128 in int8); producer and consumers keep its
// stage and round parity in counters, so no step divides.
template <int MODE, bool BINNED>
__global__ void __launch_bounds__(G_THREADS, 1)
fused_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tb,
                   const __grid_constant__ CUtensorMap tbias, const int32_t* __restrict__ n_valid,
                   const float* __restrict__ alpha, void* __restrict__ out_vv,
                   int32_t* __restrict__ out_i, int b, int ldq, int n, int k, int tile_n,
                   int stages) {
  using Acc = std::conditional_t<MODE == G_BF16, float, int32_t>;  // the fragment
  using T = std::conditional_t<MODE == G_I8, int32_t, float>;      // the scores
  constexpr bool BIAS = MODE == G_I8_L2;
  constexpr int KD = MODE == G_BF16 ? 64 : 128;  // d a box
  const T FILL = fill_of(T());
  extern __shared__ uint8_t g_smem[];
  __shared__ __align__(8) uint64_t full[G_STAGES_MAX], empty[G_STAGES_MAX], abar;
  const uint32_t base = (smem_u32(g_smem) + 1023u) & ~1023u;
  const int kb = (ldq + KD - 1) / KD;  // boxes a chunk
  const uint32_t a_s = base, ring = base + kb * G_BOX;
  T* lv = reinterpret_cast<T*>(g_smem + (base - smem_u32(g_smem)) + kb * G_BOX +
                               stages * G_STAGE);  // [64 rows][K_MAX]
  int32_t* li = reinterpret_cast<int32_t*>(lv + G_TOPK);
  T* tv = reinterpret_cast<T*>(li + G_TOPK);               // binned: scores
  uint16_t* tc = reinterpret_cast<uint16_t*>(tv + G_TABLE);  // binned: chunk in the tile
  float* bias_w = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(li + G_TOPK) +
                                           (BINNED ? G_TABLE_BYTES : 0));  // L2: [stages][128]
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
    lv[i] = FILL;
    li[i] = 0;
  }
  if (BINNED)
    for (int i = threadIdx.x; i < G_TABLE; i += G_THREADS) tv[i] = FILL;
  __syncthreads();

  if (warp == 4) {  // producer
    if (lane == 0) {
      mbar_expect_tx(&abar, kb * G_BOX);
      for (int j = 0; j < kb; ++j) tma_load_2d(a_s + j * G_BOX, &tq, KD * j, row0, &abar);
      int s = 0;          // the stage, and the parity of its round, of the next box
      unsigned ph = 0;
      bool wrapped = false;
      for (int c = 0; c < nchunks; ++c)
        for (int j = 0; j < kb; ++j) {
          if (wrapped) mbar_wait(&empty[s], ph ^ 1u);
          const bool with_bias = BIAS && j == kb - 1;
          mbar_expect_tx(&full[s], G_STAGE + (with_bias ? G_BIAS : 0));
          if constexpr (MODE == G_BF16) {
            tma_load_2d(ring + s * G_STAGE, &tb, G_BN * c, 64 * j, &full[s]);
            tma_load_2d(ring + s * G_STAGE + G_BOX, &tb, G_BN * c + 64, 64 * j, &full[s]);
          } else {
            tma_load_2d(ring + s * G_STAGE, &tb, 128 * j, G_BN * c, &full[s]);
          }
          if (with_bias)
            tma_load_2d(smem_u32(bias_w + s * G_BN), &tbias, G_BN * c, 0, &full[s]);
          if (++s == stages) {
            s = 0;
            ph ^= 1u;
            wrapped = true;
          }
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
  Acc d[64], e[64];
  T thr[2] = {FILL, FILL};  // the rows' k-th values
  float al[2] = {0.0f, 0.0f};
  if constexpr (BIAS) {
    if (row0 + rl < b) al[0] = alpha[row0 + rl];
    if (row0 + rl + 8 < b) al[1] = alpha[row0 + rl + 8];
  }
  uint64_t dirty = 0;                     // binned: entries with a passer this tile
  int cpos = 0, tile0 = 0;                // binned: the chunk's place in its tile, the tile
  int rs = 0, last_s = 0;                 // the ring: the next box's stage, the last box's
  unsigned rph = 0;                       // the parity of the next box's round
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;

  // The product of chunk c into d, asynchronously: the chunk's first step
  // starts from zero (scale-d 0), one group a box, and each box released
  // once the next box's group is issued and its own has retired.
  auto issue = [&]() {
    for (int j = 0; j < kb; ++j) {
      const int s = rs;
      mbar_wait_loop(&full[s], rph);
      const uint32_t sa = a_s + j * G_BOX, sb = ring + s * G_STAGE;
      fence_acc(d);
      wgmma_fence();
      // A: 128-byte rows, 8-row groups 1 KB apart, a k-step 32 bytes along
      // the row.  B: bf16 128-byte d rows, a k16 step 16 rows (2 KB), the
      // two 64-column boxes 8 KB apart; int8 K-major like A, 128-byte column
      // rows, a k32 step 32 bytes along them.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (MODE == G_BF16)
          wgmma_m64n128k16(d, gmma_desc(sa + kk * 32, 16, 1024),
                           gmma_desc(sb + kk * 2048, G_BOX, 1024), j + kk);
        else
          wgmma_m64n128k32_s8(d, gmma_desc(sa + kk * 32, 16, 1024),
                              gmma_desc(sb + kk * 32, 16, 1024), j + kk);
      }
      wgmma_commit();
      fence_acc(d);
      wgmma_wait<1>();
      fence_acc(d);
      if (j > 0) mbar_arrive(&empty[last_s]);
      last_s = s;
      if (++rs == stages) {
        rs = 0;
        rph ^= 1u;
      }
    }
  };
  // The chunk's product is done: release its last box and copy it to e
  // (I8_L2: converted to scores in place, with the bias words in that box's
  // stage, before the release).
  auto retire = [&]() {
    wgmma_wait<0>();
    fence_acc(d);
    if constexpr (!BIAS) mbar_arrive(&empty[last_s]);
    copy_acc(d, e);
    if constexpr (BIAS) {
      const float* bw = bias_w + last_s * G_BN;
#pragma unroll
      for (int i = 0; i < 64; ++i)
        e[i] = __float_as_int(__fmaf_rn(__int2float_rn(e[i]), al[(i / 2) % 2],
                                        -bw[8 * (i / 4) + cl + i % 2]));
      mbar_arrive(&empty[last_s]);
    }
  };
  // Score i of the copy: I8_L2 converted in place by `retire`.
  auto val = [&](int i) -> T {
    if constexpr (BIAS)
      return __int_as_float(e[i]);
    else
      return e[i];
  };
  // The max of row h's 32 scores in this thread, as a tree.
  auto row_max = [&](int h) {
    T m[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) m[q] = max(val(4 * q + 2 * h), val(4 * q + 2 * h + 1));
#pragma unroll
    for (int q = 0; q < 8; ++q) m[q] = max(m[q], m[q + 8]);
#pragma unroll
    for (int q = 0; q < 4; ++q) m[q] = max(m[q], m[q + 4]);
    return max(max(m[0], m[2]), max(m[1], m[3]));
  };
  // The selection of chunk c from its copy e.  Entry i passes when above
  // its row's threshold and before n_bound (columns past it hold the fill
  // value).  A whole chunk first tests each row's max; only a warp with a
  // passer goes on.
  auto select = [&](int c) {
    const int col0 = c * G_BN, lim = n_bound - col0;
    auto passes = [&](int i) {
      return val(i) > thr[(i / 2) % 2] && 8 * (i / 4) + cl + i % 2 < lim;
    };
    bool any = false;
    if (lim >= G_BN) {
      any = row_max(0) > thr[0] || row_max(1) > thr[1];
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) any |= passes(i);
    }
    if (__any_sync(FULL, any)) {
      // Eight groups of eight entries; a group without a passer in the warp
      // (exact) or the thread (binned) costs its tests and one branch.
#pragma unroll
      for (int g = 0; g < 64; g += 8) {
        bool pg = false;
#pragma unroll
        for (int i = g; i < g + 8; ++i) pg |= passes(i);
        if constexpr (!BINNED) {
          // Every passer against the chunk's starting thresholds, inserted
          // by the warp; the insertion itself decides, so a tie stays exact.
          if (!__any_sync(FULL, pg)) continue;
#pragma unroll
          for (int i = g; i < g + 8; ++i) {
            unsigned m = __ballot_sync(FULL, passes(i));
            while (m) {
              const int src = __ffs(m) - 1;
              m &= m - 1;
              const T v = __shfl_sync(FULL, val(i), src);
              const int r = 16 * warp + (src >> 2) + 8 * ((i / 2) % 2);
              insert_row(lv + r * K_MAX, li + r * K_MAX, k, v,
                         col0 + 8 * (i / 4) + 2 * (src & 3) + i % 2, lane);
            }
          }
        } else {
          if (!pg) continue;
          const uint16_t cidx = (uint16_t)cpos;
#pragma unroll
          for (int i = g; i < g + 8; ++i)
            if (passes(i)) {
              const int e0 = i * 128 + t, e1 = (64 + i) * 128 + t;
              const T v0 = tv[e0];
              if (val(i) > v0) {  // strict: an equal, later score lands behind
                tv[e1] = v0;
                tc[e1] = tc[e0];
                tv[e0] = val(i);
                tc[e0] = cidx;
              } else if (val(i) > tv[e1]) {
                tv[e1] = val(i);
                tc[e1] = cidx;
              }
              dirty |= 1ull << i;
            }
        }
      }
      if constexpr (!BINNED) {
        thr[0] = lv[rl * K_MAX + k - 1];
        thr[1] = lv[(rl + 8) * K_MAX + k - 1];
      }
    }
    if (BINNED && (++cpos == tile_chunks || c == nchunks - 1)) {
      // The tile's end: insert every pair's survivors, one at a time.
      for (;;) {
        const unsigned m = __ballot_sync(FULL, dirty != 0);
        if (m == 0) break;
        const int src = __ffs(m) - 1;
        int i = 0, c0 = 0, c1 = 0;
        T v0 = 0, v1 = 0;
        if (lane == src) {
          i = __ffsll((long long)dirty) - 1;
          dirty &= dirty - 1;
          const int e0 = i * 128 + t, e1 = (64 + i) * 128 + t;
          v0 = tv[e0];
          v1 = tv[e1];
          c0 = tc[e0];
          c1 = tc[e1];
          tv[e0] = tv[e1] = FILL;
        }
        i = __shfl_sync(FULL, i, src);
        v0 = __shfl_sync(FULL, v0, src);
        v1 = __shfl_sync(FULL, v1, src);
        c0 = __shfl_sync(FULL, c0, src);
        c1 = __shfl_sync(FULL, c1, src);
        const int r = 16 * warp + (src >> 2) + 8 * ((i / 2) % 2);
        const int cb = tile0 + 8 * (i / 4) + 2 * (src & 3) + i % 2;
        insert_row(lv + r * K_MAX, li + r * K_MAX, k, v0, cb + G_BN * c0, lane);
        if (v1 > FILL) insert_row(lv + r * K_MAX, li + r * K_MAX, k, v1, cb + G_BN * c1, lane);
      }
      thr[0] = lv[rl * K_MAX + k - 1];
      thr[1] = lv[(rl + 8) * K_MAX + k - 1];
      cpos = 0;
      tile0 += tile_n;
    }
  };

  // Per chunk: the product, then the selection from its copy (a selection
  // beside the next chunk's product has ptxas serialize the groups: C7515).
  mbar_wait_loop(&abar, 0);
  for (int c = 0; c < nchunks; ++c) {
    issue();
    retire();
    select(c);
  }

  __syncwarp();
  T* out_v = static_cast<T*>(out_vv);
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + 16 * warp + r;
    if (row < b && lane < k) {
      out_v[(size_t)row * k + lane] = lv[(16 * warp + r) * K_MAX + lane];
      out_i[(size_t)row * k + lane] = li[(16 * warp + r) * K_MAX + lane];
    }
  }
}

// bf16: base_t [d, n] at a row pitch of ldb.  int8: the K-major base [n,
// ldq], alpha [b] and bias [n] (I8_L2) or null.  The ring takes as many
// stages as fit.
template <int MODE, bool BINNED>
int launch_wgmma(const void* q, const void* base, const void* alpha, const void* bias,
                 const void* n_valid, void* out_v, void* out_i, int b, int d, int ldq, int n,
                 int ldb, int k, int tile_n, cudaStream_t stream) {
  static const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  constexpr int KD = MODE == G_BF16 ? 64 : 128;
  CUtensorMap tq, tb, tbias{};
  if constexpr (MODE == G_BF16) {
    if (const int e = bf16_map(encode, &tq, q, b, ldq, ldq, G_ROWS)) return e;
    if (const int e = bf16_map(encode, &tb, base, d, n, ldb, 64)) return e;
  } else {
    if (const int e = int8_map(encode, &tq, q, b, ldq, ldq, G_ROWS)) return e;
    if (const int e = int8_map(encode, &tb, base, n, ldq, ldq, G_BN)) return e;
    if (MODE == G_I8_L2)
      if (const int e = word_map(encode, &tbias, bias, 1, n, G_BN)) return e;
  }
  const int kb = (ldq + KD - 1) / KD;
  const int fixed = 1024 + kb * G_BOX + 2 * G_TOPK * 4 + (BINNED ? G_TABLE_BYTES : 0);
  const int per_stage = G_STAGE + (MODE == G_I8_L2 ? G_BIAS : 0);
  const int cap = MODE == G_BF16 ? G_STAGES_BF16 : G_STAGES_MAX;
  const int stages = min(cap, (G_SMEM_MAX - fixed) / per_stage);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = fixed + stages * per_stage;
  if (const cudaError_t e = cudaFuncSetAttribute(
          fused_wgmma_kernel<MODE, BINNED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return (int)e;
  fused_wgmma_kernel<MODE, BINNED>
      <<<(unsigned)((b + G_ROWS - 1) / G_ROWS), G_THREADS, smem, stream>>>(
          tq, tb, tbias, static_cast<const int32_t*>(n_valid), static_cast<const float*>(alpha),
          out_v, static_cast<int32_t*>(out_i), b, ldq, n, k, tile_n, stages);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_wgmma_binned(bool binned, const void* q, const void* base, const void* alpha,
                        const void* bias, const void* n_valid, void* out_v, void* out_i, int b,
                        int d, int ldq, int n, int ldb, int k, int tile_n, cudaStream_t s) {
  return binned ? launch_wgmma<MODE, true>(q, base, alpha, bias, n_valid, out_v, out_i, b, d, ldq,
                                           n, ldb, k, tile_n, s)
                : launch_wgmma<MODE, false>(q, base, alpha, bias, n_valid, out_v, out_i, b, d,
                                            ldq, n, ldb, k, tile_n, s);
}

}  // namespace

// C entries for ctypes.  Each launches on `stream`, allocates nothing, and
// returns cudaGetLastError() (0 = launched).  `n_valid` may be null.  The
// wrapper guarantees 1 <= k <= 32, k <= n, nbins 0 or 128, tile_n a
// multiple of 128 (binned int8 and bf16: a tile walks at most 65536 chunks
// of 128), and
// d <= 512.

// fp32: q [b, d] and base_t [d, n] fp32; f32 out.
extern "C" int bruteforce_fused_topk_f32(const void* q, const void* base_t, const void* n_valid,
                                         void* out_v, void* out_i, int b, int d, int n, int k,
                                         int tile_n, int nbins, void* stream) {
  if (b == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return nbins != 0 ? launch_f32<true>(q, base_t, n_valid, out_v, out_i, b, d, n, k, tile_n, s)
                    : launch_f32<false>(q, base_t, n_valid, out_v, out_i, b, d, n, k, tile_n, s);
}

// int8: q [b, ldq] and the K-major base [n, ldq] with ldq = d rounded up
// to a multiple of 16 (the pad zero), both 16-byte aligned; alpha [b] and
// bias [n] (16-byte aligned) for L2, f32 out, or both null, int32 out.
extern "C" int bruteforce_fused_topk_i8(const void* q, const void* base_k, const void* alpha,
                                        const void* bias, const void* n_valid, void* out_v,
                                        void* out_i, int b, int ldq, int n, int k, int tile_n,
                                        int nbins, void* stream) {
  if (b == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bias != nullptr
             ? launch_wgmma_binned<G_I8_L2>(nbins != 0, q, base_k, alpha, bias, n_valid, out_v,
                                            out_i, b, ldq, ldq, n, ldq, k, tile_n, s)
             : launch_wgmma_binned<G_I8>(nbins != 0, q, base_k, nullptr, nullptr, n_valid, out_v,
                                         out_i, b, ldq, ldq, n, ldq, k, tile_n, s);
}

// The bf16 mode: q [b, ldq] bf16 with ldq = d rounded up to a multiple of
// 16 (the pad zero), base_t [d, n] bf16 at a row pitch of ldb elements (a
// multiple of 8), both 16-byte aligned; f32 out.
extern "C" int bruteforce_fused_topk_bf16(const void* q, const void* base_t, const void* n_valid,
                                          void* out_v, void* out_i, int b, int d, int ldq, int n,
                                          int ldb, int k, int tile_n, int nbins, void* stream) {
  if (b == 0) return 0;
  return launch_wgmma_binned<G_BF16>(nbins != 0, q, base_t, nullptr, nullptr, n_valid, out_v,
                                     out_i, b, d, ldq, n, ldb, k, tile_n,
                                     static_cast<cudaStream_t>(stream));
}
