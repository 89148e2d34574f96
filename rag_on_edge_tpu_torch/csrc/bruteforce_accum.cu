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
// What bounds it on the H100: multiply-adds.  B = 8192, D = 128, N = 1M is
// 1.07e12 MACs against a 128 MB base (int8; 256 MB in bf16).  int8 runs
// __dp4a (no tensor cores) and fp32 fp32 FMAs (32 ms at the 67 TFLOP/s
// peak); bf16 runs the tensor cores (2.1 ms at 989 TFLOP/s) and streams the
// base from L2 once per 192-row block (11 GB at B = 8192).  The fold and the
// final top-k add a few instructions per score and a round trip of the
// per-bin state.
//
// Design of the int8 and fp32 modes (accum_bins_kernel):
// - pass 1: one CTA of 256 threads per (32 query rows, 128 bins): two row
//   groups of 16 rows x 128 lanes, thread = (group, bin).  It walks every
//   tile holding a valid column, staging the tile's [D, 128] chunk at its
//   bins transposed in shared memory and scoring it with __dp4a (K1's
//   staging and dot loop, ivf_stage.cuh).  The group accumulator and the
//   bin's running key and column live in registers (3 x 16 ints a thread),
//   so no CTA needs another's state; it writes the running keys and
//   columns, [B, tile_n] each.  Padded tiles are skipped (their keys would
//   all be KMIN).  fp32: the same walk with K1's float stage (query rows
//   and chunk as fp32, fmaf in d order).
// Design of the bf16 mode (accum_wgmma_kernel, hopper_mma.cuh):
// - pass 1: one CTA of 416 threads per (192 query rows, 64 bins): three
//   consumer warpgroups of 64 rows and one producer warp.  The CTA's query
//   rows (zero-padded to a multiple of 16 by the wrapper) are loaded once
//   by TMA and stay in shared memory.  The producer streams each live
//   tile's [D, 64] slab through a ring of [64 d, 64 bins] boxes with a 3-D
//   tensor map over [T, D, tile_n], so the d tail past D arrives as zeros
//   and never as the next tile's rows.  Each warpgroup runs four
//   wgmma.m64n64k16 (bf16 -> f32) a box, one commit group a box, keeping
//   one group in flight, then folds the tile.  CTAs take row blocks
//   fastest, so those in flight walk the same bin slice and the base is
//   read from device memory about once; three warpgroups (not two) cut the
//   L2 traffic by a third and ran faster.
// - what keeps the wgmma groups asynchronous (ptxas serializes them, C7520,
//   on any of these): only wgmma writes the accumulators (a tile's first
//   step has scale-d 0); the fold reads a copy made by explicit moves after
//   the last group retired, never the fragment, and never beside the
//   warpgroup's next product; every box takes four k16 steps (the tail
//   past ldq is TMA's zeros), so no wgmma sits in a loop of varying count.
// - the fold, one level instead of two: the group max followed by the
//   strict merge keeps, for each bin, the first tile whose key with its low
//   log2(group) bits cleared is largest; so does one running (key, tile)
//   replaced only by a strictly larger cleared key, tiles in order.  Its
//   test is one float compare a score: cleared(monotone(d)) > rv holds
//   exactly when d > key_to_f32(rv | low), the state each thread keeps (and
//   the tile), 2 x 32 registers for its 32 (row, bin) pairs, updated
//   without a branch.  Scores are finite; an exact-zero dot is +0, as the
//   plain fp32 product gives it.
// - pass 2: one CTA of 256 threads per row takes the exact top-k over the
//   row's tile_n bins: 8 bins a thread in registers, k passes of a CTA
//   argmax by (value desc, column asc) with warp shuffles and one shared-
//   memory step.  Ties go to the lowest column, not the lowest position,
//   so K2 (lowest position) is not used.
// - keys are built on the unsigned bit pattern: (u32)dot << shift is
//   defined for negative dots and gives the bits of JAX's shift_left.
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"
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

// E: the element type, int8_t, or float (the fp32 mode, with no bias rows).
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

// ------------------------------------------------- bf16: wgmma fed by TMA

constexpr int W_BN = 64;                  // bins per CTA (one m64n64 fragment)
constexpr int W_WGS = 3;                  // consumer warpgroups, 64 query rows each
constexpr int W_ROWS = 64 * W_WGS;        // query rows per CTA
constexpr int W_THREADS = 128 * W_WGS + 32;  // + one producer warp
constexpr int W_BOX = 64 * 128;           // one [64 rows, 64 bf16] swizzled box, 8 KB
constexpr int W_A_BOX = W_ROWS * 128;     // the CTA's rows x 64 d of the queries
constexpr int W_STAGES_MAX = 16;
constexpr int W_SMEM_MAX = 232448 - 1024; // the opt-in limit less the static barriers

// Pass 1 of the bf16 mode.  q [b, ldq] bf16 (ldq = d rounded up to 16, the
// pad zero) through `tq`; tiles [T, d, tile_n] through the 3-D map `tt`.
// CTA i takes row block i % nrb and bins 64 (i / nrb) .. + 63.  Stage j of
// the ring holds the [64 d, 64 bins] box j % kb of tile j / kb.
__global__ void __launch_bounds__(W_THREADS, 1)
accum_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tt,
                   int32_t* __restrict__ rv_out, int32_t* __restrict__ ri_out, int b, int ldq,
                   int tile_n, int n, int low, int nrb, int stages) {
  extern __shared__ uint8_t w_smem[];
  __shared__ __align__(8) uint64_t full[W_STAGES_MAX], empty[W_STAGES_MAX], abar;
  const uint32_t base = (smem_u32(w_smem) + 1023u) & ~1023u;
  const int kb = (ldq + 63) / 64;            // 64-d boxes a tile
  const uint32_t a_s = base, ring = base + kb * W_A_BOX;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rb = (int)(blockIdx.x % nrb), bin0 = (int)(blockIdx.x / nrb) * W_BN;
  const int t_live = (n + tile_n - 1) / tile_n;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);                // the producer's expect_tx; the TMA bytes
      mbar_init(&empty[s], 128 * W_WGS);     // every consumer thread
    }
    mbar_init(&abar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * W_WGS) {  // producer
    if (lane == 0) {
      mbar_expect_tx(&abar, kb * W_A_BOX);
      for (int j = 0; j < kb; ++j) tma_load_2d(a_s + j * W_A_BOX, &tq, 64 * j, rb * W_ROWS, &abar);
      const int total = t_live * kb;
      for (int j = 0; j < total; ++j) {
        const int s = j % stages;
        if (j >= stages) mbar_wait(&empty[s], (unsigned)((j / stages - 1) & 1));
        mbar_expect_tx(&full[s], W_BOX);
        tma_load_3d(ring + s * W_BOX, &tt, bin0, 64 * (j % kb), j / kb, &full[s]);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the block; this
  // thread's fragment entry i is (row rl + 8 ((i / 2) % 2), bin cl + 8 (i / 4)
  // + i % 2).
  const int wg = warp >> 2;
  const int rl = 16 * (warp & 3) + (lane >> 2), cl = 2 * (lane & 3);
  float d[32], e[32], thr[32];
  int ti[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    d[i] = 0.0f;
    thr[i] = -INFINITY;  // nothing yet: every finite score improves
    ti[i] = -1;
  }
  const uint32_t lowu = (uint32_t)low;

  // The product of tile t into d, asynchronously: the tile's first step
  // starts from zero (scale-d 0), one group a box, and each box released
  // once the next box's group is issued and its own has retired.
  auto issue = [&](int t) {
    for (int j = 0; j < kb; ++j) {
      const int q = t * kb + j, s = q % stages;
      mbar_wait_loop(&full[s], (unsigned)((q / stages) & 1));
      const uint32_t sa = a_s + j * W_A_BOX + wg * 64 * 128, sb = ring + s * W_BOX;
      fence_acc(d);
      wgmma_fence();
      // A: 128-byte rows, 8-row groups 1 KB apart, a k16 step 32 bytes along
      // the row.  B: 128-byte d rows, a k16 step 16 rows (2 KB).
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16(d, gmma_desc(sa + kk * 32, 16, 1024),
                        gmma_desc(sb + kk * 2048, W_BOX, 1024), j + kk);
      wgmma_commit();
      fence_acc(d);
      wgmma_wait<1>();
      fence_acc(d);
      if (j > 0) mbar_arrive(&empty[(q - 1) % stages]);
    }
  };
  // Tile t's product is done: release its last box and copy it to e.
  auto retire = [&](int t) {
    wgmma_wait<0>();
    fence_acc(d);
    mbar_arrive(&empty[(t * kb + kb - 1) % stages]);
    copy_acc(d, e);
  };
  // The fold, branch-free: a score improves its bin when above thr; then
  // thr = key_to_f32(monotone(s) | low), which is s's bits with the low
  // bits set (s >= +0) or cleared (s < 0).  Bins at or past `lim` (the last
  // tile's columns past n) never improve.
  auto fold = [&](int t, int lim) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool up = e[i] > thr[i] && cl + 8 * (i / 4) + (i % 2) < lim;
      const uint32_t bits = __float_as_uint(e[i]);
      const uint32_t nt = (bits | lowu) ^ ((uint32_t)((int32_t)bits >> 31) & lowu);
      thr[i] = up ? __uint_as_float(nt) : thr[i];
      ti[i] = up ? t : ti[i];
    }
  };

  // Per tile: the product, then the fold of its copy (a fold beside the
  // same warpgroup's next product has ptxas serialize the groups).
  mbar_wait_loop(&abar, 0);
  for (int t = 0; t < t_live; ++t) {
    issue(t);
    retire(t);
    fold(t, t < t_live - 1 ? W_BN : n - t * tile_n - bin0);
  }

  const int row0 = rb * W_ROWS + wg * 64 + rl;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = row0 + 8 * ((i / 2) % 2), bin = bin0 + cl + 8 * (i / 4);
    if (row >= b) continue;
    int2 v, c;
    v.x = ti[i] >= 0 ? (int32_t)((uint32_t)monotone_key(thr[i]) & ~lowu) : KMIN;
    v.y = ti[i + 1] >= 0 ? (int32_t)((uint32_t)monotone_key(thr[i + 1]) & ~lowu) : KMIN;
    c.x = ti[i] >= 0 ? ti[i] * tile_n + bin : 0;
    c.y = ti[i + 1] >= 0 ? ti[i + 1] * tile_n + bin + 1 : 0;
    *reinterpret_cast<int2*>(rv_out + (size_t)row * tile_n + bin) = v;
    *reinterpret_cast<int2*>(ri_out + (size_t)row * tile_n + bin) = c;
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


int launch_accum_bf16(const void* q, const void* tiles, void* rv, void* ri, void* out_v,
                      void* out_i, int b, int d, int ldq, int tile_n, int n, int k, int group,
                      cudaStream_t s) {
  if (b == 0) return 0;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  static const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const int t_live = (n + tile_n - 1) / tile_n;
  CUtensorMap tq, tt;
  if (const int e = bf16_map(encode, &tq, q, b, ldq, ldq, W_ROWS)) return e;
  if (const int e = bf16_map_3d(encode, &tt, tiles, t_live, d, tile_n, 64)) return e;
  const int kb = (ldq + 63) / 64;
  const int stages = min(W_STAGES_MAX, (W_SMEM_MAX - 1024 - kb * W_A_BOX) / W_BOX);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = 1024 + kb * W_A_BOX + stages * W_BOX;
  if (const cudaError_t e = cudaFuncSetAttribute(
          accum_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return (int)e;
  const int nrb = (b + W_ROWS - 1) / W_ROWS;
  accum_wgmma_kernel<<<(unsigned)(nrb * (tile_n / W_BN)), W_THREADS, smem, s>>>(
      tq, tt, static_cast<int32_t*>(rv), static_cast<int32_t*>(ri), b, ldq, tile_n, n, group - 1,
      nrb, stages);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  extract_kernel<<<(unsigned)b, THREADS, 0, s>>>(
      static_cast<const int32_t*>(rv), static_cast<const int32_t*>(ri),
      static_cast<int32_t*>(out_v), static_cast<int32_t*>(out_i), tile_n, k, 0);
  return (int)cudaGetLastError();
}
}  // namespace

// C entries for ctypes.  Each launches both passes on `stream`, allocates
// nothing, and returns cudaGetLastError() (0 = launched).  rv / ri are
// [b, tile_n] int32 scratch.  The wrapper guarantees tile_n a multiple of
// 128 up to 2048, group a power of two >= 2 dividing T = n_tiles, and d <=
// 1024 (int8) or <= 320 (fp32, bf16).
// int8: `bias` may be null (no-bias mode).
extern "C" int bruteforce_accum_topk(const void* q, const void* tiles, const void* bias,
                                     void* rv, void* ri, void* out_v, void* out_i, int b,
                                     int d, int tile_n, int n, int k, int group, void* stream) {
  return launch_accum<int8_t>(q, tiles, bias, rv, ri, out_v, out_i, b, d, tile_n, n, k, group,
                              static_cast<cudaStream_t>(stream));
}

// fp32 q and tiles, no bias rows; tiles 16-byte aligned.  out_v holds the
// keys (the wrapper decodes them).
extern "C" int bruteforce_accum_topk_f(const void* q, const void* tiles, void* rv, void* ri,
                                       void* out_v, void* out_i, int b, int d, int tile_n,
                                       int n, int k, int group, void* stream) {
  return launch_accum<float>(q, tiles, nullptr, rv, ri, out_v, out_i, b, d, tile_n, n, k, group,
                             static_cast<cudaStream_t>(stream));
}

// bf16: q [b, ldq] with ldq = d rounded up to a multiple of 16 (the pad
// zero), tiles [T, d, tile_n]; both 16-byte aligned.  out_v holds the keys.
extern "C" int bruteforce_accum_topk_bf16(const void* q, const void* tiles, void* rv, void* ri,
                                          void* out_v, void* out_i, int b, int d, int ldq,
                                          int tile_n, int n, int k, int group, void* stream) {
  return launch_accum_bf16(q, tiles, rv, ri, out_v, out_i, b, d, ldq, tile_n, n, k, group,
                           static_cast<cudaStream_t>(stream));
}
