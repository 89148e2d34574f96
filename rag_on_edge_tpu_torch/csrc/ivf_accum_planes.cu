// Kernels K1 and K9 of the IVF search path: the cluster-major fine scan with
// packed accumulation.  K1 (entries ivf_accum_planes_i8 and, for fp32 and
// bf16 slabs, ivf_accum_planes_f) emits per-lane-bin top-2 "planes" of
// packed int32 keys; K9 (entries ivf_accum_extract_i8 and
// ivf_accum_extract_f, at the end of this file) emits an exact top-k per
// routed row.
//
// K1 replaces the TPU kernel rag_on_edge_tpu/ops/pallas_ivf_dma.py,
// cluster_major_accum_planes (its _kernel with planes=True, and _plane_max).
//
// What it computes, for each cluster's LAST block t and each routed query
// row r of that block:
//   key(b, r, col) = dots(b, r, col) * 256 - bias[b, col]          (int8 L2)
//                  | dots(b, r, col) * 256 + ((15 - b % 16) << 4 | col / 128)
//                  | (monotone(fp32 dots) & ~255) + the same pack   (fp32 / bf16)
//   masked to KMIN where col >= rows_valid[b],
//   folded by max over the cluster's blocks b (first block .. t),
//   then per bin (lane = col % 128) the largest key (plane 1) and the
//   largest key different from it (plane 2), written to out[t, r, :].
// Rows of blocks that are not a cluster's last block are not written.
// Float L2 has no bias rows: it rides an augmented dimension (b' = [b,
// -|b|^2/2], q' = [q, 1]) that the index already holds in the slabs.
//
// What bounds it on the H100: multiply-adds.  At the SIFT-1M slice (about
// 1.1K blocks of 2048 rows, 256 routed rows, D = 128) the int8 scan is
// 7.4e10 MACs against 0.3 GB of slabs, about 250 MACs per byte read: with
// dp4a (4 MACs per instruction, no tensor cores) the instruction rate is
// the limit, not the 3.35 TB/s of device memory.  The fp32 mode (D' = 129)
// is 7.9e10 FFMAs against 1.24 GB: the 67 TFLOP/s of fp32 FMAs bound it
// (2.4 ms), over six times the bytes' 0.37 ms.
//
// Design (simple first; wgmma and TMA are later work):
// - one CTA of 256 threads per (last block, 32-row tile of the routed
//   rows): two row groups of 16 rows x 128 lanes that share each staged
//   chunk.  CTAs on other blocks exit at once.  Thread = (group, bin lane).
// - the chunk loop (128 columns at a time) is outside, the cluster's
//   block loop inside it, so the running max over blocks and the two
//   planes stay in registers (3 x 16 ints a thread); the TPU kernel's
//   [qcap, blk] accumulator is never needed.
// - int8: each block's [D, 128] chunk is staged in shared memory
//   transposed, one packed column per lane at an odd word stride (no bank
//   conflicts on the reads), from coalesced 32-bit loads transposed with
//   __byte_perm; the query rows sit beside it and are read as 16-byte
//   broadcasts.  Dot products are __dp4a on packed int8 words, exact in
//   int32.
// - fp32 / bf16: the chunk is staged as fp32, d-row major (lane l reads
//   word e*128 + l), bf16 widened on load, and the query rows as fp32
//   rows of D' rounded up to 4; dot products are one fmaf a dimension in
//   d order.  At D' = 129 a chunk and 32 query rows take 84.5 KB of
//   dynamic shared memory.  The staging and the dot loops are shared with
//   K4 and K5 (ivf_stage.cuh).
// - int8 keys are built on the unsigned bit pattern: (u32)dots << 8 is
//   defined for negative dots and gives the same bits as JAX's shift_left
//   and torch's int32 arithmetic.  The wrapper bounds D so that it never
//   wraps.  Float keys are built from the fp32 bit pattern (monotone_key).
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "ivf_stage.cuh"

namespace {

constexpr int LANES = 128;                   // bin width: threads of one row group
constexpr int ROWS = 16;                     // routed query rows per row group
constexpr int GROUPS = 2;                    // row groups per CTA (share one staged chunk)
constexpr int THREADS = LANES * GROUPS;
constexpr int CODE_MAX = 16;                 // block codes (4 bits)
constexpr int32_t KMIN = -2147483647;        // -(2**31) + 1: invalid entry

// T: int8_t (the int8 modes) or float / __nv_bfloat16 (the float modes,
// with no bias rows).
template <typename T>
__global__ void __launch_bounds__(THREADS)
accum_planes_kernel(const T* __restrict__ qg,              // [nblocks, qcap, d]
                    const T* __restrict__ vec,             // [nblocks, d, blk]
                    const int32_t* __restrict__ block_first,  // [nblocks]
                    const int32_t* __restrict__ block_last,   // [nblocks]
                    const int32_t* __restrict__ rows_valid,   // [nblocks]
                    const int32_t* __restrict__ bias,      // [nblocks, blk] or null (int8)
                    int32_t* __restrict__ out,             // [nblocks, qcap, nplanes*128]
                    int qcap, int d, int blk, int nplanes, int qstride) {
  constexpr bool INT8 = std::is_same_v<T, int8_t>;
  const int t = blockIdx.x;
  if (block_last[t] == 0) return;
  const int lane = threadIdx.x % LANES;
  const int group = threadIdx.x / LANES;
  const int r0 = (blockIdx.y * GROUPS + group) * ROWS;  // this group's first row
  const int cstride = qstride + 1;  // int8: odd word stride, conflict-free column reads

  // Query rows [GROUPS*ROWS][qstride] words (int8: 4 dims a word; float:
  // one fp32 a word), then the chunk (int8: [LANES][cstride] words; float:
  // [qstride][LANES] fp32).
  extern __shared__ int4 smem4[];
  int32_t* q_s = reinterpret_cast<int32_t*>(smem4);
  int32_t* col_s = q_s + GROUPS * ROWS * qstride;
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
      const T* vsrc = vec + (size_t)b * d * blk + c * LANES;
      const T* qsrc = qg + (size_t)b * qcap * d;
      // The routed rows change only with the block: load them once for a
      // one-block cluster, per block otherwise.
      const bool load_q = c == 0 || nb > 1;
      if constexpr (INT8) {
        stage_chunk<THREADS>(vsrc, d, blk, qstride, col_s, cstride);
        if (load_q)
          stage_queries<THREADS>(qsrc, qcap, d, cta_r0, GROUPS * ROWS, qstride,
                                 reinterpret_cast<int8_t*>(q_s));
      } else {
        stage_chunk_f<THREADS>(vsrc, d, blk, qstride, reinterpret_cast<float*>(col_s));
        if (load_q)
          stage_queries_f<THREADS>(qsrc, qcap, d, cta_r0, GROUPS * ROWS, qstride,
                                   reinterpret_cast<float*>(q_s));
      }
      __syncthreads();

      const bool valid = col < rows_valid[b];
      const uint32_t pack = (uint32_t)(((CODE_MAX - 1) - (b & (CODE_MAX - 1))) << 4 | c);
      if constexpr (INT8) {
        int32_t acc[ROWS];
        dot_rows<ROWS>(col_s + lane * cstride, my_q, qstride, acc);
        const uint32_t sub = bias != nullptr ? (uint32_t)bias[(size_t)b * blk + col] : 0u;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const uint32_t shifted = (uint32_t)acc[r] << 8;
          const int32_t key = valid ? (int32_t)(bias != nullptr ? shifted - sub : shifted | pack)
                                    : KMIN;
          m[r] = max(m[r], key);
        }
      } else {
        float acc[ROWS];
        dot_rows_f<ROWS>(reinterpret_cast<const float*>(col_s), lane,
                         reinterpret_cast<const float*>(my_q), qstride, acc);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int32_t key = valid ? (int32_t)(((uint32_t)monotone_key(acc[r]) & ~255u) | pack)
                                    : KMIN;
          m[r] = max(m[r], key);
        }
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

template <typename T>
int launch_planes(const void* qg, const void* vec, const void* block_first,
                  const void* block_last, const void* rows_valid, const void* bias, void* out,
                  int nblocks, int qcap, int d, int blk, int nplanes, cudaStream_t stream) {
  if (nblocks == 0 || qcap == 0) return 0;
  const int qstride = stage_row_words<T>(d);
  const size_t smem =
      ((size_t)GROUPS * ROWS * qstride + stage_chunk_words<T>(qstride)) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(accum_planes_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)nblocks, (unsigned)((qcap + GROUPS * ROWS - 1) / (GROUPS * ROWS)));
  accum_planes_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qg), static_cast<const T*>(vec),
      static_cast<const int32_t*>(block_first), static_cast<const int32_t*>(block_last),
      static_cast<const int32_t*>(rows_valid), static_cast<const int32_t*>(bias),
      static_cast<int32_t*>(out), qcap, d, blk, nplanes, qstride);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries for ctypes.  Each launches on `stream`, allocates nothing, and
// returns cudaGetLastError() (0 = launched).
// int8: `bias` may be null (no-bias mode).
extern "C" int ivf_accum_planes_i8(const void* qg, const void* vec, const void* block_first,
                                   const void* block_last, const void* rows_valid,
                                   const void* bias, void* out, int nblocks, int qcap, int d,
                                   int blk, int nplanes, void* stream) {
  return launch_planes<int8_t>(qg, vec, block_first, block_last, rows_valid, bias, out,
                               nblocks, qcap, d, blk, nplanes, static_cast<cudaStream_t>(stream));
}

// fp32 (bf16 = 0) or bf16 (bf16 = 1) qg and vec, no bias rows; vec 16-byte
// aligned.
extern "C" int ivf_accum_planes_f(const void* qg, const void* vec, const void* block_first,
                                  const void* block_last, const void* rows_valid, void* out,
                                  int nblocks, int qcap, int d, int blk, int nplanes, int bf16,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_planes<__nv_bfloat16>(qg, vec, block_first, block_last, rows_valid,
                                             nullptr, out, nblocks, qcap, d, blk, nplanes, s)
              : launch_planes<float>(qg, vec, block_first, block_last, rows_valid, nullptr,
                                     out, nblocks, qcap, d, blk, nplanes, s);
}

// ---------------------------------------------------------------------------
// Kernel K9: the same scan with the extract emit.
//
// Replaces the TPU kernel rag_on_edge_tpu/ops/pallas_ivf_dma.py,
// cluster_major_accum (its _kernel with planes=False, _binned_packed_top and
// pallas_bruteforce._extract_topk).  It has no production caller in the JAX
// package; its tests and chip_smoke.py drive it.
//
// What it computes, for each cluster's LAST block t and routed row r:
//   key(b, r, col) = dots(b, r, col) * 16 - bias[b, col]             (int8 L2:
//                    the bias rows carry round(norms/alpha) << 4 minus the code)
//                  | dots(b, r, col) * 16 + (15 - b % 16)             (int8, no bias)
//                  | (monotone(fp32 dots) & ~15) + (15 - b % 16)      (fp32 / bf16)
//   masked to KMIN where col >= rows_valid[b] when mask_rows is set,
//   folded by max over the cluster's blocks b (first block .. t);
//   per bin (lane = col % 128) the largest key m1 with the LOWEST chunk
//   holding it, and (two planes) the largest key m2 different from m1 with
//   the lowest chunk holding it;
//   each decoded to (value, row (t - dd)·blk + chunk·128 + lane), dd the
//   block offset behind t that the key's code names, or (KMIN, 0) where m is
//   KMIN; the value is m >> 4 (int8) or the key m itself (float);
//   the exact top-k of those planes·128 candidates by (value desc, row asc),
//   every candidate with the winner's row masked after each pass:
//   out_v[t, r, p] = float(value) (int8) or key_to_f32(value) (float), -inf
//   for KMIN; out_i[t, r, p] = row.
// The float value is the score with its 4 low key bits replaced by the
// block code (JAX pallas_ivf_dma.py:232-240), not the exact score.
// Keys of different chunks can be equal here (K1's keys carry the chunk),
// which is why the chunk ids are tracked.
//
// What bounds it on the H100: the scan is K1's, integer multiply-adds or fp32
// FMAs; the emit adds k warp passes over 256 candidates per routed row of a
// last block.
//
// Design: K1's CTA (256 threads = 2 row groups x 128 lanes, 16 rows each),
// chunk loop outside the block loop, the fold in registers, and K1's int8
// or float stage (the float one takes 84.5 KB of dynamic shared memory at
// D' = 129).  Each lane folds
// its chunks, in increasing order, into (m1, c1, m2, c2): a key above m1
// shifts plane 1 down; a key equal to m1 changes nothing (the lower chunk
// wins, and plane 2 excludes every key equal to m1); a key between m2 and m1
// replaces plane 2.  The decoded candidates go to shared memory (over the
// staging area) and one warp per row takes the top-k with shuffles; once
// only KMIN is left, the argmax by (value, row) is the JAX fill id, so the
// rest of the row repeats it.
namespace {

template <typename T, int NPLANES>
__global__ void __launch_bounds__(THREADS)
accum_extract_kernel(const T* __restrict__ qg,               // [nblocks, qcap, d]
                     const T* __restrict__ vec,              // [nblocks, d, blk]
                     const int32_t* __restrict__ block_first,  // [nblocks]
                     const int32_t* __restrict__ block_last,   // [nblocks]
                     const int32_t* __restrict__ rows_valid,   // [nblocks]
                     const int32_t* __restrict__ bias,       // [nblocks, blk] or null (int8)
                     float* __restrict__ out_v,              // [nblocks, qcap, k]
                     int32_t* __restrict__ out_i,            // [nblocks, qcap, k]
                     int qcap, int d, int blk, int k, int mask_rows, int qstride) {
  constexpr int NCAND = NPLANES * LANES;  // candidates per row
  constexpr int PER_LANE = NCAND / 32;
  constexpr int WARPS = THREADS / 32;
  constexpr unsigned FULL = 0xffffffffu;
  constexpr bool INT8 = std::is_same_v<T, int8_t>;
  const int t = blockIdx.x;
  if (block_last[t] == 0) return;
  const int lane = threadIdx.x % LANES;
  const int group = threadIdx.x / LANES;
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  const int cstride = qstride + 1;

  extern __shared__ int4 smem4[];
  // Query rows [GROUPS*ROWS][qstride] words, then the chunk (int8:
  // [LANES][cstride] words; float: [qstride][LANES] fp32), as K1's.
  int32_t* q_s = reinterpret_cast<int32_t*>(smem4);
  int32_t* col_s = q_s + GROUPS * ROWS * qstride;
  int32_t* cand_v = q_s;                              // [GROUPS*ROWS][NCAND], after the scan
  int32_t* cand_i = q_s + GROUPS * ROWS * NCAND;
  const int32_t* my_q = q_s + group * ROWS * qstride;

  int tb = t;  // the cluster's first block
  while (tb > 0 && block_first[tb] == 0) --tb;
  const int nb = t - tb + 1;
  const int nchunks = blk / LANES;
  const int cta_r0 = blockIdx.y * GROUPS * ROWS;

  int32_t m1[ROWS], m2[ROWS];
  int c1[ROWS], c2[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m1[r] = m2[r] = KMIN;
    c1[r] = c2[r] = 0;
  }

  for (int c = 0; c < nchunks; ++c) {
    const int col = c * LANES + lane;
    int32_t m[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) m[r] = KMIN;

    for (int b = tb; b <= t; ++b) {
      const T* vsrc = vec + (size_t)b * d * blk + c * LANES;
      const T* qsrc = qg + (size_t)b * qcap * d;
      const bool load_q = c == 0 || nb > 1;
      if constexpr (INT8) {
        stage_chunk<THREADS>(vsrc, d, blk, qstride, col_s, cstride);
        if (load_q)
          stage_queries<THREADS>(qsrc, qcap, d, cta_r0, GROUPS * ROWS, qstride,
                                 reinterpret_cast<int8_t*>(q_s));
      } else {
        stage_chunk_f<THREADS>(vsrc, d, blk, qstride, reinterpret_cast<float*>(col_s));
        if (load_q)
          stage_queries_f<THREADS>(qsrc, qcap, d, cta_r0, GROUPS * ROWS, qstride,
                                   reinterpret_cast<float*>(q_s));
      }
      __syncthreads();

      const bool masked = mask_rows != 0 && col >= rows_valid[b];
      const uint32_t code = (uint32_t)((CODE_MAX - 1) - (b & (CODE_MAX - 1)));
      if constexpr (INT8) {
        int32_t acc[ROWS];
        dot_rows<ROWS>(col_s + lane * cstride, my_q, qstride, acc);
        const uint32_t sub = bias != nullptr ? (uint32_t)bias[(size_t)b * blk + col] : 0u;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const uint32_t shifted = (uint32_t)acc[r] << 4;
          const int32_t key = masked ? KMIN
                                     : (int32_t)(bias != nullptr ? shifted - sub : shifted | code);
          m[r] = max(m[r], key);
        }
      } else {
        float acc[ROWS];
        dot_rows_f<ROWS>(reinterpret_cast<const float*>(col_s), lane,
                         reinterpret_cast<const float*>(my_q), qstride, acc);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const int32_t key =
              masked ? KMIN
                     : (int32_t)(((uint32_t)monotone_key(acc[r]) & ~(uint32_t)(CODE_MAX - 1)) | code);
          m[r] = max(m[r], key);
        }
      }
      __syncthreads();  // col_s / q_s are rewritten next
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int32_t x = m[r];
      if (x > m1[r]) {
        m2[r] = m1[r];
        c2[r] = c1[r];
        m1[r] = x;
        c1[r] = c;
      } else if (NPLANES == 2 && x != m1[r] && x > m2[r]) {
        m2[r] = x;
        c2[r] = c;
      }
    }
  }

  // Decode each plane entry to (value, row); the scan area is free (the
  // block loop ended on a barrier).
  const int tl = t & (CODE_MAX - 1);
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int p = 0; p < NPLANES; ++p) {
      const int32_t mk = p == 0 ? m1[r] : m2[r];
      const int cid = p == 0 ? c1[r] : c2[r];
      const int dd = (tl - ((CODE_MAX - 1) - (mk & (CODE_MAX - 1)))) & (CODE_MAX - 1);
      const int o = (group * ROWS + r) * NCAND + p * LANES + lane;
      cand_v[o] = mk == KMIN ? KMIN : (INT8 ? mk >> 4 : mk);
      cand_i[o] = mk == KMIN ? 0 : (t - dd) * blk + cid * LANES + lane;
    }
  __syncthreads();

  // Exact top-k: one warp per row, k passes of a warp argmax by (value desc,
  // row asc); lane p keeps pass p's result.
  for (int rr = warp; rr < GROUPS * ROWS; rr += WARPS) {
    if (cta_r0 + rr >= qcap) continue;
    int32_t cv[PER_LANE];
    int ci[PER_LANE];
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      cv[i] = cand_v[rr * NCAND + i * 32 + wl];
      ci[i] = cand_i[rr * NCAND + i * 32 + wl];
    }
    float ov = -INFINITY;
    int oi = 0;
    for (int p = 0; p < k; ++p) {
      int32_t bv = cv[0];
      int bi = ci[0];
#pragma unroll
      for (int i = 1; i < PER_LANE; ++i)
        if (cv[i] > bv || (cv[i] == bv && ci[i] < bi)) {
          bv = cv[i];
          bi = ci[i];
        }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int32_t v2 = __shfl_xor_sync(FULL, bv, off);
        const int i2 = __shfl_xor_sync(FULL, bi, off);
        if (v2 > bv || (v2 == bv && i2 < bi)) {
          bv = v2;
          bi = i2;
        }
      }
      if (bv == KMIN) {
        // Only KMIN left: every later pass returns the same (KMIN, bi).
        if (wl >= p) {
          ov = -INFINITY;
          oi = bi;
        }
        break;
      }
      if (wl == p) {
        ov = INT8 ? __int2float_rn(bv) : key_to_f32(bv);
        oi = bi;
      }
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i)
        if (ci[i] == bi) cv[i] = KMIN;
    }
    if (wl < k) {
      const size_t o = ((size_t)t * qcap + cta_r0 + rr) * k + wl;
      out_v[o] = ov;
      out_i[o] = oi;
    }
  }
}

template <typename T, int NPLANES>
int launch_extract(const void* qg, const void* vec, const void* block_first,
                   const void* block_last, const void* rows_valid, const void* bias, void* out_v,
                   void* out_i, int nblocks, int qcap, int d, int blk, int k, int mask_rows,
                   cudaStream_t stream) {
  const int qstride = stage_row_words<T>(d);
  const size_t scan =
      ((size_t)GROUPS * ROWS * qstride + stage_chunk_words<T>(qstride)) * sizeof(int32_t);
  const size_t cand = (size_t)GROUPS * ROWS * NPLANES * LANES * 2 * sizeof(int32_t);
  const size_t smem = scan > cand ? scan : cand;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(accum_extract_kernel<T, NPLANES>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)nblocks, (unsigned)((qcap + GROUPS * ROWS - 1) / (GROUPS * ROWS)));
  accum_extract_kernel<T, NPLANES><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qg), static_cast<const T*>(vec),
      static_cast<const int32_t*>(block_first), static_cast<const int32_t*>(block_last),
      static_cast<const int32_t*>(rows_valid), static_cast<const int32_t*>(bias),
      static_cast<float*>(out_v), static_cast<int32_t*>(out_i), qcap, d, blk, k, mask_rows,
      qstride);
  return (int)cudaGetLastError();
}

template <typename T>
int extract(const void* qg, const void* vec, const void* block_first, const void* block_last,
            const void* rows_valid, const void* bias, void* out_v, void* out_i, int nblocks,
            int qcap, int d, int blk, int k, int nplanes, int mask_rows, void* stream) {
  if (nblocks == 0 || qcap == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nplanes == 2)
    return launch_extract<T, 2>(qg, vec, block_first, block_last, rows_valid, bias, out_v, out_i,
                                nblocks, qcap, d, blk, k, mask_rows, s);
  if (nplanes == 1)
    return launch_extract<T, 1>(qg, vec, block_first, block_last, rows_valid, bias, out_v, out_i,
                                nblocks, qcap, d, blk, k, mask_rows, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entries for ctypes.  Each launches on `stream`, allocates nothing, and
// returns cudaGetLastError() (0 = launched).  The wrapper guarantees
// blk % 128 == 0, 1 <= k <= 32 and nplanes in {1, 2}.
// int8: `bias` may be null (no-bias mode).
extern "C" int ivf_accum_extract_i8(const void* qg, const void* vec, const void* block_first,
                                    const void* block_last, const void* rows_valid,
                                    const void* bias, void* out_v, void* out_i, int nblocks,
                                    int qcap, int d, int blk, int k, int nplanes, int mask_rows,
                                    void* stream) {
  return extract<int8_t>(qg, vec, block_first, block_last, rows_valid, bias, out_v, out_i,
                         nblocks, qcap, d, blk, k, nplanes, mask_rows, stream);
}

// fp32 (bf16 = 0) or bf16 (bf16 = 1) qg and vec, no bias rows (the JAX
// function refuses them on float slabs); vec 16-byte aligned.
extern "C" int ivf_accum_extract_f(const void* qg, const void* vec, const void* block_first,
                                   const void* block_last, const void* rows_valid, void* out_v,
                                   void* out_i, int nblocks, int qcap, int d, int blk, int k,
                                   int nplanes, int mask_rows, int bf16, void* stream) {
  return bf16 ? extract<__nv_bfloat16>(qg, vec, block_first, block_last, rows_valid, nullptr,
                                       out_v, out_i, nblocks, qcap, d, blk, k, nplanes,
                                       mask_rows, stream)
              : extract<float>(qg, vec, block_first, block_last, rows_valid, nullptr, out_v,
                               out_i, nblocks, qcap, d, blk, k, nplanes, mask_rows, stream);
}
