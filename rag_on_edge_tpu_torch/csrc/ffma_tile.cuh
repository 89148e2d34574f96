// The register-tiled FFMA product shared by the fp32 modes of K3
// (bruteforce_fused.cu, fused_f32_kernel), K5 (bruteforce_accum.cu,
// accum_ffma_kernel), K1 (ivf_accum_planes.cu, planes_ffma_kernel) and K6
// and K7 (ivf_grouped_scan.cu, grouped_ffma_kernel): the pattern of K8's
// fp32 kernel (tiled_matmul.cu).
//
// - the CTA's tile: 8 MI WM rows x 128 columns, WM warps along the rows x 4
//   along the columns, MI x 8 fp32 accumulators a thread (Place: which rows
//   and columns those are; MI = 8 but in K6's and K7's 32-row tiles, MI = 4
//   with WM = 1);
// - the ring: STAGES stages of one d-slice of BK each (the kernel picks
//   both: K3 three of 16, which its shared buffers leave room for; K5 and
//   K1 two of 32; K6 and K7 two of 32, or three of 16 at bin depths 3-4),
//   the tile's rows [BM, BK] at a pitch of PA = BK + 4 floats (the pad
//   keeps a warp's 16-byte reads of eight rows apart in the banks) and the
//   chunk's [BK, 128] columns, filled by cp.async (Copier; the rows strided,
//   or gathered through an index) while the stage before is multiplied;
//   d past D, rows past the operand's and columns past its width arrive as
//   zeros, so D has no cap;
// - the product of one slice (fma_slice): every score is one fmaf a
//   dimension in d order, the groups of 4 past D skipped and the zeros of a
//   partial group adding exact zeros; a sum from +0 is never -0.
//
// What bounds it: the fp32 FMAs (67 TFLOP/s on the H100), with two 16-byte
// shared reads a dimension for eight FMAs each; the 8 x 8 tile is what
// keeps the shared-memory reads below that.
#pragma once
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {
namespace ffma {

constexpr int BN = 128;       // columns a chunk

template <int WM, int BK_, int STAGES_, int MI_ = 8>
struct Tile {
  static_assert(MI_ == 8 || WM == 1, "fewer rows a thread take one warp row");
  static constexpr int MI = MI_;              // rows a thread, 8 apart
  static constexpr int BM = 8 * MI * WM;
  static constexpr int THREADS = 128 * WM;
  static constexpr int BK = BK_;              // d a slice
  static constexpr int PA = BK + 4;           // a staged row's pitch in floats
  static constexpr int STAGES = STAGES_;
  static constexpr int A_FLOATS = BM * PA;
  static constexpr int STAGE_FLOATS = A_FLOATS + BK * BN;
  static constexpr size_t RING_BYTES = (size_t)STAGES * STAGE_FLOATS * 4;
};

// This thread's place: warp (wm, wn), lane (lm, ln) = (lane / 4, lane % 4);
// accumulator (i, j) is tile row 64 wm + 8 i + lm and chunk column 32 wn +
// 16 (j / 4) + 4 ln + j % 4 (i < MI, j < 8).
struct Place {
  int wm, wn, lm, ln;
  __device__ __forceinline__ explicit Place(int tid)
      : wm(tid >> 7), wn((tid >> 5) & 3), lm((tid & 31) >> 2), ln(tid & 3) {}
  __device__ __forceinline__ int row(int i) const { return 64 * wm + 8 * i + lm; }
  __device__ __forceinline__ int col(int j) const { return 32 * wn + 16 * (j >> 2) + 4 * ln + (j & 3); }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, the first src_bytes of them read
// (the rest written as zeros); and 4 bytes, or zeros.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// The oldest stage in flight has landed (this thread's copies; a barrier
// follows for the others').
template <class Tl>
__device__ __forceinline__ void wait_stage() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Tl::STAGES - 2) : "memory");
}
__device__ __forceinline__ void wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// This thread's cp.async copies of a ring stage, fixed for the CTA: A rows
// ar + AR j (j < BM / AR) at d column aq, B d-rows br + BR j (j < BK / BR)
// at chunk column bq, 16 bytes each; `arows` marks the A rows below the
// operand's row count.
template <class Tl>
struct Copier {
  static constexpr int BK = Tl::BK, PA = Tl::PA;
  static constexpr int ACH = BK / 4, AR = Tl::THREADS / ACH, BR = Tl::THREADS / 32;
  static constexpr int NA = Tl::BM / AR, NB = BK / BR;
  int ar, aq, br, bq;
  unsigned arows = 0;
  __device__ __forceinline__ Copier(int tid, int nrows)
      : ar(tid / ACH), aq((tid % ACH) * 4), br(tid >> 5), bq((tid & 31) * 4) {
#pragma unroll
    for (int j = 0; j < NA; ++j) arows |= (unsigned)(ar + AR * j < nrows) << j;
  }

  // Stage d-slice k0 .. k0 + BK - 1 at `stage` (a ring stage in shared
  // memory): A's rows (row r at a + r lda) and the chunk's d-rows e < d of
  // B (at b + e ldb, columns c < ncols); d past D, rows past A's and columns
  // past ncols arrive as zeros.  vec_a / vec_b: that operand's rows start on
  // 16-byte boundaries (16-byte copies; else 4-byte).
  __device__ __forceinline__ void load(float* stage, const float* __restrict__ a, int lda,
                                       bool vec_a, const float* __restrict__ b, int ldb,
                                       int ncols, bool vec_b, int d, int k0) const {
    const uint32_t so = smem_addr(stage);
    const int ea = k0 + aq;
    const int na = 4 * min(4, max(0, d - ea));     // the bytes of d an A copy holds
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const int r = ar + AR * j;
      const uint32_t dst = so + (r * PA + aq) * 4;
      const bool row = (arows >> j) & 1u;
      const float* src = a + (size_t)r * lda + ea;
      if (vec_a) {
        const int nb = row ? na : 0;
        cp_async_16(dst, nb ? src : a, nb);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = row && 4 * u < na;
          cp_async_4(dst + 4 * u, ok ? src + u : a, ok ? 4 : 0);
        }
      }
    }
    load_b(so, b, ldb, ncols, vec_b, d, k0);
  }

  // The same with A gathered: row r is row idx[r] of a [nsrc, lda] (16-byte
  // aligned rows), zeros where idx[r] lies outside [0, nsrc) or r is past
  // A's row count (K7's fp32 mode: the routed rows from the batch).
  __device__ __forceinline__ void load_gather(float* stage, const float* __restrict__ a, int lda,
                                              const int32_t* __restrict__ idx, int nsrc,
                                              const float* __restrict__ b, int ldb, int ncols,
                                              bool vec_b, int d, int k0) const {
    const uint32_t so = smem_addr(stage);
    const int ea = k0 + aq;
    const int na = 4 * min(4, max(0, d - ea));
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const int r = ar + AR * j;
      const int s = (arows >> j) & 1u ? idx[r] : -1;
      const int nb = s >= 0 && s < nsrc ? na : 0;
      cp_async_16(so + (r * PA + aq) * 4, nb ? a + (size_t)s * lda + ea : a, nb);
    }
    load_b(so, b, ldb, ncols, vec_b, d, k0);
  }

  // B's part of a stage at shared address so.
  __device__ __forceinline__ void load_b(uint32_t so, const float* __restrict__ b, int ldb,
                                         int ncols, bool vec_b, int d, int k0) const {
    const int nc = 4 * min(4, max(0, ncols - bq));  // the bytes of columns a B copy holds
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const int e = k0 + br + BR * j;
      const uint32_t dst = so + (Tl::A_FLOATS + (br + BR * j) * BN + bq) * 4;
      const float* src = b + (size_t)e * ldb + bq;
      if (vec_b) {
        const int nb = e < d ? nc : 0;
        cp_async_16(dst, nb ? src : b, nb);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = e < d && 4 * u < nc;
          cp_async_4(dst + 4 * u, ok ? src + u : b, ok ? 4 : 0);
        }
      }
    }
  }
};

// acc[i][j] += the slice's first dl dimensions (dl <= BK) of the staged
// rows and columns at Place (i, j), one fmaf each in d order.  A whole
// slice runs unrolled with no branch (the next group's shared reads
// overlap this one's FMAs); a partial one stops at the first group of 4
// past dl.
template <class Tl>
__device__ __forceinline__ void fma_slice(const float* stage, const Place& p, int dl,
                                          float (&acc)[Tl::MI][8]) {
  constexpr int BK = Tl::BK, PA = Tl::PA, MI = Tl::MI;
  const float* as = stage + (64 * p.wm + p.lm) * PA;
  const float* bs = stage + Tl::A_FLOATS + 32 * p.wn + 4 * p.ln;
  auto group4 = [&](int kq) {
    float av[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(as + i * 8 * PA + kq);
      av[i][0] = v.x;
      av[i][1] = v.y;
      av[i][2] = v.z;
      av[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 b0 = *reinterpret_cast<const float4*>(bs + (kq + kk) * BN);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + (kq + kk) * BN + 16);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = (i & 1) ? 7 - jj : jj;
          acc[i][j] = __fmaf_rn(av[i][kk], bv[j], acc[i][j]);
        }
    }
  };
  if (dl >= BK) {
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) group4(kq);
  } else {
    for (int kq = 0; kq < dl; kq += 4) group4(kq);
  }
}

template <int MI>
__device__ __forceinline__ void zero(float (&acc)[MI][8]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
}

}  // namespace ffma
}  // namespace
