// Slab staging of the one cluster-major scan kernel that does not run on
// wgmma or the FFMA register tile: K9's accum_extract_kernel
// (ivf_accum_planes.cu), its int8 stage (packed words, __dp4a) and its
// float stage (fp32 or bf16 operands widened to fp32 as they are staged,
// fmaf).  Past D' = 320 the float stage walks D in slices (float_slice,
// dot_rows_f_acc).
#pragma once
#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Host side: the 32-bit words of one staged query row of d elements of T
// (int8: four dimensions a word; fp32 and bf16: one fp32 a word), a
// multiple of 4 for the 16-byte broadcast reads; and of one staged
// [d, 128] chunk (int8: 128 packed columns at the odd stride qstride + 1;
// float: qstride fp32 rows of 128).
template <typename T>
int stage_row_words(int d) {
  return std::is_same_v<T, int8_t> ? ((d + 3) / 4 + 3) / 4 * 4 : (d + 3) / 4 * 4;
}
template <typename T>
size_t stage_chunk_words(int qstride) {
  return std::is_same_v<T, int8_t> ? (size_t)128 * (qstride + 1) : (size_t)qstride * 128;
}

// Stage one block's [d, 128] chunk as one packed column per lane: word j of
// column l holds d-rows 4j..4j+3 (zero past d).  Each task loads a 4x4 byte
// tile as four coalesced 32-bit words (4 d-rows x 4 columns) and transposes
// it in registers with __byte_perm; all tasks of a thread are independent,
// so their loads overlap.  Columns sit at an odd word stride `cstride`, so
// each lane's column reads are free of bank conflicts.
template <int NTHREADS>
__device__ __forceinline__ void stage_chunk(const int8_t* __restrict__ vsrc, int d, int blk,
                                            int qstride, int32_t* col_s, int cstride) {
  constexpr int kLanes = 128;
  const int ntasks = (kLanes / 4) * qstride;
#pragma unroll 4
  for (int task = threadIdx.x; task < ntasks; task += NTHREADS) {
    const int m = task % (kLanes / 4), j = task / (kLanes / 4);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * j + i;
      w[i] = e < d ? *reinterpret_cast<const uint32_t*>(vsrc + (size_t)e * blk + 4 * m) : 0u;
    }
    const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), hi01 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140), hi23 = __byte_perm(w[2], w[3], 0x7362);
    int32_t* dst = col_s + (4 * m) * cstride + j;
    dst[0] = (int32_t)__byte_perm(lo01, lo23, 0x5410);
    dst[cstride] = (int32_t)__byte_perm(lo01, lo23, 0x7632);
    dst[2 * cstride] = (int32_t)__byte_perm(hi01, hi23, 0x5410);
    dst[3 * cstride] = (int32_t)__byte_perm(hi01, hi23, 0x7632);
  }
}

// Load rows row0..row0+nrows-1 of a routed query table [qcap, d] into
// `q_b` as nrows x (4*qstride) bytes, zero past d and past qcap.
template <int NTHREADS>
__device__ __forceinline__ void stage_queries(const int8_t* __restrict__ qsrc, int qcap, int d,
                                              int row0, int nrows, int qstride, int8_t* q_b) {
  for (int i = threadIdx.x; i < nrows * qstride * 4; i += NTHREADS) {
    const int r = i / (qstride * 4), e = i % (qstride * 4);
    q_b[i] = (row0 + r < qcap && e < d) ? qsrc[(size_t)(row0 + r) * d + e] : 0;
  }
}

// acc[r] = int32 dot of a lane's staged column with staged query row r:
// __dp4a on packed int8 words, exact; query words are read as 16-byte
// broadcasts (every lane of a row group reads the same row).
template <int ROWS>
__device__ __forceinline__ void dot_rows(const int32_t* mycol, const int32_t* my_q, int qstride,
                                         int32_t (&acc)[ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0;
  for (int j = 0; j < qstride; j += 4) {
    const int32_t v0 = mycol[j], v1 = mycol[j + 1], v2 = mycol[j + 2], v3 = mycol[j + 3];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int4 q4 = *reinterpret_cast<const int4*>(my_q + r * qstride + j);
      acc[r] = __dp4a(v0, q4.x, acc[r]);
      acc[r] = __dp4a(v1, q4.y, acc[r]);
      acc[r] = __dp4a(v2, q4.z, acc[r]);
      acc[r] = __dp4a(v3, q4.w, acc[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// The float stage.  fp32 and bf16 operands are widened to fp32 as they are
// staged (bf16 -> fp32 is exact), and every product and sum is one fmaf in
// d order: full fp32, as the JAX kernels' Precision.HIGHEST asks, never a
// TF32 or bf16 tensor-core pass.  A staged row is `dstride` floats (d
// rounded up to 4, zero past d), so 16-byte loads along it stay aligned
// even where d is odd (D' = 129 for augmented L2).

// Four consecutive elements as fp32 (p 16-byte aligned for fp32, 8 for bf16).
__device__ __forceinline__ float4 load4_f(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4_f(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);  // little-endian: element 0 is low
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}
__device__ __forceinline__ float widen(float x) { return x; }

// The float stage holds the query rows and a [dstride, 128] chunk whole
// while dstride <= F_RESIDENT; past it, d walks in slices of F_SLICE: each
// slice of the rows and of the chunk staged, scored and released in turn,
// so D has no cap (the rows are then restaged for every chunk).
constexpr int F_RESIDENT = 320;
constexpr int F_SLICE = 64;
__host__ __device__ __forceinline__ int float_slice(int dstride) {
  return dstride <= F_RESIDENT ? dstride : F_SLICE;
}
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// Stage one block's [d, 128] chunk as fp32, d-row major: row e holds the
// chunk's 128 columns of dimension e, so lane l reads word e*128 + l and a
// warp's reads never share a bank (the int8 stage needs its transposed,
// odd-stride layout only because four d-rows share a word).  Each task is
// four columns of one row, one coalesced 16- or 8-byte load; rows d ..
// dstride-1 are zero.  `vsrc` is 16-byte aligned and `blk` a multiple of 128.
template <int NTHREADS, typename T>
__device__ __forceinline__ void stage_chunk_f(const T* __restrict__ vsrc, int d, int blk,
                                              int dstride, float* col_f) {
  constexpr int kQuads = 128 / 4;
  const int ntasks = kQuads * dstride;
  for (int task = threadIdx.x; task < ntasks; task += NTHREADS) {
    const int m = task % kQuads, e = task / kQuads;
    const float4 v = e < d ? load4_f(vsrc + (size_t)e * blk + 4 * m) : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(col_f + e * 128 + 4 * m) = v;
  }
}

// Load dimensions e0..e0+dstride-1 of rows row0..row0+nrows-1 of a query
// table [nsrc, d] (fp32 or bf16) into `q_f` as nrows x dstride fp32, zero
// past d and past nsrc.  Rows of [nsrc, d] start at any element (d may be
// odd), so the loads are scalar.
template <int NTHREADS, typename T>
__device__ __forceinline__ void stage_queries_f(const T* __restrict__ qsrc, int nsrc, int d,
                                                int row0, int nrows, int dstride, float* q_f,
                                                int e0 = 0) {
  for (int i = threadIdx.x; i < nrows * dstride; i += NTHREADS) {
    const int r = i / dstride, e = e0 + i % dstride;
    q_f[i] = (row0 + r < nsrc && e < d) ? widen(qsrc[(size_t)(row0 + r) * d + e]) : 0.0f;
  }
}

// The running form over a d-slice: acc[r] += the fp32 dot over the slice's
// first n dimensions (a multiple of 4), the staged query rows at a pitch of
// dstride floats and the staged chunk's rows one per dimension.  Slices
// taken in d order give the one-pass sum bit for bit.
template <int ROWS>
__device__ __forceinline__ void dot_rows_f_acc(const float* col_f, int lane, const float* my_q,
                                               int dstride, int n, float (&acc)[ROWS]) {
  for (int j = 0; j < n; j += 4) {
    const float v0 = col_f[j * 128 + lane], v1 = col_f[(j + 1) * 128 + lane];
    const float v2 = col_f[(j + 2) * 128 + lane], v3 = col_f[(j + 3) * 128 + lane];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 q4 = *reinterpret_cast<const float4*>(my_q + r * dstride + j);
      acc[r] = fmaf(q4.x, v0, acc[r]);
      acc[r] = fmaf(q4.y, v1, acc[r]);
      acc[r] = fmaf(q4.z, v2, acc[r]);
      acc[r] = fmaf(q4.w, v3, acc[r]);
    }
  }
}

// acc[r] = the fp32 dot of lane `lane`'s staged column with staged query
// row r: one fmaf per dimension in d order, from +0 (so an exact-zero sum
// is +0, never -0); query words are read as 16-byte broadcasts.  The zero
// rows past d add exact zeros.
template <int ROWS>
__device__ __forceinline__ void dot_rows_f(const float* col_f, int lane, const float* my_q,
                                           int dstride, float (&acc)[ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
  dot_rows_f_acc<ROWS>(col_f, lane, my_q, dstride, dstride, acc);
}

}  // namespace
