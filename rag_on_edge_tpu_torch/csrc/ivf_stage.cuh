// Slab staging shared by the cluster-major scan kernels (K1 and K9
// ivf_accum_planes.cu; K4, K6 and K7 ivf_grouped_scan.cu).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

// The gathering form: routed row i (< qcap) is row idx[i] of a query batch
// [nsrc, d], or zeros where idx[i] lies outside [0, nsrc) (an empty slot is
// -1).  Same layout of `q_b` as stage_queries.
template <int NTHREADS>
__device__ __forceinline__ void stage_queries_gather(const int8_t* __restrict__ qsrc,
                                                     const int32_t* __restrict__ idx, int nsrc,
                                                     int qcap, int d, int row0, int nrows,
                                                     int qstride, int8_t* q_b) {
  for (int i = threadIdx.x; i < nrows * qstride * 4; i += NTHREADS) {
    const int r = i / (qstride * 4), e = i % (qstride * 4);
    int8_t v = 0;
    if (row0 + r < qcap && e < d) {
      const int s = idx[row0 + r];
      if (s >= 0 && s < nsrc) v = qsrc[(size_t)s * d + e];
    }
    q_b[i] = v;
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

}  // namespace
