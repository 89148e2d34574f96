// Kernels K4, K6 and K7 of the IVF search path: the cluster-major fine scan
// with a per-row running top-k over binned survivors, with three sources of
// the routed queries; and K10, the kernel lab's four variants of K6.  Each
// has an int8 entry (_i8) and a float entry (_f: fp32 or bf16 operands).
//
// K4 (entries ivf_grouped_scan_i8 and ivf_grouped_scan_f) replaces the TPU
// kernel rag_on_edge_tpu/ops/pallas_ivf.py, cluster_major_scan_grouped (its
// _grouped_kernel, with binned_top2 and _extract_topk from
// pallas_bruteforce.py): the routed queries come per block and the output
// is per block.
// K6 (entries ivf_cluster_scan_i8 and ivf_cluster_scan_f) replaces
// cluster_major_scan in the same file (its _kernel): the routed queries come
// per cluster, qg[bc[b]], and the output is per cluster, out[bc[t]].  The
// sharded index runs it over each shard's block walk and over the recovery
// pass's compacted list.
// K7 (entries ivf_routed_scan_i8 and ivf_routed_scan_f) replaces
// cluster_major_scan_routed in the same file (its _routed_grouped_kernel):
// the routed queries are gathered from the whole batch inside the kernel,
// row r of block b being qi[cq_blocks[b, r]] (zeros where that index is
// outside [0, B)), which is what the TPU kernel's onehot(cq) @ qi gives (at
// HIGHEST precision in the float modes, so the one-hot product returns qi
// bit for bit); the output is per block, as K4's.  No [nblocks, qcap, d]
// routed table exists.
// K10 (entries ivf_variant_scan_i8 and ivf_variant_scan_f) replaces the
// kernel lab's rag_on_edge_tpu/harness/kernel_lab.py, _variant_scan (its
// _variant_kernel): K6 at bin depth 2 with no bias, in four compile-time
// variants (the Variant parameter; K4, K6 and K7 are kFull, and every
// variant branch is an `if constexpr`, so their code is unchanged):
//   kFull     - K6 itself: binned top-2 and the running merge, whose
//               per-row skip is the TPU kernel's `improves` gate;
//   kNoGate   - the merge on every block, with no skip (the same values);
//   kMaxOnly  - the scores and a row max per block, no selection: a CTA per
//               block (the TPU grid), and the last block of each cluster in
//               the walk writes its row max over all k slots of out[bc[t]],
//               ids 0 (a cluster's blocks must be contiguous in the walk, as
//               in every index's block tables);
//   kFixedOut - kMaxOnly into one constant window: out[0] holds the row max
//               of the walk's last block.  The other blocks compute and
//               write nothing, which is what the TPU's constant output index
//               gives too: its one window is written back once, at the end.
//
// What it computes, for each run of blocks that ends at a block t with
// block_last[t] = 1 (the run starts at the latest block_first at or before
// t), and each routed query row r:
//   score(b, r, col) = float(int32 dot(Q(b)[r], vec[b, :, col])) - bias[b, col]
//                      (int8; no subtraction without bias), or, in the float
//                      modes, the fp32 dot of fp32 or bf16 operands minus the
//                      bias where one is given (the index gives none: its L2
//                      rides an augmented dimension), -inf for col >= rows_valid[b];
//   Q(b) = qg[b] for K4, qg[bc[b]] for K6 and K10, qi[cq_blocks[b]] for K7;
//   per block b and bin (col % 128), the DEPTH best (score, id) with
//   id = row_base[b] + col, ties to the lowest id;
//   those 128*DEPTH survivors of each block merged into a running top-k
//   ordered by (score desc, id asc), written to out_v/out_i[O(t), r, :k]
//   with O(t) = t for K4 and K7 and bc[t] for K6.
// Only those rows are written.  Entries past the last finite score hold
// -inf and an unspecified id.  For K6, bc must be constant along a run and
// each cluster must end at most one run (the TPU kernel's output-window
// rule, pallas_ivf.py:524-531); a run whose bc[t] is outside [0, nlist)
// writes nothing.
//
// What bounds it on the H100: on the dense walk, multiply-adds, as for K1
// (with dp4a or fp32 FMAs and no tensor cores the instruction rate is the
// limit, not memory).  On the recovery pass the kernel walks only the few runs
// whose last block made the compacted list; most CTAs exit at once.  K7's
// gather reads the batch (1 MB at B = 8192, d = 128) through L2.
//
// Design (simple first; wgmma and TMA are later work):
// - one CTA of 256 threads per (last block t, tile of 32 rows; 16 rows for
//   DEPTH > 2): two row groups x 128 lanes, thread = (group, bin).  It
//   walks back from t to the run's first block and then forward, one block
//   at a time, so each block is binned and merged on its own, as on the TPU
//   (a top-DEPTH per bin folded across blocks would keep fewer candidates).
// - per block: 16 chunks of 128 columns, each staged in shared memory and
//   scored with __dp4a (int8) or fmaf (fp32 and bf16, widened to fp32 as
//   they are staged): the stages and dot loops of ivf_stage.cuh, shared
//   with K1.  The three sources differ only in the query stage: a block's
//   rows, a cluster's rows, or a gather through cq_blocks (the float gather
//   loads scalars into the zero-padded fp32 rows, since a row of D' = 129
//   starts every 516 bytes).  Each thread keeps its bin's DEPTH best
//   (score, chunk) per row in registers, inserted with strict > so an equal
//   score keeps the earlier, lower id.
//   The DEPTH survivors of a bin may be equal in value (K1's plane 2 is the
//   opposite: the largest key DIFFERENT from plane 1).
// - then the survivors go to shared memory (reusing the staging area) and
//   one warp per row merges them into the row's running top-k (k <= 32, in
//   shared memory): k passes of a warp argmax by (score desc, id asc) with
//   shuffles.  A row is skipped when no survivor beats its k-th entry, the
//   per-row form of the TPU kernel's `improves` skip.  Finite ids are unique
//   (row_base differs between blocks), so the winner is removed by id.
// - score = __int2float_rn(dot) then one __fsub_rn, the JAX kernel's order:
//   the dot is exact in f32 (|dot| <= D*127^2 < 2^24), so scores are
//   bit-equal to the plain version.  The float modes sum from +0 with one
//   fmaf a dimension in d order (an empty routed slot scores +0).
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "ivf_stage.cuh"

namespace {

constexpr int LANES = 128;               // bins: one per lane of a row group
constexpr int GROUPS = 2;                // row groups per CTA (share one staged chunk)
constexpr int THREADS = LANES * GROUPS;
constexpr int WARPS = THREADS / 32;
constexpr int K_MAX = 32;                // running top-k width in shared memory
constexpr unsigned FULL = 0xffffffffu;

template <int DEPTH>
struct Tile {
  static constexpr int ROWS = DEPTH <= 2 ? 16 : 8;   // rows per group (registers)
  static constexpr int CTA_ROWS = GROUPS * ROWS;
  static constexpr int NCAND = DEPTH * LANES;        // survivors per row and block
};

// (v, i) ranks before (bv, bi): larger score, then lower id.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Where the routed queries come from, and where the output goes:
// kBlock: K4 (qg [nblocks, qcap, d], out [nblocks, qcap, k]);
// kCluster: K6 (qg [nlist, qcap, d], out [nlist, qcap, k], through bc);
// kRouted: K7 (qg = qi [B, d] gathered through cq_blocks, out [nblocks, qcap, k]).
enum class QSrc { kBlock, kCluster, kRouted };

// K10's variants; every other kernel is kFull.
enum class Variant { kFull, kNoGate, kMaxOnly, kFixedOut };

// T: int8_t, or float / __nv_bfloat16 (the float modes).
template <typename T, int DEPTH, QSrc SRC, Variant V = Variant::kFull>
__global__ void __launch_bounds__(THREADS)
grouped_scan_kernel(const T* __restrict__ qg,                // see above
                    const T* __restrict__ vec,               // [nblocks, d, blk]
                    const int32_t* __restrict__ block_cluster, // [nblocks] (K6 only)
                    const int32_t* __restrict__ cq_blocks,   // [nblocks, qcap] (K7 only)
                    const int32_t* __restrict__ block_first,   // [nblocks]
                    const int32_t* __restrict__ block_last,    // [nblocks]
                    const int32_t* __restrict__ rows_valid,    // [nblocks]
                    const float* __restrict__ bias,          // [nblocks, blk] or null
                    const int32_t* __restrict__ row_base,      // [nblocks]
                    float* __restrict__ out_v,               // see above
                    int32_t* __restrict__ out_i,             // see above
                    int qcap, int d, int blk, int k, int qstride,
                    int nsrc) {  // rows of qg: nlist for K6, B for K7
  constexpr int ROWS = Tile<DEPTH>::ROWS;
  constexpr int CTA_ROWS = Tile<DEPTH>::CTA_ROWS;
  constexpr int NCAND = Tile<DEPTH>::NCAND;
  constexpr int PER_LANE = NCAND / 32;
  constexpr bool INT8 = std::is_same_v<T, int8_t>;
  const float NEG_INF = -INFINITY;

  const int t = blockIdx.x;
  // K10's kMaxOnly and kFixedOut: one block per CTA, a row max, no selection.
  constexpr bool MAX_ONLY = V == Variant::kMaxOnly || V == Variant::kFixedOut;
  if constexpr (!MAX_ONLY) {
    if (block_last[t] == 0) return;
  }
  constexpr bool BY_CLUSTER = SRC == QSrc::kCluster;
  int orow = BY_CLUSTER ? block_cluster[t] : t;  // the output row
  if (BY_CLUSTER && (orow < 0 || orow >= nsrc)) return;
  bool writes = true;
  if constexpr (V == Variant::kMaxOnly) {
    writes = t + 1 == (int)gridDim.x || block_cluster[t + 1] != orow;
  } else if constexpr (V == Variant::kFixedOut) {
    writes = t + 1 == (int)gridDim.x;
    orow = 0;
  }
  const int lane = threadIdx.x % LANES;
  const int group = threadIdx.x / LANES;
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  const int cta_r0 = blockIdx.y * CTA_ROWS;
  const int cstride = qstride + 1;  // int8: odd word stride, conflict-free column reads

  // Shared memory: the running top-k, then a scan area (staged query rows
  // and slab chunk) that the block's survivors reuse once the scan is done.
  // int8: query rows of qstride words (4 dims a word) and the chunk
  // [LANES][cstride] words; float: query rows of qstride fp32 and the chunk
  // [qstride][LANES] fp32.
  extern __shared__ int4 smem4[];
  float* run_v = reinterpret_cast<float*>(smem4);                      // [CTA_ROWS][K_MAX]
  int32_t* run_i = reinterpret_cast<int32_t*>(run_v + CTA_ROWS * K_MAX);
  int32_t* q_s = run_i + CTA_ROWS * K_MAX;                             // [CTA_ROWS][qstride]
  int32_t* col_s = q_s + CTA_ROWS * qstride;                           // [LANES][cstride]
  float* cand_v = reinterpret_cast<float*>(q_s);                       // [CTA_ROWS][NCAND]
  int32_t* cand_i = reinterpret_cast<int32_t*>(cand_v + CTA_ROWS * NCAND);
  const int32_t* my_q = q_s + group * ROWS * qstride;

  for (int i = threadIdx.x; i < CTA_ROWS * K_MAX; i += THREADS) {
    run_v[i] = NEG_INF;
    run_i[i] = 0;
  }

  int tb = t;  // the run's first block
  if constexpr (!MAX_ONLY) {
    while (tb > 0 && block_first[tb] == 0) --tb;
  }
  const int nchunks = blk / LANES;

  for (int b = tb; b <= t; ++b) {
    const int nvalid = rows_valid[b];
    if (nvalid <= 0) continue;  // all scores -inf: nothing to merge (uniform in the CTA)
    if constexpr (!INT8 && SRC == QSrc::kRouted) {
      stage_queries_gather_f<THREADS>(qg, cq_blocks + (size_t)b * qcap, nsrc, qcap, d, cta_r0,
                                      CTA_ROWS, qstride, reinterpret_cast<float*>(q_s));
    } else if constexpr (!INT8) {
      const int qrow = BY_CLUSTER ? block_cluster[b] : b;
      stage_queries_f<THREADS>(qg + (size_t)qrow * qcap * d, qcap, d, cta_r0, CTA_ROWS, qstride,
                               reinterpret_cast<float*>(q_s));
    } else if constexpr (SRC == QSrc::kRouted) {
      stage_queries_gather<THREADS>(qg, cq_blocks + (size_t)b * qcap, nsrc, qcap, d, cta_r0,
                                    CTA_ROWS, qstride, reinterpret_cast<int8_t*>(q_s));
    } else {
      const int qrow = BY_CLUSTER ? block_cluster[b] : b;
      stage_queries<THREADS>(qg + (size_t)qrow * qcap * d, qcap, d, cta_r0, CTA_ROWS, qstride,
                             reinterpret_cast<int8_t*>(q_s));
    }
    const float* brow = bias != nullptr ? bias + (size_t)b * blk : nullptr;

    float tv[ROWS][DEPTH];
    int tc[ROWS][DEPTH];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < DEPTH; ++j) {
        tv[r][j] = NEG_INF;
        tc[r][j] = 0;
      }

    for (int c = 0; c < nchunks; ++c) {
      const T* vsrc = vec + (size_t)b * d * blk + c * LANES;
      float sc[ROWS];  // the chunk's scores before the bias
      if constexpr (INT8) {
        stage_chunk<THREADS>(vsrc, d, blk, qstride, col_s, cstride);
        __syncthreads();
        int32_t acc[ROWS];
        dot_rows<ROWS>(col_s + lane * cstride, my_q, qstride, acc);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) sc[r] = __int2float_rn(acc[r]);
      } else {
        stage_chunk_f<THREADS>(vsrc, d, blk, qstride, reinterpret_cast<float*>(col_s));
        __syncthreads();
        dot_rows_f<ROWS>(reinterpret_cast<const float*>(col_s), lane,
                         reinterpret_cast<const float*>(my_q), qstride, sc);
      }
      const int col = c * LANES + lane;
      const bool valid = col < nvalid;
      const float sub = brow != nullptr ? brow[col] : 0.0f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float x = sc[r];
        if (brow != nullptr) x = __fsub_rn(x, sub);
        if (!valid) x = NEG_INF;
        if constexpr (MAX_ONLY) {
          if (x > tv[r][0]) tv[r][0] = x;
        } else {
          // Insert into the bin's sorted top-DEPTH; strict > keeps an
          // equal, earlier (lower-id) entry ahead.  Descending j reads
          // tv[j-1] before it is rewritten.
#pragma unroll
          for (int j = DEPTH - 1; j > 0; --j) {
            if (x > tv[r][j - 1]) {
              tv[r][j] = tv[r][j - 1];
              tc[r][j] = tc[r][j - 1];
            } else if (x > tv[r][j]) {
              tv[r][j] = x;
              tc[r][j] = c;
            }
          }
          if (x > tv[r][0]) {
            tv[r][0] = x;
            tc[r][0] = c;
          }
        }
      }
      __syncthreads();  // col_s is restaged next
    }

    if constexpr (MAX_ONLY) {
      // The row max: each lane's column max to shared memory, then a warp
      // per row reduces its 128 lanes into slot 0 of the row's state.
#pragma unroll
      for (int r = 0; r < ROWS; ++r) cand_v[(group * ROWS + r) * LANES + lane] = tv[r][0];
      __syncthreads();
      for (int rr = warp; rr < CTA_ROWS; rr += WARPS) {
        float mx = NEG_INF;
#pragma unroll
        for (int i = 0; i < LANES / 32; ++i) mx = fmaxf(mx, cand_v[rr * LANES + i * 32 + wl]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        if (wl == 0) run_v[rr * K_MAX] = mx;
      }
      __syncthreads();
      continue;
    }

    // Survivors to shared memory (over the scan area, now free).
    const int rb = row_base[b];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < DEPTH; ++j) {
        const int o = (group * ROWS + r) * NCAND + j * LANES + lane;
        cand_v[o] = tv[r][j];
        cand_i[o] = rb + tc[r][j] * LANES + lane;
      }
    __syncthreads();

    // Merge: one warp per row.
    for (int rr = warp; rr < CTA_ROWS; rr += WARPS) {
      if (cta_r0 + rr >= qcap) continue;
      float* sv = run_v + rr * K_MAX;
      int32_t* si = run_i + rr * K_MAX;
      const float kv = sv[k - 1];
      const int ki = si[k - 1];
      float cv[PER_LANE];
      int ci[PER_LANE];
      bool beats = false;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        cv[i] = cand_v[rr * NCAND + i * 32 + wl];
        ci[i] = cand_i[rr * NCAND + i * 32 + wl];
        beats |= cv[i] > NEG_INF && better(cv[i], ci[i], kv, ki);
      }
      if constexpr (V != Variant::kNoGate) {
        if (!__any_sync(FULL, beats)) continue;
      }
      float ov = wl < k ? sv[wl] : NEG_INF;
      int oi = wl < k ? si[wl] : 0;
      __syncwarp();
      for (int p = 0; p < k; ++p) {
        float bv = ov;
        int bi = oi;
#pragma unroll
        for (int i = 0; i < PER_LANE; ++i)
          if (better(cv[i], ci[i], bv, bi)) {
            bv = cv[i];
            bi = ci[i];
          }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float v2 = __shfl_xor_sync(FULL, bv, off);
          const int i2 = __shfl_xor_sync(FULL, bi, off);
          if (better(v2, i2, bv, bi)) {
            bv = v2;
            bi = i2;
          }
        }
        // Only -inf left: slots p.. of the old state held -inf already
        // (any finite one would have won).  bv is the same in every lane.
        if (bv == NEG_INF) break;
        if (wl == 0) {
          sv[p] = bv;
          si[p] = bi;
        }
        if (ov == bv && oi == bi) ov = NEG_INF;
#pragma unroll
        for (int i = 0; i < PER_LANE; ++i)
          if (cv[i] == bv && ci[i] == bi) cv[i] = NEG_INF;
      }
      __syncwarp();
    }
    __syncthreads();  // the survivors' area is restaged by the next block
  }

  __syncthreads();
  if (!writes) return;
  for (int i = threadIdx.x; i < CTA_ROWS * k; i += THREADS) {
    const int r = i / k, p = i % k;
    if (cta_r0 + r >= qcap) continue;
    const size_t o = ((size_t)orow * qcap + cta_r0 + r) * k + p;
    out_v[o] = run_v[r * K_MAX + (MAX_ONLY ? 0 : p)];
    out_i[o] = MAX_ONLY ? 0 : run_i[r * K_MAX + p];
  }
}

template <typename T, int DEPTH, QSrc SRC, Variant V>
int launch(const void* qg, const void* vec, const void* block_cluster, const void* cq_blocks,
           const void* block_first, const void* block_last, const void* rows_valid,
           const void* bias, const void* row_base, void* out_v, void* out_i, int nblocks,
           int qcap, int d, int blk, int k, int nsrc, cudaStream_t stream) {
  constexpr int CTA_ROWS = Tile<DEPTH>::CTA_ROWS;
  const int qstride = stage_row_words<T>(d);
  const size_t run = (size_t)CTA_ROWS * K_MAX * 2 * sizeof(int32_t);
  const size_t scan = ((size_t)CTA_ROWS * qstride + stage_chunk_words<T>(qstride))
                      * sizeof(int32_t);
  const size_t cand = (size_t)CTA_ROWS * Tile<DEPTH>::NCAND * 2 * sizeof(int32_t);
  const size_t smem = run + (scan > cand ? scan : cand);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(grouped_scan_kernel<T, DEPTH, SRC, V>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)nblocks, (unsigned)((qcap + CTA_ROWS - 1) / CTA_ROWS));
  grouped_scan_kernel<T, DEPTH, SRC, V><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qg), static_cast<const T*>(vec),
      static_cast<const int32_t*>(block_cluster), static_cast<const int32_t*>(cq_blocks),
      static_cast<const int32_t*>(block_first), static_cast<const int32_t*>(block_last),
      static_cast<const int32_t*>(rows_valid), static_cast<const float*>(bias),
      static_cast<const int32_t*>(row_base), static_cast<float*>(out_v),
      static_cast<int32_t*>(out_i), qcap, d, blk, k, qstride, nsrc);
  return (int)cudaGetLastError();
}

template <QSrc SRC, Variant V = Variant::kFull, typename T = int8_t>
int dispatch(const void* qg, const void* vec, const void* block_cluster, const void* cq_blocks,
             const void* block_first, const void* block_last, const void* rows_valid,
             const void* bias, const void* row_base, void* out_v, void* out_i, int nblocks,
             int qcap, int d, int blk, int k, int depth, int nsrc, void* stream) {
  if (nblocks == 0 || qcap == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RAG_LAUNCH(D)                                                                        \
  launch<T, D, SRC, V>(qg, vec, block_cluster, cq_blocks, block_first, block_last, rows_valid, \
                       bias, row_base, out_v, out_i, nblocks, qcap, d, blk, k, nsrc, s)
  switch (depth) {
    case 1: return RAG_LAUNCH(1);
    case 2: return RAG_LAUNCH(2);
    case 3: return RAG_LAUNCH(3);
    case 4: return RAG_LAUNCH(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RAG_LAUNCH
}

}  // namespace

// C entries for ctypes.  Each launches on `stream`, allocates nothing, and
// returns cudaGetLastError() (0 = launched).  `bias` may be null (no-bias
// mode).  The wrappers guarantee blk % 128 == 0, 1 <= k <= 32 and
// 1 <= depth <= 4.
//
// K4: qg [nblocks, qcap, d], out [nblocks, qcap, k].
extern "C" int ivf_grouped_scan_i8(const void* qg, const void* vec, const void* block_first,
                                   const void* block_last, const void* rows_valid,
                                   const void* bias, const void* row_base, void* out_v,
                                   void* out_i, int nblocks, int qcap, int d, int blk, int k,
                                   int depth, void* stream) {
  return dispatch<QSrc::kBlock>(qg, vec, nullptr, nullptr, block_first, block_last, rows_valid,
                                bias, row_base, out_v, out_i, nblocks, qcap, d, blk, k, depth,
                                nblocks, stream);
}

// K4's float modes: fp32 (bf16 = 0) or bf16 (bf16 = 1) qg and vec; vec
// 16-byte aligned.
extern "C" int ivf_grouped_scan_f(const void* qg, const void* vec, const void* block_first,
                                  const void* block_last, const void* rows_valid,
                                  const void* bias, const void* row_base, void* out_v,
                                  void* out_i, int nblocks, int qcap, int d, int blk, int k,
                                  int depth, int bf16, void* stream) {
  return bf16 ? dispatch<QSrc::kBlock, Variant::kFull, __nv_bfloat16>(
                    qg, vec, nullptr, nullptr, block_first, block_last, rows_valid, bias,
                    row_base, out_v, out_i, nblocks, qcap, d, blk, k, depth, nblocks, stream)
              : dispatch<QSrc::kBlock, Variant::kFull, float>(
                    qg, vec, nullptr, nullptr, block_first, block_last, rows_valid, bias,
                    row_base, out_v, out_i, nblocks, qcap, d, blk, k, depth, nblocks, stream);
}

// K6: qg [nlist, qcap, d], block_cluster [nblocks], out [nlist, qcap, k].
extern "C" int ivf_cluster_scan_i8(const void* qg, const void* vec, const void* block_cluster,
                                   const void* block_first, const void* block_last,
                                   const void* rows_valid, const void* bias,
                                   const void* row_base, void* out_v, void* out_i, int nlist,
                                   int nblocks, int qcap, int d, int blk, int k, int depth,
                                   void* stream) {
  return dispatch<QSrc::kCluster>(qg, vec, block_cluster, nullptr, block_first, block_last,
                                  rows_valid, bias, row_base, out_v, out_i, nblocks, qcap, d,
                                  blk, k, depth, nlist, stream);
}

// K6's float modes: fp32 (bf16 = 0) or bf16 (bf16 = 1) qg and vec; vec
// 16-byte aligned.
extern "C" int ivf_cluster_scan_f(const void* qg, const void* vec, const void* block_cluster,
                                  const void* block_first, const void* block_last,
                                  const void* rows_valid, const void* bias, const void* row_base,
                                  void* out_v, void* out_i, int nlist, int nblocks, int qcap,
                                  int d, int blk, int k, int depth, int bf16, void* stream) {
  return bf16 ? dispatch<QSrc::kCluster, Variant::kFull, __nv_bfloat16>(
                    qg, vec, block_cluster, nullptr, block_first, block_last, rows_valid, bias,
                    row_base, out_v, out_i, nblocks, qcap, d, blk, k, depth, nlist, stream)
              : dispatch<QSrc::kCluster, Variant::kFull, float>(
                    qg, vec, block_cluster, nullptr, block_first, block_last, rows_valid, bias,
                    row_base, out_v, out_i, nblocks, qcap, d, blk, k, depth, nlist, stream);
}

// K7: qi [nbatch, d], cq_blocks [nblocks, qcap] (-1 = empty slot),
// out [nblocks, qcap, k].
extern "C" int ivf_routed_scan_i8(const void* qi, const void* cq_blocks, const void* vec,
                                  const void* block_first, const void* block_last,
                                  const void* rows_valid, const void* bias, const void* row_base,
                                  void* out_v, void* out_i, int nbatch, int nblocks, int qcap,
                                  int d, int blk, int k, int depth, void* stream) {
  return dispatch<QSrc::kRouted>(qi, vec, nullptr, cq_blocks, block_first, block_last,
                                 rows_valid, bias, row_base, out_v, out_i, nblocks, qcap, d, blk,
                                 k, depth, nbatch, stream);
}

// K7's float modes: fp32 (bf16 = 0) or bf16 (bf16 = 1) qi and vec; vec
// 16-byte aligned (qi is read a scalar at a time).
extern "C" int ivf_routed_scan_f(const void* qi, const void* cq_blocks, const void* vec,
                                 const void* block_first, const void* block_last,
                                 const void* rows_valid, const void* bias, const void* row_base,
                                 void* out_v, void* out_i, int nbatch, int nblocks, int qcap,
                                 int d, int blk, int k, int depth, int bf16, void* stream) {
  return bf16 ? dispatch<QSrc::kRouted, Variant::kFull, __nv_bfloat16>(
                    qi, vec, nullptr, cq_blocks, block_first, block_last, rows_valid, bias,
                    row_base, out_v, out_i, nblocks, qcap, d, blk, k, depth, nbatch, stream)
              : dispatch<QSrc::kRouted, Variant::kFull, float>(
                    qi, vec, nullptr, cq_blocks, block_first, block_last, rows_valid, bias,
                    row_base, out_v, out_i, nblocks, qcap, d, blk, k, depth, nbatch, stream);
}

// K10: qg [nlist, qcap, d], block_cluster [nblocks], out [nlist, qcap, k];
// bin depth 2, no bias; variant 0-3 = full, nogate, maxonly, fixedout.
namespace {
template <typename T>
int variant_scan(const void* qg, const void* vec, const void* block_cluster,
                 const void* block_first, const void* block_last, const void* rows_valid,
                 const void* row_base, void* out_v, void* out_i, int nlist, int nblocks, int qcap,
                 int d, int blk, int k, int variant, void* stream) {
#define RAG_VARIANT(V)                                                                         \
  dispatch<QSrc::kCluster, V, T>(qg, vec, block_cluster, nullptr, block_first, block_last,      \
                                 rows_valid, nullptr, row_base, out_v, out_i, nblocks, qcap, d, \
                                 blk, k, 2, nlist, stream)
  switch (variant) {
    case 0: return RAG_VARIANT(Variant::kFull);
    case 1: return RAG_VARIANT(Variant::kNoGate);
    case 2: return RAG_VARIANT(Variant::kMaxOnly);
    case 3: return RAG_VARIANT(Variant::kFixedOut);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RAG_VARIANT
}
}  // namespace

extern "C" int ivf_variant_scan_i8(const void* qg, const void* vec, const void* block_cluster,
                                   const void* block_first, const void* block_last,
                                   const void* rows_valid, const void* row_base, void* out_v,
                                   void* out_i, int nlist, int nblocks, int qcap, int d, int blk,
                                   int k, int variant, void* stream) {
  return variant_scan<int8_t>(qg, vec, block_cluster, block_first, block_last, rows_valid,
                              row_base, out_v, out_i, nlist, nblocks, qcap, d, blk, k, variant,
                              stream);
}

// K10's float modes: fp32 (bf16 = 0) or bf16 (bf16 = 1) qg and vec; vec
// 16-byte aligned.
extern "C" int ivf_variant_scan_f(const void* qg, const void* vec, const void* block_cluster,
                                  const void* block_first, const void* block_last,
                                  const void* rows_valid, const void* row_base, void* out_v,
                                  void* out_i, int nlist, int nblocks, int qcap, int d, int blk,
                                  int k, int variant, int bf16, void* stream) {
  return bf16 ? variant_scan<__nv_bfloat16>(qg, vec, block_cluster, block_first, block_last,
                                            rows_valid, row_base, out_v, out_i, nlist, nblocks,
                                            qcap, d, blk, k, variant, stream)
              : variant_scan<float>(qg, vec, block_cluster, block_first, block_last, rows_valid,
                                    row_base, out_v, out_i, nlist, nblocks, qcap, d, blk, k,
                                    variant, stream);
}
