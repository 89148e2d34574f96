// Kernels K1 and K9 of the IVF search path: the cluster-major fine scan with
// packed accumulation.  K1 (entries ivf_accum_planes_i8, ivf_accum_planes_bf16
// and ivf_accum_planes_f32) emits per-lane-bin top-2 "planes" of packed int32
// keys; K9 (entries ivf_accum_extract_i8 and ivf_accum_extract_f, at the end
// of this file) emits an exact top-k per routed row.
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
// What bounds it on the H100: only a block's columns below rows_valid yield
// a key that is not KMIN, so at the SIFT-1M slice (1176 blocks of 2048
// rows holding 1,000,000 valid columns, 256 routed rows, D = 128) the
// int8 product is 6.6e10 operations against 0.13 GB of valid slab and bias
// columns, 0.04 GB of routed rows and 0.27 GB of planes written: on the
// tensor cores (1,979 T int8 ops/s) the bytes bound it, 0.13 ms at 3.35
// TB/s.  The bf16 mode (D' = 129) moves 0.6 GB, 0.18 ms, its product a
// third of that at 989 TFLOP/s.  The fp32 mode has no tensor-core path
// without TF32, which would change the keys: its 3.3e10 FFMAs bound it
// (0.99 ms at 67 TFLOP/s), over three times the bytes' 0.28 ms.
//
// Design of the int8 and bf16 modes (planes_wgmma_kernel, hopper_mma.cuh):
// - one CTA of two warpgroups per (last block t, 128 routed rows, one half
//   of the 128 bins); CTAs on other blocks exit at once.  Warpgroup wg owns
//   64 routed rows x the CTA's 64 bins across every chunk, so its running
//   planes have the accumulator fragment's shape (32 registers each); the
//   TPU kernel's [qcap, blk] accumulator is never needed.
// - the work is a list of (chunk, block) half-chunks: chunk-major, the
//   cluster's blocks inside, and only those holding a valid column (a
//   half-chunk past rows_valid would only add KMIN keys, so skipping it is
//   exact; the padded tails of SIFT-1M's blocks are over half of the slab).
//   Each half-chunk is kb units of 128 bytes of d: 4 k-steps of wgmma
//   m64n64k32 s8 -> s32 (int8) or m64n64k16 bf16 -> f32 (bf16) per unit.
// - operands: the routed rows (A, K-major, the wrapper pads D to TMA's
//   16-byte pitch: no copy at D = 128) stay in shared memory for a one-block
//   cluster, and ride in the unit's stage for a longer one, or where they
//   are too wide to stay beside two stages (bf16 past D ~ 700); the slab's unit
//   (B) rides a TMA ring of `stages` stages, one mbarrier each.  Thread 0
//   refills the stage the last unit released; d past D arrives as TMA's
//   zeros, and the k-steps past D add zeros.
// - bf16 B is read N-major through wgmma's transpose bit, straight from its
//   TMA box.  8-bit operands have no transpose bit, and the slab is N-major
//   ([D, blk], the JAX layout): the kernel transposes each int8 unit on its
//   way into shared memory instead of copying the slab per call.  TMA lands
//   the unit as four [128 d, 16 bin] boxes; every thread turns two 4 x 4
//   byte tiles into K-major words with __byte_perm (lane-dependent selectors
//   fold in a row rotation that spreads the reads over the banks) and
//   stores them in the 128-byte-swizzled layout the descriptor reads (the
//   stores free of bank conflicts, the reads two-way).  The transpose of
//   unit u+1 runs while unit u's wgmma groups are in flight, on two B
//   buffers; one barrier a unit orders it all.  Measured once during
//   development on an H100 at the SIFT-1M slice, by timing the same launch
//   with the transpose left out: 0.049-0.061 ms of the int8 L2 call's
//   0.51-0.53, where a per-call K-major copy of the slab would take about
//   1 ms.
// - the epilogue on the fragment: after the unit's groups retire, a copy of
//   the accumulators (copy_acc: reading the fragment itself has ptxas
//   serialize the groups) is turned into keys, masked only in the
//   half-chunk that holds rows_valid, max-folded into a running key only
//   in a cluster of several blocks, and the chunk's key updates the two
//   planes branch-free: keys of two chunks never tie (the pack names the
//   chunk) except in L2 with arbitrary bias rows, which keeps the test for
//   a key equal to plane 1.  int8 L2: the unit's 64 bias words ride in its
//   last stage.  bf16: an exact-zero sum is taken as +0 before its key.
// - int8 keys are built on the unsigned bit pattern: (u32)dots << 8 is
//   defined for negative dots and gives the same bits as JAX's shift_left
//   and torch's int32 arithmetic.  The wrapper bounds D so that it never
//   wraps.
// - what bounds it as built: 0.50-0.57 ms int8 L2 at the SIFT-1M slice on
//   the H100, 3.9-4.3x the byte bound of the valid columns; bf16 in
//   PERF.md section 6.  213-218 registers (int8; bf16 178) leave one CTA of two
//   warpgroups an SM, so each CTA's first TMA round trip is exposed, and
//   the fold costs some six integer operations a score.
//
// Design of the fp32 mode (planes_ffma_kernel): K3 fp32's register tile
// (ffma_tile.cuh, shared with K3 and K5): one CTA of 256 threads per (last
// block, 128 routed rows), 8 x 8 fp32 accumulators a thread over a chunk's
// 128 bins, the rows' and the slab's d-slices of 32 through a two-stage
// cp.async ring (any D; one fmaf a dimension in d order from +0); the walk
// over (chunk, block) pairs holding a valid column, as the wgmma modes'
// half-chunks, so chunks past rows_valid cost nothing; the routed rows are
// re-read from L2 for each chunk.  The running planes: plane 1 in
// registers, plane 2 and the multi-block chunk max in shared memory.  The
// first design (a thread 16 rows x 1 bin, the chunk staged between
// barriers: K9's float stage) ran 8.75 ms at the SIFT-1M slice on the H100
// (PERF.md section 6).
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "ffma_tile.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int LANES = 128;                   // bins: a chunk's columns
constexpr int CODE_MAX = 16;                 // block codes (4 bits)
constexpr int32_t KMIN = -2147483647;        // -(2**31) + 1: invalid entry

// ------------------------------------------ int8 and bf16: wgmma fed by TMA

enum PMode { P_BF16 = 0, P_I8 = 1, P_I8_L2 = 2 };

constexpr int P_WGS = 2;                     // warpgroups: 64 routed rows each
constexpr int P_THREADS = 128 * P_WGS;
constexpr int P_ROWS = 64 * P_WGS;           // routed rows a CTA
constexpr int P_BINS = 64;                   // bins a CTA: one half of the 128
constexpr int P_BOX = P_BINS * 128;          // a unit of B: 64 bins x 128 bytes of d, 8 KB
constexpr int P_A_BOX = P_ROWS * 128;        // a unit of A: the CTA's rows x 128 bytes, 16 KB
constexpr int P_BIAS = P_BINS * 4;           // int8 L2: a half-chunk's 64 bias words
constexpr int P_STAGES_MAX = 8;
constexpr int P_SMEM_MAX = 232448 - 1024;    // the opt-in limit less the static part

// The next (chunk c, block b) half-chunk after (c, b) that holds a valid
// column (with all_cols, K9 without its row mask: every one), chunk-major
// over the cluster's blocks tb..t; false past the last.  Every thread walks
// the same list from the same global values.
__device__ __forceinline__ bool next_half(int& c, int& b, int tb, int t, int nchunks, int col0,
                                          const int32_t* __restrict__ rows_valid, int all_cols) {
  for (;;) {
    if (++b > t) {
      b = tb;
      if (++c >= nchunks) return false;
    }
    if (all_cols || c * 128 + col0 < rows_valid[b]) return true;
  }
}

// K9's key of a score: the 4-bit block code alone in its low bits (K1's
// carry the code and the chunk in eight).
__device__ __forceinline__ uint32_t extract_key(float x, uint32_t code) {
  return ((uint32_t)monotone_key(x) & ~(uint32_t)(CODE_MAX - 1)) | code;
}

// K9's planes of one (row, bin) with their chunks, c = (c1 | c2 << 16): the
// chunk's key x (chunks come in increasing order) shifts plane 1 down where
// it is larger, and replaces plane 2 where it lies between them and differs
// from plane 1, so each plane keeps the lowest chunk holding its key.
__device__ __forceinline__ void extract_update(int32_t x, int chunk, int32_t& p1, int32_t& p2,
                                               int32_t* cs) {
  if (x > p1) {
    p2 = p1;
    p1 = x;
    *cs = chunk | (*cs << 16);
  } else if (x != p1 && x > p2) {
    p2 = x;
    *cs = (*cs & 0xffff) | (chunk << 16);
  }
}

// K9's decoded candidate of a plane key mk of chunk cid and bin lane at the
// cluster's last block t: (value, row), the value mk >> 4 (int8) or mk
// itself (float), the row named by the block code; (KMIN, 0) for KMIN.
template <bool INT8>
__device__ __forceinline__ int2 extract_decode(int32_t mk, int cid, int lane, int t, int blk) {
  if (mk == KMIN) return make_int2(KMIN, 0);
  const int dd = ((t & (CODE_MAX - 1)) - ((CODE_MAX - 1) - (mk & (CODE_MAX - 1)))) &
                 (CODE_MAX - 1);
  return make_int2(INT8 ? mk >> 4 : mk, (t - dd) * blk + cid * LANES + lane);
}

// A routed row's plane update with the chunk's key x: plane 1 the largest,
// plane 2 the largest different from plane 1.  Without `ties`, x never
// equals plane 1 unless both are KMIN, where either form keeps plane 2.
template <bool TIES>
__device__ __forceinline__ void plane_update(int32_t x, int32_t& p1, int32_t& p2) {
  const int32_t lo = min(x, p1);
  p2 = (TIES && x == p1) ? p2 : max(p2, lo);
  p1 = max(p1, x);
}

// The fp32 mode on ffma_tile.cuh's 128 x 128 tile: qg [nblocks, qcap, d]
// and vec [nblocks, d, blk] fp32.  CTA (t, y): last block t, routed rows
// 128 y .. + 127, the tile's columns a chunk's 128 bins.  The walk is
// next_half's (chunk, block) list with col0 = 0 (chunk-major, the
// cluster's blocks inside, only those holding a valid column), nk d-slices
// each; accumulator (i, j) is (row, bin) Place (i, j).  Plane 1 stays in
// registers; plane 2 and, in a cluster of several blocks, the chunk's max
// over its blocks so far live in shared memory laid out by thread ([64][TH]:
// the accesses never conflict; 64 accumulators and three 64-key arrays
// would not fit a thread's 255 registers).
// Two stages of 32 d: 2% faster than three of 16 on the H100 at SIFT-1M.
// EX (K9): its keys, its row mask (all_cols: none, every chunk walked), the
// planes' chunks (c1 | c2 << 16) a third [64][TH] array, and the decoded
// candidates written to out (values) and out_i (rows); that array leaves
// the ring three stages of 8 d.
template <bool EX>
using FTile = std::conditional_t<EX, ffma::Tile<2, 8, 3>, ffma::Tile<2, 32, 2>>;
template <bool EX>
__global__ void __launch_bounds__(FTile<EX>::THREADS, 1)
planes_ffma_kernel(const float* __restrict__ qg, const float* __restrict__ vec,
                   const int32_t* __restrict__ block_first, const int32_t* __restrict__ block_last,
                   const int32_t* __restrict__ rows_valid, int32_t* __restrict__ out,
                   int32_t* __restrict__ out_i, int qcap, int d, int blk, int nplanes, int vec_a,
                   int all_cols) {
  using FT = FTile<EX>;
  constexpr int TH = FT::THREADS, SF = FT::STAGE_FLOATS;
  const int t = blockIdx.x;
  if (block_last[t] == 0) return;
  extern __shared__ __align__(16) float fsm[];
  int32_t* const p2_s = reinterpret_cast<int32_t*>(fsm + FT::STAGES * SF);  // [64][TH]
  int32_t* const m_s = p2_s + 64 * TH;                                    // [64][TH]
  int32_t* const c_s = m_s + 64 * TH;                                     // EX: [64][TH]
  const int tid = threadIdx.x;
  const ffma::Place pl(tid);
  const int r0 = blockIdx.y * FT::BM;
  int tb = t;  // the cluster's first block
  while (tb > 0 && block_first[tb] == 0) --tb;
  const int nchunks = blk / 128;
  const int nk = (d + FT::BK - 1) / FT::BK;

  int32_t p1[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) p1[i][j] = KMIN;
#pragma unroll 8
  for (int e = 0; e < 64; ++e) {
    p2_s[e * TH + tid] = KMIN;
    if (EX) c_s[e * TH + tid] = 0;
  }
  float acc[8][8];
  ffma::zero(acc);

  // A step is (chunk, block, d-slice); the producer's runs STAGES - 1
  // ahead of the consumers'.
  auto advance = [&](int& c, int& b, int& kq) {
    if (++kq < nk) return true;
    kq = 0;
    return next_half(c, b, tb, t, nchunks, 0, rows_valid, all_cols);
  };
  int pc = 0, pb = tb - 1, pk = nk - 1;
  bool phave = advance(pc, pb, pk);
  int cc = pc, cb = pb, ck = pk;
  bool have = phave;
  const ffma::Copier<FT> cp(tid, qcap - r0);
  auto load = [&](int slot) {
    cp.load(fsm + slot * SF, qg + ((size_t)pb * qcap + r0) * d, d, vec_a,
            vec + (size_t)pb * d * blk + pc * 128, blk, 128, true, d, pk * FT::BK);
    phave = advance(pc, pb, pk);
  };
#pragma unroll
  for (int s = 0; s < FT::STAGES - 1; ++s) {
    if (phave) load(s);
    ffma::commit();
  }
  int slot = 0, pslot = FT::STAGES - 1;
  bool first = true;  // the step's (chunk, block) is its chunk's first
  while (have) {
    ffma::wait_stage<FT>();
    __syncthreads();  // the stage has landed, and the one refilled next is read
    if (phave) load(pslot);
    ffma::commit();
    pslot = pslot + 1 == FT::STAGES ? 0 : pslot + 1;
    ffma::fma_slice<FT>(fsm + slot * SF, pl, d - ck * FT::BK, acc);
    slot = slot + 1 == FT::STAGES ? 0 : slot + 1;
    const int b = cb, c = cc;
    const bool done = ck == nk - 1;
    have = advance(cc, cb, ck);
    if (!done) continue;
    // Block b's scores of chunk c: keys, masked past rows_valid, max-folded
    // over the chunk's blocks, and at its last block into the planes.
    const bool last = !have || cc != c;
    const int lim = all_cols ? 128 : rows_valid[b] - c * 128;
    const uint32_t code = (uint32_t)((CODE_MAX - 1) - (b & (CODE_MAX - 1)));
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = (8 * i + j) * TH + tid;
        int32_t x = KMIN;
        if (pl.col(j) < lim)
          x = EX ? (int32_t)extract_key(acc[i][j], code)
                 : (int32_t)(((uint32_t)monotone_key(acc[i][j]) & ~255u) | code << 4 | c);
        if (!first) x = max(x, m_s[e]);
        if (!last) {
          m_s[e] = x;
        } else {
          int32_t p2 = p2_s[e];
          if constexpr (EX)
            extract_update(x, c, p1[i][j], p2, &c_s[e]);
          else
            plane_update<false>(x, p1[i][j], p2);  // keys of two chunks never tie
          p2_s[e] = p2;
        }
      }
    ffma::zero(acc);
    first = last;
  }
  ffma::wait_all();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + pl.row(i);
    if (row >= qcap) continue;
    const size_t ro = ((size_t)t * qcap + row) * (size_t)(nplanes * 128);
    int32_t* o = out + ro;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // columns pl.col(4 h) .. + 3
      const int c0 = pl.col(4 * h), e0 = (8 * i + 4 * h) * TH + tid;
      if constexpr (EX) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          if (p == nplanes) break;
          int2 cand[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int cs = c_s[e0 + u * TH];
            cand[u] = extract_decode<false>(p ? p2_s[e0 + u * TH] : p1[i][4 * h + u],
                                            p ? cs >> 16 : cs & 0xffff, c0 + u, t, blk);
          }
          *reinterpret_cast<int4*>(o + 128 * p + c0) =
              make_int4(cand[0].x, cand[1].x, cand[2].x, cand[3].x);
          *reinterpret_cast<int4*>(out_i + ro + 128 * p + c0) =
              make_int4(cand[0].y, cand[1].y, cand[2].y, cand[3].y);
        }
      } else {
        *reinterpret_cast<int4*>(o + c0) =
            make_int4(p1[i][4 * h], p1[i][4 * h + 1], p1[i][4 * h + 2], p1[i][4 * h + 3]);
        if (nplanes == 2)
          *reinterpret_cast<int4*>(o + 128 + c0) =
              make_int4(p2_s[e0], p2_s[e0 + TH], p2_s[e0 + 2 * TH], p2_s[e0 + 3 * TH]);
      }
    }
  }
}

template <bool EX>
int launch_planes_f32(const void* qg, const void* vec, const void* block_first,
                      const void* block_last, const void* rows_valid, void* out, void* out_i,
                      int nblocks, int qcap, int d, int blk, int nplanes, int all_cols,
                      cudaStream_t stream) {
  if (nblocks == 0 || qcap == 0) return 0;
  using FT = FTile<EX>;
  constexpr size_t smem =
      FT::RING_BYTES + (size_t)(EX ? 3 : 2) * 64 * FT::THREADS * sizeof(int32_t);
  if (const cudaError_t e = cudaFuncSetAttribute(
          planes_ffma_kernel<EX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return (int)e;
  const int vec_a = d % 4 == 0 && reinterpret_cast<uintptr_t>(qg) % 16 == 0;
  const dim3 grid((unsigned)nblocks, (unsigned)((qcap + FT::BM - 1) / FT::BM));
  planes_ffma_kernel<EX><<<grid, FT::THREADS, smem, stream>>>(
      static_cast<const float*>(qg), static_cast<const float*>(vec),
      static_cast<const int32_t*>(block_first), static_cast<const int32_t*>(block_last),
      static_cast<const int32_t*>(rows_valid), static_cast<int32_t*>(out),
      static_cast<int32_t*>(out_i), qcap, d, blk, nplanes, vec_a, all_cols);
  return (int)cudaGetLastError();
}

// qg [nblocks, qcap, ldq] through `tq` (int8: ldq = D rounded up to 16;
// bf16: to 8, the pad zero), the slab [nblocks, d, blk] through `tv` (int8:
// [1, 128, 16] boxes; bf16: [1, 64, 64], 128-byte swizzle), and (L2) the
// bias rows [nblocks, blk] through `tb`.  CTA i: last block t = i / nsub
// and, with x = i % nsub, routed rows 128 (x / 2) .. + 127 and bins 64 (x %
// 2) .. + 63 (a block's CTAs run side by side and share its slab in L2).  kb
// units of 128 bytes of d a half-chunk.  EX (K9): its keys (shifted by 4,
// the block code alone), its row mask (all_cols: none, every half-chunk
// walked), the planes' chunks (c1 | c2 << 16) in shared memory laid out by
// thread ([32][256]), and the decoded candidates written to out (values)
// and out_i (rows).
template <int MODE, bool EX>
__global__ void __launch_bounds__(P_THREADS, 1)
planes_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tb,
                    const int32_t* __restrict__ block_first,
                    const int32_t* __restrict__ block_last,
                    const int32_t* __restrict__ rows_valid, int32_t* __restrict__ out,
                    int32_t* __restrict__ out_i, int qcap, int blk, int kb, int nplanes,
                    int stages, int nsub, int a_ring, int all_cols) {
  using Acc = std::conditional_t<MODE == P_BF16, float, int32_t>;
  constexpr bool INT8 = MODE != P_BF16;
  constexpr bool BIAS = MODE == P_I8_L2;
  constexpr int KD = INT8 ? 128 : 64;  // d a unit
  const int t = (int)(blockIdx.x / nsub), x = (int)(blockIdx.x % nsub);
  if (block_last[t] == 0) return;
  const int rt = x >> 1, col0 = (x & 1) * P_BINS;
  extern __shared__ uint8_t p_smem[];
  __shared__ __align__(8) uint64_t full[P_STAGES_MAX], abar;
  const uint32_t base = (smem_u32(p_smem) + 1023u) & ~1023u;
  uint8_t* const gbase = p_smem + (base - smem_u32(p_smem));
  // Resident A (kb units, none with a_ring), the stages' B and A, two
  // transposed B buffers (int8), the stages' bias words (L2).
  const uint32_t res_a = base, st_b = res_a + (a_ring ? 0 : kb) * P_A_BOX;
  const uint32_t st_a = st_b + stages * P_BOX;
  const uint32_t bk = st_a + stages * P_A_BOX, st_bias = bk + (INT8 ? 2 * P_BOX : 0);
  int32_t* const c_s = reinterpret_cast<int32_t*>(gbase + (st_bias - base) +
                                                  (BIAS ? stages * P_BIAS : 0));  // EX
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2;

  int tb_ = t;  // the cluster's first block
  while (tb_ > 0 && block_first[tb_] == 0) --tb_;
  const int tb0 = tb_;
  // A rides the stages where it changes with the block, or is too wide to
  // stay resident beside two stages (a_ring).
  const bool multi = a_ring || t > tb0;
  const int nchunks = blk / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    mbar_init(&abar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The consumers' unit (cc, cb, cj) and the producer's (thread 0, `stages`
  // units ahead).
  int cc = 0, cb = tb0 - 1, cj = 0;
  bool have = next_half(cc, cb, tb0, t, nchunks, col0, rows_valid, all_cols);
  int pc = cc, pb = cb, pj = 0;
  bool phave = have;
  auto load = [&](int s) {
    const bool with_bias = BIAS && pj == kb - 1;
    mbar_expect_tx(&full[s], P_BOX + (multi ? P_A_BOX : 0) + (with_bias ? P_BIAS : 0));
    const int c0 = pc * 128 + col0;
    if constexpr (INT8) {
#pragma unroll
      for (int g = 0; g < 4; ++g)
        tma_load_3d(st_b + s * P_BOX + g * 2048, &tv, c0 + 16 * g, 128 * pj, pb, &full[s]);
    } else {
      tma_load_3d(st_b + s * P_BOX, &tv, c0, 64 * pj, pb, &full[s]);
    }
    if (multi) tma_load_3d(st_a + s * P_A_BOX, &tq, KD * pj, rt * P_ROWS, pb, &full[s]);
    if (with_bias) tma_load_2d(st_bias + s * P_BIAS, &tb, c0, pb, &full[s]);
    if (++pj == kb) {
      pj = 0;
      phave = next_half(pc, pb, tb0, t, nchunks, col0, rows_valid, all_cols);
    }
  };
  if (threadIdx.x == 0 && have) {
    if (!multi) {
      mbar_expect_tx(&abar, kb * P_A_BOX);
      for (int j = 0; j < kb; ++j)
        tma_load_3d(res_a + j * P_A_BOX, &tq, KD * j, rt * P_ROWS, t, &abar);
    }
    for (int s = 0; s < stages && phave; ++s) load(s);
  }

  // Fragment entry i of this thread: routed row rl + 8 ((i / 2) % 2), bin
  // cl + 8 (i / 4) + i % 2 of the CTA's 64.
  const int rl = 16 * (warp & 3) + (lane >> 2), cl = 2 * (lane & 3);
  Acc d[32], e[32];
  int32_t run[32], p1[32], p2[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    d[i] = 0;
    p1[i] = p2[i] = KMIN;
    if (EX) c_s[i * P_THREADS + threadIdx.x] = 0;
  }
  int rs = 0, kbuf = 0;  // the unit's stage and (int8) transposed buffer
  unsigned rph = 0;      // the parity of the unit's stage round
  int last_c = -1;       // the chunk of the previous half-chunk

  // Make unit (stage s, parity ph) ready for wgmma: its bytes have landed;
  // int8 transposes it into buffer kbuf.
  auto prep = [&](int s, unsigned ph, int buf) {
    mbar_wait_loop(&full[s], ph);
    if constexpr (INT8)
      transpose_unit(reinterpret_cast<const uint32_t*>(gbase + (st_b - base) + s * P_BOX),
                     gbase + (bk - base) + buf * P_BOX);
  };
  // The half-chunk's keys from the copy e, folded into the planes.
  // `lim` is rows_valid[b] less the half-chunk's first column: bins at or
  // past it are KMIN (tested only where lim < 64).
  auto epilogue = [&](int c, int b, bool first, bool last) {
    const int lim = all_cols ? P_BINS : rows_valid[b] - (c * 128 + col0);
    const uint32_t code = (uint32_t)((CODE_MAX - 1) - (b & (CODE_MAX - 1)));
    // K1's keys carry the code and the chunk in 8 bits; K9's the code in 4.
    const uint32_t pack = EX ? code : code << 4 | c;
    constexpr int SHIFT = EX ? 4 : 8;
    const uint32_t* bw = reinterpret_cast<const uint32_t*>(gbase + (st_bias - base) + rs * P_BIAS);
    int32_t key[32];
    auto keys = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = cl + 8 * (i / 4) + (i % 2);
        uint32_t k;
        if constexpr (MODE == P_BF16)
          k = ((uint32_t)monotone_key(__fadd_rn(e[i], 0.0f)) & ~((1u << SHIFT) - 1u)) | pack;
        else if constexpr (BIAS)
          k = ((uint32_t)e[i] << SHIFT) - bw[col];
        else
          k = ((uint32_t)e[i] << SHIFT) | pack;
        key[i] = (decltype(masked)::value && col >= lim) ? KMIN : (int32_t)k;
      }
    };
    if (lim >= P_BINS)
      keys(std::false_type{});
    else
      keys(std::true_type{});
    // The chunk's key (its blocks folded) into the planes.
    auto planes = [&](const int32_t(&x)[32]) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if constexpr (EX)
          extract_update(x[i], c, p1[i], p2[i], &c_s[i * P_THREADS + threadIdx.x]);
        else
          plane_update<BIAS>(x[i], p1[i], p2[i]);
      }
    };
    if (first && last) {
      planes(key);
    } else if (first) {
#pragma unroll
      for (int i = 0; i < 32; ++i) run[i] = key[i];
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) run[i] = max(run[i], key[i]);
      if (last) planes(run);
    }
  };

  if (have) {
    prep(0, 0, 0);
    if constexpr (INT8) fence_proxy_async();
    __syncthreads();
    if (!multi) mbar_wait_loop(&abar, 0);
  }
  while (have) {
    // The unit's product: 4 k-steps, the half-chunk's first unit from zero.
    {
      const uint32_t sa = (multi ? st_a + rs * P_A_BOX : res_a + cj * P_A_BOX) + wg * (P_A_BOX / 2);
      const uint32_t sb = INT8 ? bk + kbuf * P_BOX : st_b + rs * P_BOX;
      fence_acc(d);
      wgmma_fence();
      // A: 128-byte rows, 8-row groups 1 KB apart, a k-step 32 bytes along
      // the row.  B int8: K-major like A; bf16: 128-byte d rows, a k16 step
      // 16 rows (2 KB).
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (INT8)
          wgmma_m64n64k32_s8(d, gmma_desc(sa + kk * 32, 16, 1024),
                             gmma_desc(sb + kk * 32, 16, 1024), cj + kk);
        else
          wgmma_m64n64k16(d, gmma_desc(sa + kk * 32, 16, 1024),
                          gmma_desc(sb + kk * 2048, P_BOX, 1024), cj + kk);
      }
      wgmma_commit();
      fence_acc(d);
    }
    // The next unit, and its preparation while the groups run.
    int nc = cc, nb = cb, nj = cj + 1;
    bool nhave = true;
    if (nj == kb) {
      nj = 0;
      nhave = next_half(nc, nb, tb0, t, nchunks, col0, rows_valid, all_cols);
    }
    const int ns = rs + 1 == stages ? 0 : rs + 1;
    const unsigned nph = rs + 1 == stages ? rph ^ 1u : rph;
    if (nhave) prep(ns, nph, kbuf ^ 1);
    wgmma_wait<0>();
    fence_acc(d);
    if (cj == kb - 1) {
      copy_acc(d, e);
      epilogue(cc, cb, cc != last_c, !nhave || nc != cc);
      last_c = cc;
    }
    if constexpr (INT8) fence_proxy_async();
    __syncthreads();  // stage rs and buffer kbuf are free; the next unit is staged
    if (threadIdx.x == 0 && phave) load(rs);
    cc = nc;
    cb = nb;
    cj = nj;
    rs = ns;
    rph = nph;
    kbuf ^= 1;
    have = nhave;
  }

  const int row0 = rt * P_ROWS + wg * 64 + rl;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = row0 + 8 * ((i / 2) % 2);
    if (row >= qcap) continue;
    const int bin = col0 + cl + 8 * (i / 4);
    const size_t o = ((size_t)t * qcap + row) * (size_t)(nplanes * 128) + bin;
    if constexpr (EX) {
      const int cs0 = c_s[i * P_THREADS + threadIdx.x], cs1 = c_s[(i + 1) * P_THREADS + threadIdx.x];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (p == nplanes) break;
        const int2 a = extract_decode<INT8>(p ? p2[i] : p1[i], p ? cs0 >> 16 : cs0 & 0xffff, bin,
                                            t, blk);
        const int2 b = extract_decode<INT8>(p ? p2[i + 1] : p1[i + 1],
                                            p ? cs1 >> 16 : cs1 & 0xffff, bin + 1, t, blk);
        *reinterpret_cast<int2*>(out + o + 128 * p) = make_int2(a.x, b.x);
        *reinterpret_cast<int2*>(out_i + o + 128 * p) = make_int2(a.y, b.y);
      }
    } else {
      *reinterpret_cast<int2*>(out + o) = make_int2(p1[i], p1[i + 1]);
      if (nplanes == 2) *reinterpret_cast<int2*>(out + o + 128) = make_int2(p2[i], p2[i + 1]);
    }
  }
}

// qg [nblocks, qcap, ldq], vec [nblocks, d, blk] (int8 or bf16), bias
// [nblocks, blk] (int8 L2) or null.  EX: K9's scan, out_i its candidates'
// rows.
template <int MODE, bool EX>
int launch_planes_wgmma(const void* qg, const void* vec, const void* block_first,
                        const void* block_last, const void* rows_valid, const void* bias,
                        void* out, void* out_i, int nblocks, int qcap, int d, int ldq, int blk,
                        int nplanes, int all_cols, cudaStream_t s) {
  if (nblocks == 0 || qcap == 0) return 0;
  static const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  constexpr int KD = MODE == P_BF16 ? 64 : 128;
  const int kb = (d + KD - 1) / KD;
  CUtensorMap tq, tv, tb{};
  if constexpr (MODE == P_BF16) {
    if (const int e = bf16_map_3d(encode, &tq, qg, nblocks, qcap, ldq, P_ROWS)) return e;
    if (const int e = bf16_map_3d(encode, &tv, vec, nblocks, d, blk, 64)) return e;
  } else {
    if (const int e = int8_map_3d(encode, &tq, qg, nblocks, qcap, ldq, 128, P_ROWS, true))
      return e;
    if (const int e = int8_map_3d(encode, &tv, vec, nblocks, d, blk, 16, 128, false)) return e;
    if (MODE == P_I8_L2)
      if (const int e = word_map(encode, &tb, bias, nblocks, blk, P_BINS)) return e;
  }
  const int per_stage = P_BOX + P_A_BOX + (MODE == P_I8_L2 ? P_BIAS : 0);
  // K9's chunks of the planes: [32][P_THREADS] words past the ring.
  const int chunks = EX ? 32 * P_THREADS * 4 : 0;
  const int a_ring = (P_SMEM_MAX - 1024 - kb * P_A_BOX - (MODE == P_BF16 ? 0 : 2 * P_BOX) -
                      chunks) / per_stage < 2;
  const int fixed =
      1024 + (a_ring ? 0 : kb) * P_A_BOX + (MODE == P_BF16 ? 0 : 2 * P_BOX) + chunks;
  const int stages = min(P_STAGES_MAX, (P_SMEM_MAX - fixed) / per_stage);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = fixed + stages * per_stage;
  if (const cudaError_t e = cudaFuncSetAttribute(
          planes_wgmma_kernel<MODE, EX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return (int)e;
  const int nsub = 2 * ((qcap + P_ROWS - 1) / P_ROWS);
  planes_wgmma_kernel<MODE, EX><<<(unsigned)((long long)nblocks * nsub), P_THREADS, smem, s>>>(
      tq, tv, tb, static_cast<const int32_t*>(block_first),
      static_cast<const int32_t*>(block_last), static_cast<const int32_t*>(rows_valid),
      static_cast<int32_t*>(out), static_cast<int32_t*>(out_i), qcap, blk, kb, nplanes, stages,
      nsub, a_ring, all_cols);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries for ctypes.  Each launches on `stream`, allocates nothing, and
// returns cudaGetLastError() (0 = launched).  The wrapper guarantees blk a
// multiple of 128 up to 2048, nplanes in {1, 2} and 16-byte aligned inputs.
// int8: qg [nblocks, qcap, ldq] with ldq = d rounded up to 16 (the pad
// zero), vec [nblocks, d, blk]; `bias` [nblocks, blk] or null (no-bias mode).
extern "C" int ivf_accum_planes_i8(const void* qg, const void* vec, const void* block_first,
                                   const void* block_last, const void* rows_valid,
                                   const void* bias, void* out, int nblocks, int qcap, int d,
                                   int ldq, int blk, int nplanes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bias != nullptr
             ? launch_planes_wgmma<P_I8_L2, false>(qg, vec, block_first, block_last, rows_valid,
                                                   bias, out, nullptr, nblocks, qcap, d, ldq, blk,
                                                   nplanes, 0, s)
             : launch_planes_wgmma<P_I8, false>(qg, vec, block_first, block_last, rows_valid,
                                                nullptr, out, nullptr, nblocks, qcap, d, ldq, blk,
                                                nplanes, 0, s);
}

// bf16: qg [nblocks, qcap, ldq] with ldq = d rounded up to 8 (the pad zero),
// vec [nblocks, d, blk]; no bias rows.
extern "C" int ivf_accum_planes_bf16(const void* qg, const void* vec, const void* block_first,
                                     const void* block_last, const void* rows_valid, void* out,
                                     int nblocks, int qcap, int d, int ldq, int blk, int nplanes,
                                     void* stream) {
  return launch_planes_wgmma<P_BF16, false>(qg, vec, block_first, block_last, rows_valid, nullptr,
                                            out, nullptr, nblocks, qcap, d, ldq, blk, nplanes, 0,
                                            static_cast<cudaStream_t>(stream));
}

// fp32 qg [nblocks, qcap, d] and vec [nblocks, d, blk], no bias rows.
extern "C" int ivf_accum_planes_f32(const void* qg, const void* vec, const void* block_first,
                                    const void* block_last, const void* rows_valid, void* out,
                                    int nblocks, int qcap, int d, int blk, int nplanes,
                                    void* stream) {
  return launch_planes_f32<false>(qg, vec, block_first, block_last, rows_valid, out, nullptr,
                                  nblocks, qcap, d, blk, nplanes, 0,
                                  static_cast<cudaStream_t>(stream));
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
//
// What bounds it on the H100: the scan is K1's (its bounds above; without
// the row mask every column of a block is scored, the padding too); the
// emit reads the candidates and writes k entries a row.
//
// Design: two kernels a call.
// - the scan is K1's, each mode on K1's kernel with EX set: int8 and bf16
//   planes_wgmma_kernel (wgmma m64n64k32 s8 / m64n64k16 bf16 fed by the TMA
//   ring, the int8 units transposed in shared memory, the (chunk, block)
//   walk), fp32 planes_ffma_kernel (ffma_tile.cuh's register tile).  The
//   key is K9's (shift 4, the block code alone), so keys of two chunks can
//   tie: each (row, bin) keeps its planes' chunks beside them (16 bits
//   each, in shared memory laid out by thread), and the walk being
//   chunk-major, "first seen wins" keeps the lowest chunk (extract_update).
//   A wgmma CTA holds 64 of the 128 bins, so the scan writes each row's
//   decoded candidates (value, row) [nblocks, qcap, planes·128] to device
//   memory;
// - the emit (extract_emit_kernel): a warp a routed row of a last block.
//   Each lane sorts its candidates (value desc, row asc) in registers; a
//   pass takes the warp's best head by a shuffle reduction and the lane
//   that held it pops it (finite rows are unique, so that is JAX's mask of
//   the winner's row).  Once only KMIN is left, JAX's argmax returns the
//   lowest row of all the row's candidates, masked ones included: the
//   rest of the row repeats it.  Lane 0 writes each pass, so k has no cap.
namespace {

constexpr int E_WARPS = 8;  // the emit's rows a CTA, a warp each

template <bool INT8, int NC>
__global__ void __launch_bounds__(E_WARPS * 32)
extract_emit_kernel(const int32_t* __restrict__ cand_v, const int32_t* __restrict__ cand_i,
                    const int32_t* __restrict__ block_last, float* __restrict__ out_v,
                    int32_t* __restrict__ out_i, int qcap, int k) {
  constexpr int PER_LANE = NC / 32;
  constexpr unsigned FULL = 0xffffffffu;
  const int t = blockIdx.x, wl = threadIdx.x & 31;
  const int row = blockIdx.y * E_WARPS + (threadIdx.x >> 5);
  if (block_last[t] == 0 || row >= qcap) return;
  const size_t rc = ((size_t)t * qcap + row) * NC;
  int32_t cv[PER_LANE];
  int ci[PER_LANE];
  int fill = INT32_MAX;  // the row's lowest candidate row: JAX's fill id
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    cv[i] = cand_v[rc + i * 32 + wl];
    ci[i] = cand_i[rc + i * 32 + wl];
    fill = min(fill, ci[i]);
  }
  fill = __reduce_min_sync(FULL, fill);
  // The lane's list sorted (value desc, row asc): odd-even transposition.
#pragma unroll
  for (int r = 0; r < PER_LANE; ++r)
#pragma unroll
    for (int i = r & 1; i + 1 < PER_LANE; i += 2)
      if (cv[i + 1] > cv[i] || (cv[i + 1] == cv[i] && ci[i + 1] < ci[i])) {
        const int32_t v = cv[i];
        const int c = ci[i];
        cv[i] = cv[i + 1];
        ci[i] = ci[i + 1];
        cv[i + 1] = v;
        ci[i + 1] = c;
      }
  float* const ov = out_v + ((size_t)t * qcap + row) * k;
  int32_t* const oi = out_i + ((size_t)t * qcap + row) * k;
  for (int p = 0; p < k; ++p) {
    int32_t bv = cv[0];
    int bi = ci[0];
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
      // Only KMIN left: every later pass returns the same (KMIN, fill).
      for (int q = p + wl; q < k; q += 32) {
        ov[q] = -INFINITY;
        oi[q] = fill;
      }
      return;
    }
    if (wl == 0) {
      ov[p] = INT8 ? __int2float_rn(bv) : key_to_f32(bv);
      oi[p] = bi;
    }
    if (cv[0] == bv && ci[0] == bi) {  // this lane held the winner: pop it
#pragma unroll
      for (int i = 0; i + 1 < PER_LANE; ++i) {
        cv[i] = cv[i + 1];
        ci[i] = ci[i + 1];
      }
      cv[PER_LANE - 1] = KMIN;
    }
  }
}

// The scan (K1's kernel of the mode with EX) into cand_v / cand_i, then
// the emit.  mode: P_I8 / P_I8_L2 / P_BF16, or -1 for fp32.
int extract(int mode, const void* qg, const void* vec, const void* block_first,
            const void* block_last, const void* rows_valid, const void* bias, void* cand_v,
            void* cand_i, void* out_v, void* out_i, int nblocks, int qcap, int d, int ldq,
            int blk, int k, int nplanes, int mask_rows, cudaStream_t s) {
  if (nblocks == 0 || qcap == 0) return 0;
  if (k < 1 || (nplanes != 1 && nplanes != 2)) return (int)cudaErrorInvalidValue;
  const int all = !mask_rows;
  int err;
  switch (mode) {
    case P_I8_L2:
      err = launch_planes_wgmma<P_I8_L2, true>(qg, vec, block_first, block_last, rows_valid, bias,
                                               cand_v, cand_i, nblocks, qcap, d, ldq, blk,
                                               nplanes, all, s);
      break;
    case P_I8:
      err = launch_planes_wgmma<P_I8, true>(qg, vec, block_first, block_last, rows_valid, nullptr,
                                            cand_v, cand_i, nblocks, qcap, d, ldq, blk, nplanes,
                                            all, s);
      break;
    case P_BF16:
      err = launch_planes_wgmma<P_BF16, true>(qg, vec, block_first, block_last, rows_valid,
                                              nullptr, cand_v, cand_i, nblocks, qcap, d, ldq,
                                              blk, nplanes, all, s);
      break;
    default:
      err = launch_planes_f32<true>(qg, vec, block_first, block_last, rows_valid, cand_v, cand_i,
                                    nblocks, qcap, d, blk, nplanes, all, s);
  }
  if (err) return err;
  const dim3 grid((unsigned)nblocks, (unsigned)((qcap + E_WARPS - 1) / E_WARPS));
  const auto* cv = static_cast<const int32_t*>(cand_v);
  const auto* ci = static_cast<const int32_t*>(cand_i);
  const auto* bl = static_cast<const int32_t*>(block_last);
  auto* ov = static_cast<float*>(out_v);
  auto* oi = static_cast<int32_t*>(out_i);
  const bool int8 = mode != P_BF16 && mode >= 0;
  if (int8 && nplanes == 2)
    extract_emit_kernel<true, 256><<<grid, E_WARPS * 32, 0, s>>>(cv, ci, bl, ov, oi, qcap, k);
  else if (int8)
    extract_emit_kernel<true, 128><<<grid, E_WARPS * 32, 0, s>>>(cv, ci, bl, ov, oi, qcap, k);
  else if (nplanes == 2)
    extract_emit_kernel<false, 256><<<grid, E_WARPS * 32, 0, s>>>(cv, ci, bl, ov, oi, qcap, k);
  else
    extract_emit_kernel<false, 128><<<grid, E_WARPS * 32, 0, s>>>(cv, ci, bl, ov, oi, qcap, k);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries for ctypes.  Each launches its two kernels on `stream`,
// allocates nothing, and returns cudaGetLastError() (0 = launched).  The
// wrapper guarantees blk % 128 == 0, k >= 1, nplanes in {1, 2}, 16-byte
// aligned inputs, and cand_v / cand_i [nblocks, qcap, nplanes·128] int32
// of scratch (the scan's decoded candidates).  int8: qg [nblocks, qcap,
// ldq] with ldq = d rounded up to 16 (the pad zero), `bias` [nblocks, blk]
// or null (no-bias mode).
extern "C" int ivf_accum_extract_i8(const void* qg, const void* vec, const void* block_first,
                                    const void* block_last, const void* rows_valid,
                                    const void* bias, void* cand_v, void* cand_i, void* out_v,
                                    void* out_i, int nblocks, int qcap, int d, int ldq, int blk,
                                    int k, int nplanes, int mask_rows, void* stream) {
  return extract(bias != nullptr ? P_I8_L2 : P_I8, qg, vec, block_first, block_last, rows_valid,
                 bias, cand_v, cand_i, out_v, out_i, nblocks, qcap, d, ldq, blk, k, nplanes,
                 mask_rows, static_cast<cudaStream_t>(stream));
}

// fp32 (bf16 = 0: qg [nblocks, qcap, d]) or bf16 (bf16 = 1: qg [nblocks,
// qcap, ldq], ldq = d rounded up to 8, the pad zero) qg and vec, no bias
// rows (the JAX function refuses them on float slabs).
extern "C" int ivf_accum_extract_f(const void* qg, const void* vec, const void* block_first,
                                   const void* block_last, const void* rows_valid, void* cand_v,
                                   void* cand_i, void* out_v, void* out_i, int nblocks, int qcap,
                                   int d, int ldq, int blk, int k, int nplanes, int mask_rows,
                                   int bf16, void* stream) {
  return extract(bf16 ? P_BF16 : -1, qg, vec, block_first, block_last, rows_valid, nullptr,
                 cand_v, cand_i, out_v, out_i, nblocks, qcap, d, ldq, blk, k, nplanes, mask_rows,
                 static_cast<cudaStream_t>(stream));
}
