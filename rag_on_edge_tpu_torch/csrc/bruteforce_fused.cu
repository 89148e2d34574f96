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
//   - nbins > 0: over the survivors of each tile of tile_n columns, the
//     two best (score desc, col asc) of every bin col % nbins within the
//     tile.  nbins 128: each column of a chunk is a bin (the table below);
//     any other nbins runs the general binning (the GEN instances,
//     gen_bin_chunk): per-(row, bin) lists in device memory, a chunk's
//     passers through shared memory, a chunk across two tiles (tile_n off
//     the 128-column chunk) binned once for each.
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
// tier) is bound by fp32 FMAs: [1024, 129] x [129, 1M] is 1.35e11 FMAs,
// 3.94 ms at the card's 67 TFLOP/s (2 flops an FMA).
//
// Design of the fp32 mode (fused_f32_kernel).  The first design ran one
// CTA of 256 threads per 32 query rows over all N columns, each thread 16
// rows x 1 column by scalar fmaf from shared memory: a 1024-row
// ground-truth chunk filled 32 of the 132 SMs and ran at 33x its FFMA bound
// (PERF.md section 6).  Now:
// - a 2-D grid: row tiles x column splits.  The wrapper sizes the splits
//   from the SM count (ops/bruteforce_fused.py, split_plan) so that the
//   CTAs fill one wave (B = 1024: 8 row tiles x 16 splits on 132 SMs; two
//   and four waves ran slower, the more so the larger k: every split pays
//   its own first merges), each split at least 32 chunks long.  CTAs of
//   one split run side by side (row tiles fastest), so its slice of the
//   base is read from device memory about once.  Each split writes its
//   rows' sorted top-k (value, id) to its k columns of a [B, nsplit k]
//   buffer, and the wrapper joins the splits with K2 (fused_topk.cu),
//   ties to the lowest position: splits lie in column order and each list
//   in (score desc, id asc) order, so that is the lowest id.  In binned
//   mode the splits fall on tile_n multiples, so the tiles, and the
//   survivors, are the JAX wrapper's.  D is never split: each score is
//   one fmaf a dimension in d order from +0, as the plain version.
// - the register tile of ffma_tile.cuh (shared with K5's and K1's fp32
//   modes), on the pattern of K8's fp32 kernel (tiled_matmul.cu): 128 rows
//   (binned: 64) x 128 columns a CTA, 8 x 8 fp32 accumulators a thread; the
//   query rows' and the base's d-slices of 16 come through a three-stage
//   cp.async ring, so D has no cap, and the query rows are re-read from L2
//   each chunk.  Groups of 4 d past D are skipped.
// - selection on the accumulators.  Each thread tests its 64 scores against
//   its rows' k-th values (registers); a passer goes to its row's candidate
//   buffer in shared memory (one shared atomic per thread and row).  Once a
//   row's buffer could overflow on the next chunk, the next step's barrier
//   (a __syncthreads_or) has the CTA merge every row's buffer: a warp a row,
//   each entry placed at its rank in the union of the sorted list and the
//   buffer (every (score, id) is distinct; a ballot counts the list entries
//   above a buffer entry), ranks below k kept.  Merging every row at once
//   makes the CTA wait once where single rows would stop it again and
//   again.  The lists, up to 256 long, live in the
//   output buffer itself (in L2), so k costs no shared memory (the merge
//   holds a list in 1, 2, 4 or 8 registers a lane, by k); merges are rare
//   after the first chunk.  A larger k runs in passes of 256 (the
//   wrapper's by_passes), each bounded as the int8 and bf16 modes' below.
// - binned: a thread owns the same 64 (row, bin) pairs in every chunk, and
//   keeps each pair's two best passers of the tile in a shared table
//   (strict >, so an equal, later score lands behind); at the tile's end
//   the survivors go to the buffers a warp column at a time and are merged.
//   The threshold only moves at tile ends, and a bin's top two among its
//   passers are its top two wherever they pass.
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
// - wide D: where two stages no longer fit beside the resident query rows
//   (bf16 past D ~ 700 binned, int8 past ~1400), the rows ride in the ring
//   instead, one [64 rows, 128 bytes] box beside each stage's base box,
//   re-read from L2 every chunk: D has no cap.
// - k > 32: the wrapper runs the kernel in passes of 32 (ops/_build.py,
//   by_passes), each pass given every row's last entry of the one before
//   as a bound; only an entry ranked after its bound may enter (in binned
//   mode the bound is applied to the survivors, so the bins are cut as
//   before).  The passes' lists, joined, are the exact top-k.
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "ffma_tile.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int K_MAX = 32;                // the wgmma modes' running top-k width in shared memory
constexpr int F_BN = ffma::BN;           // columns a chunk (and the binned mode's bins)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int32_t fill_of(int32_t) { return INT32_MIN; }
__device__ __forceinline__ float fill_of(float) { return -INFINITY; }
__device__ __forceinline__ int32_t top_of(int32_t) { return INT32_MAX; }
__device__ __forceinline__ float top_of(float) { return INFINITY; }

// (v, i) ranks before (bv, bi): larger score, then lower id.
template <typename T>
__device__ __forceinline__ bool better(T v, int i, T bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The general binning (GEN instances): nbins other than 128.  Each (row,
// bin) keeps its two best (score desc, column asc) of the tile in device
// memory, a slot of lists a CTA: [64 rows][nbins][2] scores and columns.  A
// chunk's scores of passers (the fill value elsewhere) go to shared memory
// S [rows][S_LD]; then one thread a (row, l), l < min(nbins, x_hi - x_lo),
// takes the chunk's columns x_lo + l, x_lo + l + nbins, ... below x_hi of
// the row (one bin, (tcol + l) % nbins) in ascending order: strict >, so an
// equal, later score lands behind.  [x_lo, x_hi) is the part of the chunk
// in one tile, tcol the tile's column of x_lo, col0 the chunk's global
// column.  A tile_n off the 128-column chunk (F11) leaves a chunk across
// two tiles: it is binned once for each, the other tile's columns left out.
constexpr int S_LD = F_BN + 4;

template <typename T>
__device__ __forceinline__ void gen_bin_chunk(T* __restrict__ lv, int32_t* __restrict__ li,
                                              const T* __restrict__ S, int rows, int nbins,
                                              int tcol, int col0, int x_lo, int x_hi, int t,
                                              int nt) {
  const int owners = min(nbins, x_hi - x_lo);
  for (int p = t; p < rows * owners; p += nt) {
    const int r = p / owners, l = p - r * owners;
    const size_t o = ((size_t)r * nbins + (tcol + l) % nbins) * 2;
    for (int x = x_lo + l; x < x_hi; x += nbins) {
      const T v = S[r * S_LD + x];
      if (!(v > lv[o + 1])) continue;
      if (v > lv[o]) {
        lv[o + 1] = lv[o];
        li[o + 1] = li[o];
        lv[o] = v;
        li[o] = col0 + x;
      } else {
        lv[o + 1] = v;
        li[o + 1] = col0 + x;
      }
    }
  }
}

// ------------------------------------------- fp32: register-tiled FFMA
constexpr int F_KMAX = 256;              // the widest top-k a launch: 8 entries a lane

// The CTA's shape: WM warps along the rows (64 rows each) x 4 along the
// chunk's 128 columns (ffma_tile.cuh).  Exact mode: 128 rows, and a buffer
// a row that takes a whole chunk's passers on top of the 28 it may hold
// (it is merged past those); binned: 64 rows beside the table, and a
// buffer that takes one warp column's tile-end survivors (4 lanes x 8 bins
// x 2).
template <bool BINNED>
struct FTile {
  static constexpr int WM = BINNED ? 1 : 2;
  using T = ffma::Tile<WM, 16, 3>;  // three slices of 16: the buffers leave no room for more
  static constexpr int BM = T::BM;
  static constexpr int THREADS = T::THREADS;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int BUF = BINNED ? 64 : 28 + F_BN;
  static constexpr int BJ = (BUF + 31) / 32;
  static constexpr int TABLE = BINNED ? 2 * 64 * THREADS : 0;  // entries of the binned table
  static constexpr size_t SMEM = T::RING_BYTES + ((size_t)BM * BUF * 2 + 5 * BM +
                                                  (size_t)TABLE * 2) * 4;
};

// q [b, ldq] (ldq = d rounded up to 4, the pad zero, 16-byte aligned),
// base [d, ldb] (columns n.. ignored), out_v / out_i [b, ldo]: split s
// writes its rows' top-k, sorted, at columns s k .. s k + k - 1 (the caller
// fills them with (-inf, 0) first).  CTA (x, s) takes rows BM x .. and the
// columns [s split_cols, (s + 1) split_cols) of the base; split_cols is a
// multiple of 128, and in binned mode of tile_n.  Thread accumulator (i, j)
// is (row, column) Place (i, j) of the tile and the chunk (ffma_tile.cuh).
// bound_v / bound_i [b], or null: a later pass of the wrapper's, where
// only an entry ranked after its row's bound may enter (binned: a
// survivor).
template <bool BINNED, int KJ, bool GEN = false>
__global__ void __launch_bounds__(FTile<BINNED>::THREADS, 1)
fused_f32_kernel(const float* __restrict__ q, const float* __restrict__ base,
                 const int32_t* __restrict__ n_valid, const float* __restrict__ bound_v,
                 const int32_t* __restrict__ bound_i, float* __restrict__ out_v,
                 int32_t* __restrict__ out_i, float* __restrict__ gen_v,
                 int32_t* __restrict__ gen_i, int b, int d, int ldq, int n, int ldb, int k,
                 int tile_n, int nbins, int split_cols, int ldo, int vec_b) {
  static_assert(!GEN || BINNED, "the general binning is a binned mode");
  using Tl = FTile<BINNED>;
  constexpr int WM = Tl::WM, BM = Tl::BM, THREADS = Tl::THREADS, WARPS = Tl::WARPS;
  using R = typename Tl::T;
  constexpr int BUF = Tl::BUF, SF = R::STAGE_FLOATS;
  const float FILL = -INFINITY;
  extern __shared__ __align__(16) float fsm[];
  float* const buf_v = fsm + R::STAGES * SF;              // [BM][BUF]
  int32_t* const buf_i = reinterpret_cast<int32_t*>(buf_v + BM * BUF);
  int* const cnt = buf_i + BM * BUF;                         // [BM] candidates held
  int* const len = cnt + BM;                                 // [BM] entries of the list
  float* const thr_s = reinterpret_cast<float*>(len + BM);   // [BM] the k-th value, or -inf
  float* const bnd_v = thr_s + BM;                           // [BM] the bound, or +inf
  int32_t* const bnd_i = reinterpret_cast<int32_t*>(bnd_v + BM);
  float* const tv = reinterpret_cast<float*>(bnd_i + BM);    // binned: [2][64][THREADS]
  int32_t* const ti = reinterpret_cast<int32_t*>(tv + Tl::TABLE);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const ffma::Place pl(tid);
  const int row0 = blockIdx.x * BM, split = blockIdx.y;
  const int c_lo = split * split_cols;
  const int c_hi = min(n, c_lo + split_cols);
  const int nchunks = (c_hi - c_lo + F_BN - 1) / F_BN;
  const int nk = (d + R::BK - 1) / R::BK;
  const int steps = nchunks * nk;
  const int n_bound = n_valid != nullptr ? min(*n_valid, n) : n;
  const int tile_chunks = BINNED ? tile_n / F_BN : 1;
  // GEN: this CTA's slot of lists, all fill at the start.
  const size_t gen_n = GEN ? (size_t)nbins * 2 : 0;
  float* const glv = GEN ? gen_v + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * BM * gen_n
                         : nullptr;
  int32_t* const gli = GEN ? gen_i + (glv - gen_v) : nullptr;
  if constexpr (GEN)
    for (size_t i = tid; i < BM * gen_n; i += THREADS) glv[i] = FILL;

  for (int i = tid; i < BM; i += THREADS) {
    cnt[i] = 0;
    len[i] = 0;
    thr_s[i] = FILL;
    const bool has = bound_i != nullptr && row0 + i < b;
    bnd_v[i] = has ? bound_v[row0 + i] : INFINITY;
    bnd_i[i] = has ? bound_i[row0 + i] : -1;
  }
  for (int i = tid; i < Tl::TABLE; i += THREADS) tv[i] = FILL;

  // The ring: the next load's chunk, d-slice and stage (counters: no step
  // divides).
  const ffma::Copier<R> cp(tid, b - row0);
  const float* const qa = q + (size_t)row0 * ldq;
  int pc = 0, pk = 0, pslot = 0;
  auto load_next = [&]() {
    const int col = c_lo + pc * F_BN;
    cp.load(fsm + pslot * SF, qa, ldq, true, base + col, ldb, n - col, vec_b, d, pk * R::BK);
    if (++pk == nk) {
      pk = 0;
      ++pc;
    }
    pslot = pslot + 1 == R::STAGES ? 0 : pslot + 1;
  };

  float thr[8];
  bool live[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    thr[i] = FILL;
    live[i] = row0 + pl.row(i) < b;
  }
  uint64_t dirty = 0;  // binned: this thread's (row, bin) pairs with a passer this tile
  float acc[8][8];
  ffma::zero(acc);

  // (v, id) is ranked after row rl's bound.
  auto after = [&](int rl, float v, int id) { return better(bnd_v[rl], bnd_i[rl], v, id); };

  // Push this thread's entries of row slot i whose bit is set in `m` into
  // the row's buffer: one shared atomic for all of them.  Returns the
  // buffer's count after them.
  auto push = [&](int i, unsigned m, const float (&v)[16], const int (&id)[16]) {
    const int rl = pl.row(i);
    const int base_at = atomicAdd(&cnt[rl], __popc(m));
    int at = base_at;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if ((m >> j) & 1u) {
        buf_v[rl * BUF + at] = v[j];
        buf_i[rl * BUF + at] = id[j];
        ++at;
      }
    return at;
  };
  // Merge each row's buffer into its sorted list (in out_v / out_i, KJ
  // entries a lane): one warp a row, the warps' rows side by side.
  // Every (score, id) is distinct, so an entry's rank in the union is the
  // count of entries better than it: a list entry's is its position plus
  // the buffer entries better than it, a buffer entry's the list entries
  // and buffer entries better than it.  Ranks below k are written; the list
  // grows to min(k, len + cnt).
  auto merge = [&]() {
    for (int rl = warp; rl < BM; rl += WARPS) {
      const int c = cnt[rl];
      if (c == 0) continue;  // the same in every lane
      const int ln_ = len[rl];
      float* const gv = out_v + (size_t)(row0 + rl) * ldo + (size_t)split * k;
      int32_t* const gi = out_i + (size_t)(row0 + rl) * ldo + (size_t)split * k;
      float lv[KJ], bv[Tl::BJ];
      int li[KJ], bi[Tl::BJ], lr[KJ], brk[Tl::BJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int e = 32 * j + lane;
        lv[j] = e < ln_ ? gv[e] : FILL;
        li[j] = e < ln_ ? gi[e] : INT32_MAX;
        lr[j] = e;
      }
#pragma unroll
      for (int j = 0; j < Tl::BJ; ++j) {
        const int e = 32 * j + lane;
        bv[j] = e < c ? buf_v[rl * BUF + e] : FILL;
        bi[j] = e < c ? buf_i[rl * BUF + e] : INT32_MAX;
        brk[j] = 0;
      }
      // Buffer entry t against every entry: the lanes' list and buffer
      // entries count it when it is better, and a ballot counts the list
      // entries better than it for the lane that holds it.
#pragma unroll 4
      for (int t = 0; t < c; ++t) {
        const float v = buf_v[rl * BUF + t];
        const int id = buf_i[rl * BUF + t];
        int above = 0;
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          lr[j] += better(v, id, lv[j], li[j]);
          above += __popc(__ballot_sync(FULL, better(lv[j], li[j], v, id)));
        }
#pragma unroll
        for (int j = 0; j < Tl::BJ; ++j)
          brk[j] += better(v, id, bv[j], bi[j]) + ((t >> 5) == j && (t & 31) == lane ? above : 0);
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        if (32 * j + lane < ln_ && lr[j] < k) {
          gv[lr[j]] = lv[j];
          gi[lr[j]] = li[j];
          if (lr[j] == k - 1) thr_s[rl] = lv[j];
        }
#pragma unroll
      for (int j = 0; j < Tl::BJ; ++j)
        if (32 * j + lane < c && brk[j] < k) {
          gv[brk[j]] = bv[j];
          gi[brk[j]] = bi[j];
          if (brk[j] == k - 1) thr_s[rl] = bv[j];
        }
      __syncwarp();
      if (lane == 0) {
        len[rl] = min(k, ln_ + c);
        cnt[rl] = 0;
      }
    }
  };
  auto reload = [&]() {
#pragma unroll
    for (int i = 0; i < 8; ++i) thr[i] = thr_s[pl.row(i)];
  };

  __syncthreads();  // the counters and bounds are set before any push
#pragma unroll
  for (int s = 0; s < R::STAGES - 1; ++s) {
    if (s < steps) load_next();
    ffma::commit();
  }
  int c = 0, kt = 0, slot = 0;  // the step's chunk, d-slice and stage
  int cpos = 0;      // binned: the chunk's place in its tile
  bool need = false;  // exact: a row this thread pushed to could overflow on the next chunk
  for (int step = 0; step < steps; ++step) {
    ffma::wait_stage<R>();
    // The step's barrier also tells whether the last chunk's pushes left a
    // row at risk; if so its rows merge before anything is pushed again.
    if (__syncthreads_or(need)) {
      merge();  // every row with a candidate: the CTA waits once for all
      __syncthreads();
      reload();
    }
    need = false;
    if (step + R::STAGES - 1 < steps) load_next();
    ffma::commit();
    ffma::fma_slice<R>(fsm + slot * SF, pl, d - kt * R::BK, acc);
    slot = slot + 1 == R::STAGES ? 0 : slot + 1;
    if (++kt < nk) continue;
    kt = 0;

    // The chunk is scored: the selection.  Only a score above its row's
    // k-th value can enter (an equal one has a higher id and loses).
    const int col0 = c_lo + c * F_BN;
    if constexpr (!BINNED) {
      // Push the passers ranked after the row's bound (a later pass: the
      // test runs only on the rare passers); the merge waits for the next
      // step's barrier (the split's last chunk merges every row after the
      // walk).
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v[16];
        int id[16];
        unsigned m = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = col0 + pl.col(j);
          v[j] = acc[i][j];
          id[j] = col;
          m |= (unsigned)(live[i] && col < n_bound && acc[i][j] > thr[i]) << j;
        }
        if (m && bound_i != nullptr) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (!after(pl.row(i), v[j], id[j])) m &= ~(1u << j);
        }
        if (m) need |= push(i, m, v, id) > BUF - F_BN;
      }
    } else if constexpr (GEN) {
      // The chunk's passers through S (over the table) into the lists.
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = col0 + pl.col(j);
          const float x = acc[i][j];
          tv[pl.row(i) * S_LD + pl.col(j)] =
              live[i] && col < n_bound && x > thr[i] ? x : FILL;
        }
      __syncthreads();
      // The chunk's part in each tile it meets (two where tile_n is off the
      // chunk: split_cols is a multiple of tile_n, so tiles start at
      // multiples of it), each tile's lists taken at the tile's end.
      for (int x = 0; x < F_BN && col0 + x < c_hi;) {
        const int t0 = (col0 + x) / tile_n * tile_n;
        const int x_hi = min(F_BN, t0 + tile_n - col0);
        gen_bin_chunk(glv, gli, tv, BM, nbins, col0 + x - t0, col0, x, x_hi, tid, THREADS);
        __syncthreads();
        if (t0 + tile_n <= col0 + F_BN || c == nchunks - 1) {
          // The tile's end: each row's lists ranked after its bound go to
          // the buffers, BUF a row at a time, each batch merged.
          const int r = tid >> 1;  // two threads a row
          for (size_t b0 = 0; b0 < gen_n; b0 += BUF) {
            for (size_t j = b0 + (tid & 1); j < min(gen_n, b0 + BUF); j += 2) {
              const size_t o = r * gen_n + j;
              const float v = glv[o];
              const int id = gli[o];
              glv[o] = FILL;
              if (v > FILL && after(r, v, id)) {
                const int at = atomicAdd(&cnt[r], 1);
                buf_v[r * BUF + at] = v;
                buf_i[r * BUF + at] = id;
              }
            }
            __syncthreads();
            merge();
            __syncthreads();
          }
          reload();
        }
        x = x_hi;
      }
    } else {
      const bool last = c == nchunks - 1;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = col0 + pl.col(j);
          const float x = acc[i][j];
          if (live[i] && col < n_bound && x > thr[i]) {
            const int p = 8 * i + j;
            const int e0 = p * THREADS + tid, e1 = (64 + p) * THREADS + tid;
            const float v0 = tv[e0];
            if (x > v0) {  // strict: an equal, later score lands behind
              tv[e1] = v0;
              ti[e1] = ti[e0];
              tv[e0] = x;
              ti[e0] = col;
            } else if (x > tv[e1]) {
              tv[e1] = x;
              ti[e1] = col;
            }
            dirty |= 1ull << p;
          }
        }
      if (++cpos == tile_chunks || last) {
        // The tile's end: its survivors ranked after their row's bound go
        // to the buffers a warp column at a time (at most 64 a row), each
        // batch merged.
        cpos = 0;
        if (__syncthreads_or(dirty != 0)) {
          for (int s = 0; s < 4; ++s) {
            if (pl.wn == s && dirty) {
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                if (((dirty >> (8 * i)) & 0xffull) == 0) continue;
                float v[16];
                int id[16];
                unsigned m = 0;
#pragma unroll
                for (int j = 0; j < 16; ++j) {
                  const int e = ((j >> 3) * 64 + 8 * i + (j & 7)) * THREADS + tid;
                  v[j] = tv[e];
                  id[j] = ti[e];
                  m |= (unsigned)(v[j] > FILL && after(pl.row(i), v[j], id[j])) << j;
                  tv[e] = FILL;
                }
                if (m) push(i, m, v, id);
              }
              dirty = 0;
            }
            __syncthreads();
            merge();
            __syncthreads();
          }
          reload();
        }
      }
    }
    ffma::zero(acc);
    ++c;
  }
  ffma::wait_all();
  if constexpr (!BINNED) {
    __syncthreads();
    merge();
  }
}

template <bool BINNED, int KJ, bool GEN = false>
int launch_f32(const void* q, const void* base, const void* n_valid, const void* bound_v,
               const void* bound_i, void* out_v, void* out_i, void* gen_v, void* gen_i, int b,
               int d, int ldq, int n, int ldb, int k, int tile_n, int nbins, int split_cols,
               int nsplit, int ldo, cudaStream_t stream) {
  using Tl = FTile<BINNED>;
  if (const cudaError_t e = cudaFuncSetAttribute(fused_f32_kernel<BINNED, KJ, GEN>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)Tl::SMEM))
    return (int)e;
  const int vec_b = ldb % 4 == 0 && reinterpret_cast<uintptr_t>(base) % 16 == 0;
  const dim3 grid((unsigned)((b + Tl::BM - 1) / Tl::BM), (unsigned)nsplit);
  fused_f32_kernel<BINNED, KJ, GEN><<<grid, Tl::THREADS, Tl::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(base),
      static_cast<const int32_t*>(n_valid), static_cast<const float*>(bound_v),
      static_cast<const int32_t*>(bound_i), static_cast<float*>(out_v),
      static_cast<int32_t*>(out_i), static_cast<float*>(gen_v), static_cast<int32_t*>(gen_i), b,
      d, ldq, n, ldb, k, tile_n, nbins, split_cols, ldo, vec_b);
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
template <int MODE, bool BINNED, bool GEN = false>
__global__ void __launch_bounds__(G_THREADS, 1)
fused_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tb,
                   const __grid_constant__ CUtensorMap tbias, const int32_t* __restrict__ n_valid,
                   const float* __restrict__ alpha, const void* __restrict__ bound_vv,
                   const int32_t* __restrict__ bound_i, void* __restrict__ out_vv,
                   int32_t* __restrict__ out_i, void* __restrict__ gen_vv,
                   int32_t* __restrict__ gen_i, int b, int ldq, int n, int k, int tile_n,
                   int nbins, int stages, int qring) {
  static_assert(!GEN || BINNED, "the general binning is a binned mode");
  using Acc = std::conditional_t<MODE == G_BF16, float, int32_t>;  // the fragment
  using T = std::conditional_t<MODE == G_I8, int32_t, float>;      // the scores
  constexpr bool BIAS = MODE == G_I8_L2;
  constexpr int KD = MODE == G_BF16 ? 64 : 128;  // d a box
  const T FILL = fill_of(T());
  extern __shared__ uint8_t g_smem[];
  __shared__ __align__(8) uint64_t full[G_STAGES_MAX], empty[G_STAGES_MAX], abar;
  const uint32_t base = (smem_u32(g_smem) + 1023u) & ~1023u;
  const int kb = (ldq + KD - 1) / KD;  // boxes a chunk
  // The query rows: resident (kb boxes, loaded once), or with qring one box
  // beside each stage's base box, re-read from L2 every chunk.
  const int resident = qring ? 0 : kb * G_BOX, stage_bytes = G_STAGE + (qring ? G_BOX : 0);
  const uint32_t a_s = base, ring = base + resident;
  T* lv = reinterpret_cast<T*>(g_smem + (base - smem_u32(g_smem)) + resident +
                               stages * stage_bytes);  // [64 rows][K_MAX]
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
      if (!qring) {
        mbar_expect_tx(&abar, kb * G_BOX);
        for (int j = 0; j < kb; ++j) tma_load_2d(a_s + j * G_BOX, &tq, KD * j, row0, &abar);
      }
      int s = 0;          // the stage, and the parity of its round, of the next box
      unsigned ph = 0;
      bool wrapped = false;
      for (int c = 0; c < nchunks; ++c)
        for (int j = 0; j < kb; ++j) {
          if (wrapped) mbar_wait(&empty[s], ph ^ 1u);
          const bool with_bias = BIAS && j == kb - 1;
          mbar_expect_tx(&full[s], stage_bytes + (with_bias ? G_BIAS : 0));
          const uint32_t st = ring + s * stage_bytes;
          if constexpr (MODE == G_BF16) {
            tma_load_2d(st, &tb, G_BN * c, 64 * j, &full[s]);
            tma_load_2d(st + G_BOX, &tb, G_BN * c + 64, 64 * j, &full[s]);
          } else {
            tma_load_2d(st, &tb, 128 * j, G_BN * c, &full[s]);
          }
          if (qring) tma_load_2d(st + G_STAGE, &tq, KD * j, row0, &full[s]);
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
  // GEN: warp w's 16 rows' lists in this CTA's slot, all fill at the start,
  // and its 16 rows of S over the table.
  const size_t gen_n = GEN ? (size_t)nbins * 2 : 0;
  T* const glv = GEN ? static_cast<T*>(gen_vv) + ((size_t)blockIdx.x * G_ROWS + 16 * warp) * gen_n
                     : nullptr;
  int32_t* const gli = GEN ? gen_i + (glv - static_cast<T*>(gen_vv)) : nullptr;
  T* const S = tv + warp * 16 * S_LD;
  if constexpr (GEN)
    for (size_t i = lane; i < 16 * gen_n; i += 32) glv[i] = FILL;
  const int rl = 16 * warp + (lane >> 2), cl = 2 * (lane & 3);
  const int n_bound = n_valid != nullptr ? min(*n_valid, n) : n;
  const int tile_chunks = BINNED ? tile_n / G_BN : 1;
  Acc d[64], e[64];
  T thr[2] = {FILL, FILL};  // the rows' k-th values
  // The rows' bounds (a later pass of the wrapper's): only an entry ranked
  // after (bnd_v, bnd_i) may enter.  No bound: (the type's top, -1).
  T bnd_v[2];
  int bnd_i[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + rl + 8 * h;
    const bool has = bound_i != nullptr && r < b;
    bnd_v[h] = has ? static_cast<const T*>(bound_vv)[r] : top_of(T());
    bnd_i[h] = has ? bound_i[r] : -1;
  }
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
      const uint32_t sb = ring + s * stage_bytes, sa = qring ? sb + G_STAGE : a_s + j * G_BOX;
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
  // GEN: the tile's end: each of the warp's rows takes its lists' entries
  // ranked after its bound, one at a time, and the lists are reset.
  auto gen_flush = [&]() {
    for (int r16 = 0; r16 < 16; ++r16) {
      const int r = 16 * warp + r16, src = (r16 & 7) * 4;
      const T bv = __shfl_sync(FULL, r16 < 8 ? bnd_v[0] : bnd_v[1], src);
      const int bi = __shfl_sync(FULL, r16 < 8 ? bnd_i[0] : bnd_i[1], src);
      for (size_t j0 = 0; j0 < gen_n; j0 += 32) {
        const size_t o = r16 * gen_n + j0 + lane;
        T v = FILL;
        int id = 0;
        if (j0 + lane < gen_n) {
          v = glv[o];
          id = gli[o];
          glv[o] = FILL;
        }
        unsigned m = __ballot_sync(FULL, v > FILL && better(bv, bi, v, id));
        while (m) {
          const int s2 = __ffs(m) - 1;
          m &= m - 1;
          insert_row(lv + r * K_MAX, li + r * K_MAX, k, __shfl_sync(FULL, v, s2),
                     __shfl_sync(FULL, id, s2), lane);
        }
      }
    }
    thr[0] = lv[rl * K_MAX + k - 1];
    thr[1] = lv[(rl + 8) * K_MAX + k - 1];
  };
  // The selection of chunk c from its copy e.  Entry i passes when above
  // its row's threshold and before n_bound (columns past it hold the fill
  // value).  A whole chunk first tests each row's max; only a warp with a
  // passer goes on.
  auto select = [&](int c) {
    const int col0 = c * G_BN, lim = n_bound - col0;
    auto passes = [&](int i) {
      const int h = (i / 2) % 2, cc = 8 * (i / 4) + cl + i % 2;
      return val(i) > thr[h] && cc < lim &&
             (BINNED || better(bnd_v[h], bnd_i[h], val(i), col0 + cc));
    };
    bool any = false;
    if (lim >= G_BN) {
      any = row_max(0) > thr[0] || row_max(1) > thr[1];
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) any |= passes(i);
    }
    if constexpr (GEN) {
      // The chunk's passers through the warp's rows of S into its lists:
      // the chunk's part in each tile it meets (two where tile_n is off the
      // chunk), each tile's lists taken at the tile's end.
      const bool bin = __any_sync(FULL, any);
      if (bin) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
          S[((lane >> 2) + 8 * ((i / 2) % 2)) * S_LD + 8 * (i / 4) + cl + i % 2] =
              passes(i) ? val(i) : FILL;
        __syncwarp();
      }
      for (int x = 0; x < G_BN && col0 + x < n;) {
        const int t0 = (col0 + x) / tile_n * tile_n;
        const int x_hi = min(G_BN, t0 + tile_n - col0);
        if (bin) {
          gen_bin_chunk(glv, gli, S, 16, nbins, col0 + x - t0, col0, x, x_hi, lane, 32);
          __syncwarp();
        }
        if (t0 + tile_n <= col0 + G_BN || c == nchunks - 1) gen_flush();
        x = x_hi;
      }
    } else if (__any_sync(FULL, any)) {
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
    if (BINNED && !GEN && (++cpos == tile_chunks || c == nchunks - 1)) {
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
        const int h = (i / 2) % 2;
        const int r = 16 * warp + (src >> 2) + 8 * h;
        const int cb = tile0 + 8 * (i / 4) + 2 * (src & 3) + i % 2;
        // The bound is applied to the survivors, after the bins are cut.
        const T bv = __shfl_sync(FULL, h ? bnd_v[1] : bnd_v[0], src);
        const int bi = __shfl_sync(FULL, h ? bnd_i[1] : bnd_i[0], src);
        if (better(bv, bi, v0, cb + G_BN * c0))
          insert_row(lv + r * K_MAX, li + r * K_MAX, k, v0, cb + G_BN * c0, lane);
        if (v1 > FILL && better(bv, bi, v1, cb + G_BN * c1))
          insert_row(lv + r * K_MAX, li + r * K_MAX, k, v1, cb + G_BN * c1, lane);
      }
      thr[0] = lv[rl * K_MAX + k - 1];
      thr[1] = lv[(rl + 8) * K_MAX + k - 1];
      cpos = 0;
      tile0 += tile_n;
    }
  };

  // Per chunk: the product, then the selection from its copy (a selection
  // beside the next chunk's product has ptxas serialize the groups: C7515).
  if (!qring) mbar_wait_loop(&abar, 0);
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
template <int MODE, bool BINNED, bool GEN = false>
int launch_wgmma(const void* q, const void* base, const void* alpha, const void* bias,
                 const void* n_valid, const void* bound_v, const void* bound_i, void* out_v,
                 void* out_i, void* gen_v, void* gen_i, int b, int d, int ldq, int n, int ldb,
                 int k, int tile_n, int nbins, cudaStream_t stream) {
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
  const int cap = MODE == G_BF16 ? G_STAGES_BF16 : G_STAGES_MAX;
  const int bias_bytes = MODE == G_I8_L2 ? G_BIAS : 0;
  const int fixed = 1024 + 2 * G_TOPK * 4 + (BINNED ? G_TABLE_BYTES : 0);
  // The query rows stay resident where two stages fit beside them; past
  // that (wide D) they ride in the ring, a box beside each base box.
  const int qring = (G_SMEM_MAX - fixed - kb * G_BOX) / (G_STAGE + bias_bytes) < 2;
  const int per_stage = G_STAGE + bias_bytes + (qring ? G_BOX : 0);
  const int resident = qring ? 0 : kb * G_BOX;
  const int stages = min(cap, (G_SMEM_MAX - fixed - resident) / per_stage);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int smem = fixed + resident + stages * per_stage;
  if (const cudaError_t e = cudaFuncSetAttribute(fused_wgmma_kernel<MODE, BINNED, GEN>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 smem))
    return (int)e;
  fused_wgmma_kernel<MODE, BINNED, GEN>
      <<<(unsigned)((b + G_ROWS - 1) / G_ROWS), G_THREADS, smem, stream>>>(
          tq, tb, tbias, static_cast<const int32_t*>(n_valid), static_cast<const float*>(alpha),
          bound_v, static_cast<const int32_t*>(bound_i), out_v, static_cast<int32_t*>(out_i),
          gen_v, static_cast<int32_t*>(gen_i), b, ldq, n, k, tile_n, nbins, stages, qring);
  return (int)cudaGetLastError();
}

// What the binned modes take: tile_n a multiple of nbins, and the general
// binning where its lists are given (any nbins), else nbins 128 on the
// table.
bool bins_ok(int nbins, int tile_n, const void* gen_v) {
  return nbins == 0 || (nbins > 0 && tile_n % nbins == 0 && (nbins == 128 || gen_v != nullptr));
}

template <int MODE>
int launch_wgmma_binned(int nbins, const void* q, const void* base, const void* alpha,
                        const void* bias, const void* n_valid, const void* bound_v,
                        const void* bound_i, void* out_v, void* out_i, void* gen_v, void* gen_i,
                        int b, int d, int ldq, int n, int ldb, int k, int tile_n,
                        cudaStream_t s) {
  if (nbins != 0 && gen_v != nullptr)
    return launch_wgmma<MODE, true, true>(q, base, alpha, bias, n_valid, bound_v, bound_i, out_v,
                                          out_i, gen_v, gen_i, b, d, ldq, n, ldb, k, tile_n,
                                          nbins, s);
  return nbins ? launch_wgmma<MODE, true>(q, base, alpha, bias, n_valid, bound_v, bound_i, out_v,
                                          out_i, nullptr, nullptr, b, d, ldq, n, ldb, k, tile_n,
                                          nbins, s)
               : launch_wgmma<MODE, false>(q, base, alpha, bias, n_valid, bound_v, bound_i,
                                           out_v, out_i, nullptr, nullptr, b, d, ldq, n, ldb, k,
                                           tile_n, 0, s);
}

}  // namespace

// C entries for ctypes.  Each launches on `stream`, allocates nothing, and
// returns cudaGetLastError() (0 = launched).  `n_valid` may be null.  The
// wrapper guarantees k <= n and tile_n a multiple of nbins.  Binned, the
// general binning runs where gen_v / gen_i are given (every nbins but 128,
// and 128 on int8 and bf16 tiles past 65536 chunks, the table's reach): 64·nbins·2
// scores (the scores' type) and int32 columns for each CTA (int8 and bf16:
// ceil(b / 64) CTAs; fp32: ceil(b / 64) · nsplit), else null.  The
// int8 and bf16 entries take 1 <= k <= 32 and, for a later pass of the
// wrapper's (ops/_build.py, by_passes), each row's bound (bound_v [b] of
// the scores' type, bound_i [b] int32, or both null): only an entry ranked
// after it may enter, the bound applied to the binned mode's survivors.

// fp32: q [b, ldq] (ldq = d rounded up to 4, the pad zero, 16-byte
// aligned) and base_t [d, ldb] fp32 (columns n.. ignored); out_v / out_i
// [b, ldo], split s's sorted top-k at columns s k .. s k + k - 1, filled
// with (-inf, 0) by the caller.  nsplit splits of split_cols columns (a
// multiple of 128, and of tile_n in binned mode: of their least common
// multiple); k <= 256 a launch, a
// larger k in passes of 256 with the bounds as above.
extern "C" int bruteforce_fused_topk_f32(const void* q, const void* base_t, const void* n_valid,
                                         const void* bound_v, const void* bound_i, void* out_v,
                                         void* out_i, void* gen_v, void* gen_i, int b, int d,
                                         int ldq, int n, int ldb, int k, int tile_n, int nbins,
                                         int split_cols, int nsplit, int ldo, void* stream) {
  if (b == 0) return 0;
  if (k < 1 || k > F_KMAX || ldq % 4 || split_cols % F_BN || nsplit < 1 || ldo < nsplit * k ||
      !bins_ok(nbins, tile_n, gen_v) || (nbins != 0 && split_cols % tile_n))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The list's registers a lane in the merge: 1, 2, 4 or 8.
#define RAG_F32(BINNED, KJ, GEN)                                                                \
  launch_f32<BINNED, KJ, GEN>(q, base_t, n_valid, bound_v, bound_i, out_v, out_i, gen_v, gen_i, \
                              b, d, ldq, n, ldb, k, tile_n, nbins, split_cols, nsplit, ldo, s)
  const int kj = k <= 32 ? 1 : k <= 64 ? 2 : k <= 128 ? 4 : 8;
  if (nbins != 0 && gen_v != nullptr) {
    switch (kj) {
      case 1: return RAG_F32(true, 1, true);
      case 2: return RAG_F32(true, 2, true);
      case 4: return RAG_F32(true, 4, true);
      default: return RAG_F32(true, 8, true);
    }
  }
  switch (kj + (nbins != 0 ? 16 : 0)) {
    case 1: return RAG_F32(false, 1, false);
    case 2: return RAG_F32(false, 2, false);
    case 4: return RAG_F32(false, 4, false);
    case 8: return RAG_F32(false, 8, false);
    case 17: return RAG_F32(true, 1, false);
    case 18: return RAG_F32(true, 2, false);
    case 20: return RAG_F32(true, 4, false);
    default: return RAG_F32(true, 8, false);
  }
#undef RAG_F32
}

// int8: q [b, ldq] and the K-major base [n, ldq] with ldq = d rounded up
// to a multiple of 16 (the pad zero), both 16-byte aligned; alpha [b] and
// bias [n] (16-byte aligned) for L2, f32 out, or both null, int32 out.
extern "C" int bruteforce_fused_topk_i8(const void* q, const void* base_k, const void* alpha,
                                        const void* bias, const void* n_valid,
                                        const void* bound_v, const void* bound_i, void* out_v,
                                        void* out_i, void* gen_v, void* gen_i, int b, int ldq,
                                        int n, int k, int tile_n, int nbins, void* stream) {
  if (b == 0) return 0;
  if (k < 1 || k > K_MAX || !bins_ok(nbins, tile_n, gen_v)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bias != nullptr
             ? launch_wgmma_binned<G_I8_L2>(nbins, q, base_k, alpha, bias, n_valid, bound_v,
                                            bound_i, out_v, out_i, gen_v, gen_i, b, ldq, ldq, n,
                                            ldq, k, tile_n, s)
             : launch_wgmma_binned<G_I8>(nbins, q, base_k, nullptr, nullptr, n_valid,
                                         bound_v, bound_i, out_v, out_i, gen_v, gen_i, b, ldq,
                                         ldq, n, ldq, k, tile_n, s);
}

// The bf16 mode: q [b, ldq] bf16 with ldq = d rounded up to a multiple of
// 16 (the pad zero), base_t [d, n] bf16 at a row pitch of ldb elements (a
// multiple of 8), both 16-byte aligned; f32 out.
extern "C" int bruteforce_fused_topk_bf16(const void* q, const void* base_t, const void* n_valid,
                                          const void* bound_v, const void* bound_i, void* out_v,
                                          void* out_i, void* gen_v, void* gen_i, int b, int d,
                                          int ldq, int n, int ldb, int k, int tile_n, int nbins,
                                          void* stream) {
  if (b == 0) return 0;
  if (k < 1 || k > K_MAX || !bins_ok(nbins, tile_n, gen_v)) return (int)cudaErrorInvalidValue;
  return launch_wgmma_binned<G_BF16>(nbins, q, base_t, nullptr, nullptr, n_valid, bound_v,
                                     bound_i, out_v, out_i, gen_v, gen_i, b, d, ldq, n, ldb, k,
                                     tile_n, static_cast<cudaStream_t>(stream));
}
