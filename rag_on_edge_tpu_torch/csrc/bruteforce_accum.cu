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
// no bias rows: it rides an augmented dimension held in the tiles.  The int8
// L2 bias rows carry -code(t) in their low bits (l2_bias_rows builds them
// so), which is what makes a key's low bits name its tile.
//
// What bounds it on the H100: multiply-adds.  B = 8192, D = 128, N = 1M is
// 1.07e12 MACs against a 128 MB base (int8; 256 MB in bf16).  int8 and bf16
// run the tensor cores (1.1 ms at 1,979 T int8 ops/s, 2.1 ms at 989 bf16
// TFLOP/s) and stream the base from L2 once per 192-row block (5.6 GB int8,
// 11 GB bf16 at B = 8192); fp32 runs fp32 FMAs (32 ms at the 67 TFLOP/s
// peak).  The fold and the final top-k add a few instructions per score and
// a round trip of the per-bin state; on the tensor-core modes the fold, not
// the product, is most of each tile's time.
//
// Design of the fp32 mode (accum_ffma_kernel):
// - pass 1: K3 fp32's register tile (ffma_tile.cuh): one CTA of 256
//   threads per (128 query rows, 128 bins), 8 x 8 fp32 accumulators a
//   thread, the rows' and the tile's d-slices of 32 through a two-stage
//   cp.async ring (any D; each score one fmaf a dimension in d order from
//   +0), the steps running through every live tile's slices in turn.  CTAs
//   take row blocks fastest, so those in flight share a bin slice of each
//   tile in L2.  After a tile's last slice its 64 scores a thread fold as
//   the bf16 mode's below: a threshold a (row, bin) in registers, the tile
//   that set it in shared memory (64 thresholds, 64 tiles and 64
//   accumulators would not fit a thread's 255 registers).  The first
//   design staged each [D, 128] chunk between barriers and had a thread
//   score 16 rows x 1 bin from shared memory, reading 20 words for 16 FMAs
//   (100.8 ms at the SIFT-1M shape on the H100, PERF.md section 6).
// Design of the bf16 and int8 modes (accum_wgmma_kernel, hopper_mma.cuh):
// - pass 1: one CTA of up to 416 threads per (64 wgs query rows, 64 bins):
//   wgs consumer warpgroups of 64 rows (three; int8 takes fewer when the
//   batch has fewer rows, or where D leaves the ring under four stages) and
//   one producer warp.  The CTA's query rows (zero-padded to a multiple of
//   16 by the wrapper) are loaded once by TMA and stay in shared memory.
//   The producer streams each live tile's [D, 64] slab through a ring of
//   128-byte-wide boxes: bf16 [64 d, 64 bins] boxes of a 3-D tensor map over
//   [T, D, tile_n], so the d tail past D arrives as zeros and never as the
//   next tile's rows; int8 [64 bins, 128 d] boxes of the wrapper's K-major
//   copy [T, tile_n, ldq] (8-bit wgmma operands have no transpose bit, so B
//   must be K-major in shared memory: the wrapper transposes the tiles with
//   one torch copy a call, ~0.4 ms at SIFT-1M on the H100 (_build.kmajor,
//   PERF.md section 6), and keeps no second copy).
//   Each warpgroup runs four wgmma a box (bf16 m64n64k16 -> f32, int8
//   m64n64k32 s8 -> s32), one commit group a box, keeping one group in
//   flight, then folds the tile.  CTAs take row blocks fastest, so those in
//   flight walk the same bin slice and the base is read from device memory
//   about once; three warpgroups (not two) cut the L2 traffic by a third and
//   ran faster.  int8 L2: the tile's 64 bias words ride in the stage of its
//   last box (one more TMA box on the same barrier), and that stage is
//   released after the fold has read them.
// - what keeps the wgmma groups asynchronous (ptxas serializes them, C7520,
//   on any of these): only wgmma writes the accumulators (a tile's first
//   step has scale-d 0); the fold reads a copy made by explicit moves after
//   the last group retired, never the fragment, and never beside the
//   warpgroup's next product; every box takes four k-steps (the tail past
//   ldq is TMA's zeros), so no wgmma sits in a loop of varying count.
// - the fold, one level instead of two: the group max followed by the
//   strict merge keeps, for each bin, the first tile whose key with its low
//   log2(group) bits cleared is largest (within a group the larger code, the
//   earlier tile, wins a tie; across groups the strict merge keeps the
//   earlier one); so does one running (cleared key, tile) replaced only by a
//   strictly larger cleared key, tiles in order.  Each thread keeps it for
//   its 32 (row, bin) pairs, 2 x 32 registers, updated without a branch;
//   only the last tile tests the columns past n, and the ring's stage and
//   parity are counters, so the fold, which bounds the kernel, stays a few
//   instructions a score.
//   bf16: cleared(monotone(d)) > rv holds exactly when d > key_to_f32(rv |
//   low), one float compare a score (scores are finite; an exact-zero dot
//   is +0, as the plain fp32 product gives it).  int8: the cleared key is
//   (u32)dot << shift (IP) or ((u32)dot << shift - bias) & ~low (L2), one
//   integer compare a score; a valid key never clears to KMIN's value, so
//   KMIN as the start loses to every valid key as the two-level fold's does.
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

#include "ffma_tile.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int THREADS = 256;             // pass 2: threads a row
constexpr int32_t KMIN = -2147483647;    // -(2**31) + 1: a masked column
constexpr int EPT = 8;                   // bins per thread in pass 2 (tile_n <= 2048)
constexpr unsigned FULL = 0xffffffffu;

// Pass 1 of the fp32 mode on ffma_tile.cuh's 128 x 128 tile: q [b, d] and
// tiles [T, d, tile_n] fp32.  CTA i takes row block i % nrb (128 query
// rows) and bins 128 (i / nrb) .. + 127 of every tile; accumulator (i, j)
// is (row, bin) Place (i, j).  Each (row, bin) keeps its threshold in a
// register (the bf16 mode's fold: a score improves its bin when above it,
// and then it becomes key_to_f32(monotone(s) | low)) and its tile in
// shared memory, laid out by thread ([64][THREADS]: the stores never
// conflict), -1 while no tile has improved it.
// Two stages of 32 d: 6% faster than three of 16 on the H100 at SIFT-1M.
using ATile = ffma::Tile<2, 32, 2>;
__global__ void __launch_bounds__(ATile::THREADS, 1)
accum_ffma_kernel(const float* __restrict__ q,           // [b, d]
                  const float* __restrict__ tiles,       // [T, d, tile_n]
                  int32_t* __restrict__ rv_out,          // [b, tile_n]
                  int32_t* __restrict__ ri_out,          // [b, tile_n]
                  int b, int d, int tile_n, int n, int low, int nrb, int vec_a) {
  constexpr int TH = ATile::THREADS, SF = ATile::STAGE_FLOATS;
  extern __shared__ __align__(16) float fsm[];
  int32_t* const ti_s = reinterpret_cast<int32_t*>(fsm + ATile::STAGES * SF);  // [64][TH]
  const int tid = threadIdx.x;
  const ffma::Place pl(tid);
  const int row0 = (int)(blockIdx.x % nrb) * ATile::BM;
  const int bin0 = (int)(blockIdx.x / nrb) * ffma::BN;
  const int t_live = (n + tile_n - 1) / tile_n;  // tiles holding a valid column
  const int nk = (d + ATile::BK - 1) / ATile::BK;
  const int steps = t_live * nk;
  const uint32_t lowu = (uint32_t)low;

  // The ring: the next load's tile, d-slice and stage (counters: no step
  // divides).
  const ffma::Copier<ATile> cp(tid, b - row0);
  const float* const qa = q + (size_t)row0 * d;
  int pt = 0, pk = 0, pslot = 0;
  auto load_next = [&]() {
    cp.load(fsm + pslot * SF, qa, d, vec_a, tiles + (size_t)pt * d * tile_n + bin0, tile_n,
            ffma::BN, true, d, pk * ATile::BK);
    if (++pk == nk) {
      pk = 0;
      ++pt;
    }
    pslot = pslot + 1 == ATile::STAGES ? 0 : pslot + 1;
  };

  float thr[8][8], acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) thr[i][j] = -INFINITY;  // every finite score improves
  ffma::zero(acc);
#pragma unroll 8
  for (int p = 0; p < 64; ++p) ti_s[p * TH + tid] = -1;

#pragma unroll
  for (int s = 0; s < ATile::STAGES - 1; ++s) {
    if (s < steps) load_next();
    ffma::commit();
  }
  int t = 0, kt = 0, slot = 0;  // the step's tile, d-slice and stage
  for (int step = 0; step < steps; ++step) {
    ffma::wait_stage<ATile>();
    __syncthreads();  // the stage has landed, and the one refilled next is read
    if (step + ATile::STAGES - 1 < steps) load_next();
    ffma::commit();
    ffma::fma_slice<ATile>(fsm + slot * SF, pl, d - kt * ATile::BK, acc);
    slot = slot + 1 == ATile::STAGES ? 0 : slot + 1;
    if (++kt < nk) continue;
    kt = 0;
    // Tile t is scored: the fold, branch-free.  Only the last tile has
    // bins at or past lim, its columns past n, which never improve.
    const int lim = t == t_live - 1 ? n - t * tile_n - bin0 : ffma::BN;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x = acc[i][j];
        const bool up = x > thr[i][j] && pl.col(j) < lim;
        const uint32_t bits = __float_as_uint(x);
        const uint32_t nt = (bits | lowu) ^ ((uint32_t)((int32_t)bits >> 31) & lowu);
        thr[i][j] = up ? __uint_as_float(nt) : thr[i][j];
        if (up) ti_s[(8 * i + j) * TH + tid] = t;
      }
    ffma::zero(acc);
    ++t;
  }
  ffma::wait_all();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + pl.row(i);
    if (row >= b) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // columns pl.col(4 h) .. + 3
      int v[4], c[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 4 * h + u;
        const int tt = ti_s[(8 * i + j) * TH + tid];
        v[u] = tt >= 0 ? (int32_t)((uint32_t)monotone_key(thr[i][j]) & ~lowu) : KMIN;
        c[u] = tt >= 0 ? tt * tile_n + bin0 + pl.col(j) : 0;
      }
      const size_t o = (size_t)row * tile_n + bin0 + pl.col(4 * h);
      *reinterpret_cast<int4*>(rv_out + o) = make_int4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<int4*>(ri_out + o) = make_int4(c[0], c[1], c[2], c[3]);
    }
  }
}

// ---------------------------------------- bf16 and int8: wgmma fed by TMA

enum WMode { W_BF16 = 0, W_I8 = 1, W_I8_L2 = 2 };

constexpr int W_BN = 64;                  // bins per CTA (one m64n64 fragment)
constexpr int W_WGS = 3;                  // consumer warpgroups at most, 64 query rows each
constexpr int W_THREADS = 128 * W_WGS + 32;  // + one producer warp
constexpr int W_BOX = 64 * 128;           // one [64 rows, 128 bytes] swizzled box, 8 KB
constexpr int W_A_WG = 64 * 128;          // a warpgroup's 64 query rows x 128 bytes
constexpr int W_BIAS = W_BN * 4;          // int8 L2: a tile's 64 bias words
constexpr int W_STAGES_MAX = 16;
constexpr int W_SMEM_MAX = 232448 - 1024; // the opt-in limit less the static barriers

// Pass 1 of the bf16 and int8 modes.  q [b, ldq] (ldq = d rounded up to
// 16, the pad zero) through `tq`.  bf16: tiles [T, d, tile_n] through the
// 3-D map `tt`; int8: the K-major tiles [T, tile_n, ldq] through the 2-D
// map `tt` over [T tile_n, ldq], and (L2) the bias rows [T, tile_n] through
// `tbias`.  CTA i takes row block i % nrb (64 wgs rows) and bins 64 (i /
// nrb) .. + 63.  The ring holds the tiles' 128-byte boxes in turn (kb a
// tile: 64 d in bf16, 128 in int8); producer and consumers keep its stage
// and round parity in counters, so no step divides.
template <int MODE>
__global__ void __launch_bounds__(W_THREADS, 1)
accum_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tt,
                   const __grid_constant__ CUtensorMap tbias, int32_t* __restrict__ rv_out,
                   int32_t* __restrict__ ri_out, int b, int ldq, int tile_n, int n, int low,
                   int nrb, int stages, int wgs, int a_ring) {
  using Acc = std::conditional_t<MODE == W_BF16, float, int32_t>;
  constexpr bool BIAS = MODE == W_I8_L2;
  constexpr int KD = MODE == W_BF16 ? 64 : 128;  // d a box
  extern __shared__ uint8_t w_smem[];
  __shared__ __align__(8) uint64_t full[W_STAGES_MAX], empty[W_STAGES_MAX], abar;
  const uint32_t base = (smem_u32(w_smem) + 1023u) & ~1023u;
  const int kb = (ldq + KD - 1) / KD;        // boxes a tile
  const int a_box = wgs * W_A_WG;            // the CTA's rows x one box of d
  // The query rows stay resident (kb boxes), or with a_ring (wide D) ride
  // each stage beside its base box, re-read from L2 for every tile.
  const int stage_bytes = W_BOX + (a_ring ? a_box : 0);
  const uint32_t a_s = base, ring = base + (a_ring ? 0 : kb) * a_box;
  const uint32_t bias_s = ring + stages * stage_bytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rb = (int)(blockIdx.x % nrb), bin0 = (int)(blockIdx.x / nrb) * W_BN;
  const int t_live = (n + tile_n - 1) / tile_n;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);                // the producer's expect_tx; the TMA bytes
      mbar_init(&empty[s], 128 * wgs);       // every consumer thread
    }
    mbar_init(&abar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * wgs) {  // producer
    if (lane == 0) {
      if (!a_ring) {
        mbar_expect_tx(&abar, kb * a_box);
        for (int j = 0; j < kb; ++j)
          tma_load_2d(a_s + j * a_box, &tq, KD * j, rb * 64 * wgs, &abar);
      }
      int s = 0;          // the stage, and the parity of its round, of the next box
      unsigned ph = 0;
      bool wrapped = false;
      for (int t = 0; t < t_live; ++t)
        for (int j = 0; j < kb; ++j) {
          if (wrapped) mbar_wait(&empty[s], ph ^ 1u);
          const bool with_bias = BIAS && j == kb - 1;
          mbar_expect_tx(&full[s], stage_bytes + (with_bias ? W_BIAS : 0));
          if constexpr (MODE == W_BF16)
            tma_load_3d(ring + s * stage_bytes, &tt, bin0, 64 * j, t, &full[s]);
          else
            tma_load_2d(ring + s * stage_bytes, &tt, 128 * j, t * tile_n + bin0, &full[s]);
          if (a_ring) tma_load_2d(ring + s * stage_bytes + W_BOX, &tq, KD * j, rb * 64 * wgs,
                                  &full[s]);
          if (with_bias) tma_load_2d(bias_s + s * W_BIAS, &tbias, bin0, t, &full[s]);
          if (++s == stages) {
            s = 0;
            ph ^= 1u;
            wrapped = true;
          }
        }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the block; this
  // thread's fragment entry i is (row rl + 8 ((i / 2) % 2), bin cl + 8 (i / 4)
  // + i % 2).  st is the running state: bf16 the threshold, int8 the cleared key.
  const int wg = warp >> 2;
  const int rl = 16 * (warp & 3) + (lane >> 2), cl = 2 * (lane & 3);
  Acc d[32], e[32], st[32];
  int ti[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    d[i] = 0;
    if constexpr (MODE == W_BF16)
      st[i] = -INFINITY;  // nothing yet: every finite score improves
    else
      st[i] = KMIN;
    ti[i] = -1;
  }
  const uint32_t lowu = (uint32_t)low;
  const int shift = __popc(low);
  int rs = 0, last_s = 0;    // the ring: the next box's stage, the last box's
  unsigned rph = 0;          // the parity of the next box's round

  // The product of tile t into d, asynchronously: the tile's first step
  // starts from zero (scale-d 0), one group a box, and each box released
  // once the next box's group is issued and its own has retired.
  auto issue = [&]() {
    for (int j = 0; j < kb; ++j) {
      const int s = rs;
      mbar_wait_loop(&full[s], rph);
      const uint32_t sb = ring + s * stage_bytes;
      const uint32_t sa = (a_ring ? sb + W_BOX : a_s + j * a_box) + wg * W_A_WG;
      fence_acc(d);
      wgmma_fence();
      // A: 128-byte rows, 8-row groups 1 KB apart, a k-step 32 bytes along
      // the row.  B: bf16 128-byte d rows, a k16 step 16 rows (2 KB); int8
      // K-major like A, 128-byte bin rows, a k32 step 32 bytes along them.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if constexpr (MODE == W_BF16)
          wgmma_m64n64k16(d, gmma_desc(sa + kk * 32, 16, 1024),
                          gmma_desc(sb + kk * 2048, W_BOX, 1024), j + kk);
        else
          wgmma_m64n64k32_s8(d, gmma_desc(sa + kk * 32, 16, 1024),
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
  // The tile's product is done: release its last box (int8 L2: after the
  // fold, which reads the bias words in its stage) and copy it to e.
  auto retire = [&]() {
    wgmma_wait<0>();
    fence_acc(d);
    if constexpr (!BIAS) mbar_arrive(&empty[last_s]);
    copy_acc(d, e);
  };
  // The fold, branch-free.  Only the last tile (`edge`) tests the bins at
  // or past `lim`, its columns past n, which never improve.  bf16: a score
  // improves its bin when above thr; then thr = key_to_f32(monotone(s) |
  // low), which is s's bits with the low bits set (s >= +0) or cleared (s <
  // 0).  int8: a cleared key improves its bin when above the bin's.
  auto fold = [&](int t, auto edge, int lim) {
    auto inside = [&](int c) { return !decltype(edge)::value || c < lim; };
    if constexpr (MODE == W_BF16) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool up = e[i] > st[i] && inside(cl + 8 * (i / 4) + (i % 2));
        const uint32_t bits = __float_as_uint(e[i]);
        const uint32_t nt = (bits | lowu) ^ ((uint32_t)((int32_t)bits >> 31) & lowu);
        st[i] = up ? __uint_as_float(nt) : st[i];
        ti[i] = up ? t : ti[i];
      }
    } else {
      const uint32_t* bw = reinterpret_cast<const uint32_t*>(
          w_smem + (bias_s - smem_u32(w_smem)) + last_s * W_BIAS);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = cl + 8 * (i / 4) + (i % 2);
        uint32_t key = (uint32_t)e[i] << shift;
        if constexpr (BIAS) key = (key - bw[c]) & ~lowu;
        const bool up = (int32_t)key > st[i] && inside(c);
        st[i] = up ? (int32_t)key : st[i];
        ti[i] = up ? t : ti[i];
      }
      if constexpr (BIAS) mbar_arrive(&empty[last_s]);
    }
  };

  // Per tile: the product, then the fold of its copy (a fold beside the
  // same warpgroup's next product has ptxas serialize the groups).
  mbar_wait_loop(&abar, 0);
  for (int t = 0; t < t_live - 1; ++t) {
    issue();
    retire();
    fold(t, std::false_type{}, 0);
  }
  issue();
  retire();
  fold(t_live - 1, std::true_type{}, n - (t_live - 1) * tile_n - bin0);

  const int row0 = rb * 64 * wgs + wg * 64 + rl;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int row = row0 + 8 * ((i / 2) % 2), bin = bin0 + cl + 8 * (i / 4);
    if (row >= b) continue;
    int2 v, c;
    if constexpr (MODE == W_BF16) {
      v.x = ti[i] >= 0 ? (int32_t)((uint32_t)monotone_key(st[i]) & ~lowu) : KMIN;
      v.y = ti[i + 1] >= 0 ? (int32_t)((uint32_t)monotone_key(st[i + 1]) & ~lowu) : KMIN;
    } else {
      v.x = st[i];  // KMIN where no tile improved the bin
      v.y = st[i + 1];
    }
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

int launch_accum_f32(const void* q, const void* tiles, void* rv, void* ri, void* out_v,
                     void* out_i, int b, int d, int tile_n, int n, int k, int group,
                     cudaStream_t s) {
  if (b == 0) return 0;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = ATile::RING_BYTES + (size_t)64 * ATile::THREADS * sizeof(int32_t);
  if (const cudaError_t e = cudaFuncSetAttribute(
          accum_ffma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
    return (int)e;
  const int vec_a = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int nrb = (b + ATile::BM - 1) / ATile::BM;
  accum_ffma_kernel<<<(unsigned)(nrb * (tile_n / ffma::BN)), ATile::THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(tiles), static_cast<int32_t*>(rv),
      static_cast<int32_t*>(ri), b, d, tile_n, n, group - 1, nrb, vec_a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // The float keys are compared as they are: their low bits are ceded.
  extract_kernel<<<(unsigned)b, THREADS, 0, s>>>(
      static_cast<const int32_t*>(rv), static_cast<const int32_t*>(ri),
      static_cast<int32_t*>(out_v), static_cast<int32_t*>(out_i), tile_n, k, 0);
  return (int)cudaGetLastError();
}

// bf16: tiles [T, d, tile_n]; int8: tiles [T, tile_n, ldq] (K-major), bias
// [T, tile_n] (L2) or null.
template <int MODE>
int launch_accum_wgmma(const void* q, const void* tiles, const void* bias, void* rv, void* ri,
                       void* out_v, void* out_i, int b, int d, int ldq, int tile_n, int n, int k,
                       int group, cudaStream_t s) {
  if (b == 0) return 0;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  static const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  constexpr int KD = MODE == W_BF16 ? 64 : 128;
  const int t_live = (n + tile_n - 1) / tile_n;
  const int kb = (ldq + KD - 1) / KD;
  const int per_stage = W_BOX + (MODE == W_I8_L2 ? W_BIAS : 0);
  // int8 takes no more warpgroups than the batch fills; both take fewer
  // where the resident query rows would leave the ring under four stages,
  // and past one warpgroup's (wide D) the rows ride the ring instead.
  int wgs = MODE == W_BF16 ? W_WGS : min(W_WGS, (b + 63) / 64);
  int stages = 0, a_ring = 0, stage_bytes = per_stage;
  for (;; --wgs) {
    stages = min(W_STAGES_MAX, (W_SMEM_MAX - 1024 - kb * wgs * W_A_WG) / per_stage);
    if (stages >= 4 || wgs == 1) break;
  }
  if (stages < 2) {
    a_ring = 1;
    wgs = MODE == W_BF16 ? W_WGS : min(W_WGS, (b + 63) / 64);
    stage_bytes = per_stage + wgs * W_A_WG;
    stages = min(W_STAGES_MAX, (W_SMEM_MAX - 1024) / stage_bytes);
  }
  if (stages < 2) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tt, tb{};
  if constexpr (MODE == W_BF16) {
    if (const int e = bf16_map(encode, &tq, q, b, ldq, ldq, 64 * wgs)) return e;
    if (const int e = bf16_map_3d(encode, &tt, tiles, t_live, d, tile_n, 64)) return e;
  } else {
    if (const int e = int8_map(encode, &tq, q, b, ldq, ldq, 64 * wgs)) return e;
    if (const int e = int8_map(encode, &tt, tiles, (long long)t_live * tile_n, ldq, ldq, W_BN))
      return e;
    if (MODE == W_I8_L2)
      if (const int e = word_map(encode, &tb, bias, t_live, tile_n, W_BN)) return e;
  }
  const int smem = 1024 + (a_ring ? 0 : kb * wgs * W_A_WG) + stages * stage_bytes;
  if (const cudaError_t e = cudaFuncSetAttribute(
          accum_wgmma_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return (int)e;
  const int nrb = (b + 64 * wgs - 1) / (64 * wgs);
  accum_wgmma_kernel<MODE><<<(unsigned)(nrb * (tile_n / W_BN)), 128 * wgs + 32, smem, s>>>(
      tq, tt, tb, static_cast<int32_t*>(rv), static_cast<int32_t*>(ri), b, ldq, tile_n, n,
      group - 1, nrb, stages, wgs, a_ring);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int shift = 0;
  while ((1 << shift) < group) ++shift;
  extract_kernel<<<(unsigned)b, THREADS, 0, s>>>(
      static_cast<const int32_t*>(rv), static_cast<const int32_t*>(ri),
      static_cast<int32_t*>(out_v), static_cast<int32_t*>(out_i), tile_n, k,
      MODE == W_BF16 ? 0 : shift);
  return (int)cudaGetLastError();
}
}  // namespace

// C entries for ctypes.  Each launches both passes on `stream`, allocates
// nothing, and returns cudaGetLastError() (0 = launched).  rv / ri are
// [b, tile_n] int32 scratch.  The wrapper guarantees tile_n a multiple of
// 128 up to 2048 and group a power of two >= 2 dividing T = n_tiles.
// int8: q [b, ldq] and the K-major tiles [T, tile_n, ldq], ldq = d rounded
// up to a multiple of 16 (the pad zero), both 16-byte aligned; `bias` [T,
// tile_n] (16-byte aligned) or null (no-bias mode).
extern "C" int bruteforce_accum_topk(const void* q, const void* tiles, const void* bias,
                                     void* rv, void* ri, void* out_v, void* out_i, int b,
                                     int ldq, int tile_n, int n, int k, int group, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bias != nullptr
             ? launch_accum_wgmma<W_I8_L2>(q, tiles, bias, rv, ri, out_v, out_i, b, ldq, ldq,
                                           tile_n, n, k, group, s)
             : launch_accum_wgmma<W_I8>(q, tiles, nullptr, rv, ri, out_v, out_i, b, ldq, ldq,
                                        tile_n, n, k, group, s);
}

// fp32 q and tiles, no bias rows; tiles 16-byte aligned.  out_v holds the
// keys (the wrapper decodes them).
extern "C" int bruteforce_accum_topk_f(const void* q, const void* tiles, void* rv, void* ri,
                                       void* out_v, void* out_i, int b, int d, int tile_n,
                                       int n, int k, int group, void* stream) {
  return launch_accum_f32(q, tiles, rv, ri, out_v, out_i, b, d, tile_n, n, k, group,
                          static_cast<cudaStream_t>(stream));
}

// bf16: q [b, ldq] with ldq = d rounded up to a multiple of 16 (the pad
// zero), tiles [T, d, tile_n]; both 16-byte aligned.  out_v holds the keys.
extern "C" int bruteforce_accum_topk_bf16(const void* q, const void* tiles, void* rv, void* ri,
                                          void* out_v, void* out_i, int b, int d, int ldq,
                                          int tile_n, int n, int k, int group, void* stream) {
  return launch_accum_wgmma<W_BF16>(q, tiles, nullptr, rv, ri, out_v, out_i, b, d, ldq, tile_n,
                                    n, k, group, static_cast<cudaStream_t>(stream));
}
