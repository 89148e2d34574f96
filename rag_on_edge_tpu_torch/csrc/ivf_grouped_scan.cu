// Kernels K4, K6 and K7 of the IVF search path: the cluster-major fine scan
// with a per-row running top-k over binned survivors, with three sources of
// the routed queries; and K10, the kernel lab's four variants of K6.  Each
// has an int8 entry (_i8) and a float entry (_f: fp32 or bf16 operands).
// All of them run on two kernels: grouped_wgmma_kernel (int8 and bf16) and
// grouped_ffma_kernel (fp32).
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
// pass's compacted list (whose excluded tail is parked on the last listed
// block's cluster as blocks with no rows that end no run: no CTA writes for
// them).
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
// variants (the Variant parameter of both kernels; K4, K6 and K7 are kFull,
// and every variant branch is an `if constexpr`, so their code is
// unchanged):
//   kFull     - K6 itself (the same instance): binned top-2 and the running
//               merge, whose per-candidate filter against the row's k-th
//               entry is the TPU kernel's `improves` gate;
//   kNoGate   - every survivor of every block enters the merge, with no
//               filter against the k-th entry (the same values);
//   kMaxOnly  - the scores and a row max per block, no selection: a CTA per
//               block (the TPU grid) and no run walk, and the last block of
//               each cluster in the walk writes its row max over all k slots
//               of out[bc[t]], ids 0 (a cluster's blocks must be contiguous
//               in the walk, as in every index's block tables);
//   kFixedOut - kMaxOnly into one constant window: out[0] holds the row max
//               of the walk's last block.  The other CTAs compute and write
//               nothing (a runtime store predicate, so their work stays),
//               which is what the TPU's constant output index gives too: its
//               one window is written back once, at the end.
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
//   per block b and bin (col % nbins), the DEPTH best (score, id) with
//   id = row_base[b] + col, ties to the lowest id;
//   those nbins*DEPTH survivors of each block merged into a running top-k
//   ordered by (score desc, id asc), written to out_v/out_i[O(t), r, :k]
//   with O(t) = t for K4 and K7 and bc[t] for K6 and K10.
// Only those rows are written.  Entries past the last finite score hold
// -inf and an unspecified id.  For K6, bc must be constant along a run and
// each cluster must end at most one run (the TPU kernel's output-window
// rule, pallas_ivf.py:524-531); a run whose bc[t] is outside [0, nlist)
// writes nothing.
//
// What bounds it on the H100: on the dense walk (SIFT-1M: 1176 blocks of
// 2048 columns holding 1,000,000 valid ones, 256 routed rows, D = 128) the
// int8 product is 6.6e10 operations, 0.03 ms on the tensor cores, and the
// bytes (the valid slab columns, the routed rows, the top-k written) 0.05-
// 0.06 ms; the selection after the product (a top-DEPTH per bin and a
// merge per block and row) is not counted in either.  The fp32 mode (D' =
// 129, L2 on the augmented dimension) has no tensor-core path that keeps
// its scores, so its FMAs bound it (0.99 ms at 67 TFLOP/s over every routed
// slot); bf16 on wgmma is bound by its bytes (0.09 ms).  On the recovery
// pass the kernel walks only the few runs whose last block made the
// compacted list; most CTAs exit at once, and the time is one CTA's walk
// along the longest run.  K7's gather reads the batch (1 MB at B = 8192,
// d = 128) through L2.
//
// Design of the int8 and bf16 modes (grouped_wgmma_kernel<T, DEPTH, SRC,
// V>, hopper_mma.cuh):
// - one CTA of two warpgroups per (last block t, N routed rows: 32, or 16
//   for DEPTH > 2); CTAs on other blocks exit before any setup, and K6's
//   CTAs whose run's cluster bc[t] lies outside [0, nlist) too.  The
//   product is transposed against K1's: the chunk's 128 bins are wgmma's M
//   (64 a warpgroup) and the routed rows its N, so m64nNk32 s8 -> s32 (bf16:
//   m64nNk16 -> f32) puts each (row, bin) in one thread's registers in every
//   chunk, and the per-bin top-DEPTH (score, chunk) stays beside the
//   fragment (F = N / 2 entries a thread); no score goes through shared
//   memory.
// - empty slots: most rows of a routed table are zero (at B = 8192,
//   nprobe 4, nlist 1024 a cluster routes 32 pairs on average into qcap
//   256 slots; the recovery table holds only the dropped pairs), and a
//   zero row scores 0 - bias on every column whatever the slab holds.  A tile
//   whose rows are all zero in every block of its run loads no slab: it
//   bins one row from the bias words and merges it, and every row takes
//   the result.  In the other tiles the rows that were zero in every block
//   so far share one running top-k: the lowest is binned and merged, the
//   others copy it after each merge.  Both are exact.
// - the work is a list of (block, chunk, unit) along the run: blocks
//   without rows and chunks wholly past rows_valid are skipped (they would
//   only add -inf; SIFT-1M's blocks are about 41% full), chunks ascending
//   within a block so ties still go to the lower id.  Each unit is 128
//   bytes of d (64 bf16 dims): 4 k-steps.
// - operands: the slab's unit lands by TMA in a ring (`stages` deep, one
//   mbarrier each).  int8 lands as eight [128 d, 16 bin] boxes and the
//   threads transpose it into two K-major swizzled tiles (transpose_unit,
//   shared with K1), unit u+1 while unit u's groups run: 8-bit operands have
//   no transpose bit.  bf16 lands as two [64 d, 64 bin] boxes that wgmma
//   reads as they lie, M-major through its transpose-A bit.  No per-call
//   copy of the slab.  The routed rows (N x kb units) stay in shared memory
//   for the block: K4, K6 and K10 by TMA (rows at a 16-byte pitch; a 3-D
//   map over qg [planes, qcap, ldq] whose outer coordinate is the block b
//   for K4 and its cluster bc[b] for K6 and K10, the same rows in every
//   block of a K6 run; d past D arrives as zeros), K7 gathered by the
//   threads in 16-byte pieces from qi (zero rows for slots outside [0, B);
//   bf16 zeroes a piece's elements past D, since a pitched row's pad may
//   hold anything) and handed to wgmma through the proxy fence.  The next
//   block's rows load while this one's survivors merge.  Where kb units of
//   rows would leave the ring under two stages (int8 D past 2816 at depth
//   1-2, 5888 at 3-4; bf16 past 1920 and 3968), they are not held: the
//   threads gather each unit's rows in 16-byte pieces into one of two unit
//   buffers while the unit before multiplies, re-read from L2 every chunk,
//   and the empty-row test reads q itself; so D has no cap.
// - the epilogue on copy_acc's copy of the fragment (reading the fragment
//   itself has ptxas serialize the groups): int8 score = __int2float_rn(dot)
//   then one __fsub_rn of the bias; bf16 takes an exact-zero sum as +0 (the
//   plain version sums from +0) before the bias; -inf past rows_valid,
//   inserted with strict > (an equal score keeps the earlier, lower id).
// - per block the survivors go to shared memory and each warp merges its
//   N / 8 rows side by side (merge_rows): only candidates that beat the
//   row's k-th entry take part (kNoGate: all of them), each lane's four
//   bins are sorted lists whose heads compete, a pass takes the warp's best
//   by two reductions (the score key, then the lowest id at it), and once
//   every candidate that took part is placed the rest of the row is its old
//   list, shifted.
// - kMaxOnly and kFixedOut keep one running max an entry of the copy
//   instead of the top-DEPTH, and at the block's end reduce it over the
//   128 bins: within a warp by shuffles, across the eight warps through
//   shared memory.
//
// Design of the fp32 modes (grouped_ffma_kernel<DEPTH, SRC, V>,
// ffma_tile.cuh, the register tile of K1's, K3's and K5's fp32 modes):
// - one CTA of 128 threads per (last block t, 32 routed rows), 4 x 8 fp32
//   accumulators a thread over the chunk's 128 bins; the walk over (block,
//   chunk, d-slice) as above, the slices (32 d; 16 at DEPTH > 2) riding a
//   cp.async ring while the slice before is multiplied, the routed rows
//   re-read from L2 with every slice (K4, K6 and K10 strided from qg, K7
//   gathered through cq_blocks at a 16-byte row pitch); one fmaf a
//   dimension in d order from +0, so scores are bit-equal to the plain
//   version's on exact data.
// - a top-DEPTH (score, chunk) per accumulator would pass 255 registers:
//   the lists live in shared memory as [row][depth][bin] (the scores
//   fp32, the chunks in 16 bits: up to 65536 chunks a block), the chunk's
//   first block writes them, later chunks read one threshold a score and
//   insert only what passes it; the merge reads them in place.  Empty slots as in
//   the wgmma modes: all-zero tiles from the bias words, zero rows sharing
//   one running top-k (K7: a row is taken as zero where its slot lies
//   outside [0, B); a zero query in a valid slot is scored, which is exact
//   too).  kMaxOnly and kFixedOut keep a row max a thread in registers
//   and reduce it across the four warps through shared memory.
// - the recovery list's time is one CTA's serial walk along its longest
//   run (a hot cluster's blocks), not the product.
//
// The general selection (DEPTH = 0 instances of both kernels; GenArgs
// below): nbins other than 128, bin depths past 4, fp32 past 65536 chunks
// a block.  The same walk, product, empty-slot handling and passes as the
// kernels' own selection, with a slower epilogue through shared memory and
// device memory (PERF.md section 6 times it).
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ffma_tile.cuh"
#include "hopper_mma.cuh"

namespace {

constexpr int LANES = 128;               // bins: the chunk's columns mod 128
constexpr int THREADS = 256;             // grouped_wgmma_kernel: two warpgroups
constexpr int WARPS = THREADS / 32;
constexpr int K_MAX = 32;                // running top-k width in shared memory
constexpr unsigned FULL = 0xffffffffu;

// (v, i) ranks before (bv, bi): larger score, then lower id.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Where the routed queries come from, and where the output goes:
// kBlock: K4 (qg [nblocks, qcap, d], out [nblocks, qcap, k]);
// kCluster: K6 and K10 (qg [nlist, qcap, d], out [nlist, qcap, k], through bc);
// kRouted: K7 (qg = qi [B, d] gathered through cq_blocks, out [nblocks, qcap, k]).
enum class QSrc { kBlock, kCluster, kRouted };

// K10's variants; every other kernel is kFull.
enum class Variant { kFull, kNoGate, kMaxOnly, kFixedOut };

// kMaxOnly and kFixedOut: a row max per block, no selection, no run walk.
template <Variant V>
constexpr bool kMaxVariant = V == Variant::kMaxOnly || V == Variant::kFixedOut;

// ------------------------- K4, K6 and K7 int8, K6 and K7 bf16: wgmma fed by TMA

constexpr int W_UNIT = 128 * 128;         // a unit of the slab: 128 bins x 128 bytes of d
constexpr int W_HALF = W_UNIT / 2;        // one warpgroup's 64 bins
constexpr int W_STAGES_MAX = 6;
constexpr int W_SMEM_MAX = 232448 - 1024; // the opt-in limit less the static part

// A CTA's tiling: N routed rows (the wgmma's N) x the 128 bins (its M, two
// warpgroups of 64), so each thread holds F (row, bin) entries of the
// fragment, with a top-DEPTH each.
template <int DEPTH>
struct WTile {
  static constexpr int N = DEPTH <= 2 ? 32 : 16;
  static constexpr int F = N / 2;
  // Survivors per row and block (the general selection: one chunk's scores).
  static constexpr int NCAND = (DEPTH > 0 ? DEPTH : 1) * LANES;
  static constexpr int CS = NCAND + 4;         // their row stride: the stores are conflict-free
};

// One k-step of the unit's product: int8 m64nNk32 s8 (A and B K-major);
// bf16 m64nNk16 with A M-major (the transpose-A bit) and B K-major.
template <int R>
__device__ __forceinline__ void wgmma_step(int32_t (&d)[R], uint64_t da, uint64_t db, int acc) {
  if constexpr (R == 16)
    wgmma_m64n32k32_s8(d, da, db, acc);
  else
    wgmma_m64n16k32_s8(d, da, db, acc);
}
template <int R>
__device__ __forceinline__ void wgmma_step(float (&d)[R], uint64_t da, uint64_t db, int acc) {
  if constexpr (R == 16)
    wgmma_m64n32k16_ta(d, da, db, acc);
  else
    wgmma_m64n16k16_ta(d, da, db, acc);
}

// Insert x (chunk c) into a sorted top-DEPTH: strict > keeps an equal,
// earlier (lower-id) entry ahead; descending j reads tv[j-1] before it is
// rewritten.
template <int DEPTH>
__device__ __forceinline__ void insert_top(float (&tv)[DEPTH], int (&tc)[DEPTH], float x, int c) {
#pragma unroll
  for (int j = DEPTH - 1; j > 0; --j) {
    if (x > tv[j - 1]) {
      tv[j] = tv[j - 1];
      tc[j] = tc[j - 1];
    } else if (x > tv[j]) {
      tv[j] = x;
      tc[j] = c;
    }
  }
  if (x > tv[0]) {
    tv[0] = x;
    tc[0] = c;
  }
}

// The unit after (b, c, j) along the run tb..t: j over the kb units of d,
// c over the chunks of block b that hold a valid column, b over the blocks
// that hold rows; false past the last.  Start from (tb - 1, 0, kb - 1).
// Every thread walks the same list from the same global values.
__device__ __forceinline__ bool next_unit(int& b, int& c, int& j, int tb, int t, int kb, int blk,
                                          const int32_t* __restrict__ rows_valid) {
  if (++j < kb) return true;
  j = 0;
  if (b >= tb && ++c * LANES < min(rows_valid[b], blk)) return true;
  c = 0;
  while (++b <= t)
    if (rows_valid[b] > 0) return true;
  return false;
}

// A tile whose rows are zero in every block of the run scores 0 - bias on
// every valid column, whatever the slab holds: row 0's top-DEPTH (score,
// chunk) of bin `bin` (< 128) of a block with nvalid valid columns, from
// the bias words bw (this bin's, the block's first; null: scores +0).
template <int DEPTH>
__device__ __forceinline__ void zero_row_top(const float* __restrict__ bw, int nvalid, int bin,
                                             float (&zv)[DEPTH], int (&zc)[DEPTH]) {
#pragma unroll
  for (int j = 0; j < DEPTH; ++j) {
    zv[j] = -INFINITY;
    zc[j] = 0;
  }
  const int nch = (nvalid + LANES - 1) / LANES;
  for (int c0 = 0; c0 < nch; c0 += 8) {
    float w[8];  // eight chunks' words in flight at once
#pragma unroll
    for (int u = 0; u < 8; ++u) w[u] = bw != nullptr && c0 + u < nch ? bw[(c0 + u) * LANES] : 0.0f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 + u;
      if (c >= nch) break;
      float x = bw != nullptr ? __fsub_rn(0.0f, w[u]) : 0.0f;
      if (c * LANES + bin >= nvalid) x = -INFINITY;
      insert_top<DEPTH>(zv, zc, x, c);
    }
  }
}

// A block's survivors merged into the running top-k of rows rows[0..R-1],
// side by side, by one warp; rows not set in `act` take no part.
// cand(row, depth, bin, v, id) reads a survivor.  With GATE, only candidates
// that beat the row's k-th entry can enter (the others have k better
// entries ahead of them) and the row is skipped when there are none (the
// TPU kernel's `improves`); without (K10's kNoGate) every finite one takes
// part, to the same result.  Once every candidate that takes part is placed
// the rest of the row is its old list, shifted.  Lane l holds bins l + 32 q (q < 4), each a
// list sorted by (score desc, id asc), and old entry l: a pass takes the
// lane's best head, then the warp's best by two reductions (the largest
// score key, then the lowest id at it), and the lane that held it pops that
// list.  Finite ids are unique (row_base differs between blocks); scores
// are never -0, so the score key orders them as the floats do.  With a
// bound (s_bv, s_bi: a later pass of the wrapper's), only survivors ranked
// after it take part.
template <int DEPTH, int R, bool GATE = true, class Cand>
__device__ __forceinline__ void merge_rows(const int (&rows)[R], uint32_t act, const Cand& cand,
                                           float* __restrict__ run_v, int32_t* __restrict__ run_i,
                                           const float* __restrict__ s_bv,
                                           const int* __restrict__ s_bi, int k) {
  const float NEG_INF = -INFINITY;
  const int wl = threadIdx.x & 31;
  float lv[R][4][DEPTH], ov[R], sv0[R];
  int li[R][4][DEPTH], oi[R], si0[R], nbeat[R], left[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int rr = rows[r];
    const bool on = (act >> rr) & 1u;  // the same in every lane
    const float kv = run_v[rr * K_MAX + k - 1];
    const int ki = run_i[rr * K_MAX + k - 1];
    int cnt = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int drop = 0;  // the bin's entries at or before the row's bound: a prefix
#pragma unroll
      for (int j = 0; j < DEPTH; ++j) {
        float v = NEG_INF;
        int id = 0;
        if (on) cand(rr, j, q * 32 + wl, v, id);
        const bool after = better(s_bv[rr], s_bi[rr], v, id);
        const bool beats = v > NEG_INF && (!GATE || better(v, id, kv, ki)) && after;
        lv[r][q][j] = beats ? v : NEG_INF;
        li[r][q][j] = id;
        cnt += beats;
        drop += v > NEG_INF && !after;
      }
      // The bin's list is sorted (score desc, id asc), so the entries the
      // bound drops lead it: shift the rest to the head, where a pass reads.
#pragma unroll
      for (int s = 0; s < DEPTH - 1; ++s) {
        if (s >= drop) break;
#pragma unroll
        for (int j = 0; j + 1 < DEPTH; ++j) {
          lv[r][q][j] = lv[r][q][j + 1];
          li[r][q][j] = li[r][q][j + 1];
        }
        lv[r][q][DEPTH - 1] = NEG_INF;
      }
    }
    nbeat[r] = left[r] = __reduce_add_sync(FULL, cnt);
    ov[r] = sv0[r] = wl < k ? run_v[rr * K_MAX + wl] : NEG_INF;
    oi[r] = si0[r] = wl < k ? run_i[rr * K_MAX + wl] : 0;
  }
  __syncwarp();
  for (int p = 0; p < k; ++p) {
    bool busy = false;
#pragma unroll
    for (int r = 0; r < R; ++r) busy |= left[r] > 0;
    if (!busy) break;
    int mk[R], mi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float bv = ov[r];
      int bi = oi[r];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (better(lv[r][q][0], li[r][q][0], bv, bi)) {
          bv = lv[r][q][0];
          bi = li[r][q][0];
        }
      mk[r] = monotone_key(bv);
      mi[r] = bi;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int key = __reduce_max_sync(FULL, mk[r]);
      mi[r] = __reduce_min_sync(FULL, mk[r] == key ? mi[r] : INT32_MAX);
      mk[r] = key;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (left[r] == 0) continue;  // the same in every lane
      const int rr = rows[r];
      const float bv = key_to_f32(mk[r]);
      if (wl == 0) {
        run_v[rr * K_MAX + p] = bv;
        run_i[rr * K_MAX + p] = mi[r];
      }
      const bool took = ov[r] == bv && oi[r] == mi[r];
      if (took) ov[r] = NEG_INF;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (lv[r][q][0] == bv && li[r][q][0] == mi[r]) {
#pragma unroll
          for (int j = 0; j + 1 < DEPTH; ++j) {
            lv[r][q][j] = lv[r][q][j + 1];
            li[r][q][j] = li[r][q][j + 1];
          }
          lv[r][q][DEPTH - 1] = NEG_INF;
        }
      if (!__any_sync(FULL, took) && --left[r] == 0) {
        // Slots p+1.. take the old entries not yet placed, in order.
        const int at = wl + nbeat[r];
        if (wl >= p + 1 - nbeat[r] && at < k) {
          run_v[rr * K_MAX + at] = sv0[r];
          run_i[rr * K_MAX + at] = si0[r];
        }
      }
    }
  }
  __syncwarp();
}

// The general selection (the DEPTH = 0 instances of both kernels): any
// nbins dividing blk, any bin depth, and fp32 at any blk.  A chunk's scores
// go to shared memory as S [rows][ls] (bias applied, -inf past rows_valid),
// and then either
// - keepall: every column of the chunk is a candidate of the running top-k
//   (warp_merge reads S).  The wrapper asks for it where the bin depth is
//   at least min(k, blk / nbins): a column among a row's top k of the run
//   has fewer than k better columns in its bin, so it survives any such
//   depth, and the binned walk is the unbinned one;
// - lists: each (row, bin) keeps its top `depth` (score, column) of the
//   block, sorted (score desc, column asc), in a slot of global scratch
//   that the CTA holds while it runs (gen_acquire: one lock word a slot,
//   more slots than CTAs fit on the card, so a free one always exists);
//   bin = column % nbins, the columns of a chunk in a bin scanned in
//   ascending order by one thread (strict >, so an equal, later score stays
//   behind).  At the block's end warp_merge takes each row's lists, and the
//   lists are reset.
// This is JAX's binned_top2 over the block at any depth, then its merge.
struct GenArgs {
  float* v;          // nslots x [rows][nbins][depth] scores
  int32_t* c;        // their columns within the block
  int32_t* locks;    // [nslots], 0 = free
  int nslots, nbins, depth, keepall;
};

__device__ __forceinline__ int gen_acquire(int32_t* locks, int nslots) {
  int s = (int)(((size_t)gridDim.x * blockIdx.y + blockIdx.x) % (size_t)nslots);
  while (atomicCAS(&locks[s], 0, 1) != 0) s = s + 1 == nslots ? 0 : s + 1;
  __threadfence();
  return s;
}

__device__ __forceinline__ void gen_release(int32_t* locks, int s) {
  __threadfence();
  atomicExch(&locks[s], 0);
}

// Every list of the CTA's slot (`rows` rows) to -inf.
__device__ __forceinline__ void gen_reset(const GenArgs& g, int slot, int rows) {
  const size_t n = (size_t)rows * g.nbins * g.depth;
  float* lv = g.v + (size_t)slot * n;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) lv[i] = -INFINITY;
}

// Chunk c's scores S [rows][ls] into the lists of the rows in `need`: one
// thread a (row, l), l < min(nbins, 128), taking the chunk's columns l, l +
// nbins, ... (one bin, (128 c + l) % nbins) in ascending order.
__device__ __forceinline__ void gen_insert(const GenArgs& g, int slot, int rows,
                                           const float* S, int ls, uint32_t need, int c) {
  const int owners = min(g.nbins, LANES), col0 = c * LANES, dep = g.depth;
  const size_t per = (size_t)rows * g.nbins * dep;
  float* const lvb = g.v + (size_t)slot * per;
  int32_t* const lcb = g.c + (size_t)slot * per;
  for (int i = threadIdx.x; i < rows * owners; i += blockDim.x) {
    const int row = i / owners, l = i - row * owners;
    if (!((need >> row) & 1u)) continue;
    const size_t o = ((size_t)row * g.nbins + (col0 + l) % g.nbins) * dep;
    float* lv = lvb + o;
    int32_t* lc = lcb + o;
    for (int x = l; x < LANES; x += g.nbins) {
      const float sc = S[row * ls + x];
      if (!(sc > lv[dep - 1])) continue;
      int p = dep - 1;
      for (; p > 0 && sc > lv[p - 1]; --p) {
        lv[p] = lv[p - 1];
        lc[p] = lc[p - 1];
      }
      lv[p] = sc;
      lc[p] = col0 + x;
    }
  }
}

// Candidates 0..n-1 (cand(j, v, id)) merged into one row's running top-k
// (run_v / run_i, k <= 32 entries) by one warp: lane l holds entry l; each
// finite candidate ranked after the row's bound (bv, bi) and before its
// k-th entry is placed at its rank (the count of better entries, a ballot)
// and the tail shifts one lane down.  Finite ids are unique, so the order
// of insertion does not matter.
template <class Cand>
__device__ __forceinline__ void warp_merge(int n, const Cand& cand, float* __restrict__ run_v,
                                           int32_t* __restrict__ run_i, float bv, int bi,
                                           int k) {
  const int wl = threadIdx.x & 31;
  float rv = wl < k ? run_v[wl] : -INFINITY;
  int ri = wl < k ? run_i[wl] : 0;
  float kv = __shfl_sync(FULL, rv, k - 1);
  int ki = __shfl_sync(FULL, ri, k - 1);
  for (int j0 = 0; j0 < n; j0 += 32) {
    float v = -INFINITY;
    int id = 0;
    if (j0 + wl < n) cand(j0 + wl, v, id);
    unsigned m = __ballot_sync(FULL, v > -INFINITY && better(v, id, kv, ki) &&
                                         better(bv, bi, v, id));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float cv = __shfl_sync(FULL, v, src);
      const int ci = __shfl_sync(FULL, id, src);
      if (!better(cv, ci, kv, ki)) continue;  // the same in every lane
      const int pos = __popc(__ballot_sync(FULL, wl < k && better(rv, ri, cv, ci)));
      const float uv = __shfl_up_sync(FULL, rv, 1);
      const int ui = __shfl_up_sync(FULL, ri, 1);
      if (wl == pos) {
        rv = cv;
        ri = ci;
      } else if (wl > pos) {
        rv = uv;
        ri = ui;
      }
      kv = __shfl_sync(FULL, rv, k - 1);
      ki = __shfl_sync(FULL, ri, k - 1);
    }
  }
  if (wl < k) {
    run_v[wl] = rv;
    run_i[wl] = ri;
  }
  __syncwarp();
}

// The rows in `act` of a CTA (`rows` rows, run_v / run_i [rows][K_MAX])
// merged with their candidates by the CTA's warps, a row a warp at a time:
// keepall, chunk c's scores S [rows][ls] (ids rb + 128 c + column);
// else the lists of the CTA's slot (ids rb + column), which are then reset.
// Every thread calls it; a barrier follows.
__device__ __forceinline__ void gen_merge(const GenArgs& g, int slot, int rows, uint32_t act,
                                          const float* S, int ls, int c, int rb,
                                          float* run_v, int32_t* run_i, const float* s_bv,
                                          const int* s_bi, int k) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const size_t per = (size_t)g.nbins * g.depth;
  for (int rr = warp; rr < rows; rr += nw) {
    if (!((act >> rr) & 1u)) continue;
    if (g.keepall) {
      const float* sr = S + rr * ls;
      const int r0 = rb + c * LANES;
      warp_merge(LANES, [&](int j, float& v, int& id) { v = sr[j]; id = r0 + j; },
                 run_v + rr * K_MAX, run_i + rr * K_MAX, s_bv[rr], s_bi[rr], k);
    } else {
      const float* lv = g.v + ((size_t)slot * rows + rr) * per;
      const int32_t* lc = g.c + ((size_t)slot * rows + rr) * per;
      warp_merge((int)per, [&](int j, float& v, int& id) { v = lv[j]; id = rb + lc[j]; },
                 run_v + rr * K_MAX, run_i + rr * K_MAX, s_bv[rr], s_bi[rr], k);
    }
  }
  if (!g.keepall) {
    __syncthreads();
    gen_reset(g, slot, rows);
  }
}

// T: int8_t or __nv_bfloat16.  K4 (SRC kBlock: q = qg [nblocks, qcap] rows,
// also through `tq`, [1, N, 128-byte] boxes, 128-byte swizzle), K6 and K10
// (SRC kCluster: q = qg [nsrc = nlist, qcap] rows, block b's rows being
// qg[block_cluster[b]], the same map, the output row of a run ending at t
// being block_cluster[t]) and K7 (SRC kRouted: q = qi [nsrc] rows, row r of
// block b being qi[cq_blocks[b, r]], gathered by the threads); the slab
// [nblocks, d, blk] through `tv` (int8: [1, 128, 16] boxes; bf16: [1, 64,
// 64], 128-byte swizzle).  The rows of q lie ldq bytes apart (a multiple of
// 16), their first qbytes (D) holding data: int8 is zero past it, bf16 need
// not be.  kb units of 128 bytes of d.  CTA (t, y): last block t (kMaxOnly,
// kFixedOut: block t), routed rows N y .. N y + N - 1.  V: K10's variant
// (kCluster and no bias but kFull).
template <typename T, int DEPTH, QSrc SRC, Variant V = Variant::kFull>
__global__ void __launch_bounds__(THREADS, 1)
grouped_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tv,
                     const int8_t* __restrict__ q,            // bytes
                     const int32_t* __restrict__ cq_blocks,   // [nblocks, qcap] (K7)
                     const int32_t* __restrict__ block_cluster, // [nblocks] (K6)
                     const int32_t* __restrict__ block_first,
                     const int32_t* __restrict__ block_last,
                     const int32_t* __restrict__ rows_valid,
                     const float* __restrict__ bias,          // [nblocks, blk] or null
                     const int32_t* __restrict__ row_base,
                     const float* __restrict__ bound_v,   // like out's rows, or null
                     const int32_t* __restrict__ bound_i,
                     float* __restrict__ out_v, int32_t* __restrict__ out_i,
                     int qcap, int blk, int kb, int ldq, int qbytes, int k, int stages, int nsrc,
                     int qwide, const GenArgs gen) {
  constexpr bool BF16 = std::is_same_v<T, __nv_bfloat16>;
  using Acc = std::conditional_t<BF16, float, int32_t>;
  using Tl = WTile<DEPTH>;
  constexpr int N = Tl::N, F = Tl::F, CS = Tl::CS;
  constexpr int R = N / WARPS;               // rows each warp merges
  constexpr int QUNIT = N * 128;             // a unit of the routed rows
  constexpr int KD = 128 / (int)sizeof(T);   // d a unit
  constexpr bool MAX_ONLY = kMaxVariant<V>;
  constexpr bool GEN = DEPTH == 0;           // the general selection
  constexpr int LD = GEN ? 1 : DEPTH;
  static_assert(V == Variant::kFull || SRC == QSrc::kCluster, "K10's variants are K6's");
  static_assert(!(GEN && MAX_ONLY), "kMaxOnly and kFixedOut select nothing");
  const float NEG_INF = -INFINITY;

  // CTAs on blocks that end no run leave before any setup (the recovery
  // pass lists ~300 blocks and walks ~5 runs), and so do K6's CTAs whose
  // run's cluster has no output row.  kMaxOnly and kFixedOut run every
  // block alone, and only some CTAs write (`writes`, a runtime predicate).
  const int t = blockIdx.x;
  if constexpr (!MAX_ONLY) {
    if (block_last[t] == 0) return;
  }
  int orow = t;  // the output row: the block (K4, K7) or its cluster (K6, K10)
  if constexpr (SRC == QSrc::kCluster) {
    orow = block_cluster[t];
    if (orow < 0 || orow >= nsrc) return;
  }
  bool writes = true;
  if constexpr (V == Variant::kMaxOnly) {
    writes = t + 1 == (int)gridDim.x || block_cluster[t + 1] != orow;
  } else if constexpr (V == Variant::kFixedOut) {
    writes = t + 1 == (int)gridDim.x;
    orow = 0;
  }
  // Block b's rows in q: K4's own, K6's cluster's (K7 gathers through cq).
  auto qrow = [&](int b) { return SRC == QSrc::kCluster ? block_cluster[b] : b; };
  const int r0 = blockIdx.y * N;
  int tb = t;  // the run's first block
  if constexpr (!MAX_ONLY) {
    while (tb > 0 && block_first[tb] == 0) --tb;
  }
  int cb = tb - 1, cc = 0, cj = kb - 1;  // the consumers' unit
  bool have = next_unit(cb, cc, cj, tb, t, kb, blk, rows_valid);
  if (!have) {  // no block of the run holds rows: every entry is -inf
    if (!writes) return;
    for (int i = threadIdx.x; i < N * k; i += THREADS) {
      const int r = i / k;
      if (r0 + r >= qcap) continue;
      const size_t o = ((size_t)orow * qcap + r0) * k + i;
      out_v[o] = NEG_INF;
      out_i[o] = 0;
    }
    return;
  }

  // Shared memory: the TMA ring of raw slab units, two transposed units
  // (int8), the routed rows (kb units; wide D: two, each unit's rows
  // gathered beside its transpose), the block's survivors and the running
  // top-k.
  extern __shared__ uint8_t w_smem[];
  __shared__ __align__(8) uint64_t full[W_STAGES_MAX], qbar;
  __shared__ uint32_t s_nz;  // the routed rows of the block that hold a nonzero byte
  __shared__ int s_slot;     // the general selection's slot of lists
  // Each row's bound (a later pass of the wrapper's): only survivors ranked
  // after it take part in the merge.  No bound: (+inf, -1).
  __shared__ float s_bv[32];
  __shared__ int s_bi[32];
  const uint32_t base = (smem_u32(w_smem) + 1023u) & ~1023u;
  uint8_t* const gbase = w_smem + (base - smem_u32(w_smem));
  const uint32_t st = base, bk = st + stages * W_UNIT, qs = bk + (BF16 ? 0 : 2 * W_UNIT);
  float* const cand_v = reinterpret_cast<float*>(gbase + (qs - base) + (qwide ? 2 : kb) * QUNIT);
  int32_t* const cand_i = reinterpret_cast<int32_t*>(cand_v + N * CS);
  float* const run_v = reinterpret_cast<float*>(cand_i + N * CS);
  int32_t* const run_i = reinterpret_cast<int32_t*>(run_v + N * K_MAX);

  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31, wg = warp >> 2;
  // Fragment entry i of this thread: bin bin0 + 8 ((i / 2) % 2) of the
  // chunk, routed row 8 (i / 4) + 2 (wl % 4) + i % 2 of the CTA's N.
  const int bin0 = 64 * wg + 16 * (warp & 3) + (wl >> 2);
  // The CTA's rows below qcap.
  const int nrows = min(qcap - r0, N);
  const uint32_t vmask = nrows == 32 ? ~0u : (1u << nrows) - 1u;

  for (int i = threadIdx.x; i < N * K_MAX; i += THREADS) {
    run_v[i] = NEG_INF;
    run_i[i] = 0;
  }
  if (threadIdx.x < N) {
    const bool has = bound_i != nullptr && r0 + (int)threadIdx.x < qcap;
    const size_t o = (size_t)orow * qcap + r0 + threadIdx.x;
    s_bv[threadIdx.x] = has ? bound_v[o] : INFINITY;
    s_bi[threadIdx.x] = has ? bound_i[o] : -1;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    mbar_init(&qbar, 1);
    s_nz = 0;
    if (GEN && !gen.keepall) s_slot = gen_acquire(gen.locks, gen.nslots);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const bool lists = GEN && !gen.keepall;
  if (lists) gen_reset(gen, s_slot, N);
  // The slot goes back once every thread is done with it.
  auto release = [&]() {
    if (!lists) return;
    __syncthreads();
    if (threadIdx.x == 0) gen_release(gen.locks, s_slot);
  };

  // Row n of block b in q, or null (past qcap; K7: a slot outside [0, nsrc)).
  auto row_ptr = [&](int b, int n) -> const int8_t* {
    if (r0 + n >= qcap) return nullptr;
    if constexpr (SRC == QSrc::kRouted) {
      const int s = cq_blocks[(size_t)b * qcap + r0 + n];
      return s >= 0 && s < nsrc ? q + (size_t)s * ldq : nullptr;
    } else {
      return q + ((size_t)qrow(b) * qcap + r0 + n) * ldq;
    }
  };
  // 16 bytes of a routed row (null: zeros) at byte `off`: zeros past ldq,
  // and (bf16) past the row's qbytes of data.
  auto piece = [&](const int8_t* row, int off) -> int4 {
    int4 v = make_int4(0, 0, 0, 0);
    if (row == nullptr || off >= ldq) return v;
    v = *reinterpret_cast<const int4*>(row + off);
    if constexpr (BF16) {
      const int keep = qbytes - off;  // bytes of data in the piece; even
      if (keep < 16) {
        int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int kw = keep - 4 * u;
          w[u] = kw >= 4 ? w[u] : kw <= 0 ? 0 : (w[u] & 0xffff);
        }
        v = make_int4(w[0], w[1], w[2], w[3]);
      }
    }
    return v;
  };
  // Wide D: unit j of block b's routed rows into row buffer buf, by the
  // threads in 16-byte pieces, in the layout TMA gives (zeros past the data
  // and for rows without a source); the proxy fence and a barrier follow.
  auto gather_unit = [&](int b, int j, int buf) {
    for (int i = threadIdx.x; i < N * 8; i += THREADS) {
      const int n = i >> 3, p = i & 7;
      *reinterpret_cast<int4*>(gbase + (qs - base) + buf * QUNIT + n * 128 + ((p ^ (n & 7)) << 4)) =
          piece(row_ptr(b, n), 16 * (8 * j + p));
    }
  };

  // Block b's routed rows into the K-major swizzled tile: K4 and K6 by TMA
  // on qbar, K7 gathered in 16-byte pieces (zero rows for slots outside [0,
  // nsrc) and past qcap), then the proxy fence; a barrier follows.  Wide D
  // takes its rows a unit at a time (gather_unit) instead.
  auto load_queries = [&](int b) {
    if (qwide) return;
    if constexpr (SRC != QSrc::kRouted) {
      if (threadIdx.x == 0) {
        const int qb = qrow(b);
        mbar_expect_tx(&qbar, kb * QUNIT);
        for (int j = 0; j < kb; ++j) tma_load_3d(qs + j * QUNIT, &tq, KD * j, r0, qb, &qbar);
      }
    } else {
      const int pieces = kb * 8;
      for (int i = threadIdx.x; i < N * pieces; i += THREADS) {
        const int n = i / pieces, p = i % pieces;
        *reinterpret_cast<int4*>(gbase + (qs - base) + (p >> 3) * QUNIT + n * 128 +
                                 (((p & 7) ^ (n & 7)) << 4)) = piece(row_ptr(b, n), 16 * p);
      }
      fence_proxy_async();
    }
  };

  // Block b's rows that hold a nonzero byte, from the tile in shared
  // memory (wide D: from q), into s_nz (bit n: row n; reset beforehand, read
  // after a barrier).  TPR threads a row, then a ballot.
  auto detect = [&](int b) {
    constexpr int TPR = THREADS / N;
    const int n = threadIdx.x / TPR;
    uint32_t any = 0;
    if (qwide) {
      const int8_t* src = row_ptr(b, n);
      for (int p = threadIdx.x % TPR; src != nullptr && p < ldq / 16; p += TPR) {
        const int4 v = piece(src, 16 * p);
        any |= v.x | v.y | v.z | v.w;
      }
    } else {
      for (int p = threadIdx.x % TPR; p < kb * 8; p += TPR) {
        const uint4 v = *reinterpret_cast<const uint4*>(gbase + (qs - base) + (p >> 3) * QUNIT +
                                                        n * 128 + (((p & 7) ^ (n & 7)) << 4));
        any |= v.x | v.y | v.z | v.w;
      }
    }
    const unsigned ball = __ballot_sync(FULL, any != 0);
    if (wl == 0) {
      uint32_t rows = 0;
#pragma unroll
      for (int j = 0; j < 32 / TPR; ++j)
        if ((ball >> (j * TPR)) & ((1u << TPR) - 1u)) rows |= 1u << (warp * (32 / TPR) + j);
      if (rows) atomicOr(&s_nz, rows);
    }
  };

  // The producer (thread 0): `stages` units ahead of the consumers.  int8:
  // eight [128 d, 16 bin] boxes; bf16: two [64 d, 64 bin] boxes, one a
  // warpgroup.
  int pb = cb, pc = cc, pj = cj;
  bool phave = true;
  auto load = [&](int s) {
    mbar_expect_tx(&full[s], W_UNIT);
    if constexpr (BF16) {
#pragma unroll
      for (int g = 0; g < 2; ++g)
        tma_load_3d(st + s * W_UNIT + g * W_HALF, &tv, pc * LANES + 64 * g, KD * pj, pb, &full[s]);
    } else {
#pragma unroll
      for (int g = 0; g < 8; ++g)
        tma_load_3d(st + s * W_UNIT + g * 2048, &tv, pc * LANES + 16 * g, KD * pj, pb, &full[s]);
    }
    phave = next_unit(pb, pc, pj, tb, t, kb, blk, rows_valid);
  };

  // Make the unit in stage s (parity ph) ready: its bytes have landed; int8
  // transposes both halves (64 bins each) into buffer buf.
  auto prep = [&](int s, unsigned ph, int buf) {
    mbar_wait_loop(&full[s], ph);
    if constexpr (!BF16) {
      const uint32_t* raw = reinterpret_cast<const uint32_t*>(gbase + (st - base) + s * W_UNIT);
      uint8_t* dst = gbase + (bk - base) + buf * W_UNIT;
      transpose_unit(raw, dst);
      transpose_unit(raw + W_HALF / 4, dst + W_HALF);
    }
  };

  Acc d[F], e[F];
  float tv_[F][LD];
  int tc_[F][LD];
#pragma unroll
  for (int i = 0; i < F; ++i) {
    d[i] = 0;
#pragma unroll
    for (int j = 0; j < LD; ++j) {
      tv_[i][j] = NEG_INF;
      tc_[i][j] = 0;
    }
  }
  float bsub[2] = {0.0f, 0.0f};

  // The chunk's scores from the copy e, inserted into each entry's sorted
  // top-DEPTH.  Bins at or past lim (rows_valid[b] less the chunk's first
  // column) score -inf.  Only
  // the rows in `need` are kept (the others copy a row after the merge):
  // entry i covers rows 8 (i / 4) + i % 2 + {0, 2, 4, 6} across a warp's
  // lanes, so the test is the same in every lane.
  auto epilogue = [&](int b, int c, uint32_t need) {
    const int lim = rows_valid[b] - c * LANES;
#pragma unroll
    for (int i = 0; i < F; ++i) {
      if (!(need & (0x55u << (8 * (i >> 2) + (i & 1))))) continue;
      float x;
      if constexpr (BF16)
        x = __fadd_rn(e[i], 0.0f);  // an exact-zero sum as +0
      else
        x = __int2float_rn(e[i]);
      if (bias != nullptr) x = __fsub_rn(x, bsub[(i >> 1) & 1]);
      if (bin0 + 8 * ((i >> 1) & 1) >= lim) x = NEG_INF;
      if constexpr (GEN) {  // to S, [row][bin]
        cand_v[(8 * (i >> 2) + 2 * (wl & 3) + (i & 1)) * CS + bin0 + 8 * ((i >> 1) & 1)] = x;
      } else if constexpr (MAX_ONLY) {
        if (x > tv_[i][0]) tv_[i][0] = x;
      } else {
        insert_top<LD>(tv_[i], tc_[i], x, c);
      }
    }
  };

  // Block b's survivors to shared memory, [row][depth][bin], and the
  // entries reset for the next block.
  auto flush = [&](int b) {
    if constexpr (GEN) return;  // the lists are in the slot
    const int rb = row_base[b];
#pragma unroll
    for (int i = 0; i < F; ++i) {
      const int bin = bin0 + 8 * ((i >> 1) & 1);
      const int row = 8 * (i >> 2) + 2 * (wl & 3) + (i & 1);
#pragma unroll
      for (int j = 0; j < LD; ++j) {
        cand_v[row * CS + j * LANES + bin] = tv_[i][j];
        cand_i[row * CS + j * LANES + bin] = rb + tc_[i][j] * LANES + bin;
      }
    }
#pragma unroll
    for (int i = 0; i < F; ++i)
#pragma unroll
      for (int j = 0; j < LD; ++j) {
        tv_[i][j] = NEG_INF;
        tc_[i][j] = 0;
      }
  };

  // The survivors merged into each row's running top-k, warp w taking rows
  // w, w + 8, ... side by side (merge_rows).  Rows in `dup` are left out:
  // their state is copied from another row after.
  auto cand = [&](int rr, int j, int bin, float& v, int& id) {
    v = cand_v[rr * CS + j * LANES + bin];
    id = cand_i[rr * CS + j * LANES + bin];
  };
  int mrows[R];
#pragma unroll
  for (int r = 0; r < R; ++r) mrows[r] = warp + WARPS * r;
  // The general selection: chunk c of block b scored into S (cand_v):
  // keepall merges it, else its scores go to the lists.
  auto gen_chunk = [&](int b, int c, uint32_t rows) {
    if (gen.keepall)
      gen_merge(gen, 0, N, rows, cand_v, CS, c, row_base[b], run_v, run_i, s_bv, s_bi, k);
    else
      gen_insert(gen, s_slot, N, cand_v, CS, rows, c);
  };
  auto merge = [&](uint32_t dup, int b) {
    if constexpr (GEN) {
      if (lists)
        gen_merge(gen, s_slot, N, vmask & ~dup, cand_v, CS, 0, row_base[b], run_v, run_i, s_bv,
                  s_bi, k);
    } else if constexpr (!MAX_ONLY) {
      merge_rows<LD, R, V != Variant::kNoGate>(mrows, vmask & ~dup, cand, run_v, run_i, s_bv,
                                                s_bi, k);
    }
  };

  // kMaxOnly, kFixedOut: each row's max over the block's 128 bins into
  // slot 0 of its running state.  Entries i and i ^ 2 hold one row in two
  // bins; the lanes of one wl % 4 hold a row's other bins of the warp
  // (shuffles), the eight warps the rest (shared memory, over cand_v).
  auto row_max = [&]() {
#pragma unroll
    for (int h = 0; h < F / 2; ++h) {
      const int i = 4 * (h >> 1) + (h & 1);
      float x = fmaxf(tv_[i][0], tv_[i + 2][0]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
      if (wl < 4) cand_v[warp * N + 8 * (h >> 1) + 2 * wl + (h & 1)] = x;
    }
    __syncthreads();
    if (threadIdx.x < N) {
      float x = NEG_INF;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) x = fmaxf(x, cand_v[w * N + threadIdx.x]);
      run_v[threadIdx.x * K_MAX] = x;
    }
    __syncthreads();
  };

  // A tile whose rows are zero in every block of the run (most tiles of a
  // routed table hold only empty slots) loads no slab: per block the
  // threads of bins 0-127 bin row 0's scores from the bias words
  // (zero_row_top), row 0 is merged, and every row takes its result.  The
  // test stops at the first block that holds a row (a routed table's
  // cluster shares its rows across its blocks, so that is the run's
  // first).
  bool nonzero = false;
  for (int b = tb; b <= t && !nonzero; ++b) {
    if (rows_valid[b] <= 0) continue;
    bool any = false;
    if constexpr (SRC != QSrc::kRouted) {
      const int pieces = ldq / 16;
      const size_t qb = qrow(b);
      for (int i = threadIdx.x; i < nrows * pieces; i += THREADS) {
        const int4 v = *reinterpret_cast<const int4*>(
            q + (qb * qcap + r0 + i / pieces) * ldq + 16 * (i % pieces));
        any |= (v.x | v.y | v.z | v.w) != 0;
      }
    } else {
      for (int n = threadIdx.x; n < nrows; n += THREADS) {
        const int s = cq_blocks[(size_t)b * qcap + r0 + n];
        any |= s >= 0 && s < nsrc;
      }
    }
    nonzero = __syncthreads_or(any);
  }
  if (!nonzero) {
    if constexpr (MAX_ONLY) {
      // Every valid column scores +0 (no bias), and block t holds one.
      if (!writes) return;
      for (int i = threadIdx.x; i < nrows * k; i += THREADS) {
        const size_t o = ((size_t)orow * qcap + r0) * k + i;
        out_v[o] = 0.0f;
        out_i[o] = 0;
      }
      return;
    }
    for (int b = tb; b <= t; ++b) {
      const int nvalid = min(rows_valid[b], blk);
      if (nvalid <= 0) continue;
      if constexpr (GEN) {
        // Row 0's scores chunk by chunk into S, through the general selection.
        for (int c = 0; c * LANES < nvalid; ++c) {
          if (threadIdx.x < LANES) {
            const int col = c * LANES + threadIdx.x;
            cand_v[threadIdx.x] = col >= nvalid ? NEG_INF
                                  : bias != nullptr ? __fsub_rn(0.0f, bias[(size_t)b * blk + col])
                                                    : 0.0f;
          }
          __syncthreads();
          gen_chunk(b, c, 1u);
          __syncthreads();
        }
      } else {
        if (threadIdx.x < LANES) {
          float zv[LD];
          int zc[LD];
          zero_row_top<LD>(bias != nullptr ? bias + (size_t)b * blk + threadIdx.x : nullptr,
                           nvalid, threadIdx.x, zv, zc);
          const int rb = row_base[b];
#pragma unroll
          for (int j = 0; j < LD; ++j) {
            cand_v[j * LANES + threadIdx.x] = zv[j];
            cand_i[j * LANES + threadIdx.x] = rb + zc[j] * LANES + threadIdx.x;
          }
        }
        __syncthreads();
      }
      merge(vmask & ~1u, b);
      __syncthreads();
    }
    release();
    for (int i = threadIdx.x; i < nrows * k; i += THREADS) {
      const size_t o = ((size_t)orow * qcap + r0) * k + i;
      out_v[o] = run_v[i % k];
      out_i[o] = run_i[i % k];
    }
    return;
  }

  if (threadIdx.x == 0)
    for (int s = 0; s < stages && phave; ++s) load(s);
  load_queries(cb);
  int rs = 0, kbuf = 0;  // the unit's stage and transposed buffer
  unsigned rph = 0, qph = 0;
  prep(0, 0, 0);
  if (qwide) gather_unit(cb, cj, 0);
  fence_proxy_async();
  __syncthreads();
  if (SRC != QSrc::kRouted && !qwide) {
    mbar_wait_loop(&qbar, qph);
    qph ^= 1u;
  }
  detect(cb);
  __syncthreads();
  // Rows that were zero in every block so far (`same`) share one running
  // top-k, their candidates being equal in every block: the lowest of them
  // (`lead`) is scored and merged, the others (`dup`) copy it after the
  // merge.
  // With bounds, rows differ by their bounds: none shares; nor in
  // kMaxOnly and kFixedOut, which keep no top-k.
  uint32_t same = bound_i != nullptr || MAX_ONLY ? 0u : vmask, dup = 0, need = 0;
  int lead = 0;
  auto rows_of_block = [&]() {
    same &= ~s_nz;
    lead = same != 0 ? __ffs(same) - 1 : 0;
    dup = same & ~(1u << lead);
    need = vmask & ~dup;
  };
  rows_of_block();
  while (have) {
    if (bias != nullptr && cj == 0) {  // the chunk's bias words for this thread's two bins
      const float* bw = bias + (size_t)cb * blk + cc * LANES + bin0;
      bsub[0] = bw[0];
      bsub[1] = bw[8];
    }
    // The unit's product: 4 k-steps, the chunk's first unit from zero.  B:
    // the N routed rows, K-major, 128-byte rows, 8-row groups 1 KB apart, a
    // k-step 32 bytes along the row.  A: the warpgroup's 64 bins; int8
    // K-major as B; bf16 M-major, 128-byte d rows, a k16 step 16 rows (2 KB).
    {
      const uint32_t sa = (BF16 ? st + rs * W_UNIT : bk + kbuf * W_UNIT) + wg * W_HALF;
      const uint32_t sb = qs + (qwide ? kbuf : cj) * QUNIT;
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_step(d, BF16 ? gmma_desc(sa + kk * 2048, W_HALF, 1024)
                           : gmma_desc(sa + kk * 32, 16, 1024),
                   gmma_desc(sb + kk * 32, 16, 1024), cj + kk);
      wgmma_commit();
      fence_acc(d);
    }
    // The next unit, and its transpose while the groups run.
    int nb = cb, nc = cc, nj = cj;
    const bool nhave = next_unit(nb, nc, nj, tb, t, kb, blk, rows_valid);
    const int ns = rs + 1 == stages ? 0 : rs + 1;
    const unsigned nph = rs + 1 == stages ? rph ^ 1u : rph;
    if (nhave) {
      prep(ns, nph, kbuf ^ 1);
      if (qwide) gather_unit(nb, nj, kbuf ^ 1);
    }
    wgmma_wait<0>();
    fence_acc(d);
    const bool chunk_end = cj == kb - 1;
    if (chunk_end) {
      copy_acc(d, e);
      epilogue(cb, cc, need);
    }
    fence_proxy_async();
    __syncthreads();  // stage rs and buffer kbuf are free; the next unit is transposed
    if (threadIdx.x == 0 && phave) load(rs);
    if (GEN && chunk_end) {  // S is read before the next chunk writes it
      gen_chunk(cb, cc, need);
      __syncthreads();
    }
    if (MAX_ONLY && chunk_end && !nhave) {
      row_max();  // the CTA's one block is scored
    } else if (chunk_end && (!nhave || nb != cb)) {
      // Block cb is scored: every product on the routed rows retired, so
      // the next block's rows load while this one's survivors merge.
      if (nhave) load_queries(nb);
      flush(cb);
      if (threadIdx.x == 0) s_nz = 0;
      __syncthreads();
      merge(dup, cb);
      __syncthreads();
      for (int i = threadIdx.x; dup != 0 && i < N * k; i += THREADS) {
        const int r = i / k, p = i % k;
        if ((dup >> r) & 1u) {
          run_v[r * K_MAX + p] = run_v[lead * K_MAX + p];
          run_i[r * K_MAX + p] = run_i[lead * K_MAX + p];
        }
      }
      if (nhave) {
        if (SRC != QSrc::kRouted && !qwide) {
          mbar_wait_loop(&qbar, qph);
          qph ^= 1u;
        }
        detect(nb);
      }
      __syncthreads();
      rows_of_block();
    }
    cb = nb;
    cc = nc;
    cj = nj;
    rs = ns;
    rph = nph;
    kbuf ^= 1;
    have = nhave;
  }
  release();

  if (!writes) return;
  for (int i = threadIdx.x; i < N * k; i += THREADS) {
    const int r = i / k, p = i % k;
    if (r0 + r >= qcap) continue;
    const size_t o = ((size_t)orow * qcap + r0 + r) * k + p;
    out_v[o] = run_v[r * K_MAX + (MAX_ONLY ? 0 : p)];
    out_i[o] = MAX_ONLY ? 0 : run_i[r * K_MAX + p];
  }
}

// The general selection's lists: more slots than the kernel's CTAs that fit
// on the card at once, so a CTA that waits for one always finds one freed.
template <class Kernel>
int check_slots(Kernel kernel, int threads, size_t smem, const GenArgs& gen) {
  if (gen.nbins < 1 || gen.depth < 1) return (int)cudaErrorInvalidValue;
  if (gen.keepall) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (const cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return (int)e;
  if (const cudaError_t e =
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem))
    return (int)e;
  return gen.v == nullptr || gen.c == nullptr || gen.locks == nullptr ||
                 (long long)per_sm * sms > gen.nslots
             ? (int)cudaErrorInvalidValue
             : 0;
}

// q: K4's qg [nblocks, qcap] rows, K6's and K10's qg [nsrc = nlist, qcap]
// rows or K7's qi [nsrc] rows, of d elements of T at a pitch of ldq elements
// (16 bytes' worth; int8: the pad zero); cq_blocks [nblocks, qcap] (K7),
// block_cluster [nblocks] (K6, K10), vec [nblocks, d, blk], bias [nblocks,
// blk] or null.
template <typename T, int DEPTH, QSrc SRC, Variant V>
int launch_wgmma(const void* q, const void* cq_blocks, const void* block_cluster, const void* vec,
                 const void* block_first, const void* block_last, const void* rows_valid,
                 const void* bias, const void* row_base, const void* bound_v,
                 const void* bound_i, void* out_v, void* out_i, int nblocks, int qcap, int d,
                 int ldq, int blk, int k, int nsrc, const GenArgs& gen, cudaStream_t s) {
  constexpr bool BF16 = std::is_same_v<T, __nv_bfloat16>;
  constexpr int ES = (int)sizeof(T), KD = 128 / ES;
  using Tl = WTile<DEPTH>;
  static const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const int kb = (d + KD - 1) / KD;
  const int planes = SRC == QSrc::kCluster ? nsrc : nblocks;
  CUtensorMap tq{}, tv;
  if constexpr (SRC != QSrc::kRouted) {
    const int e = BF16 ? bf16_map_3d(encode, &tq, q, planes, qcap, d, Tl::N, ldq)
                       : int8_map_3d(encode, &tq, q, planes, qcap, ldq, 128, Tl::N, true);
    if (e) return e;
  }
  if (const int e = BF16 ? bf16_map_3d(encode, &tv, vec, nblocks, d, blk, 64)
                         : int8_map_3d(encode, &tv, vec, nblocks, d, blk, 16, 128, false))
    return e;
  // The routed rows stay resident for the block (kb units) while that
  // leaves two stages; wider, two unit buffers take them a unit at a time.
  const int part = 1024 + (BF16 ? 0 : 2 * W_UNIT) +
                   Tl::N * (Tl::CS + K_MAX) * 2 * (int)sizeof(int32_t);
  int qwide = 0, fixed = part + kb * Tl::N * 128;
  if ((W_SMEM_MAX - fixed) / W_UNIT < 2) {
    qwide = 1;
    fixed = part + 2 * Tl::N * 128;
  }
  const int stages = min(W_STAGES_MAX, (W_SMEM_MAX - fixed) / W_UNIT);
  const int smem = fixed + stages * W_UNIT;
  if (const cudaError_t e = cudaFuncSetAttribute(grouped_wgmma_kernel<T, DEPTH, SRC, V>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 smem))
    return (int)e;
  if (DEPTH == 0)
    if (const int e = check_slots(grouped_wgmma_kernel<T, DEPTH, SRC, V>, THREADS, smem, gen))
      return e;
  const dim3 grid((unsigned)nblocks, (unsigned)((qcap + Tl::N - 1) / Tl::N));
  grouped_wgmma_kernel<T, DEPTH, SRC, V><<<grid, THREADS, smem, s>>>(
      tq, tv, static_cast<const int8_t*>(q), static_cast<const int32_t*>(cq_blocks),
      static_cast<const int32_t*>(block_cluster), static_cast<const int32_t*>(block_first),
      static_cast<const int32_t*>(block_last),
      static_cast<const int32_t*>(rows_valid), static_cast<const float*>(bias),
      static_cast<const int32_t*>(row_base), static_cast<const float*>(bound_v),
      static_cast<const int32_t*>(bound_i), static_cast<float*>(out_v),
      static_cast<int32_t*>(out_i), qcap, blk, kb, ldq * ES, d * ES, k, stages, nsrc, qwide, gen);
  return (int)cudaGetLastError();
}

// ------------------------------- K4, K6, K7 and K10 fp32: the FFMA register tile

// The fp32 modes' tile: ffma_tile.cuh's tile cut to 32 routed rows (WM = 1:
// four warps; MI = 4: 4 x 8 accumulators a thread) x the chunk's 128 bins;
// d-slices of 32 through two stages, or of 16 through three at DEPTH > 2,
// whose lists take more shared memory.
constexpr int F_ROWS = 32;
template <int DEPTH>
using FTile = ffma::Tile<1, DEPTH <= 2 ? 32 : 16, DEPTH <= 2 ? 2 : 3, F_ROWS / 8>;
constexpr int F_CHUNKS = 65536;  // chunks a block: the lists keep a chunk in 16 bits

// A row's stride in the lists [row][depth][bin] (odd: a warp's epilogue
// stores of eight rows fall at most two to a bank), and the shared memory of
// the ring, the lists and the running top-k.
template <int DEPTH>
struct FList {
  static constexpr int CS = (DEPTH > 0 ? DEPTH : 1) * LANES + 1;  // general: one chunk's scores
  static constexpr size_t SMEM = FTile<DEPTH>::RING_BYTES +
                                 (size_t)F_ROWS * CS * (sizeof(float) + sizeof(uint16_t)) +
                                 (size_t)F_ROWS * K_MAX * 2 * sizeof(int32_t);
};

// K4 (SRC kBlock: q = qg [nblocks, qcap] rows), K6 and K10 (SRC kCluster:
// q = qg [nsrc = nlist, qcap] rows, block b's rows being
// qg[block_cluster[b]], the output row of a run ending at t being
// block_cluster[t]) and K7 (SRC kRouted: q = qi [nsrc] rows, row r of block
// b being qi[cq_blocks[b, r]]): rows of d fp32 at a pitch of ldq (a
// multiple of 4, 16-byte aligned); the slab vec [nblocks, d, blk] (16-byte
// aligned).  CTA (t, y): last block t (kMaxOnly, kFixedOut: block t), routed
// rows F_ROWS y .. + F_ROWS - 1.  The walk is next_unit's over (block,
// chunk, d-slice), nk slices a chunk; accumulator (i, j) is (row, bin)
// Place (i, j).  V: K10's variant, as grouped_wgmma_kernel's.
template <int DEPTH, QSrc SRC, Variant V = Variant::kFull>
__global__ void __launch_bounds__(FTile<DEPTH>::THREADS, 2)
grouped_ffma_kernel(const float* __restrict__ q,
                    const int32_t* __restrict__ cq_blocks,     // [nblocks, qcap] (K7)
                    const int32_t* __restrict__ block_cluster, // [nblocks] (K6)
                    const float* __restrict__ vec,
                    const int32_t* __restrict__ block_first,
                    const int32_t* __restrict__ block_last,
                    const int32_t* __restrict__ rows_valid,
                    const float* __restrict__ bias,            // [nblocks, blk] or null
                    const int32_t* __restrict__ row_base,
                    const float* __restrict__ bound_v,         // like out's rows, or null
                    const int32_t* __restrict__ bound_i,
                    float* __restrict__ out_v, int32_t* __restrict__ out_i,
                    int qcap, int d, int blk, int ldq, int k, int nsrc, const GenArgs gen) {
  using Tl = FTile<DEPTH>;
  constexpr bool MAX_ONLY = kMaxVariant<V>;
  constexpr bool GEN = DEPTH == 0;         // the general selection
  constexpr int LD = GEN ? 1 : DEPTH;
  static_assert(!(GEN && MAX_ONLY), "kMaxOnly and kFixedOut select nothing");
  static_assert(V == Variant::kFull || SRC == QSrc::kCluster, "K10's variants are K6's");
  constexpr int TH = Tl::THREADS, SF = Tl::STAGE_FLOATS, CS = FList<DEPTH>::CS;
  constexpr int NW = TH / 32;             // warps
  constexpr int R = DEPTH <= 2 ? 4 : 2;   // rows a warp merges side by side
  const float NEG_INF = -INFINITY;

  const int t = blockIdx.x;
  if constexpr (!MAX_ONLY) {
    if (block_last[t] == 0) return;
  }
  int orow = t;  // the output row: the block (K4, K7) or its cluster (K6, K10)
  if constexpr (SRC == QSrc::kCluster) {
    orow = block_cluster[t];
    if (orow < 0 || orow >= nsrc) return;
  }
  bool writes = true;  // kMaxOnly, kFixedOut: as grouped_wgmma_kernel's
  if constexpr (V == Variant::kMaxOnly) {
    writes = t + 1 == (int)gridDim.x || block_cluster[t + 1] != orow;
  } else if constexpr (V == Variant::kFixedOut) {
    writes = t + 1 == (int)gridDim.x;
    orow = 0;
  }
  // Block b's rows in q: K4's own, K6's cluster's (K7 gathers through cq).
  auto qrow = [&](int b) { return SRC == QSrc::kCluster ? block_cluster[b] : b; };
  const int r0 = blockIdx.y * F_ROWS;
  const int nrows = min(qcap - r0, F_ROWS);
  static_assert(F_ROWS == 32, "a CTA's rows are the bits of one word");
  const uint32_t vmask = nrows == 32 ? ~0u : (1u << nrows) - 1u;
  constexpr int MI = Tl::MI;
  int tb = t;  // the run's first block
  if constexpr (!MAX_ONLY) {
    while (tb > 0 && block_first[tb] == 0) --tb;
  }
  const int nk = (d + Tl::BK - 1) / Tl::BK;

  // Shared memory: the ring, the lists' scores [F_ROWS][CS] (general: the
  // chunk's scores S), the running top-k, the lists' chunks [F_ROWS][CS]
  // (16 bits each).
  extern __shared__ __align__(16) float fsm[];
  float* const list_v = fsm + Tl::STAGES * SF;
  float* const run_v = list_v + F_ROWS * CS;
  int32_t* const run_i = reinterpret_cast<int32_t*>(run_v + F_ROWS * K_MAX);
  uint16_t* const list_c = reinterpret_cast<uint16_t*>(run_i + F_ROWS * K_MAX);
  __shared__ float s_bv[F_ROWS];
  __shared__ int s_bi[F_ROWS];
  __shared__ uint32_t s_nz;  // the rows of the block taken as nonzero
  __shared__ int s_slot;     // the general selection's slot of lists
  const int tid = threadIdx.x, warp = tid >> 5, wl = tid & 31;

  for (int i = tid; i < F_ROWS * K_MAX; i += TH) {
    run_v[i] = NEG_INF;
    run_i[i] = 0;
  }
  if (tid < F_ROWS) {
    const bool has = bound_i != nullptr && r0 + tid < qcap;
    const size_t o = (size_t)orow * qcap + r0 + tid;
    s_bv[tid] = has ? bound_v[o] : INFINITY;
    s_bi[tid] = has ? bound_i[o] : -1;
  }
  if (tid == 0) {
    s_nz = 0;
    if (GEN && !gen.keepall) s_slot = gen_acquire(gen.locks, gen.nslots);
  }
  __syncthreads();
  const bool lists = GEN && !gen.keepall;
  if (lists) gen_reset(gen, s_slot, F_ROWS);
  auto release = [&]() {  // once every thread is done with the slot
    if (!lists) return;
    __syncthreads();
    if (tid == 0) gen_release(gen.locks, s_slot);
  };

  // Row n (< nrows) of block b taken as nonzero: K4 and K6 hold a nonzero
  // word in its ldq; K7 has a slot in [0, nsrc) (a zero query there is
  // scored, which is exact too).  TPR threads a row.
  constexpr int TPR = TH / F_ROWS;
  auto row_nonzero = [&](int b, int n, int part) {
    if (n >= nrows) return false;
    if constexpr (SRC == QSrc::kRouted) {
      const int s = cq_blocks[(size_t)b * qcap + r0 + n];
      return part == 0 && s >= 0 && s < nsrc;
    } else {
      const float4* row = reinterpret_cast<const float4*>(
          q + ((size_t)qrow(b) * qcap + r0 + n) * ldq);
      unsigned any = 0;
      for (int p = part; p < ldq / 4; p += TPR) {
        const uint4 v = *reinterpret_cast<const uint4*>(row + p);
        any |= v.x | v.y | v.z | v.w;
      }
      return any != 0;
    }
  };
  // Block b's nonzero rows into s_nz (reset beforehand, read after a
  // barrier).
  auto detect = [&](int b) {
    const unsigned ball = __ballot_sync(FULL, row_nonzero(b, tid / TPR, tid % TPR));
    if (wl == 0) {
      uint32_t rows = 0;
#pragma unroll
      for (int j = 0; j < 32 / TPR; ++j)
        if ((ball >> (j * TPR)) & ((1u << TPR) - 1u)) rows |= 1u << (warp * (32 / TPR) + j);
      if (rows) atomicOr(&s_nz, rows);
    }
  };

  // The survivors of the block (row base rb) merged into each row's running
  // top-k: warp w takes rows w + NW (r + R g), R side by side, the groups in
  // turn; a group without a row in `act` is skipped.
  int rb = 0;
  auto cand = [&](int rr, int j, int bin, float& v, int& id) {
    const int o = rr * CS + j * LANES + bin;
    v = list_v[o];
    id = rb + list_c[o] * LANES + bin;
  };
  auto merge = [&](uint32_t act) {
    if constexpr (MAX_ONLY) return;
    if constexpr (GEN) {
      if (lists)
        gen_merge(gen, s_slot, F_ROWS, act, list_v, CS, 0, rb, run_v, run_i, s_bv, s_bi, k);
      return;
    }
#pragma unroll 1
    for (int g = 0; g < F_ROWS / (NW * R); ++g) {
      int rows[R];
      bool any = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        rows[r] = warp + NW * (r + R * g);
        any |= (act >> rows[r]) & 1u;
      }
      if (any)
        merge_rows<LD, R, V != Variant::kNoGate>(rows, act, cand, run_v, run_i, s_bv, s_bi, k);
    }
  };
  // The general selection: chunk c of block b scored into S (list_v):
  // keepall merges it, else its scores go to the lists.
  auto gen_chunk = [&](int b, int c, uint32_t rows) {
    if (gen.keepall)
      gen_merge(gen, 0, F_ROWS, rows, list_v, CS, c, row_base[b], run_v, run_i, s_bv, s_bi, k);
    else
      gen_insert(gen, s_slot, F_ROWS, list_v, CS, rows, c);
  };

  // The all-zero tile (the wgmma modes' test and path): row 0 binned from
  // the bias words and merged, its result every row's.
  bool nonzero = false;
  for (int b = tb; b <= t && !nonzero; ++b) {
    if (rows_valid[b] <= 0) continue;
    nonzero = __syncthreads_or(row_nonzero(b, tid / TPR, tid % TPR));
  }
  if (!nonzero) {
    if constexpr (MAX_ONLY) {
      // Every valid column scores +0 (no bias): the row max is +0 where
      // block t holds one, else -inf.
      if (!writes) return;
      const float z = rows_valid[t] > 0 ? 0.0f : NEG_INF;
      for (int i = tid; i < nrows * k; i += TH) {
        const size_t o = ((size_t)orow * qcap + r0) * k + i;
        out_v[o] = z;
        out_i[o] = 0;
      }
      return;
    }
    for (int b = tb; b <= t; ++b) {
      const int nvalid = min(rows_valid[b], blk);
      if (nvalid <= 0) continue;
      rb = row_base[b];
      if constexpr (GEN) {
        // Row 0's scores chunk by chunk into S, through the general selection.
        for (int c = 0; c * LANES < nvalid; ++c) {
          const int col = c * LANES + tid;
          list_v[tid] = col >= nvalid ? NEG_INF
                        : bias != nullptr ? __fsub_rn(0.0f, bias[(size_t)b * blk + col]) : 0.0f;
          __syncthreads();
          gen_chunk(b, c, 1u);
          __syncthreads();
        }
      } else {
        float zv[LD];
        int zc[LD];
        zero_row_top<LD>(bias != nullptr ? bias + (size_t)b * blk + tid : nullptr, nvalid, tid,
                         zv, zc);
#pragma unroll
        for (int j = 0; j < LD; ++j) {
          list_v[j * LANES + tid] = zv[j];
          list_c[j * LANES + tid] = (uint16_t)zc[j];
        }
        __syncthreads();
      }
      merge(1u);
      __syncthreads();
    }
    release();
    for (int i = tid; i < nrows * k; i += TH) {
      const size_t o = ((size_t)orow * qcap + r0) * k + i;
      out_v[o] = run_v[i % k];
      out_i[o] = run_i[i % k];
    }
    return;
  }

  // The producer's step runs STAGES - 1 ahead of the consumers'.
  const ffma::Copier<Tl> cp(tid, nrows);
  int pb = tb - 1, pc = 0, pk = nk - 1;
  bool phave = next_unit(pb, pc, pk, tb, t, nk, blk, rows_valid);
  int cb = pb, cc = pc, ck = pk;
  bool have = phave;
  auto load = [&](int slot) {
    float* stage = fsm + slot * SF;
    const float* bsrc = vec + (size_t)pb * d * blk + pc * LANES;
    if constexpr (SRC != QSrc::kRouted)
      cp.load(stage, q + ((size_t)qrow(pb) * qcap + r0) * ldq, ldq, true, bsrc, blk, LANES, true,
              d, pk * Tl::BK);
    else
      cp.load_gather(stage, q, ldq, cq_blocks + (size_t)pb * qcap + r0, nsrc, bsrc, blk, LANES,
                     true, d, pk * Tl::BK);
    phave = next_unit(pb, pc, pk, tb, t, nk, blk, rows_valid);
  };
#pragma unroll
  for (int s = 0; s < Tl::STAGES - 1; ++s) {
    if (phave) load(s);
    ffma::commit();
  }

  // Rows zero in every block so far share one running top-k, as in the
  // wgmma modes: `lead` is scored and merged, `dup` copy it.
  detect(cb);
  __syncthreads();
  uint32_t same = bound_i != nullptr || MAX_ONLY ? 0u : vmask, dup = 0, need = 0;
  int lead = 0;
  auto rows_of_block = [&]() {
    same &= ~s_nz;
    lead = same != 0 ? __ffs(same) - 1 : 0;
    dup = same & ~(1u << lead);
    need = vmask & ~dup;
  };
  rows_of_block();

  // kMaxOnly, kFixedOut: this thread's max of each of its rows over its
  // columns of every chunk so far.
  float rmax[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) rmax[i] = NEG_INF;

  // Chunk c of block b scored: each needed entry, less the bias and -inf
  // past rows_valid, into its (row, bin)'s list: the block's first chunk
  // writes the list, a later one inserts a score above the list's last.
  const ffma::Place pl(tid);
  auto epilogue = [&](int b, int c, const float (&acc)[MI][8]) {
    const int lim = rows_valid[b] - c * LANES;
    if constexpr (MAX_ONLY) {  // no bias
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (pl.col(j) < lim && acc[i][j] > rmax[i]) rmax[i] = acc[i][j];
      return;
    }
    float bs[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bs[j] = bias != nullptr ? bias[(size_t)b * blk + c * LANES + pl.col(j)] : 0.0f;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int row = pl.row(i);
      if (!((need >> row) & 1u)) continue;
      float* lv = list_v + row * CS;
      uint16_t* lc = list_c + row * CS;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int bin = pl.col(j);
        float x = acc[i][j];
        if (bias != nullptr) x = __fsub_rn(x, bs[j]);
        if (bin >= lim) x = NEG_INF;
        if constexpr (GEN) {  // to S, [row][bin]
          lv[bin] = x;
        } else if (c == 0) {
          lv[bin] = x;
          lc[bin] = 0;
#pragma unroll
          for (int u = 1; u < LD; ++u) lv[u * LANES + bin] = NEG_INF;
        } else if (x > lv[(LD - 1) * LANES + bin]) {
          float tv[LD];
          int tc[LD];
#pragma unroll
          for (int u = 0; u < LD; ++u) {
            tv[u] = lv[u * LANES + bin];
            tc[u] = lc[u * LANES + bin];
          }
          insert_top<LD>(tv, tc, x, c);
#pragma unroll
          for (int u = 0; u < LD; ++u) {
            lv[u * LANES + bin] = tv[u];
            lc[u * LANES + bin] = (uint16_t)tc[u];
          }
        }
      }
    }
  };

  float acc[MI][8];
  ffma::zero(acc);
  int slot = 0, pslot = Tl::STAGES - 1;
  while (have) {
    ffma::wait_stage<Tl>();
    __syncthreads();  // the stage has landed, and the one refilled next is read
    if (phave) load(pslot);
    ffma::commit();
    pslot = pslot + 1 == Tl::STAGES ? 0 : pslot + 1;
    ffma::fma_slice<Tl>(fsm + slot * SF, pl, d - ck * Tl::BK, acc);
    slot = slot + 1 == Tl::STAGES ? 0 : slot + 1;
    const int b = cb, c = cc;
    const bool done = ck == nk - 1;
    have = next_unit(cb, cc, ck, tb, t, nk, blk, rows_valid);
    if (!done) continue;
    epilogue(b, c, acc);
    ffma::zero(acc);
    if constexpr (GEN) {  // S is whole, and read before the next chunk writes it
      __syncthreads();
      gen_chunk(b, c, need);
      __syncthreads();
    }
    if (have && cb == b) continue;
    if constexpr (MAX_ONLY) {
      // The CTA's one block is scored: each row's max across the four
      // lanes of one lm (shuffles) and the four warps (shared memory, over
      // the lists), into slot 0 of its running state.
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        float x = rmax[i];
        x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
        x = fmaxf(x, __shfl_xor_sync(FULL, x, 2));
        if (pl.ln == 0) list_v[pl.wn * F_ROWS + pl.row(i)] = x;
      }
      __syncthreads();
      if (tid < F_ROWS)
        run_v[tid * K_MAX] = fmaxf(fmaxf(list_v[tid], list_v[F_ROWS + tid]),
                                   fmaxf(list_v[2 * F_ROWS + tid], list_v[3 * F_ROWS + tid]));
      __syncthreads();
      continue;
    }
    // Block b is scored: its lists merged, the dup rows copied, the next
    // block's rows tested.
    rb = row_base[b];
    if (tid == 0) s_nz = 0;
    __syncthreads();
    merge(vmask & ~dup);
    __syncthreads();
    for (int i = tid; dup != 0 && i < F_ROWS * k; i += TH) {
      const int r = i / k, p = i % k;
      if ((dup >> r) & 1u) {
        run_v[r * K_MAX + p] = run_v[lead * K_MAX + p];
        run_i[r * K_MAX + p] = run_i[lead * K_MAX + p];
      }
    }
    if (have) detect(cb);
    __syncthreads();
    rows_of_block();
  }
  ffma::wait_all();
  release();

  if (!writes) return;
  for (int i = tid; i < F_ROWS * k; i += TH) {
    const int r = i / k, p = i % k;
    if (r >= nrows) continue;
    const size_t o = ((size_t)orow * qcap + r0 + r) * k + p;
    out_v[o] = run_v[r * K_MAX + (MAX_ONLY ? 0 : p)];
    out_i[o] = MAX_ONLY ? 0 : run_i[r * K_MAX + p];
  }
}

// q: K4's qg [nblocks, qcap] rows, K6's and K10's qg [nsrc = nlist, qcap]
// rows or K7's qi [nsrc] rows, of d fp32 at a pitch of ldq (a multiple of
// 4), 16-byte aligned; cq_blocks [nblocks, qcap] (K7), block_cluster
// [nblocks] (K6, K10), vec [nblocks, d, blk] 16-byte aligned, bias
// [nblocks, blk] or null; blk <= 128 * F_CHUNKS.
template <int DEPTH, QSrc SRC, Variant V>
int launch_ffma(const void* q, const void* cq_blocks, const void* block_cluster, const void* vec,
                const void* block_first, const void* block_last, const void* rows_valid,
                const void* bias, const void* row_base, const void* bound_v, const void* bound_i,
                void* out_v, void* out_i, int nblocks, int qcap, int d, int ldq, int blk, int k,
                int nsrc, const GenArgs& gen, cudaStream_t s) {
  if ((DEPTH > 0 && blk > LANES * F_CHUNKS) || ldq % 4 != 0) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = FList<DEPTH>::SMEM;
  if (const cudaError_t e = cudaFuncSetAttribute(grouped_ffma_kernel<DEPTH, SRC, V>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem))
    return (int)e;
  if (DEPTH == 0)
    if (const int e = check_slots(grouped_ffma_kernel<DEPTH, SRC, V>, FTile<DEPTH>::THREADS, smem,
                                  gen))
      return e;
  const dim3 grid((unsigned)nblocks, (unsigned)((qcap + F_ROWS - 1) / F_ROWS));
  grouped_ffma_kernel<DEPTH, SRC, V><<<grid, FTile<DEPTH>::THREADS, smem, s>>>(
      static_cast<const float*>(q), static_cast<const int32_t*>(cq_blocks),
      static_cast<const int32_t*>(block_cluster), static_cast<const float*>(vec),
      static_cast<const int32_t*>(block_first), static_cast<const int32_t*>(block_last),
      static_cast<const int32_t*>(rows_valid), static_cast<const float*>(bias),
      static_cast<const int32_t*>(row_base), static_cast<const float*>(bound_v),
      static_cast<const int32_t*>(bound_i), static_cast<float*>(out_v),
      static_cast<int32_t*>(out_i), qcap, d, blk, ldq, k, nsrc, gen);
  return (int)cudaGetLastError();
}

// One launch of an int8 or bf16 mode on grouped_wgmma_kernel (T = int8_t or
// __nv_bfloat16), or of an fp32 mode on grouped_ffma_kernel (T = float).
template <typename T, int DEPTH, QSrc SRC, Variant V = Variant::kFull>
int launch_scan(const void* q, const void* cq_blocks, const void* block_cluster, const void* vec,
                const void* block_first, const void* block_last, const void* rows_valid,
                const void* bias, const void* row_base, const void* bound_v, const void* bound_i,
                void* out_v, void* out_i, int nblocks, int qcap, int d, int ldq, int blk, int k,
                int nsrc, const GenArgs& gen, cudaStream_t s) {
  if constexpr (std::is_same_v<T, float>)
    return launch_ffma<DEPTH, SRC, V>(q, cq_blocks, block_cluster, vec, block_first,
                                      block_last, rows_valid, bias, row_base, bound_v, bound_i,
                                      out_v, out_i, nblocks, qcap, d, ldq, blk, k, nsrc, gen, s);
  else
    return launch_wgmma<T, DEPTH, SRC, V>(q, cq_blocks, block_cluster, vec, block_first,
                                          block_last, rows_valid, bias, row_base, bound_v,
                                          bound_i, out_v, out_i, nblocks, qcap, d, ldq, blk, k,
                                          nsrc, gen, s);
}

// Whether a launch takes the general selection: nbins other than 128, a
// bin depth past 4, or fp32 past 65536 chunks a block (the lists' 16 bits).
template <typename T>
bool general(int nbins, int depth, int blk) {
  return nbins != LANES || depth > 4 || (std::is_same_v<T, float> && blk > LANES * F_CHUNKS);
}

// The general selection's arguments of a C entry.
GenArgs gen_args(void* gen_v, void* gen_c, void* gen_locks, int nslots, int nbins, int depth,
                 int keepall) {
  return GenArgs{static_cast<float*>(gen_v), static_cast<int32_t*>(gen_c),
                 static_cast<int32_t*>(gen_locks), nslots, nbins, depth, keepall};
}

// The same at any bin depth and nbins: depth 1-4 at nbins 128 on the
// instances of that depth, the rest on the general selection.
template <typename T, QSrc SRC>
int dispatch_scan(const void* q, const void* cq_blocks, const void* block_cluster,
                  const void* vec, const void* block_first, const void* block_last,
                  const void* rows_valid, const void* bias, const void* row_base,
                  const void* bound_v, const void* bound_i, void* out_v, void* out_i,
                  int nblocks, int qcap, int d, int ldq, int blk, int k, int depth, int nsrc,
                  const GenArgs& gen, void* stream) {
  if (nblocks == 0 || qcap == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RAG_LAUNCH(D)                                                                         \
  launch_scan<T, D, SRC>(q, cq_blocks, block_cluster, vec, block_first, block_last, rows_valid, \
                         bias, row_base, bound_v, bound_i, out_v, out_i, nblocks, qcap, d, ldq, \
                         blk, k, nsrc, gen, s)
  if (general<T>(gen.nbins, depth, blk)) return RAG_LAUNCH(0);
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
// mode).  The wrappers guarantee blk % 128 == 0, blk % nbins == 0, 1 <= k
// <= 32 (K10's maxonly and fixedout: any k) and 1 <= depth <= blk / nbins
// (the effective depth).  The entries take, for a later pass of the
// wrapper's (ops/_build.py, by_passes), each output row's bound (bound_v
// f32 and bound_i int32, shaped as out's rows, or both null): only a
// survivor ranked after it may enter the row's top-k.  The float entries
// take fp32 (bf16 = 0; on the FFMA tile) or bf16 (bf16 = 1; on wgmma)
// operands, the routed rows at a pitch of ldq (16 bytes' worth; the pad
// need not be zero); the int8 entries' ldq is d rounded up to 16 with the
// pad zero.  q and vec are 16-byte aligned.  The general selection (any
// nbins but 128, depth past 4, fp32 past 65536 chunks a block) takes
// `keepall` (1: every column is a candidate, which the wrapper asks for
// where depth >= min(k of the whole call, blk / nbins)) and otherwise its
// scratch: gen_v and gen_c nslots x [32][nbins][depth] floats and ints,
// gen_locks [nslots] int32 zeros, nslots at least the kernel's CTAs that fit
// on the card at once.
//
// K4: qg [nblocks, qcap, ldq], out [nblocks, qcap, k].
extern "C" int ivf_grouped_scan_i8(const void* qg, const void* vec, const void* block_first,
                                   const void* block_last, const void* rows_valid,
                                   const void* bias, const void* row_base, const void* bound_v,
                                   const void* bound_i, void* out_v, void* out_i, void* gen_v,
                                   void* gen_c, void* gen_locks, int nblocks, int qcap, int d,
                                   int ldq, int blk, int k, int depth, int nbins, int keepall,
                                   int nslots, void* stream) {
  const GenArgs g = gen_args(gen_v, gen_c, gen_locks, nslots, nbins, depth, keepall);
  return dispatch_scan<int8_t, QSrc::kBlock>(qg, nullptr, nullptr, vec, block_first, block_last,
                                             rows_valid, bias, row_base, bound_v, bound_i, out_v,
                                             out_i, nblocks, qcap, d, ldq, blk, k, depth, nblocks,
                                             g, stream);
}

extern "C" int ivf_grouped_scan_f(const void* qg, const void* vec, const void* block_first,
                                  const void* block_last, const void* rows_valid,
                                  const void* bias, const void* row_base, const void* bound_v,
                                  const void* bound_i, void* out_v, void* out_i, void* gen_v,
                                  void* gen_c, void* gen_locks, int nblocks, int qcap, int d,
                                  int ldq, int blk, int k, int depth, int bf16, int nbins,
                                  int keepall, int nslots, void* stream) {
  const GenArgs g = gen_args(gen_v, gen_c, gen_locks, nslots, nbins, depth, keepall);
  return bf16 ? dispatch_scan<__nv_bfloat16, QSrc::kBlock>(
                    qg, nullptr, nullptr, vec, block_first, block_last, rows_valid, bias,
                    row_base, bound_v, bound_i, out_v, out_i, nblocks, qcap, d, ldq, blk, k,
                    depth, nblocks, g, stream)
              : dispatch_scan<float, QSrc::kBlock>(
                    qg, nullptr, nullptr, vec, block_first, block_last, rows_valid, bias,
                    row_base, bound_v, bound_i, out_v, out_i, nblocks, qcap, d, ldq, blk, k,
                    depth, nblocks, g, stream);
}

// K6: qg [nlist, qcap, ldq], block_cluster [nblocks], out [nlist, qcap, k].
extern "C" int ivf_cluster_scan_i8(const void* qg, const void* vec, const void* block_cluster,
                                   const void* block_first, const void* block_last,
                                   const void* rows_valid, const void* bias,
                                   const void* row_base, const void* bound_v,
                                   const void* bound_i, void* out_v, void* out_i, void* gen_v,
                                   void* gen_c, void* gen_locks, int nlist, int nblocks, int qcap,
                                   int d, int ldq, int blk, int k, int depth, int nbins,
                                   int keepall, int nslots, void* stream) {
  const GenArgs g = gen_args(gen_v, gen_c, gen_locks, nslots, nbins, depth, keepall);
  return dispatch_scan<int8_t, QSrc::kCluster>(qg, nullptr, block_cluster, vec, block_first,
                                               block_last, rows_valid, bias, row_base, bound_v,
                                               bound_i, out_v, out_i, nblocks, qcap, d, ldq, blk,
                                               k, depth, nlist, g, stream);
}

extern "C" int ivf_cluster_scan_f(const void* qg, const void* vec, const void* block_cluster,
                                  const void* block_first, const void* block_last,
                                  const void* rows_valid, const void* bias, const void* row_base,
                                  const void* bound_v, const void* bound_i, void* out_v,
                                  void* out_i, void* gen_v, void* gen_c, void* gen_locks,
                                  int nlist, int nblocks, int qcap, int d, int ldq, int blk,
                                  int k, int depth, int bf16, int nbins, int keepall, int nslots,
                                  void* stream) {
  const GenArgs g = gen_args(gen_v, gen_c, gen_locks, nslots, nbins, depth, keepall);
  return bf16 ? dispatch_scan<__nv_bfloat16, QSrc::kCluster>(
                    qg, nullptr, block_cluster, vec, block_first, block_last, rows_valid, bias,
                    row_base, bound_v, bound_i, out_v, out_i, nblocks, qcap, d, ldq, blk, k,
                    depth, nlist, g, stream)
              : dispatch_scan<float, QSrc::kCluster>(
                    qg, nullptr, block_cluster, vec, block_first, block_last, rows_valid, bias,
                    row_base, bound_v, bound_i, out_v, out_i, nblocks, qcap, d, ldq, blk, k,
                    depth, nlist, g, stream);
}

// K7: qi [nbatch, ldq], cq_blocks [nblocks, qcap] (-1 = empty slot), out
// [nblocks, qcap, k].
extern "C" int ivf_routed_scan_i8(const void* qi, const void* cq_blocks, const void* vec,
                                  const void* block_first, const void* block_last,
                                  const void* rows_valid, const void* bias, const void* row_base,
                                  const void* bound_v, const void* bound_i, void* out_v,
                                  void* out_i, void* gen_v, void* gen_c, void* gen_locks,
                                  int nbatch, int nblocks, int qcap, int d, int ldq, int blk,
                                  int k, int depth, int nbins, int keepall, int nslots,
                                  void* stream) {
  const GenArgs g = gen_args(gen_v, gen_c, gen_locks, nslots, nbins, depth, keepall);
  return dispatch_scan<int8_t, QSrc::kRouted>(qi, cq_blocks, nullptr, vec, block_first,
                                              block_last, rows_valid, bias, row_base, bound_v,
                                              bound_i, out_v, out_i, nblocks, qcap, d, ldq, blk,
                                              k, depth, nbatch, g, stream);
}

extern "C" int ivf_routed_scan_f(const void* qi, const void* cq_blocks, const void* vec,
                                 const void* block_first, const void* block_last,
                                 const void* rows_valid, const void* bias, const void* row_base,
                                 const void* bound_v, const void* bound_i, void* out_v,
                                 void* out_i, void* gen_v, void* gen_c, void* gen_locks,
                                 int nbatch, int nblocks, int qcap, int d, int ldq, int blk, int k,
                                 int depth, int bf16, int nbins, int keepall, int nslots,
                                 void* stream) {
  const GenArgs g = gen_args(gen_v, gen_c, gen_locks, nslots, nbins, depth, keepall);
  return bf16 ? dispatch_scan<__nv_bfloat16, QSrc::kRouted>(
                    qi, cq_blocks, nullptr, vec, block_first, block_last, rows_valid, bias,
                    row_base, bound_v, bound_i, out_v, out_i, nblocks, qcap, d, ldq, blk, k,
                    depth, nbatch, g, stream)
              : dispatch_scan<float, QSrc::kRouted>(
                    qi, cq_blocks, nullptr, vec, block_first, block_last, rows_valid, bias,
                    row_base, bound_v, bound_i, out_v, out_i, nblocks, qcap, d, ldq, blk, k,
                    depth, nbatch, g, stream);
}

// K10: qg [nlist, qcap, ldq], block_cluster [nblocks], out [nlist, qcap, k];
// bin depth 2, no bias; variant 0-3 = full, nogate, maxonly, fixedout (full
// is K6's own instance).  full and nogate take k <= 32 and the bounds of a
// later pass as K6 does; maxonly and fixedout write their row max to any k
// slots and take no bounds.  full and nogate at nbins other than 128 (or
// fp32 past 65536 chunks a block) run K6's general selection at the
// effective depth min(2, blk / nbins), nogate too (its merge tests each
// candidate against the k-th entry; the values are the same); maxonly and
// fixedout select nothing, so nbins changes nothing there.
namespace {
template <typename T>
int variant_scan(const void* qg, const void* vec, const void* block_cluster,
                 const void* block_first, const void* block_last, const void* rows_valid,
                 const void* row_base, const void* bound_v, const void* bound_i, void* out_v,
                 void* out_i, int nlist, int nblocks, int qcap, int d, int ldq, int blk, int k,
                 int variant, const GenArgs& g, void* stream) {
  if (nblocks == 0 || qcap == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RAG_VARIANT(D, V)                                                                     \
  launch_scan<T, D, QSrc::kCluster, V>(qg, nullptr, block_cluster, vec, block_first, block_last, \
                                       rows_valid, nullptr, row_base, bound_v, bound_i, out_v,   \
                                       out_i, nblocks, qcap, d, ldq, blk, k, nlist, g, s)
  if (variant <= 1 && general<T>(g.nbins, g.depth, blk)) return RAG_VARIANT(0, Variant::kFull);
  switch (variant) {
    case 0: return RAG_VARIANT(2, Variant::kFull);
    case 1: return RAG_VARIANT(2, Variant::kNoGate);
    case 2: return RAG_VARIANT(2, Variant::kMaxOnly);
    case 3: return RAG_VARIANT(2, Variant::kFixedOut);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RAG_VARIANT
}
}  // namespace

extern "C" int ivf_variant_scan_i8(const void* qg, const void* vec, const void* block_cluster,
                                   const void* block_first, const void* block_last,
                                   const void* rows_valid, const void* row_base,
                                   const void* bound_v, const void* bound_i, void* out_v,
                                   void* out_i, void* gen_v, void* gen_c, void* gen_locks,
                                   int nlist, int nblocks, int qcap, int d, int ldq, int blk,
                                   int k, int variant, int nbins, int depth, int keepall,
                                   int nslots, void* stream) {
  const GenArgs g = gen_args(gen_v, gen_c, gen_locks, nslots, nbins, depth, keepall);
  return variant_scan<int8_t>(qg, vec, block_cluster, block_first, block_last, rows_valid,
                              row_base, bound_v, bound_i, out_v, out_i, nlist, nblocks, qcap, d,
                              ldq, blk, k, variant, g, stream);
}

extern "C" int ivf_variant_scan_f(const void* qg, const void* vec, const void* block_cluster,
                                  const void* block_first, const void* block_last,
                                  const void* rows_valid, const void* row_base,
                                  const void* bound_v, const void* bound_i, void* out_v,
                                  void* out_i, void* gen_v, void* gen_c, void* gen_locks,
                                  int nlist, int nblocks, int qcap, int d, int ldq, int blk,
                                  int k, int variant, int bf16, int nbins, int depth, int keepall,
                                  int nslots, void* stream) {
  const GenArgs g = gen_args(gen_v, gen_c, gen_locks, nslots, nbins, depth, keepall);
  return bf16 ? variant_scan<__nv_bfloat16>(qg, vec, block_cluster, block_first, block_last,
                                            rows_valid, row_base, bound_v, bound_i, out_v, out_i,
                                            nlist, nblocks, qcap, d, ldq, blk, k, variant, g,
                                            stream)
              : variant_scan<float>(qg, vec, block_cluster, block_first, block_last, rows_valid,
                                    row_base, bound_v, bound_i, out_v, out_i, nlist, nblocks,
                                    qcap, d, ldq, blk, k, variant, g, stream);
}
