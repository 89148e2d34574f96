// Kernel K8 of the spatial GEMM: C[M, N] = A[M, K] @ B[K, N], int8 -> int32,
// bf16 -> f32 and f32 -> f32, for any M, N and K.
//
// It replaces the TPU kernel rag_on_edge_tpu/ops/pallas_matmul.py,
// tiled_matmul (its _kernel): a (M/bm, N/bn, K/bk) grid whose K steps carry
// an accumulator in VMEM and emit each C tile once.  Here each CTA owns one
// tile of C and walks K itself, the accumulator in registers.  A is
// row-major [M, K] and B row-major [K, N] (N-contiguous) in every mode.
//
// What bounds each mode on the H100:
// - int8 at the SIFT-1M scoring product [8192, 128] x [128, 1M]: K is small,
//   so the int32 output is most of the bytes (32.8 GB against 129 MB in):
//   HBM writes, 9.8 ms at 3.35 TB/s.
// - bf16 at 4096^3: the tensor cores, 0.139 ms at 989 TFLOP/s, which only
//   wgmma reaches (the legacy mma.sync path tops out near a third of it:
//   K14 measured 320-341 T ops/s).  At the skinny [8192, 128] x
//   [128, 131072] the 4.3 GB f32 output bounds it (1.29 ms).
// - f32 at 4096^3: the FFMA rate, 2.05 ms at 67 TFLOP/s.  The product stays
//   in fp32 on FFMA: TF32 (and 3xTF32) would break the 2K*2^-24 bound every
//   check holds it to.
//
// Designs:
// - bf16 (wgmma_kernel): a 128 x 256 C tile per CTA, 64 bf16 of K (128
//   bytes, one swizzle row) a stage, a ring of 4 stages (48 KB each) in
//   dynamic shared memory.  One producer warp issues TMA copies
//   (cp.async.bulk.tensor.2d, 128-byte swizzle): A's [128 rows, 64 K] box
//   and B's [64 K, 256 N] tile as four [64 K, 64 N] boxes, taken as they
//   lie; each stage has a full barrier (expect_tx) and an empty barrier.
//   Two consumer warpgroups, 64 rows each, run
//   wgmma.mma_async.m64n256k16.f32.bf16.bf16 from shared memory: A K-major,
//   B MN-major through the transpose-B bit, so no thread touches an
//   operand.  One wgmma group stays in flight; a stage is released once the
//   group that read it has retired.  TMA fills rows past M, columns past N
//   and the K tail with zeros, so ragged edges add 0.  The epilogue stages
//   the accumulators in the drained ring and writes whole rows of C with
//   16-byte streaming stores (direct 8-byte stores from the fragments were
//   a fifth slower at the skinny product).  The TMA, mbarrier and wgmma
//   building blocks live in hopper_mma.cuh, shared with K5's and K3's bf16
//   modes.
// - f32 (f32_kernel): a 128 x 128 C tile per CTA, 8 warps as 2 (M) x 4 (N),
//   each warp 64 x 32 and each lane 8 x 8 (rows 8 apart, two 4-column
//   blocks).  Both operands go to shared memory as they lie, with 16-byte
//   cp.async copies (zero-filled past the edges) through a ring of 3
//   stages of 32 K and one barrier a stage.  A keeps its rows, at a pitch
//   of 36 floats, so a lane reads 4 K-values of a row as one 16-byte
//   broadcast, free of bank conflicts; 16 shared loads feed 256 __fmaf_rn.
//   It takes 168 registers at one CTA an SM: capped at 128 for two, it
//   spilled, or ran slower without spills.
// - int8 (mma_kernel): mma.sync m16n8k32 s8.s8 -> s32 (wgmma takes 8-bit B
//   only K-major, and B is N-contiguous).  8 warps as 2 (M) x 4 (N), each
//   warp 64 x 32 of a 128 x 128 C tile; K advances 64 bytes a tile.  A is
//   copied as it lies; B is transposed on the way to shared memory
//   (__byte_perm), because the mma B operand wants K-contiguous words per
//   column and ldmatrix cannot transpose 8-bit data.  Tiles are XOR-swizzled
//   [128][16]-word arrays read with ldmatrix.x4 (csrc/mma_frag.cuh),
//   double-buffered through registers.  Each warp stages its C block
//   through shared memory and writes whole 128-byte rows with 16-byte
//   streaming stores, so the 32.8 GB output moves in full lines.
//
// nvcc -Xptxas -v (CUDA 12.9, sm_90a):
//   wgmma_kernel        154 registers, no spills; 64 B static + 197,632 B
//                       dynamic shared memory (the ring and 1 KB of slack)
//   f32_kernel          168 registers, no spills; 104,448 B dynamic
//   mma_kernel          128 registers, 4 B spilled; 40,960 B static
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"
#include "mma_frag.cuh"

namespace {

// The f32 kernel's C tile for this CTA, of a grid of mtiles x ntiles: runs
// of 8 M tiles, and the N tiles one after the other within a run, so the
// CTAs in flight at once share their rows of A and columns of B in L2
// (a few percent faster than M tiles fastest at 4096^3, where A and B are
// 64 MB each).
__device__ __forceinline__ void grouped_tile(int mtiles, int* mt, int* nt) {
  const int ntiles = (int)gridDim.x / mtiles, run = (int)blockIdx.x / (8 * ntiles);
  const int rows = min(8, mtiles - 8 * run), rem = (int)blockIdx.x - 8 * run * ntiles;
  *mt = 8 * run + rem % rows;
  *nt = rem / rows;
}

// ------------------------------------------------------------- int8: mma.sync

constexpr int BM = 128, BN = 128;   // C tile per CTA
constexpr int THREADS = 256;
constexpr int TILE_WORDS = BM * KW; // one operand tile in shared memory (BM == BN)

// The epilogue stages each warp's C block through shared memory, 32 rows
// at a time, at a pitch of 40 words (the fragment pairs' 8-byte writes are
// then free of bank conflicts), and writes whole 128-byte rows of C.
constexpr int C_PITCH = 40;
constexpr int SMEM_WORDS = 8 * 32 * C_PITCH;  // >= the 2 x 2 operand tiles

// a [m, k] int8 (k a multiple of 16), b [k, ldb] int8 (ldb a multiple of 4;
// columns n..ldb-1 ignored), c [m, n] int32.
__global__ void __launch_bounds__(THREADS, 2)
mma_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
           int32_t* __restrict__ c, int m, int n, int k, int ldb, int mtiles) {
  using Acc = int32_t;
  constexpr int P = 4;                     // K values per 32-bit word
  constexpr int NCG = BN / 4;              // column words of B per tile row
  constexpr int NBLK = KW * NCG / THREADS; // B word-blocks per thread
  // [buffer][A, B^T][tile] in the main loop; the epilogue's staging after it.
  static_assert(SMEM_WORDS >= 2 * 2 * TILE_WORDS, "staging must cover the operand tiles");
  __shared__ __align__(16) uint32_t smem_raw[SMEM_WORDS];
  auto tile = [&](int buf, int which) { return smem_raw + (buf * 2 + which) * TILE_WORDS; };

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;  // mma groupID, thread in group
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = (int)(blockIdx.x % mtiles) * BM;
  const int n0 = (int)(blockIdx.x / mtiles) * BN;
  const size_t a_pitch = (size_t)k, b_pitch = (size_t)ldb;
  const int nk = (k + KB - 1) / KB;

  uint4 ra[2];
  uint32_t rb[NBLK][P];

  auto load_tile = [&](int kt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // A: 128 rows x 4 chunks of 16 bytes
      const int ci = tid + THREADS * j, row = ci >> 2, q = ci & 3;
      const int kb = kt * KB + q * 16;
      ra[j] = (m0 + row < m && kb < k)
                  ? *reinterpret_cast<const uint4*>(a + (size_t)(m0 + row) * a_pitch + kb)
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < NBLK; ++j) {  // B: KW K-words x NCG column words
      const int bi = tid + THREADS * j, bl = bi & 31, bw = bi >> 5;
      const int kw = (bl & 3) + 4 * (bw & 3), cg = (bl >> 2) + 8 * (bw >> 2);
      const int cb = n0 + cg * 4;  // byte column
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int kr = kt * KB + kw * P + i;
        rb[j][i] = (kr < k && (size_t)cb < b_pitch)
                       ? *reinterpret_cast<const uint32_t*>(b + (size_t)kr * b_pitch + cb)
                       : 0u;
      }
    }
  };
  auto store_tile = [&](int buf) {
    uint32_t* as = tile(buf, 0);
    uint32_t* bs = tile(buf, 1);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ci = tid + THREADS * j, row = ci >> 2, q = ci & 3;
      *reinterpret_cast<uint4*>(as + swz(row, q * 4)) = ra[j];
    }
#pragma unroll
    for (int j = 0; j < NBLK; ++j) {
      const int bi = tid + THREADS * j, bl = bi & 31, bw = bi >> 5;
      const int kw = (bl & 3) + 4 * (bw & 3), cg = (bl >> 2) + 8 * (bw >> 2);
      uint32_t o[P];
      BStage<P>::transpose(rb[j], o);
#pragma unroll
      for (int cc = 0; cc < P; ++cc) bs[swz(cg * P + cc, kw)] = o[cc];
    }
  };

  Acc acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = Acc(0);

  if (nk > 0) {
    load_tile(0);
    store_tile(0);
    __syncthreads();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) load_tile(kt + 1);
    const uint32_t* as = tile(cur, 0);
    const uint32_t* bs = tile(cur, 1);
#pragma unroll
    for (int s = 0; s < KW / 8; ++s) {  // 32 bytes of K per mma
      // ldmatrix.x4: A rows (lane & 15) of the m16 tile, 16-byte group
      // 2s + lane / 16 (a0..a3); B rows (lane & 7) + 8 (lane / 16) of two n8
      // tiles, group 2s + (lane / 8) % 2 (b0, b1 of each).
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(af[mt], as + swz(wm * 64 + mt * 16 + (lane & 15), 4 * (2 * s + (lane >> 4))));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldsm_x4(r, bs + swz(wn * 32 + np * 16 + (lane & 7) + 8 * (lane >> 4),
                            4 * (2 * s + ((lane >> 3) & 1))));
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) Mma<Elem::kI8>::run(acc[mt][nt], af[mt], bf[nt]);
    }
    if (more) store_tile(cur ^ 1);
    __syncthreads();
  }

  // Epilogue: the operand tiles are free (the loop ended on a barrier).
  // Each warp stages 32 of its 64 rows at a time and writes each row of its
  // 32 columns as 128 contiguous bytes (16 bytes a lane, 4 rows a pass).
  Acc* stage = reinterpret_cast<Acc*>(smem_raw) + warp * 32 * C_PITCH;
  const bool vec = (n & 3) == 0;  // rows of C 16-byte aligned
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int ml = 0; ml < 2; ++ml)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const Acc* v = acc[2 * half + ml][nt];
        Acc* p = stage + (ml * 16 + g) * C_PITCH + nt * 8 + 2 * tg;
        *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&v[0]),
                                                  *reinterpret_cast<const uint32_t*>(&v[1]));
        *reinterpret_cast<uint2*>(p + 8 * C_PITCH) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&v[2]),
                       *reinterpret_cast<const uint32_t*>(&v[3]));
      }
    __syncwarp();
    const int col = n0 + wn * 32 + (lane & 7) * 4;
#pragma unroll
    for (int pass = 0; pass < 8; ++pass) {
      const int sr = pass * 4 + (lane >> 3);
      const int row = m0 + wm * 64 + half * 32 + sr;
      if (row >= m) continue;
      const int4 w = *reinterpret_cast<const int4*>(stage + sr * C_PITCH + (lane & 7) * 4);
      Acc* p = c + (size_t)row * n + col;
      if (vec && col + 3 < n) {
        __stcs(reinterpret_cast<int4*>(p), w);
      } else {
        const Acc* x = reinterpret_cast<const Acc*>(&w);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < n) __stcs(p + j, x[j]);
      }
    }
    __syncwarp();
  }
}

// ------------------------------------------------- bf16: wgmma fed by TMA

constexpr int WG_BM = 128, WG_BN = 256, WG_BK = 64;  // C tile; K a stage (128 bytes)
constexpr int WG_STAGES = 4;
constexpr int WG_A_BYTES = WG_BM * WG_BK * 2;        // 16 KB: [128 rows][64 K]
constexpr int WG_B_BOX = WG_BK * 64 * 2;             // 8 KB: [64 K][64 N]
constexpr int WG_STAGE_BYTES = WG_A_BYTES + 4 * WG_B_BOX;
constexpr int WG_THREADS = 288;                      // 2 consumer warpgroups + 1 producer warp
constexpr int WG_SMEM = WG_STAGES * WG_STAGE_BYTES + 1024;  // + slack to align the ring to 1 KB
constexpr int WG_CP = 264;  // the epilogue's row pitch in floats (8-byte writes conflict-free)
static_assert(2 * 64 * WG_CP * 4 <= WG_STAGES * WG_STAGE_BYTES, "C staging must fit the ring");

// c [m, n] f32 from the bf16 tensor maps of a [m, k] and b [k, ldb] (see
// launch_bf16); CTA i computes C tile i, M tiles fastest (the grouped
// order of the f32 kernel was a fifth slower at the skinny product's
// 64 x 512 tiles and no faster at 4096^3).
__global__ void __launch_bounds__(WG_THREADS, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
             float* __restrict__ c, int m, int n, int k, int mtiles) {
  extern __shared__ uint8_t wg_smem[];
  __shared__ __align__(8) uint64_t full[WG_STAGES], empty[WG_STAGES];
  const uint32_t ring_off = ((smem_u32(wg_smem) + 1023u) & ~1023u) - smem_u32(wg_smem);
  const uint32_t ring = smem_u32(wg_smem) + ring_off;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = (int)(blockIdx.x % mtiles) * WG_BM, n0 = (int)(blockIdx.x / mtiles) * WG_BN;
  const int nk = (k + WG_BK - 1) / WG_BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx; the TMA bytes complete it
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer
    if (lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % WG_STAGES;
        if (kt >= WG_STAGES) mbar_wait(&empty[s], (unsigned)((kt / WG_STAGES - 1) & 1));
        const uint32_t sa = ring + s * WG_STAGE_BYTES, sb = sa + WG_A_BYTES;
        mbar_expect_tx(&full[s], WG_STAGE_BYTES);
        tma_load_2d(sa, &ta, kt * WG_BK, m0, &full[s]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          tma_load_2d(sb + j * WG_B_BOX, &tb, n0 + 64 * j, kt * WG_BK, &full[s]);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile.
  const int wg = warp >> 2;
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % WG_STAGES;
    mbar_wait(&full[s], (unsigned)((kt / WG_STAGES) & 1));
    const uint32_t sa = ring + s * WG_STAGE_BYTES + wg * 64 * 128;
    const uint32_t sb = ring + s * WG_STAGE_BYTES + WG_A_BYTES;
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    // A: 128-byte rows, 8-row groups 1 KB apart; a k16 step is 32 bytes
    // along the row.  B: 128-byte K rows, 8-row groups 1 KB apart, the four
    // 64-column boxes 8 KB apart; a k16 step is 16 rows, 2 KB.
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
      wgmma_m64n256k16(d, gmma_desc(sa + kk * 32, 16, 1024),
                       gmma_desc(sb + kk * 2048, WG_B_BOX, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_acc(d);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(d);
    // The previous stage's group has retired: release that stage.
    if (kt > 0 && lane == 0) mbar_arrive(&empty[(kt - 1) % WG_STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(d);

  // Epilogue.  Once both warpgroups are done with the ring, each stages its
  // 64 x 256 block there at a pitch of WG_CP floats: d[i] holds row
  // 16 (warp % 4) + lane / 4 + 8 ((i / 2) % 2) and column
  // 8 (i / 4) + 2 (lane % 4) + i % 2, written as 8-byte pairs free of bank
  // conflicts.  Then each row of C goes out as 1 KB of 16-byte streaming
  // stores, half a row a warp instruction.
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  float* st = reinterpret_cast<float*>(wg_smem + ring_off) + wg * 64 * WG_CP;
  const int lr = (warp & 3) * 16 + (lane >> 2), lc = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(st + (lr + 8 * h) * WG_CP + 8 * j + lc) =
          make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const int t = threadIdx.x & 127;
  const bool vec = (n & 3) == 0;  // rows of C 16-byte aligned
#pragma unroll 4
  for (int pass = 0; pass < 32; ++pass) {
    const int r = pass * 2 + (t >> 6), cc = (t & 63) * 4;
    const int row = m0 + wg * 64 + r, col = n0 + cc;
    if (row >= m || col >= n) continue;
    const float4 v = *reinterpret_cast<const float4*>(st + r * WG_CP + cc);
    float* p = c + (size_t)row * n + col;
    if (vec && col + 3 < n) {
      __stcs(reinterpret_cast<float4*>(p), v);
    } else {
      const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < n) __stcs(p + e, x[e]);
    }
  }
}

// ------------------------------------------- f32: cp.async-pipelined FFMA

constexpr int F_BM = 128, F_BN = 128, F_BK = 32, F_STAGES = 3;
constexpr int F_THREADS = 256;
constexpr int F_PA = F_BK + 4;  // A's row pitch in floats (see f32_kernel)
constexpr int F_A_FLOATS = F_BM * F_PA, F_B_FLOATS = F_BK * F_BN;
constexpr int F_STAGE_FLOATS = F_A_FLOATS + F_B_FLOATS;
constexpr int F_SMEM = F_STAGES * F_STAGE_FLOATS * 4;
constexpr int F_ACH = F_BK / 4, F_BCH = F_BN / 4;  // 16-byte chunks a row of A, of B
constexpr int F_AR = F_THREADS / F_ACH, F_BR = F_THREADS / F_BCH;  // rows a pass

// 16 bytes from global to shared memory; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// a [m, k], b [k, ldb], c [m, n] f32; k and ldb multiples of 4 and both
// bases 16-byte aligned (columns n..ldb-1 of b ignored).  Warp (wm, wn) of
// the 2 x 4 computes the 64 x 32 block at (64 wm, 32 wn) of the CTA's tile;
// its lane (lm, ln) = (lane / 4, lane % 4) rows 8 i + lm (i < 8) and
// columns 16 q + 4 ln + 0..3 (q < 2) of it.  Rows lm and lm + 1 lie 36
// floats (4 banks) apart, so a warp's 16-byte read of A at one row slot
// touches 32 distinct banks (8 rows, 4 lanes each, as broadcasts) and its
// reads of B 16 banks.
__global__ void __launch_bounds__(F_THREADS, 1)
f32_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
           int m, int n, int k, int ldb, int mtiles) {
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int lm = lane >> 2, ln = lane & 3;
  int mt, nt;
  grouped_tile(mtiles, &mt, &nt);
  const int m0 = mt * F_BM, n0 = nt * F_BN;
  const int nk = (k + F_BK - 1) / F_BK;

  // This thread's copies: A rows ar + F_AR j at K column aq, B K-rows
  // br + F_BR j at column bq, a stage at a time.
  const int ar = tid / F_ACH, aq = (tid % F_ACH) * 4;
  const int br = tid / F_BCH, bq = (tid % F_BCH) * 4;
  const float* ga = a + (size_t)(m0 + ar) * k + aq;
  const float* gb = b + (size_t)br * ldb + n0 + bq;
  const uint32_t sa0 = smem_u32(fsm) + (ar * F_PA + aq) * 4;
  const uint32_t sb0 = smem_u32(fsm) + (F_A_FLOATS + br * F_BN + bq) * 4;
  unsigned arows = 0;
#pragma unroll
  for (int j = 0; j < F_BM / F_AR; ++j) arows |= (unsigned)(m0 + ar + F_AR * j < m) << j;
  const bool bcol = n0 + bq < ldb;

  auto load = [&](int kt) {
    const uint32_t so = (kt % F_STAGES) * F_STAGE_FLOATS * 4;
    const int k0 = kt * F_BK;
    const bool akok = k0 + aq < k;
#pragma unroll
    for (int j = 0; j < F_BM / F_AR; ++j) {
      const bool ok = akok && ((arows >> j) & 1);
      cp_async16(sa0 + so + j * F_AR * F_PA * 4, ok ? ga + (size_t)F_AR * j * k + k0 : a,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < F_BK / F_BR; ++j) {
      const bool ok = bcol && k0 + br + F_BR * j < k;
      cp_async16(sb0 + so + j * F_BR * F_BN * 4, ok ? gb + (size_t)(k0 + F_BR * j) * ldb : b,
                 ok ? 16 : 0);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < nk) load(s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int kt = 0; kt < nk; ++kt) {
    // Stage kt has landed for this thread; the barrier makes it whole and
    // frees the stage read in step kt - 1, which the next copy refills.
    asm volatile("cp.async.wait_group %0;\n" ::"n"(F_STAGES - 2) : "memory");
    __syncthreads();
    if (kt + F_STAGES - 1 < nk) load(kt + F_STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const float* as = fsm + (kt % F_STAGES) * F_STAGE_FLOATS + (wm * 64 + lm) * F_PA;
    const float* bs = fsm + (kt % F_STAGES) * F_STAGE_FLOATS + F_A_FLOATS + wn * 32 + ln * 4;
#pragma unroll
    for (int kq = 0; kq < F_BK; kq += 4) {
      float av[8][4];  // 4 K values of each row: one 16-byte read a row
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(as + i * 8 * F_PA + kq);
        av[i][0] = v.x;
        av[i][1] = v.y;
        av[i][2] = v.z;
        av[i][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(bs + (kq + kk) * F_BN);
        const float4 b1 = *reinterpret_cast<const float4*>(bs + (kq + kk) * F_BN + 16);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        // Rows in turn, the columns of odd rows backwards: this order ran a
        // few percent faster on the H100 than a plain one.
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = (i & 1) ? 7 - jj : jj;
            acc[i][j] = __fmaf_rn(av[i][kk], bv[j], acc[i][j]);
          }
      }
    }
  }

  const bool vec = (n & 3) == 0;  // rows of C 16-byte aligned
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + wm * 64 + i * 8 + lm;
    if (row >= m) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = n0 + wn * 32 + 16 * q + ln * 4;
      float* p = c + (size_t)row * n + col;
      if (vec && col + 3 < n) {
        __stcs(reinterpret_cast<float4*>(p), make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                                                         acc[i][4 * q + 2], acc[i][4 * q + 3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < n) __stcs(p + j, acc[i][4 * q + j]);
      }
    }
  }
}

// ------------------------------------------------------------- launchers

// The 1-D grid of (bm x bn) C tiles.  The int8 and bf16 kernels take M
// tiles fastest, so consecutive CTAs share one tile of B; the f32 kernel
// groups them (grouped_tile).
int grid_of(int m, int n, int bm, int bn, int* mtiles, unsigned* blocks) {
  const long long mt = (m + bm - 1) / bm, nt = (n + bn - 1) / bn;
  if (mt * nt > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  *mtiles = (int)mt;
  *blocks = (unsigned)(mt * nt);
  return 0;
}

}  // namespace

// C entries for ctypes.  Each launches on `stream`, allocates nothing, and
// returns a CUDA error code (0 = launched).  Row-major, contiguous: a [m, k],
// b [k, ldb] (n <= ldb; columns n..ldb-1 ignored), c [m, n].  The wrapper
// guarantees k * elem_size and ldb * elem_size multiples of 16 bytes and
// 16-byte-aligned bases (TMA's and cp.async's rule); for int8 only A's:
// B's pitch and base need 4 bytes.  The float kernels take more than 48 KB
// of dynamic shared memory, which a launch is refused without the function
// attribute.  The attribute belongs to each device's copy of the kernel, so
// each entry sets it on every call, on the current device.
extern "C" int tiled_matmul_bf16(const void* a, const void* b, void* c, int m, int n, int k,
                                 int ldb, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0) return (int)cudaMemsetAsync(c, 0, (size_t)m * n * sizeof(float), st);
  static const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap ta, tb;
  if (const int e = bf16_map(encode, &ta, a, m, k, k, WG_BM)) return e;
  if (const int e = bf16_map(encode, &tb, b, k, n, ldb, WG_BK)) return e;
  int mtiles;
  unsigned blocks;
  if (const int e = grid_of(m, n, WG_BM, WG_BN, &mtiles, &blocks)) return e;
  if (const cudaError_t e =
          cudaFuncSetAttribute(wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM))
    return (int)e;
  wgmma_kernel<<<blocks, WG_THREADS, WG_SMEM, st>>>(ta, tb, static_cast<float*>(c), m, n, k,
                                                    mtiles);
  return (int)cudaGetLastError();
}

extern "C" int tiled_matmul_int8(const void* a, const void* b, void* c, int m, int n, int k,
                                 int ldb, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  int mtiles;
  unsigned blocks;
  if (const int e = grid_of(m, n, BM, BN, &mtiles, &blocks)) return e;
  mma_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b), static_cast<int32_t*>(c),
      m, n, k, ldb, mtiles);
  return (int)cudaGetLastError();
}

extern "C" int tiled_matmul_fp32(const void* a, const void* b, void* c, int m, int n, int k,
                                 int ldb, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  int mtiles;
  unsigned blocks;
  if (const int e = grid_of(m, n, F_BM, F_BN, &mtiles, &blocks)) return e;
  if (const cudaError_t e =
          cudaFuncSetAttribute(f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM))
    return (int)e;
  f32_kernel<<<blocks, F_THREADS, F_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), m, n,
      k, ldb, mtiles);
  return (int)cudaGetLastError();
}
