// Kernels K11-K14: the hardware probes.  They replace the four Pallas probes
// of rag_on_edge_tpu/harness/hw_probe.py and measure this card's ceilings:
//
// K11 _step_probe      a trivial kernel over g steps: the fixed cost of a
//                      step (a CTA, or one turn of an in-kernel loop).
// K12 _stream_probe    a walk over [nblocks, d, blk] int8/bf16 tiles, fat
//                      blocks a step, each step max-reduced (optionally
//                      through a product with a resident x [m, d], on the
//                      tensor cores through wgmma).
// K13 _dma_probe       the same walk through a ring of `depth` bulk async
//                      copies (cp.async.bulk, TMA's 1-D copy) per CTA.
// K14 _gemm_rate_probe g steps of a resident [tb, d] x [d, tn] product, A
//                      twisted each step: the in-kernel matrix rate, on the
//                      tensor cores through wgmma (A in registers) or, for
//                      int8, on __dp4a.
//
// What each returns is the JAX function's value: K11 twice the last step's
// tile; K12 the last step's max (the TPU output window is pinned, so the
// last step's write is what lands); K13 the max over the walked blocks;
// K14 the max of the last step's product.  Every step's work is consumed
// all the same: K11's loads are volatile, K12 writes every step's max into
// `steps`, K14 every step's max per unit and warp into `sink`; the checks
// hold those buffers whole against the plain versions.
//
// What bounds each on the H100: K11 nothing but its fixed costs (it moves
// 4 KB a step: its gap to the byte bound is the quantity it reports); K12
// without the product and K13 device memory (3.35 TB/s); K12 with the
// product device memory too (at d = 128 the product is ~0.07 ms of
// tensor-core time on a 512 MB walk, the bytes 0.16 ms), so its design is
// a deep cp.async ring with two CTAs an SM, the product and the int8
// transpose of each unit overlapped with the bytes of the next; K14 the
// tensor-core rate (int8 1979 T ops/s, bf16 989 TFLOP/s), so its design
// keeps both operands resident (A in registers, B in shared memory), two
// accumulator sets and RING groups in flight, the fold of one step under
// the next step's groups; on the dp4a unit, the 32-bit integer pipe.
//
// How the TPU grid maps onto the card (dimension_semantics):
// - "parallel" and None: one CTA per step; CTAs run in no order.
// - "arbitrary": the steps in order inside one CTA (K11), or a persistent
//   grid of one CTA per SM, each walking a contiguous run of steps in order
//   (K12).
// Shared memory is the constraint the TPU's VMEM is not: one TPU block
// (128 x 2048 int8, 256 KB) exceeds a CTA's 227 KB, so K12 takes a tile in
// 16 KB units (128 columns by 128 bytes of d; x's 128-row tiles in turn,
// x resident or riding the ring past what fits), K13 copies 16 KB slices
// of the walk into its ring (at most 8 stages, whatever JAX's depth; the
// walk's tail past its last 16-byte piece by ordinary loads), and K14
// splits v's columns (and q's rows) across CTAs, each CTA holding one 128
// x 128 unit of the product resident and taking every R-th step (past 16
// k-steps of 32 bytes, K in chunks of 16 staged each step).  The wrappers
// pad d (K12's x, K14's q and v) and K12's blk to 4-byte words with zeros.
#include <cstdint>
#include <type_traits>
#include <utility>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ffma_tile.cuh"
#include "hopper_mma.cuh"

namespace {

enum class Elem { kI8, kBF16 };

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BM = 128, BN = 128;    // product unit per CTA (K12, K14)
constexpr int STAGE = 16384;         // bytes of one K13 ring stage
constexpr int MAX_DEPTH = 8;         // K13 ring stages
constexpr float NEG_INF = -__builtin_huge_valf();

// Max over the warp; every lane gets the result.
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Max over the CTA; every thread gets the result.  Ends on a barrier, so
// it can be called again at once.
__device__ __forceinline__ float block_max(float v) {
  __shared__ float red[WARPS];
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  return m;
}

// ------------------------------------------------------------------ K11

// A volatile 16-byte load: the compiler keeps every step's load although
// only the last step's value is used.
__device__ __forceinline__ float4 ld_volatile(const float* p) {
  float4 v;
  asm volatile("ld.volatile.global.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float4 twice(float4 v) {
  return make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f);
}

// One CTA per step; thread t moves float4 t of the [8, 128] tile (tile 0,
// or tile i when moving).  Only step g-1 writes out.
__global__ void __launch_bounds__(THREADS) step_grid_kernel(const float* in, float* out, int g,
                                                            int moving) {
  const int i = blockIdx.x;
  const float4 v = ld_volatile(in + (moving ? (size_t)i * 1024 : 0) + 4 * threadIdx.x);
  if (i == g - 1) reinterpret_cast<float4*>(out)[threadIdx.x] = twice(v);
}

// The steps in order in one CTA, a barrier between steps.
__global__ void __launch_bounds__(THREADS) step_loop_kernel(const float* in, float* out, int g,
                                                            int moving) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < g; ++i) {
    v = ld_volatile(in + (moving ? (size_t)i * 1024 : 0) + 4 * threadIdx.x);
    __syncthreads();
  }
  reinterpret_cast<float4*>(out)[threadIdx.x] = twice(v);
}

// ------------------------------------------------------- K12 / K13 max

// Lane-wise max over 32-bit words of int8 (4 lanes) or bf16 (2 lanes).
template <Elem E>
struct Lanes;

template <>
struct Lanes<Elem::kI8> {
  static constexpr int kEs = 1;
  static constexpr uint32_t kInit = 0x80808080u;  // -128 in every lane
  __device__ __forceinline__ static uint32_t vmax(uint32_t a, uint32_t b) {
    return __vmaxs4(a, b);
  }
  __device__ __forceinline__ static float reduce(uint32_t a) {
    const float b0 = (float)(int8_t)(a & 0xff), b1 = (float)(int8_t)((a >> 8) & 0xff);
    const float b2 = (float)(int8_t)((a >> 16) & 0xff), b3 = (float)(int8_t)(a >> 24);
    return fmaxf(fmaxf(b0, b1), fmaxf(b2, b3));
  }
  __device__ __forceinline__ static float elem(const uint8_t* p) { return (float)(int8_t)*p; }
};

template <>
struct Lanes<Elem::kBF16> {
  static constexpr int kEs = 2;
  static constexpr uint32_t kInit = 0xff80ff80u;  // -inf in both lanes
  __device__ __forceinline__ static uint32_t vmax(uint32_t a, uint32_t b) {
    const __nv_bfloat162 m = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                     *reinterpret_cast<const __nv_bfloat162*>(&b));
    return *reinterpret_cast<const uint32_t*>(&m);
  }
  __device__ __forceinline__ static float reduce(uint32_t a) {
    return fmaxf(__uint_as_float(a << 16), __uint_as_float(a & 0xffff0000u));
  }
  __device__ __forceinline__ static float elem(const uint8_t* p) {
    return __uint_as_float((uint32_t)*reinterpret_cast<const uint16_t*>(p) << 16);
  }
};

template <Elem E>
struct WordMax {
  uint32_t m[4] = {Lanes<E>::kInit, Lanes<E>::kInit, Lanes<E>::kInit, Lanes<E>::kInit};
  __device__ __forceinline__ void add(const uint4& w) {
    m[0] = Lanes<E>::vmax(m[0], w.x);
    m[1] = Lanes<E>::vmax(m[1], w.y);
    m[2] = Lanes<E>::vmax(m[2], w.z);
    m[3] = Lanes<E>::vmax(m[3], w.w);
  }
  __device__ __forceinline__ float value() const {
    return fmaxf(fmaxf(Lanes<E>::reduce(m[0]), Lanes<E>::reduce(m[1])),
                 fmaxf(Lanes<E>::reduce(m[2]), Lanes<E>::reduce(m[3])));
  }
};

// This thread's max over a byte range of device memory (element-aligned):
// 16-byte streaming loads, UNROLL in flight a thread, neighbouring threads
// on neighbouring addresses; the unaligned head and tail element by element.
template <Elem E>
__device__ __forceinline__ float range_max(const uint8_t* p, size_t nbytes) {
  constexpr int ES = Lanes<E>::kEs;
  constexpr int UNROLL = 8;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  uintptr_t a0 = (a + 15) & ~(uintptr_t)15, a1 = (a + nbytes) & ~(uintptr_t)15;
  if (a0 > a1) a0 = a1 = a + nbytes;
  float m = NEG_INF;
  for (uintptr_t q = a + threadIdx.x * ES; q < a0; q += THREADS * ES)
    m = fmaxf(m, Lanes<E>::elem(reinterpret_cast<const uint8_t*>(q)));
  for (uintptr_t q = a1 + threadIdx.x * ES; q < a + nbytes; q += THREADS * ES)
    m = fmaxf(m, Lanes<E>::elem(reinterpret_cast<const uint8_t*>(q)));
  const uint4* v = reinterpret_cast<const uint4*>(a0);
  const size_t nv = (a1 - a0) / 16;
  WordMax<E> wm;
  for (size_t j = threadIdx.x; j < nv; j += (size_t)THREADS * UNROLL) {
    uint4 w[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t idx = j + (size_t)u * THREADS;
      const uint32_t f = Lanes<E>::kInit;
      w[u] = idx < nv ? __ldcs(v + idx) : make_uint4(f, f, f, f);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) wm.add(w[u]);
  }
  return fmaxf(m, wm.value());
}

// The steps a CTA walks: its own (a CTA per step), or a contiguous run.
__device__ __forceinline__ void step_range(int g, int persistent, int* s0, int* s1) {
  if (!persistent) {
    *s0 = blockIdx.x;
    *s1 = blockIdx.x + 1;
    return;
  }
  const int per = (g + gridDim.x - 1) / gridDim.x;
  *s0 = min(g, (int)blockIdx.x * per);
  *s1 = min(g, *s0 + per);
}

// K12 without the product: steps[s] = max of step s's fat blocks
// (step_bytes contiguous bytes).
template <Elem E>
__global__ void __launch_bounds__(THREADS) stream_max_kernel(const uint8_t* __restrict__ data,
                                                             float* __restrict__ steps, int g,
                                                             size_t step_bytes, int persistent) {
  int s0, s1;
  step_range(g, persistent, &s0, &s1);
  for (int s = s0; s < s1; ++s) {
    const float m = block_max(range_max<E>(data + (size_t)s * step_bytes, step_bytes));
    if (threadIdx.x == 0) steps[s] = m;
  }
}

// ----------------------------------------------------- K12 / K14 wgmma

constexpr int UNIT = 16384;             // a [128][128-byte] operand tile; a K12 ring stage
constexpr int RAW_BOX = 2064;           // K12 int8: a [128 d][16 B] box, padded by 16 bytes
constexpr int RAW_UNIT = 8 * RAW_BOX;   // K12 int8: a ring stage of eight such boxes
constexpr int MAX_STAGES = 8;           // K12 ring stages
constexpr int RAW_SLOT = 17 * 1024;     // K12 int8 with x in the ring: the raw unit, 1 KB-aligned
// K12's dynamic shared memory for two CTAs an SM (half the SM's 228 KB,
// less the 1 KB the card keeps per CTA and room for the static part), and
// for one.
constexpr int SMEM_TWO = 233472 / 2 - 1024 - 256;
constexpr int SMEM_ONE = 232448 - 256;
constexpr uint32_t ONES = 0x01010101u;  // the int8 twist: four 1s

template <typename Acc>
__device__ __forceinline__ Acc lowest();
template <>
__device__ __forceinline__ int32_t lowest<int32_t>() {
  return INT32_MIN;
}
template <>
__device__ __forceinline__ float lowest<float>() {
  return NEG_INF;
}

// A fold's max as f32 (int8: the integer max, converted once; no entry:
// -inf).
__device__ __forceinline__ float to_f32(int32_t v) { return v == INT32_MIN ? NEG_INF : (float)v; }
__device__ __forceinline__ float to_f32(float v) { return v; }

// One accumulator read through a move, after its groups retired: code that
// reads the fragment itself has ptxas serialize the wgmma groups.
__device__ __forceinline__ int32_t acc_mov(int32_t x) {
  int32_t y;
  asm volatile("mov.b32 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}
__device__ __forceinline__ float acc_mov(float x) {
  float y;
  asm volatile("mov.b32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ int32_t max3(int32_t a, int32_t b, int32_t c) {
  return __vimax3_s32(a, b, c);  // one DPX instruction on Hopper
}
__device__ __forceinline__ float max3(float a, float b, float c) { return fmaxf(fmaxf(a, b), c); }

// This thread's max of a retired m64n128 fragment over the tile's rows
// below `rows` and columns below `cols` (FULL: the whole tile, no test);
// `r` is this thread's first row (entry i: row r + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (t % 4) + i % 2).  With `sel`, each row's max first,
// across the quad of threads that holds the row, as the TPU's per-row
// reduction does; the value is the same.
template <bool FULL, typename Acc>
__device__ __forceinline__ Acc fold_max(const Acc (&d)[64], int r, int rows, int cols, bool sel) {
  const int c0 = 2 * (threadIdx.x & 3);
  Acc m = lowest<Acc>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool row_ok = FULL || r + 8 * h < rows;
    Acc rm = lowest<Acc>();
#pragma unroll
    for (int i = 2 * h; i < 64; i += 4) {
      const Acc v0 = acc_mov(d[i]), v1 = acc_mov(d[i + 1]);
      if constexpr (FULL) {
        rm = max3(rm, v0, v1);
      } else {
        const int col = 8 * (i / 4) + c0;
        if (row_ok && col < cols) rm = max(rm, v0);
        if (row_ok && col + 1 < cols) rm = max(rm, v1);
      }
    }
    if (sel) {
      rm = max(rm, __shfl_xor_sync(0xffffffffu, rm, 1));
      rm = max(rm, __shfl_xor_sync(0xffffffffu, rm, 2));
    }
    m = max(m, rm);
  }
  return m;
}

__device__ __forceinline__ uint8_t* align_1k(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// Wait until at most n (0..MAX_STAGES - 1) of this thread's groups are
// pending.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// K12 with the product: steps[s] = max over step s's fat tiles of
// max(x @ tile), x [m, d] (rows ldx bytes apart, a multiple of 4), tile
// [d, blk] (rows ldb elements apart).  The CTA's walk is a list of units
// (step, 128-row tile of x, tile, 128-column slice, 128 bytes of d: int8
// 128 d, bf16 64 d), 16 KB each, through a ring of `stages` stages filled
// by cp.async, each thread's pieces of a unit one group (16-byte pieces
// where the row pitch ldb·es and the base allow, 4-byte pieces otherwise;
// rows past d and columns past blk arrive as zeros); the ring runs across
// step boundaries.  Each row tile of x walks the step's units again.  The
// bytes bound it, so the ring is as deep as two CTAs an SM leave room for
// (a CTA per step: one CTA's start hides under the other's walk), or one
// (the persistent grid).  x is wgmma's A, K-major as
// it lies (two warpgroups of 64 rows, a 128-byte-swizzled tile per unit of
// d, landed by cp.async in the first unit's group); each unit is four
// k-steps of m64n128k32 s8 / m64n128k16 bf16.  bf16 reads the unit N-major
// through the transpose-B bit.  int8 has no transpose bit: the unit lands
// as eight [128 d][16 column] boxes (each padded by 16 bytes, so that a
// row's 128 bytes, landed side by side, fall on eight bank groups) and
// transpose_unit (K1's) turns it K-major into one of two buffers while the
// previous unit's groups run; its stage is refilled as soon as it is
// transposed, a unit earlier than bf16's.  A slice's fragment is folded
// into the step's max (rows below m, columns below blk; no test where
// there are none) through moves, the step's max reduced over the CTA and
// written.  Where x's tiles (mtiles x nku of 16 KB) leave the ring under two
// stages (XRING), each stage carries the unit's x tile beside it, re-read
// from L2, and int8 refills a stage only once its x tile is used (lead 0).
// MULTI: x has more than one row tile (XRING implies it); without it the
// walk keeps no row-tile position.
template <typename T, bool XRING, bool MULTI>
__global__ void __launch_bounds__(THREADS, 2)
stream_wgmma_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ data,
                    float* __restrict__ steps, int m, int ldx, int d, int blk, int ldb, int fat,
                    int g, int persistent, int stages, int vec16) {
  constexpr bool INT8 = std::is_same_v<T, int8_t>;
  using Acc = std::conditional_t<INT8, int32_t, float>;
  constexpr int ES = sizeof(T);
  constexpr int KD = 128 / ES;    // d of a unit
  constexpr int CH = 8 * ES;      // 16-byte chunks of a unit row (128 columns)
  int s0, s1;
  step_range(g, persistent, &s0, &s1);
  const int kbytes = d * ES, nku = (kbytes + 127) / 128, nsl = (blk + BN - 1) / BN;
  static_assert(MULTI || !XRING, "x rides the ring only in the multi-tile walk");
  const int mtiles = MULTI ? (m + BM - 1) / BM : 1;
  const int per_step = fat * nsl * mtiles * nku, nu = (s1 - s0) * per_step;
  if (nu == 0) return;
  extern __shared__ uint8_t smem_raw[];
  // A stage: the raw unit, then (xring) the unit's x tile, 1 KB-aligned.
  constexpr int xoff = INT8 ? RAW_SLOT : UNIT;
  constexpr int sst = XRING ? xoff + UNIT : (INT8 ? RAW_UNIT : UNIT);
  uint8_t* const xs = align_1k(smem_raw);          // x: mtiles x nku [128 rows][128 B] tiles
  uint8_t* const ring = xs + (XRING ? 0 : mtiles * nku * UNIT);  // the stages
  uint8_t* const bk = ring + ((stages * sst + 1023) & ~1023);  // int8: two K-major units
  const uint32_t xsa = smem_u32(xs), ringa = smem_u32(ring), bka = smem_u32(bk);
  const size_t pitch = (size_t)ldb * ES, tile_bytes = (size_t)d * pitch;

  // A position in the walk: x's row tile mt of the step, the step's tile
  // f, 128-column slice sl and 128 bytes of d ku, innermost last; the
  // walk's units in order (each row tile walks the step's units again).
  struct Pos {
    int s, mt, f, sl, ku;
  };
  auto next = [&](Pos& p) {
    if (++p.ku < nku) return;
    p.ku = 0;
    if (++p.sl < nsl) return;
    p.sl = 0;
    if (++p.f < fat) return;
    p.f = 0;
    if constexpr (MULTI) {
      if (++p.mt < mtiles) return;
      p.mt = 0;
    }
    ++p.s;
  };
  // Where 16-byte chunk c of row rr of a unit lands in its stage: int8 in
  // box c ([128 d][16 B], transpose_unit's input; the 16-byte pad puts a
  // row's 8 chunks on 8 bank groups), bf16 in N-half c / 8 ([64 d][128 B]),
  // chunk c % 8 swizzled by rr.
  auto chunk_at = [](int rr, int c) {
    return INT8 ? c * RAW_BOX + rr * 16 : (c >> 3) * 8192 + rr * 128 + (((c & 7) ^ (rr & 7)) << 4);
  };
  // x's row tile mt, 128 bytes of d ku, at shared address dst: word w of
  // row r at 16-byte chunk (w % 32) / 4 ^ (r % 8), by 4-byte cp.async
  // pieces (zeros past m and d).
  auto load_x = [&](uint32_t dst, int mt, int ku) {
    for (int e = threadIdx.x; e < BM * 32; e += THREADS) {
      const int w = e % 32, row = e / 32, gr = mt * BM + row, byte = ku * 128 + 4 * w;
      const bool ok = gr < m && byte < kbytes;
      ffma::cp_async_4(dst + row * 128 + (((w >> 2) ^ (row & 7)) << 4) + (w & 3) * 4,
                       ok ? x + (size_t)gr * ldx + byte : x, ok ? 4 : 0);
    }
  };
  // Issue the pieces of the unit at `pp` (nothing past the walk) into stage
  // `pst`, then advance both.
  Pos pp{s0, 0, 0, 0, 0};
  int pst = 0;
  auto load = [&]() {
    if (pp.s < s1) {
      const uint8_t* src = data + ((size_t)pp.s * fat + pp.f) * tile_bytes +
                           (size_t)pp.ku * KD * pitch + (size_t)pp.sl * BN * ES;
      const int colb = (blk - pp.sl * BN) * ES;  // valid bytes of the slice's rows
      const int rows = min(KD, d - pp.ku * KD);  // valid d of the unit
      const uint32_t dst = ringa + pst * sst;
      if constexpr (XRING) load_x(dst + xoff, pp.mt, pp.ku);
      if (vec16) {
        for (int e = threadIdx.x; e < KD * CH; e += THREADS) {
          const int c = e % CH, rr = e / CH;  // a row's 128 (int8) or 256 bytes, side by side
          const bool ok = rr < rows && 16 * c < colb;
          ffma::cp_async_16(dst + chunk_at(rr, c), ok ? src + rr * pitch + 16 * c : data,
                            ok ? 16 : 0);
        }
      } else {
        for (int e = threadIdx.x; e < KD * CH * 4; e += THREADS) {
          const int w = e % (CH * 4), rr = e / (CH * 4);
          const bool ok = rr < rows && 4 * w < colb;
          ffma::cp_async_4(dst + chunk_at(rr, w >> 2) + 4 * (w & 3),
                           ok ? src + rr * pitch + 4 * w : data, ok ? 4 : 0);
        }
      }
      next(pp);
    }
    pst = pst + 1 == stages ? 0 : pst + 1;
  };
  // Make the unit in stage `st` ready: its pieces (and, first, x's words)
  // landed for every thread; int8 transposes it into buffer `buf`.
  auto prep = [&](int st, int buf, int pending) {
    cp_async_wait(pending);
    fence_proxy_async();
    __syncthreads();
    if constexpr (INT8) {
      const auto* raw = reinterpret_cast<const uint32_t*>(ring + st * sst);
      uint8_t* dst = bk + buf * UNIT;
      transpose_unit(raw, dst, RAW_BOX / 4);
      transpose_unit(raw + RAW_BOX, dst + 8192, RAW_BOX / 4);
    }
  };

  // x, once (unless it rides in the ring), in the first unit's group: tile
  // (mt, ku) at mt nku + ku.
  if constexpr (!XRING)
    for (int t = 0; t < mtiles * nku; ++t) load_x(xsa + t * UNIT, t / nku, t % nku);
  // Unit k's pieces are cp.async group k.  int8 refills a stage once its
  // unit is transposed, one unit earlier than bf16, whose wgmma reads the
  // stage itself (as it reads the x tile in the ring): `lead` more units in
  // flight.
  constexpr int lead = INT8 && !XRING ? 1 : 0;
  for (int j = 0; j < stages; ++j) {
    load();
    ffma::commit();
  }
  prep(0, 0, stages - 1);
  fence_proxy_async();
  __syncthreads();
  if constexpr (lead > 0) {
    load();
    ffma::commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = warp >> 2;
  const int r = wg * 64 + 16 * (warp & 3) + (lane >> 2);  // this thread's first row
  Acc acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  Acc mx = lowest<Acc>();
  Pos cp{s0, 0, 0, 0, 0};  // the unit the product takes
  int cst = 0;             // its stage
  for (int u = 0; u < nu; ++u) {
    const uint32_t sa = (XRING ? ringa + cst * sst + xoff
                               : xsa + ((MULTI ? cp.mt * nku : 0) + cp.ku) * UNIT) +
                        wg * 8192;
    const uint32_t sb = INT8 ? bka + (u & 1) * UNIT : ringa + cst * sst;
    fence_acc(acc);
    wgmma_fence();
    // A and int8 B: 128-byte rows, 8-row groups 1 KB apart, a k-step 32
    // bytes along the row; bf16 B: 128-byte d rows, a k16 step 16 rows (2
    // KB), the N-halves 8 KB apart.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (INT8)
        wgmma_m64n128k32_s8(acc, gmma_desc(sa + kk * 32, 16, 1024),
                            gmma_desc(sb + kk * 32, 16, 1024), cp.ku + kk);
      else
        wgmma_m64n128k16(acc, gmma_desc(sa + kk * 32, 16, 1024),
                         gmma_desc(sb + kk * 2048, 8192, 1024), cp.ku + kk);
    }
    wgmma_commit();
    fence_acc(acc);
    const int nst = cst + 1 == stages ? 0 : cst + 1;
    if (u + 1 < nu) prep(nst, (u + 1) & 1, stages - 2 + lead);
    wgmma_wait<0>();
    fence_acc(acc);
    const Pos at = cp;
    next(cp);
    if (cp.ku == 0) {  // the last unit of the slice's row tile
      const int cols = blk - at.sl * BN, rows = MULTI ? m - at.mt * BM : m;
      mx = max(mx, rows >= BM && cols >= BN ? fold_max<true>(acc, r, 0, 0, false)
                                            : fold_max<false>(acc, r, rows, cols, false));
      if (cp.s != at.s) {  // the step's last slice
        const float sm = block_max(to_f32(mx));
        if (threadIdx.x == 0) steps[at.s] = sm;
        mx = lowest<Acc>();
      }
    }
    fence_proxy_async();  // int8: the transposed unit u + 1
    __syncthreads();      // buffer u & 1 is free, and stage cst (int8: nst)
    load();
    ffma::commit();
    cst = nst;
  }
}

// K14 on the tensor cores.  CTA c holds unit c % U of the product (a
// 128-row tile of q, 64 rows a warpgroup; a 128-column tile of v; all of
// K, NKT k-steps of 32 bytes) and takes steps c / U, c / U + R, ...  Each
// warpgroup keeps its rows' wgmma A fragment of every k-step in registers,
// loaded once from device memory (K-major, as q's rows lie); B stays in
// shared memory (int8: K-major, v transposed once on its way in; bf16:
// N-major, read through the transpose-B bit).  A step twists a copy of A
// (int8: row i % tb set to 1; bf16: every element times bf16(1 + i),
// rounded to bf16) into a ring of RING k-step fragments and issues one
// group a k-step (m64n128k32 s8 / m64n128k16 bf16, A from registers); a
// slot is rewritten once the group that read it, RING groups back, has
// retired.  Steps alternate between two accumulator sets: the wait before
// step i+1's RING-th group retires step i's last, whose fragment is then
// folded (on int32 for int8) while step i+1's groups run.  Each warp
// writes its max of each step's unit to sink[i][unit][warp].
template <typename T, int NKT>
__global__ void __launch_bounds__(THREADS, 1)
gemm_rate_wgmma_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ v,
                       float* __restrict__ sink, int tb, int tn, int d, int g, int units,
                       int reps, int sel) {
  constexpr bool INT8 = std::is_same_v<T, int8_t>;
  using Acc = std::conditional_t<INT8, int32_t, float>;
  // Groups in flight: a divisor of NKT, so that k-step k always takes slot
  // k % RING; fewer past 12 k-steps, where A's registers leave no room.
  constexpr int RING = NKT % 4 == 0 && NKT <= 12 ? 4
                       : NKT % 2 == 0 && NKT <= 14 ? 2
                       : NKT <= 7 ? NKT : 1;
  constexpr int HALF = NKT * 2048;  // bf16: an N-half of B, [16 NKT d][128 B]
  const int unit = blockIdx.x % units, rep = blockIdx.x / units;
  if (rep >= g) return;
  const int mtiles = (tb + BM - 1) / BM;
  const int m0 = (unit % mtiles) * BM, n0 = (unit / mtiles) * BN;
  const int kbytes = d * (int)sizeof(T);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const bs = align_1k(smem_raw);
  const uint32_t bsa = smem_u32(bs);

  // B, once.  int8: word kw of column n (its d 4 kw .. 4 kw + 3) in the
  // K-major tile of its 128 bytes of d; bf16: element (k, n) in N-half n /
  // 64, row k, its 16-byte chunk swizzled by k.
  if constexpr (INT8) {
    for (int e = threadIdx.x; e < BN * NKT * 8; e += THREADS) {
      const int n = e % BN, kw = e / BN, kb = 4 * kw;
      uint32_t w = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (kb + i < d && n0 + n < tn)
          w |= (uint32_t)v[(size_t)(kb + i) * tn + n0 + n] << (8 * i);
      *reinterpret_cast<uint32_t*>(bs + (kb >> 7) * UNIT + n * 128 +
                                   ((((kb & 127) >> 4) ^ (n & 7)) << 4) + (kb & 15)) = w;
    }
  } else {
    for (int e = threadIdx.x; e < NKT * 16 * BN; e += THREADS) {
      const int n = e % BN, k = e / BN, c = n & 63;
      const uint16_t x = k < d && n0 + n < tn
                             ? reinterpret_cast<const uint16_t*>(v)[(size_t)k * tn + n0 + n]
                             : (uint16_t)0;
      *reinterpret_cast<uint16_t*>(bs + (n >> 6) * HALF + k * 128 + (((c >> 3) ^ (k & 7)) << 4) +
                                   (c & 7) * 2) = x;
    }
  }
  fence_proxy_async();
  __syncthreads();

  // A: rows r0 and r0 + 8 of the product; per k-step {r0 bytes 4 (t % 4)
  // .., r0 + 8 the same, r0 bytes 16 + 4 (t % 4) .., r0 + 8 the same}.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rl = (warp >> 2) * 64 + 16 * (warp & 3) + (lane >> 2);  // row in the unit
  const int r0 = m0 + rl;
  uint32_t a[NKT][4];
#pragma unroll
  for (int k = 0; k < NKT; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = r0 + 8 * (j & 1), byte = 32 * k + 16 * (j >> 1) + 4 * (lane & 3);
      a[k][j] = row < tb && byte < kbytes
                    ? *reinterpret_cast<const uint32_t*>(q + (size_t)row * kbytes + byte)
                    : 0u;
    }

  uint32_t t[RING][4];
  Acc acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0;
  // Step i's max of the unit from its retired fragment, a warp's to sink.
  // A unit with no row or column to mask folds without tests (up to 12
  // k-steps: past them the second fold's registers would spill).
  const bool full = NKT <= 12 && m0 + BM <= tb && n0 + BN <= tn;
  auto emit = [&](Acc(&f)[64], int i) {
    Acc m;
    if constexpr (NKT <= 12) {
      m = full ? fold_max<true>(f, rl, 0, 0, sel != 0)
               : fold_max<false>(f, rl, tb - m0, tn - n0, sel != 0);
    } else {
      m = fold_max<false>(f, rl, tb - m0, tn - n0, sel != 0);
    }
    float mx = to_f32(m);
    mx = warp_max(mx);
    if (lane == 0) sink[((size_t)i * units + unit) * WARPS + warp] = mx;
  };
  // Issue step i's groups into `cur`; with `fold` true, fold step ip from
  // `prv` once the wait before the RING-th group has retired it.
  auto step = [&](Acc(&cur)[64], int i, Acc(&prv)[64], int ip, auto fold) {
    // int8: whether rows r0 and r0 + 8 are the twisted row; bf16: the scale.
    const int trow = i % tb;
    [[maybe_unused]] const bool tw[2] = {r0 == trow, r0 + 8 == trow};
    [[maybe_unused]] const __nv_bfloat162 scale =
        __bfloat162bfloat162(__float2bfloat16_rn((float)(1 + i)));
    fence_acc(cur);
#pragma unroll
    for (int k = 0; k < NKT; ++k) {
      uint32_t(&tk)[4] = t[k % RING];
      wgmma_wait<RING - 1>();  // the group that read slot k % RING has retired
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (INT8) {
          tk[j] = tw[j & 1] ? ONES : a[k][j];
        } else {
          const __nv_bfloat162 x =
              __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a[k][j]), scale);
          tk[j] = *reinterpret_cast<const uint32_t*>(&x);
        }
      }
      wgmma_fence();
      if constexpr (INT8)
        wgmma_m64n128k32_s8_rs(cur, tk, gmma_desc(bsa + (k >> 2) * UNIT + (k & 3) * 32, 16, 1024),
                               k);
      else
        wgmma_m64n128k16_rs(cur, tk, gmma_desc(bsa + k * 2048, HALF, 1024), k);
      wgmma_commit();
      if constexpr (decltype(fold)::value) {
        if (k == RING - 1) {
          fence_acc(prv);
          emit(prv, ip);
        }
      }
    }
    fence_acc(cur);
  };
  auto drain = [&](Acc(&f)[64], int i) {
    wgmma_wait<0>();
    fence_acc(f);
    emit(f, i);
  };

  int i = rep;
  step(acc0, i, acc1, -1, std::false_type{});
  for (;;) {
    const int ip = i;
    if ((i += reps) >= g) {
      drain(acc0, ip);
      break;
    }
    step(acc1, i, acc0, ip, std::true_type{});
    const int iq = i;
    if ((i += reps) >= g) {
      drain(acc1, iq);
      break;
    }
    step(acc0, i, acc1, iq, std::true_type{});
  }
}

// K14 on the tensor cores past 16 k-steps of 32 bytes (d·es > 512), where
// A no longer fits in registers beside two accumulator sets: the same
// units, steps and sink, K cut into chunks of 16 k-steps.  For every step
// and chunk the CTA stages the chunk's B in shared memory (as
// gemm_rate_wgmma_kernel holds its whole B) and each warpgroup loads its
// rows' A fragments of the chunk from device memory, twists them and
// issues them through a ring of four k-step slots into one accumulator
// set, the chunk's groups retired before the next chunk's B lands; the
// step's fragment is folded once its last chunk has retired.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
gemm_rate_chunked_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ v,
                         float* __restrict__ sink, int tb, int tn, int d, int g, int units,
                         int reps, int sel) {
  constexpr bool INT8 = std::is_same_v<T, int8_t>;
  using Acc = std::conditional_t<INT8, int32_t, float>;
  constexpr int NKT = 16, RING = 4;    // k-steps a chunk, slots in flight
  constexpr int HALF = NKT * 2048;     // bf16: an N-half of a chunk's B
  constexpr int KD = NKT * 32 / (int)sizeof(T);  // d a chunk
  const int unit = blockIdx.x % units, rep = blockIdx.x / units;
  if (rep >= g) return;
  const int mtiles = (tb + BM - 1) / BM;
  const int m0 = (unit % mtiles) * BM, n0 = (unit / mtiles) * BN;
  const int kbytes = d * (int)sizeof(T), nch = (d + KD - 1) / KD;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const bs = align_1k(smem_raw);
  const uint32_t bsa = smem_u32(bs);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rl = (warp >> 2) * 64 + 16 * (warp & 3) + (lane >> 2);  // row in the unit
  const int r0 = m0 + rl;

  // Chunk ch of B, laid out as gemm_rate_wgmma_kernel lays out its B.
  auto stage_b = [&](int ch) {
    const int d0 = ch * KD;
    if constexpr (INT8) {
      for (int e = threadIdx.x; e < BN * NKT * 8; e += THREADS) {
        const int n = e % BN, kb = 4 * (e / BN);
        uint32_t w = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (d0 + kb + i < d && n0 + n < tn)
            w |= (uint32_t)v[(size_t)(d0 + kb + i) * tn + n0 + n] << (8 * i);
        *reinterpret_cast<uint32_t*>(bs + (kb >> 7) * UNIT + n * 128 +
                                     ((((kb & 127) >> 4) ^ (n & 7)) << 4) + (kb & 15)) = w;
      }
    } else {
      for (int e = threadIdx.x; e < NKT * 16 * BN; e += THREADS) {
        const int n = e % BN, k = e / BN, c = n & 63;
        const uint16_t x = d0 + k < d && n0 + n < tn
                               ? reinterpret_cast<const uint16_t*>(v)[(size_t)(d0 + k) * tn + n0 + n]
                               : (uint16_t)0;
        *reinterpret_cast<uint16_t*>(bs + (n >> 6) * HALF + k * 128 +
                                     (((c >> 3) ^ (k & 7)) << 4) + (c & 7) * 2) = x;
      }
    }
  };

  uint32_t t[RING][4];
  Acc acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int i = rep; i < g; i += reps) {
    const int trow = i % tb;
    [[maybe_unused]] const bool tw[2] = {r0 == trow, r0 + 8 == trow};
    [[maybe_unused]] const __nv_bfloat162 scale =
        __bfloat162bfloat162(__float2bfloat16_rn((float)(1 + i)));
    for (int ch = 0; ch < nch; ++ch) {
      __syncthreads();  // every group on the last chunk's B has retired
      stage_b(ch);
      fence_proxy_async();
      __syncthreads();
      fence_acc(acc);
#pragma unroll
      for (int k = 0; k < NKT; ++k) {
        uint32_t(&tk)[4] = t[k % RING];
        wgmma_wait<RING - 1>();  // the group that read slot k % RING has retired
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = r0 + 8 * (j & 1);
          const int byte = ch * 512 + 32 * k + 16 * (j >> 1) + 4 * (lane & 3);
          const uint32_t a = row < tb && byte < kbytes
                                 ? *reinterpret_cast<const uint32_t*>(q + (size_t)row * kbytes +
                                                                      byte)
                                 : 0u;
          if constexpr (INT8) {
            tk[j] = tw[j & 1] ? ONES : a;
          } else {
            const __nv_bfloat162 x = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a), scale);
            tk[j] = *reinterpret_cast<const uint32_t*>(&x);
          }
        }
        wgmma_fence();
        if constexpr (INT8)
          wgmma_m64n128k32_s8_rs(acc, tk,
                                 gmma_desc(bsa + (k >> 2) * UNIT + (k & 3) * 32, 16, 1024),
                                 ch + k);
        else
          wgmma_m64n128k16_rs(acc, tk, gmma_desc(bsa + k * 2048, HALF, 1024), ch + k);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_acc(acc);
    }
    const Acc m = fold_max<false>(acc, rl, tb - m0, tn - n0, sel != 0);
    float mx = warp_max(to_f32(m));
    if (lane == 0) sink[((size_t)i * units + unit) * WARPS + warp] = mx;
  }
}

// K14 int8 on __dp4a: the same units and steps; thread (ty, tx) of 16 x 16
// holds rows ty + 16 i and columns tx + 16 j (i, j < 8) of the unit, K 16
// int8 at a time: one 16-byte shared-memory load per row of A and per
// column of B^T (K-contiguous words, A as stored, B transposed once) feeds
// 4 __dp4a each.  Rows sit at a pitch of 4 words past a multiple of 4, so
// the 16-byte loads stay aligned and free of bank conflicts.  Both tiles
// stay resident where they fit (cw = every word of K); past that (d over
// DP4A_CW_MAX bytes) K is cut into chunks of cw words that every step
// loads in turn.  Each warp writes its max of each step's unit to
// sink[i][unit][warp], as above.
constexpr int DP4A_CW_MAX = 192;  // words of K a chunk: two tiles of 100 KB
__global__ void __launch_bounds__(THREADS, 2)
gemm_rate_dp4a_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ v,
                      float* __restrict__ sink, int tb, int tn, int d, int g, int units, int reps,
                      int sel) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int kw = (d + 3) / 4, kw4 = (kw + 3) & ~3;
  const int cw = min(kw4, DP4A_CW_MAX), pitch = cw + 4, nch = (kw4 + cw - 1) / cw;
  const int unit = blockIdx.x % units, r = blockIdx.x / units;
  const int mtiles = (tb + BM - 1) / BM;
  const int m0 = (unit % mtiles) * BM, n0 = (unit / mtiles) * BN;
  uint32_t* as = smem;               // [128][pitch]: q rows
  uint32_t* bs = smem + BM * pitch;  // [128][pitch]: v columns
  // Words w0 .. w0 + cw - 1 of K into both tiles.
  auto load = [&](int w0) {
    for (int e = threadIdx.x; e < BM * cw; e += THREADS) {
      const int w = e % cw, row = e / cw;
      const uint8_t* src = q + (size_t)(m0 + row) * d + 4 * (w0 + w);
      as[row * pitch + w] =
          m0 + row < tb && w0 + w < kw ? *reinterpret_cast<const uint32_t*>(src) : 0u;
    }
    for (int e = threadIdx.x; e < BN * cw; e += THREADS) {
      const int col = e % BN, w = e / BN;
      uint32_t x = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = 4 * (w0 + w) + i;
        if (kr < d && n0 + col < tn) x |= (uint32_t)v[(size_t)kr * tn + n0 + col] << (8 * i);
      }
      bs[col * pitch + w] = x;
    }
  };
  if (nch == 1) load(0);
  __syncthreads();

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const uint4 ones = make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u);
  for (int i = r; i < g; i += reps) {
    const int trow = i % tb - m0 - ty;  // this thread's twisted row: 16 a == trow
    int acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = 0;
    for (int ch = 0; ch < nch; ++ch) {
      if (nch > 1) {
        __syncthreads();  // every thread is done with the last chunk
        load(ch * cw);
        __syncthreads();
      }
      for (int w = 0; w < cw; w += 4) {
        uint4 bv[8];
#pragma unroll
        for (int b = 0; b < 8; ++b)
          bv[b] = *reinterpret_cast<const uint4*>(bs + (tx + 16 * b) * pitch + w);
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const uint4 x = 16 * a == trow ? ones
                                         : *reinterpret_cast<const uint4*>(
                                               as + (ty + 16 * a) * pitch + w);
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            int c = __dp4a((int)x.x, (int)bv[b].x, acc[a][b]);
            c = __dp4a((int)x.y, (int)bv[b].y, c);
            c = __dp4a((int)x.z, (int)bv[b].z, c);
            acc[a][b] = __dp4a((int)x.w, (int)bv[b].w, c);
          }
        }
      }
    }
    float mx = NEG_INF;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      float rm = NEG_INF;  // the row's max over this thread's columns
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if (m0 + ty + 16 * a < tb && n0 + tx + 16 * b < tn) rm = fmaxf(rm, (float)acc[a][b]);
      if (sel) {  // the row's max across the 16 threads that hold it
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) rm = fmaxf(rm, __shfl_xor_sync(0xffffffffu, rm, o));
      }
      mx = fmaxf(mx, rm);
    }
    mx = warp_max(mx);
    if ((threadIdx.x & 31) == 0)
      sink[((size_t)i * units + unit) * WARPS + (threadIdx.x >> 5)] = mx;
  }
}

// ------------------------------------------------------------------ K13

// One thread: expect `bytes` on `bar` and start their bulk copy into
// shared memory; the copy completes the transaction on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// K13: the walk [0, nbytes) in STAGE-byte chunks, a contiguous run of
// chunks per CTA, through a ring of `depth` stages: thread 0 keeps `depth`
// copies in flight, every thread reduces each stage once its barrier
// completes, and the stage is refilled after a CTA barrier.  The bulk
// copies move whole 16-byte pieces: the last CTA reads the walk's tail past
// them (under 16 bytes, blocks of any size) with ordinary loads.
// partial[blockIdx.x] = the CTA's max.
template <Elem E>
__global__ void __launch_bounds__(THREADS) dma_ring_kernel(const uint8_t* __restrict__ data,
                                                           float* __restrict__ partial,
                                                           long long nbytes, int depth) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t bars[MAX_DEPTH];
  const long long tail = nbytes & 15;
  nbytes -= tail;
  const long long nchunks = (nbytes + STAGE - 1) / STAGE;
  const long long per = (nchunks + gridDim.x - 1) / gridDim.x;
  const long long c0 = min(nchunks, (long long)blockIdx.x * per);
  const int n = (int)(min(nchunks, c0 + per) - c0);
  auto issue = [&](int j) {
    const long long off = (c0 + j) * STAGE;
    const unsigned bytes = (unsigned)min((long long)STAGE, nbytes - off);
    bulk_load(ring + (j % depth) * STAGE, data + off, bytes, &bars[j % depth]);
  };
  if (threadIdx.x == 0) {
    for (int j = 0; j < depth; ++j) mbar_init(&bars[j], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int j = 0; j < min(depth, n); ++j) issue(j);
  WordMax<E> wm;
  for (int j = 0; j < n; ++j) {
    mbar_wait(&bars[j % depth], (unsigned)((j / depth) & 1));
    const long long off = (c0 + j) * STAGE;
    const int nv = (int)(min((long long)STAGE, nbytes - off) / 16);
    const uint4* st = reinterpret_cast<const uint4*>(ring + (j % depth) * STAGE);
    for (int k = threadIdx.x; k < nv; k += THREADS) wm.add(st[k]);
    __syncthreads();  // every thread is done with the stage
    if (threadIdx.x == 0 && j + depth < n) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(j + depth);
    }
  }
  float mt = wm.value();
  constexpr int ES = Lanes<E>::kEs;
  if (blockIdx.x + 1 == gridDim.x && threadIdx.x * ES < tail)
    mt = fmaxf(mt, Lanes<E>::elem(data + nbytes + threadIdx.x * ES));
  const float m = block_max(mt);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

// out[0] = max(in[0..n)), -inf for n = 0.
__global__ void __launch_bounds__(THREADS) max_kernel(const float* __restrict__ in, int n,
                                                      float* __restrict__ out) {
  float m = NEG_INF;
  for (int i = threadIdx.x; i < n; i += THREADS) m = fmaxf(m, in[i]);
  m = block_max(m);
  if (threadIdx.x == 0) out[0] = m;
}

int sm_count(int* sms) {
  int dev;
  if (const cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// Let each of `kernels` take dynamic shared memory up to the card's opt-in
// limit: past 48 KB of static plus dynamic, a launch is refused unless this
// attribute allows it.  The attribute belongs to one device, so each
// launcher keeps a flag per device ordinal (`done`, one set of flags per
// kernel instance or group of instances it launches) and sets the attribute
// on its first call on the current device; no later call there, such as one
// under CUDA graph capture, touches it.  K2's smem_limit (fused_topk.cu)
// does the same.
constexpr int MAX_DEVICES = 64;
using DeviceFlags = bool[MAX_DEVICES];

template <typename... K>
int allow_smem(DeviceFlags& done, K... kernels) {
  int dev, optin;
  if (const cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (done[dev]) return 0;
  if (const cudaError_t e =
          cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
    return (int)e;
  cudaError_t err = cudaSuccess;
  auto one = [&](auto kernel) {
    cudaFuncAttributes fa;
    if (!err) err = cudaFuncGetAttributes(&fa, kernel);
    if (!err)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - (int)fa.sharedSizeBytes);
  };
  (one(kernels), ...);
  if (err) return (int)err;
  done[dev] = true;
  return 0;
}

template <Elem E>
int launch_stream(const void* x, const void* data, void* steps, int m, int ldx, int d, int blk,
                  int ldb, int fat, int g, int gemm, int persistent, cudaStream_t st) {
  if (g <= 0) return 0;
  unsigned grid = (unsigned)g;
  if (persistent) {
    int sms;
    if (const int e = sm_count(&sms)) return e;
    grid = (unsigned)min(sms, g);
  }
  constexpr int ES = Lanes<E>::kEs;
  const auto* dp = static_cast<const uint8_t*>(data);
  if (!gemm) {
    const size_t step_bytes = (size_t)fat * d * ldb * ES;
    stream_max_kernel<E><<<grid, THREADS, 0, st>>>(dp, static_cast<float*>(steps), g,
                                                   step_bytes, persistent);
  } else {
    using T = std::conditional_t<E == Elem::kI8, int8_t, __nv_bfloat16>;
    // x, the ring and (int8) the two transposed units.  A CTA per step:
    // as many stages as leave two CTAs an SM (one CTA's start under the
    // other's walk), else one; the persistent grid holds one CTA an SM, so
    // it takes the deepest ring.  Where x's tiles would leave one CTA an SM
    // under two stages, x rides in the ring.
    constexpr bool I8 = E == Elem::kI8;
    const int xtiles = (m + BM - 1) / BM * ((d * ES + 127) / 128);
    const int base = 2048 + (I8 ? 2 * UNIT : 0);
    const int xring = (SMEM_ONE - base - xtiles * UNIT) / (I8 ? RAW_UNIT : UNIT) < 2;
    const int sst = xring ? (I8 ? RAW_SLOT : UNIT) + UNIT : (I8 ? RAW_UNIT : UNIT);
    const int fixed = base + (xring ? 0 : xtiles * UNIT);
    int stages = persistent ? 0 : min(MAX_STAGES, (SMEM_TWO - fixed) / sst);
    if (stages < 2) stages = min(MAX_STAGES, (SMEM_ONE - fixed) / sst);
    static DeviceFlags done;
    if (const int e = allow_smem(done, stream_wgmma_kernel<T, false, false>,
                                 stream_wgmma_kernel<T, false, true>,
                                 stream_wgmma_kernel<T, true, true>))
      return e;
    const int vec16 = (ldb * ES) % 16 == 0 && reinterpret_cast<uintptr_t>(data) % 16 == 0;
    auto* kernel = xring     ? stream_wgmma_kernel<T, true, true>
                   : m > BM ? stream_wgmma_kernel<T, false, true>
                            : stream_wgmma_kernel<T, false, false>;
    kernel<<<grid, THREADS, fixed + stages * sst, st>>>(
        static_cast<const uint8_t*>(x), dp, static_cast<float*>(steps), m, ldx, d, blk, ldb, fat,
        g, persistent, stages, vec16);
  }
  return (int)cudaGetLastError();
}

template <Elem E>
int launch_dma(const void* data, void* partial, void* out, long long nbytes, int depth,
               cudaStream_t st) {
  int sms;
  if (const int e = sm_count(&sms)) return e;
  // One CTA at least where the walk is only a tail of under 16 bytes.
  const long long nchunks = ((nbytes & ~15ll) + STAGE - 1) / STAGE;
  const int grid = nbytes > 0 ? (int)max(1ll, min((long long)sms, nchunks)) : 0;
  if (grid > 0) {
    const int smem = depth * STAGE;
    static DeviceFlags done;
    if (const int e = allow_smem(done, dma_ring_kernel<E>)) return e;
    dma_ring_kernel<E><<<grid, THREADS, smem, st>>>(static_cast<const uint8_t*>(data),
                                                    static_cast<float*>(partial), nbytes, depth);
    if (const cudaError_t e = cudaGetLastError()) return (int)e;
  }
  max_kernel<<<1, THREADS, 0, st>>>(static_cast<const float*>(partial), grid,
                                    static_cast<float*>(out));
  return (int)cudaGetLastError();
}

template <typename K>
int launch_rate(K kernel, int smem, const void* q, const void* v, void* sink, void* out, int tb,
                int tn, int d, int g, int reps, int sel, cudaStream_t st) {
  const int units = ((tb + BM - 1) / BM) * ((tn + BN - 1) / BN);
  auto* sp = static_cast<float*>(sink);
  kernel<<<units * reps, THREADS, smem, st>>>(static_cast<const uint8_t*>(q),
                                              static_cast<const uint8_t*>(v), sp, tb, tn, d, g,
                                              units, reps, sel);
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  max_kernel<<<1, THREADS, 0, st>>>(sp + (size_t)(g - 1) * units * WARPS, units * WARPS,
                                    static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// K14 on wgmma at NKT k-steps of 32 bytes: B in shared memory (int8: a
// [128][128-byte] tile per 128 bytes of d; bf16: two N-halves of NKT 2 KB).
template <typename T, int NKT>
int launch_rate_wgmma(const void* q, const void* v, void* sink, void* out, int tb, int tn, int d,
                      int g, int reps, int sel, cudaStream_t st) {
  constexpr int smem = 1024 + (std::is_same_v<T, int8_t> ? (NKT + 3) / 4 * UNIT : NKT * 4096);
  static DeviceFlags done;
  if (const int e = allow_smem(done, gemm_rate_wgmma_kernel<T, NKT>)) return e;
  return launch_rate(gemm_rate_wgmma_kernel<T, NKT>, smem, q, v, sink, out, tb, tn, d, g, reps,
                     sel, st);
}

// The instance for nkt (1..16) k-steps.
template <typename T, int... N>
int launch_rate_nkt(std::integer_sequence<int, N...>, int nkt, const void* q, const void* v,
                    void* sink, void* out, int tb, int tn, int d, int g, int reps, int sel,
                    cudaStream_t st) {
  int err = (int)cudaErrorInvalidValue;
  auto one = [&](auto n) {
    err = launch_rate_wgmma<T, decltype(n)::value>(q, v, sink, out, tb, tn, d, g, reps, sel, st);
    return true;
  };
  (void)((nkt == N + 1 && one(std::integral_constant<int, N + 1>{})) || ...);
  return err;
}

}  // namespace

// C entries for ctypes.  Each launches on `stream`, allocates nothing, and
// returns cudaGetLastError() (0 = launched).  Arrays are contiguous; `bf16`
// selects bfloat16 operands over int8.

// K11: in [8, 128] f32 (pinned) or [g * 8, 128] (moving); out [8, 128] f32.
// loop = 1 runs the steps in one CTA ("arbitrary"), else a CTA per step.
extern "C" int hw_step_probe(const void* in, void* out, int g, int moving, int loop,
                             void* stream) {
  if (g <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ip = static_cast<const float*>(in);
  auto* op = static_cast<float*>(out);
  if (loop)
    step_loop_kernel<<<1, THREADS, 0, st>>>(ip, op, g, moving);
  else
    step_grid_kernel<<<g, THREADS, 0, st>>>(ip, op, g, moving);
  return (int)cudaGetLastError();
}

// K12: data [g * fat, d, ldb] of which the first blk columns count, x [m,
// d] at a row pitch of ldx bytes (gemm: ldx and ldb * es multiples of 4,
// 4-byte aligned bases; without the product ldb = blk); steps [g] f32.
extern "C" int hw_stream_probe(const void* x, const void* data, void* steps, int m, int ldx,
                               int d, int blk, int ldb, int fat, int g, int gemm, int persistent,
                               int bf16, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_stream<Elem::kBF16>(x, data, steps, m, ldx, d, blk, ldb, fat, g, gemm,
                                           persistent, st)
              : launch_stream<Elem::kI8>(x, data, steps, m, ldx, d, blk, ldb, fat, g, gemm,
                                         persistent, st);
}

// K13: the max of data[0, nbytes) (any whole number of elements, base
// 16-byte aligned) with `depth` (1..8) copies in flight per CTA; partial
// [SMs] f32 scratch, out [1] f32.
extern "C" int hw_dma_probe(const void* data, void* partial, void* out, long long nbytes,
                            int depth, int bf16, void* stream) {
  if (depth < 1 || depth > MAX_DEPTH) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dma<Elem::kBF16>(data, partial, out, nbytes, depth, st)
              : launch_dma<Elem::kI8>(data, partial, out, nbytes, depth, st);
}

// K14: q [tb, d], v [d, tn] (d * es a multiple of 4), g >= 1 steps over
// units * reps CTAs; sink [g, units, 8] f32 (each step's max per unit and
// warp), out [1] f32 (the last step's max).  dp4a = 1 takes the __dp4a unit
// (int8 only).  Up to 16 k-steps of 32 bytes the wgmma unit holds A in
// registers (one instance a k-step count), past that it runs
// gemm_rate_chunked_kernel.
extern "C" int hw_gemm_rate_probe(const void* q, const void* v, void* sink, void* out, int tb,
                                  int tn, int d, int g, int reps, int sel, int bf16, int dp4a,
                                  void* stream) {
  const int nkt = (d * (bf16 ? 2 : 1) + 31) / 32;
  if (g <= 0 || nkt < 1 || (d * (bf16 ? 2 : 1)) % 4) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dp4a) {
    if (bf16) return (int)cudaErrorInvalidValue;
    static DeviceFlags done;
    if (const int e = allow_smem(done, gemm_rate_dp4a_kernel)) return e;
    const int cw = min((((d + 3) / 4 + 3) & ~3), DP4A_CW_MAX);
    const int smem = 2 * BM * (cw + 4) * 4;
    return launch_rate(gemm_rate_dp4a_kernel, smem, q, v, sink, out, tb, tn, d, g, reps, sel,
                       st);
  }
  if (nkt > 16) {
    constexpr int smem = 1024 + 4 * UNIT;  // a chunk's B: int8 four units, bf16 two N-halves
    if (bf16) {
      static DeviceFlags done;
      if (const int e = allow_smem(done, gemm_rate_chunked_kernel<__nv_bfloat16>)) return e;
      return launch_rate(gemm_rate_chunked_kernel<__nv_bfloat16>, smem, q, v, sink, out, tb, tn,
                         d, g, reps, sel, st);
    }
    static DeviceFlags done;
    if (const int e = allow_smem(done, gemm_rate_chunked_kernel<int8_t>)) return e;
    return launch_rate(gemm_rate_chunked_kernel<int8_t>, smem, q, v, sink, out, tb, tn, d, g,
                       reps, sel, st);
  }
  const auto n = std::make_integer_sequence<int, 16>{};
  return bf16 ? launch_rate_nkt<__nv_bfloat16>(n, nkt, q, v, sink, out, tb, tn, d, g, reps, sel,
                                               st)
              : launch_rate_nkt<int8_t>(n, nkt, q, v, sink, out, tb, tn, d, g, reps, sel, st);
}
