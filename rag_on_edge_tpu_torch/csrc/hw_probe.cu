// Kernels K11-K14: the hardware probes.  They replace the four Pallas probes
// of rag_on_edge_tpu/harness/hw_probe.py and measure this card's ceilings:
//
// K11 _step_probe      a trivial kernel over g steps: the fixed cost of a
//                      step (a CTA, or one turn of an in-kernel loop).
// K12 _stream_probe    a walk over [nblocks, d, blk] int8/bf16 tiles, fat
//                      blocks a step, each step max-reduced (optionally
//                      through a product with a resident x [m, d]).
// K13 _dma_probe       the same walk through a ring of `depth` bulk async
//                      copies (cp.async.bulk, TMA's 1-D copy) per CTA.
// K14 _gemm_rate_probe g steps of a resident [tb, d] x [d, tn] product, A
//                      twisted each step: the in-kernel matrix rate, on the
//                      tensor cores (mma.sync) or, for int8, on __dp4a.
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
// 4 KB a step); K12 without the product and K13 device memory (3.35 TB/s);
// K12's product and K14 the tensor-core rate (int8 1979 T ops/s, bf16 989
// TFLOP/s) or, on the dp4a unit, the 32-bit integer pipe.
//
// How the TPU grid maps onto the card (dimension_semantics):
// - "parallel" and None: one CTA per step; CTAs run in no order.
// - "arbitrary": the steps in order inside one CTA (K11), or a persistent
//   grid of one CTA per SM, each walking a contiguous run of steps in order
//   (K12).
// Shared memory is the constraint the TPU's VMEM is not: one TPU block
// (128 x 2048 int8, 256 KB) exceeds a CTA's 227 KB, so K12 takes a tile in
// 128-column slices, K13 copies 16 KB slices of the walk into its ring, and
// K14 splits v's columns (and q's rows) across CTAs, each CTA holding one
// 128 x 128 unit of the product resident and taking every R-th step.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_frag.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BM = 128, BN = 128;    // product unit per CTA (K12, K14)
constexpr int TILE_WORDS = BM * KW;  // one swizzled [128][16]-word operand tile
constexpr int STAGE = 16384;         // bytes of one K13 ring stage
constexpr int MAX_DEPTH = 8;         // K13 ring stages
constexpr float NEG_INF = -__builtin_huge_valf();

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

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

// ------------------------------------------------------- K12 / K14 mma

// Fill nkt swizzled A tiles from rows [r0, r0 + 128) of a row-major
// [rows, kbytes] operand (kbytes a multiple of 4); zero past the edges.
__device__ __forceinline__ void load_a_tiles(uint32_t* tiles, const uint8_t* a, int r0, int rows,
                                             int kbytes, int nkt) {
  for (int e = threadIdx.x; e < nkt * BM * KW; e += THREADS) {
    const int gw = e % (nkt * KW), row = e / (nkt * KW);  // K word fastest: coalesced
    const int r = r0 + row;
    const uint32_t v = (r < rows && gw * 4 < kbytes)
                           ? *reinterpret_cast<const uint32_t*>(a + (size_t)r * kbytes + gw * 4)
                           : 0u;
    tiles[(gw / KW) * TILE_WORDS + swz(row, gw % KW)] = v;
  }
}

// Fill nkt swizzled B^T tiles from columns [n0, n0 + 128) of a row-major
// [k, n] operand, P K-rows to a word; zero past the edges.
template <Elem E>
__device__ __forceinline__ void load_bt_tiles(uint32_t* tiles, const uint8_t* b, int n0, int n,
                                              int k, int nkt) {
  constexpr int ES = Mma<E>::kEs, P = 4 / ES;
  for (int e = threadIdx.x; e < nkt * KW * BN; e += THREADS) {
    const int col = e % BN, gw = e / BN;  // column fastest: coalesced
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int kr = gw * P + i;
      if (kr < k && n0 + col < n) {
        const uint8_t* src = b + ((size_t)kr * n + n0 + col) * ES;
        const uint32_t x =
            ES == 1 ? (uint32_t)*src : (uint32_t)*reinterpret_cast<const uint16_t*>(src);
        v |= x << (8 * ES * i);
      }
    }
    tiles[(gw / KW) * TILE_WORDS + swz(col, gw % KW)] = v;
  }
}

template <Elem E>
using Acc = typename Mma<E>::Acc;

template <Elem E>
__device__ __forceinline__ void zero(Acc<E> (&acc)[4][4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = Acc<E>(0);
}

// A warp's 64 x 32 of the 128 x 128 unit over one 64-byte K tile (K8's
// fragment loop).  `twist` edits each A fragment before its products.
template <Elem E, typename Twist>
__device__ __forceinline__ void mma_tile(Acc<E> (&acc)[4][4][4], const uint32_t* as,
                                         const uint32_t* bs, Twist twist) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int s = 0; s < KW / 8; ++s) {
    uint32_t af[4][4], bf[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      ldsm_x4(af[mt], as + swz(wm * 64 + mt * 16 + (lane & 15), 4 * (2 * s + (lane >> 4))));
      twist(af[mt], mt);
    }
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
      for (int nt = 0; nt < 4; ++nt) Mma<E>::run(acc[mt][nt], af[mt], bf[nt]);
  }
}

// This thread's max of the accumulators inside [rows) x [cols) of the unit
// at (m0, n0).  With `sel`, each row's max first (across the quad of
// threads that holds the row), as the TPU's per-row reduction does; the
// value is the same.
template <Elem E>
__device__ __forceinline__ float fold_max(const Acc<E> (&acc)[4][4][4], int m0, int rows, int n0,
                                          int cols, bool sel) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, tg = lane & 3;
  float m = NEG_INF;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool row_ok = m0 + wm * 64 + mt * 16 + g + 8 * h < rows;
      float rm = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool ok = row_ok && n0 + wn * 32 + nt * 8 + 2 * tg + c < cols;
          if (ok) rm = fmaxf(rm, (float)acc[mt][nt][2 * h + c]);
        }
      if (sel) {
        rm = fmaxf(rm, __shfl_xor_sync(0xffffffffu, rm, 1));
        rm = fmaxf(rm, __shfl_xor_sync(0xffffffffu, rm, 2));
      }
      m = fmaxf(m, rm);
    }
  return m;
}

// K12 with the product: steps[s] = max over step s's fat tiles of
// max(x @ tile), x [m <= 128, d] resident in shared memory, each tile
// [d, blk] taken in 128-column slices, 64 bytes of K at a time, through a
// register-staged double buffer (K8's loop) over the step's whole
// (tile, slice, K tile) sequence.
template <Elem E>
__global__ void __launch_bounds__(THREADS, 2)
stream_gemm_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ data,
                   float* __restrict__ steps, int m, int d, int blk, int fat, int g,
                   int persistent) {
  constexpr int ES = Mma<E>::kEs;
  constexpr int P = 4 / ES;
  constexpr int NCG = BN * ES / 4;          // column words of a B slice row
  constexpr int NBLK = KW * NCG / THREADS;  // B word-blocks per thread
  extern __shared__ __align__(16) uint32_t smem[];
  const int kbytes = d * ES, nkt = (kbytes + KB - 1) / KB;
  uint32_t* xs = smem;
  uint32_t* bsm = smem + nkt * TILE_WORDS;
  load_a_tiles(xs, x, 0, m, kbytes, nkt);
  __syncthreads();

  const int tid = threadIdx.x;
  const int nsl = (blk + BN - 1) / BN, nu = fat * nsl * nkt;
  const size_t tile_bytes = (size_t)d * blk * ES, b_pitch = (size_t)blk * ES;
  uint32_t rb[NBLK][P];
  const uint8_t* base = data;

  auto load_b = [&](int u) {
    const int kt = u % nkt, r = u / nkt;
    const int n0 = (r % nsl) * BN;
    const uint8_t* b = base + (size_t)(r / nsl) * tile_bytes;
#pragma unroll
    for (int j = 0; j < NBLK; ++j) {
      const int bi = tid + THREADS * j, bl = bi & 31, bw = bi >> 5;
      const int kw = (bl & 3) + 4 * (bw & 3), cg = (bl >> 2) + 8 * (bw >> 2);
      const size_t cb = (size_t)n0 * ES + cg * 4;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int kr = kt * (KB / ES) + kw * P + i;
        rb[j][i] = (kr < d && cb < b_pitch)
                       ? *reinterpret_cast<const uint32_t*>(b + (size_t)kr * b_pitch + cb)
                       : 0u;
      }
    }
  };
  auto store_b = [&](int buf) {
    uint32_t* bs = bsm + buf * TILE_WORDS;
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
  auto no_twist = [](uint32_t(&)[4], int) {};

  int s0, s1;
  step_range(g, persistent, &s0, &s1);
  Acc<E> acc[4][4][4];
  for (int s = s0; s < s1; ++s) {
    base = data + (size_t)s * fat * tile_bytes;
    float mx = NEG_INF;
    zero<E>(acc);
    load_b(0);
    store_b(0);
    __syncthreads();
    for (int u = 0; u < nu; ++u) {
      const int cur = u & 1, kt = u % nkt;
      const bool more = u + 1 < nu;
      if (more) load_b(u + 1);
      mma_tile<E>(acc, xs + kt * TILE_WORDS, bsm + cur * TILE_WORDS, no_twist);
      if (kt == nkt - 1) {
        mx = fmaxf(mx, fold_max<E>(acc, 0, m, ((u / nkt) % nsl) * BN, blk, false));
        zero<E>(acc);
      }
      if (more) store_b(cur ^ 1);
      __syncthreads();
    }
    mx = block_max(mx);
    if (tid == 0) steps[s] = mx;
  }
}

// K14 on the tensor cores.  CTA c holds unit c % U of the product (a 128-row
// tile of q, a 128-column tile of v, whole K) in shared memory and takes
// steps c / U, c / U + R, ...  Each step twists A (int8: row (i % tb) set to
// 1; bf16: every element times bf16(1 + i), rounded to bf16), runs the
// unit's product, and each warp writes its max of it to
// sink[i][unit][warp]: every step, unit and warp once across the grid.
template <Elem E>
__global__ void __launch_bounds__(THREADS, 2)
gemm_rate_mma_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ v,
                     float* __restrict__ sink, int tb, int tn, int d, int g, int units, int reps,
                     int sel) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int ES = Mma<E>::kEs;
  const int kbytes = d * ES, nkt = (kbytes + KB - 1) / KB;
  const int unit = blockIdx.x % units, r = blockIdx.x / units;
  const int mtiles = (tb + BM - 1) / BM;
  const int m0 = (unit % mtiles) * BM, n0 = (unit / mtiles) * BN;
  uint32_t* as = smem;
  uint32_t* bs = smem + nkt * TILE_WORDS;
  load_a_tiles(as, q, m0, tb, kbytes, nkt);
  load_bt_tiles<E>(bs, v, n0, tn, d, nkt);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = m0 + (warp >> 2) * 64 + (lane >> 2);  // + mt * 16 (+ 8)
  Acc<E> acc[4][4][4];
  for (int i = r; i < g; i += reps) {
    zero<E>(acc);
    if constexpr (E == Elem::kI8) {
      const int trow = i % tb;
      auto twist = [&](uint32_t(&a)[4], int mt) {
        const int lo = row0 + mt * 16;
        if (lo == trow) a[0] = a[2] = 0x01010101u;
        if (lo + 8 == trow) a[1] = a[3] = 0x01010101u;
      };
      for (int kt = 0; kt < nkt; ++kt)
        mma_tile<E>(acc, as + kt * TILE_WORDS, bs + kt * TILE_WORDS, twist);
    } else {
      const __nv_bfloat162 s2 = __bfloat162bfloat162(__float2bfloat16_rn((float)(1 + i)));
      auto twist = [&](uint32_t(&a)[4], int) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat162 t = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a[j]), s2);
          a[j] = *reinterpret_cast<const uint32_t*>(&t);
        }
      };
      for (int kt = 0; kt < nkt; ++kt)
        mma_tile<E>(acc, as + kt * TILE_WORDS, bs + kt * TILE_WORDS, twist);
    }
    const float mx = warp_max(fold_max<E>(acc, m0, tb, n0, tn, sel != 0));
    if (lane == 0) sink[((size_t)i * units + unit) * WARPS + warp] = mx;
  }
}

// K14 int8 on __dp4a: the same units and steps; thread (ty, tx) of 16 x 16
// holds rows ty + 16 i and columns tx + 16 j (i, j < 8) of the unit, K 16
// int8 at a time: one 16-byte shared-memory load per row of A and per
// column of B^T (K-contiguous words, A as stored, B transposed once) feeds
// 4 __dp4a each.  Rows sit at a pitch of 4 words past a multiple of 4, so
// the 16-byte loads stay aligned and free of bank conflicts.  Each warp
// writes its max of each step's unit to sink[i][unit][warp], as above.
__global__ void __launch_bounds__(THREADS, 2)
gemm_rate_dp4a_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ v,
                      float* __restrict__ sink, int tb, int tn, int d, int g, int units, int reps,
                      int sel) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int kw = (d + 3) / 4, kw4 = (kw + 3) & ~3, pitch = kw4 + 4;
  const int unit = blockIdx.x % units, r = blockIdx.x / units;
  const int mtiles = (tb + BM - 1) / BM;
  const int m0 = (unit % mtiles) * BM, n0 = (unit / mtiles) * BN;
  uint32_t* as = smem;               // [128][pitch]: q rows
  uint32_t* bs = smem + BM * pitch;  // [128][pitch]: v columns
  for (int e = threadIdx.x; e < BM * kw4; e += THREADS) {
    const int w = e % kw4, row = e / kw4;
    const uint8_t* src = q + (size_t)(m0 + row) * d + 4 * w;
    as[row * pitch + w] = m0 + row < tb && w < kw ? *reinterpret_cast<const uint32_t*>(src) : 0u;
  }
  for (int e = threadIdx.x; e < BN * kw4; e += THREADS) {
    const int col = e % BN, w = e / BN;
    uint32_t x = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = 4 * w + i;
      if (kr < d && n0 + col < tn) x |= (uint32_t)v[(size_t)kr * tn + n0 + col] << (8 * i);
    }
    bs[col * pitch + w] = x;
  }
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
    for (int w = 0; w < kw4; w += 4) {
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

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned phase) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
  } while (!done);
}

// One thread: expect `bytes` on `bar` and start their bulk copy into
// shared memory; the copy completes the transaction on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// K13: the walk [0, nbytes) in STAGE-byte chunks, a contiguous run of
// chunks per CTA, through a ring of `depth` stages: thread 0 keeps `depth`
// copies in flight, every thread reduces each stage once its barrier
// completes, and the stage is refilled after a CTA barrier.
// partial[blockIdx.x] = the CTA's max.
template <Elem E>
__global__ void __launch_bounds__(THREADS) dma_ring_kernel(const uint8_t* __restrict__ data,
                                                           float* __restrict__ partial,
                                                           long long nbytes, int depth) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ __align__(8) uint64_t bars[MAX_DEPTH];
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
  const float m = block_max(wm.value());
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

// Let `kernel` take dynamic shared memory up to the card's opt-in limit:
// past 48 KB of static plus dynamic, a launch is refused unless this
// attribute allows it.  Each launcher sets it once (a function-local
// static), on its first call, so that no later call, such as one under
// CUDA graph capture, touches it.
template <typename K>
int allow_smem(K kernel) {
  int dev, optin;
  cudaFuncAttributes fa;
  if (const cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  if (const cudaError_t e =
          cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
    return (int)e;
  if (const cudaError_t e = cudaFuncGetAttributes(&fa, kernel)) return (int)e;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   optin - (int)fa.sharedSizeBytes);
}

template <Elem E>
int launch_stream(const void* x, const void* data, void* steps, int m, int d, int blk, int fat,
                  int g, int gemm, int persistent, cudaStream_t st) {
  if (g <= 0) return 0;
  unsigned grid = (unsigned)g;
  if (persistent) {
    int sms;
    if (const int e = sm_count(&sms)) return e;
    grid = (unsigned)min(sms, g);
  }
  const auto* dp = static_cast<const uint8_t*>(data);
  if (!gemm) {
    const size_t step_bytes = (size_t)fat * d * blk * Mma<E>::kEs;
    stream_max_kernel<E><<<grid, THREADS, 0, st>>>(dp, static_cast<float*>(steps), g,
                                                   step_bytes, persistent);
  } else {
    const int nkt = (d * Mma<E>::kEs + KB - 1) / KB;
    const int smem = (nkt + 2) * TILE_WORDS * 4;
    static const int smem_err = allow_smem(stream_gemm_kernel<E>);
    if (smem_err) return smem_err;
    stream_gemm_kernel<E><<<grid, THREADS, smem, st>>>(static_cast<const uint8_t*>(x), dp,
                                                       static_cast<float*>(steps), m, d, blk,
                                                       fat, g, persistent);
  }
  return (int)cudaGetLastError();
}

template <Elem E>
int launch_dma(const void* data, void* partial, void* out, long long nbytes, int depth,
               cudaStream_t st) {
  int sms;
  if (const int e = sm_count(&sms)) return e;
  const long long nchunks = (nbytes + STAGE - 1) / STAGE;
  const int grid = (int)min((long long)sms, nchunks);
  if (grid > 0) {
    const int smem = depth * STAGE;
    static const int smem_err = allow_smem(dma_ring_kernel<E>);
    if (smem_err) return smem_err;
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

// K12: data [g * fat, d, blk], x [m, d] (m <= 128; gemm: d * es and
// blk * es multiples of 4, d * es <= 512, 4-byte aligned bases);
// steps [g] f32.
extern "C" int hw_stream_probe(const void* x, const void* data, void* steps, int m, int d,
                               int blk, int fat, int g, int gemm, int persistent, int bf16,
                               void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_stream<Elem::kBF16>(x, data, steps, m, d, blk, fat, g, gemm, persistent, st)
              : launch_stream<Elem::kI8>(x, data, steps, m, d, blk, fat, g, gemm, persistent, st);
}

// K13: the max of data[0, nbytes) (nbytes a multiple of 16, base 16-byte
// aligned) with `depth` (1..8) copies in flight per CTA; partial [SMs]
// f32 scratch, out [1] f32.
extern "C" int hw_dma_probe(const void* data, void* partial, void* out, long long nbytes,
                            int depth, int bf16, void* stream) {
  if (depth < 1 || depth > MAX_DEPTH) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dma<Elem::kBF16>(data, partial, out, nbytes, depth, st)
              : launch_dma<Elem::kI8>(data, partial, out, nbytes, depth, st);
}

// K14: q [tb, d], v [d, tn] (d * es a multiple of 4, <= 512 bytes), g >= 1
// steps over units * reps CTAs; sink [g, units, 8] f32 (each step's max per
// unit and warp), out [1] f32 (the last step's max).  dp4a = 1 takes the
// __dp4a unit (int8 only).
extern "C" int hw_gemm_rate_probe(const void* q, const void* v, void* sink, void* out, int tb,
                                  int tn, int d, int g, int reps, int sel, int bf16, int dp4a,
                                  void* stream) {
  if (g <= 0) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  static const int smem_err = [] {
    int e = allow_smem(gemm_rate_dp4a_kernel);
    if (!e) e = allow_smem(gemm_rate_mma_kernel<Elem::kI8>);
    if (!e) e = allow_smem(gemm_rate_mma_kernel<Elem::kBF16>);
    return e;
  }();
  if (smem_err) return smem_err;
  if (dp4a) {
    if (bf16) return (int)cudaErrorInvalidValue;
    const int smem = 2 * BM * ((((d + 3) / 4 + 3) & ~3) + 4) * 4;
    return launch_rate(gemm_rate_dp4a_kernel, smem, q, v, sink, out, tb, tn, d, g, reps, sel,
                       st);
  }
  const int es = bf16 ? 2 : 1;
  const int smem = 2 * ((d * es + KB - 1) / KB) * TILE_WORDS * 4;
  return bf16 ? launch_rate(gemm_rate_mma_kernel<Elem::kBF16>, smem, q, v, sink, out, tb, tn, d,
                            g, reps, sel, st)
              : launch_rate(gemm_rate_mma_kernel<Elem::kI8>, smem, q, v, sink, out, tb, tn, d, g,
                            reps, sel, st);
}
