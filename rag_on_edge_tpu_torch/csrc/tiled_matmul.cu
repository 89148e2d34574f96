// Kernel K8 of the spatial GEMM: C[M, N] = A[M, K] @ B[K, N], int8 -> int32,
// bf16 -> f32 and f32 -> f32, for any M, N and K.
//
// It replaces the TPU kernel rag_on_edge_tpu/ops/pallas_matmul.py,
// tiled_matmul (its _kernel): a (M/bm, N/bn, K/bk) grid whose K steps carry
// an accumulator in VMEM and emit each C tile once.  Here each CTA owns one
// 128 x 128 tile of C and walks K itself, the accumulator in registers.
//
// What bounds it on the H100: at the spatial GEMM's shapes K is small (128),
// so the int32 / f32 output is most of the bytes; the SIFT-1M scoring product
// [8192, 128] x [128, 1M] writes 32.8 GB against 129 MB of inputs, and is
// bound by HBM writes (9.8 ms at 3.35 TB/s).  At a square 4096^3 the
// bf16 and f32 products are bound by the tensor-core and FFMA rates.
//
// Design (simple first; wgmma, TMA and a persistent grid are later work):
// - int8 and bf16: mma.sync tensor-core tiles, m16n8k32 s8.s8 -> s32 and
//   m16n8k16 bf16 -> f32.  Both consume 32 bytes of K per instruction with
//   the same register layout (a fragment word holds 4 int8 or 2 bf16
//   K-neighbours), so one template serves both.  8 warps as 2 (M) x 4 (N),
//   each warp 64 x 32 of C: 4 x 4 mma tiles, 64 accumulators a thread.
// - K advances 64 bytes a tile (64 int8 or 32 bf16 values).  A tile is
//   copied as it lies (K-contiguous rows, 16-byte loads); B is transposed on
//   the way to shared memory (4 K-rows x 4 bytes of columns per 32-bit word,
//   __byte_perm), because the mma B operand wants K-contiguous words per
//   column and ldmatrix cannot transpose 8-bit data.  Both tiles are stored
//   as [128 rows][16 words] with the 4-word group XOR-swizzled by row bits,
//   and the fragments come out of them with ldmatrix.x4, free of bank
//   conflicts.
// - double-buffered: the next K tile is loaded into registers while the
//   current one is multiplied, then stored into the other buffer.
// - ragged edges: rows of A past M and columns of B past N load as zeros,
//   and C is stored under a mask.  The wrapper pads K to 16 bytes and the
//   row pitch of B to 4 bytes (zeros), so every load is aligned.
// - f32: FFMA, no TF32 (the reference is full fp32): 128 x 128 tiles, K 16
//   at a time, an 8 x 8 block of C a thread, both tiles in shared memory,
//   double-buffered the same way.
// - C is written once: each warp stages its 64 x 32 block through shared
//   memory, 32 rows at a time, and writes whole 128-byte rows of C with
//   16-byte streaming stores (st.global.cs), so the 32.8 GB output moves
//   in full lines and does not evict B's next tile from L2.
#include <cstdint>
#include <cuda_runtime.h>

#include "mma_frag.cuh"

namespace {

constexpr int BM = 128, BN = 128;   // C tile per CTA
constexpr int THREADS = 256;
constexpr int TILE_WORDS = BM * KW; // one operand tile in shared memory (BM == BN)

__device__ __forceinline__ void store4(int32_t* p, const int4& v) {
  __stcs(reinterpret_cast<int4*>(p), v);
}
__device__ __forceinline__ void store4(float* p, const int4& v) {
  __stcs(reinterpret_cast<float4*>(p), *reinterpret_cast<const float4*>(&v));
}

__device__ __forceinline__ void store1(int32_t* p, int32_t x) { __stcs(p, x); }
__device__ __forceinline__ void store1(float* p, float x) { __stcs(p, x); }

// The epilogue stages each warp's C block through shared memory, 32 rows
// at a time, at a pitch of 40 words (the fragment pairs' 8-byte writes are
// then free of bank conflicts), and writes whole 128-byte rows of C.
constexpr int C_PITCH = 40;
constexpr int SMEM_WORDS = 8 * 32 * C_PITCH;  // >= the 2 x 2 operand tiles

// a [m, k] (k * es a multiple of 16 bytes), b [k, ldb] (ldb * es a multiple
// of 4 bytes; columns n..ldb-1 ignored), c [m, n].
template <Elem E>
__global__ void __launch_bounds__(THREADS, 2)
mma_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
           typename Mma<E>::Acc* __restrict__ c, int m, int n, int k, int ldb, int mtiles) {
  using Acc = typename Mma<E>::Acc;
  constexpr int ES = Mma<E>::kEs;
  constexpr int P = 4 / ES;                // K values per 32-bit word
  constexpr int NCG = BN * ES / 4;         // column words of B per tile row
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
  const size_t a_pitch = (size_t)k * ES, b_pitch = (size_t)ldb * ES;
  const int kbytes = k * ES;
  const int nk = (kbytes + KB - 1) / KB;

  uint4 ra[2];
  uint32_t rb[NBLK][P];

  auto load_tile = [&](int kt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // A: 128 rows x 4 chunks of 16 bytes
      const int ci = tid + THREADS * j, row = ci >> 2, q = ci & 3;
      const int kb = kt * KB + q * 16;
      ra[j] = (m0 + row < m && kb < kbytes)
                  ? *reinterpret_cast<const uint4*>(a + (size_t)(m0 + row) * a_pitch + kb)
                  : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < NBLK; ++j) {  // B: KW K-words x NCG column words
      const int bi = tid + THREADS * j, bl = bi & 31, bw = bi >> 5;
      const int kw = (bl & 3) + 4 * (bw & 3), cg = (bl >> 2) + 8 * (bw >> 2);
      const int cb = n0 * ES + cg * 4;  // byte column
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int kr = kt * (KB / ES) + kw * P + i;
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
        for (int nt = 0; nt < 4; ++nt) Mma<E>::run(acc[mt][nt], af[mt], bf[nt]);
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
        store4(p, w);
      } else {
        const Acc* x = reinterpret_cast<const Acc*>(&w);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < n) store1(p + j, x[j]);
      }
    }
    __syncwarp();
  }
}

constexpr int FBK = 16;  // K values per tile (f32 path)

// a [m, k], b [k, n], c [m, n], f32, any shapes.  Thread (ty, tx) computes
// rows {ty*4 + i, 64 + ty*4 + i} x columns {tx*4 + j, 64 + tx*4 + j}.
__global__ void __launch_bounds__(THREADS, 2)
f32_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
           int m, int n, int k, int mtiles) {
  __shared__ __align__(16) float as[2][FBK][BM + 4];  // A^T
  __shared__ __align__(16) float bs[2][FBK][BN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = (int)(blockIdx.x % mtiles) * BM;
  const int n0 = (int)(blockIdx.x / mtiles) * BN;
  const int nk = (k + FBK - 1) / FBK;
  float ra[8], rb[8];

  auto load_tile = [&](int kt) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = tid + THREADS * j;
      const int ar = e >> 4, ak = kt * FBK + (e & 15);
      ra[j] = (m0 + ar < m && ak < k) ? a[(size_t)(m0 + ar) * k + ak] : 0.0f;
      const int bk = kt * FBK + (e >> 7), bc = n0 + (e & 127);
      rb[j] = (bk < k && bc < n) ? b[(size_t)bk * n + bc] : 0.0f;
    }
  };
  auto store_tile = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = tid + THREADS * j;
      as[buf][e & 15][e >> 4] = ra[j];
      bs[buf][e >> 7][e & 127] = rb[j];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  if (nk > 0) {
    load_tile(0);
    store_tile(0);
    __syncthreads();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) load_tile(kt + 1);
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[cur][kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    if (more) store_tile(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      float* p = c + (size_t)row * n + col;
      if (col + 3 < n && (n & 3) == 0) {
        __stcs(reinterpret_cast<float4*>(p),
               make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < n) __stcs(p + j, acc[i][4 * h + j]);
      }
    }
  }
}

// The 1-D grid: M tiles fastest, so consecutive CTAs share one tile of B.
int grid_of(int m, int n, int* mtiles, unsigned* blocks) {
  const long long mt = (m + BM - 1) / BM, nt = (n + BN - 1) / BN;
  if (mt * nt > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  *mtiles = (int)mt;
  *blocks = (unsigned)(mt * nt);
  return 0;
}

template <Elem E>
int launch_mma(const void* a, const void* b, void* c, int m, int n, int k, int ldb, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  int mtiles;
  unsigned blocks;
  if (const int e = grid_of(m, n, &mtiles, &blocks)) return e;
  mma_kernel<E><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<typename Mma<E>::Acc*>(c), m, n, k, ldb, mtiles);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries for ctypes.  Each launches on `stream`, allocates nothing, and
// returns cudaGetLastError() (0 = launched).  Row-major, contiguous:
// a [m, k], b [k, ldb] (n <= ldb), c [m, n].  For int8 and bf16 the wrapper
// guarantees k * elem_size % 16 == 0, ldb * elem_size % 4 == 0 and aligned
// base pointers (a: 16 bytes, b: 4 bytes).
extern "C" int tiled_matmul_i8(const void* a, const void* b, void* c, int m, int n, int k,
                               int ldb, void* stream) {
  return launch_mma<Elem::kI8>(a, b, c, m, n, k, ldb, stream);
}

extern "C" int tiled_matmul_bf16(const void* a, const void* b, void* c, int m, int n, int k,
                                 int ldb, void* stream) {
  return launch_mma<Elem::kBF16>(a, b, c, m, n, k, ldb, stream);
}

// f32: a [m, k], b [k, n], c [m, n]; no alignment needs.
extern "C" int tiled_matmul_f32(const void* a, const void* b, void* c, int m, int n, int k,
                                void* stream) {
  if (m <= 0 || n <= 0) return 0;
  int mtiles;
  unsigned blocks;
  if (const int e = grid_of(m, n, &mtiles, &blocks)) return e;
  f32_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), m, n,
      k, mtiles);
  return (int)cudaGetLastError();
}
