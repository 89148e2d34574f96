// Kernel K2 of the IVF search path: exact row top-k by k max-and-mask passes.
//
// Replaces the TPU kernel rag_on_edge_tpu/ops/pallas_topk.py, fused_topk
// (its _kernel, i.e. pallas_bruteforce._extract_topk over a VMEM-resident
// row tile).
//
// What it computes, for each row of x [B, W] (int32, or float32 passed by
// its bits): k passes, each taking the row max and the LOWEST position
// holding it, then masking that position to FILL (INT32_MIN, or -inf).
// Masked positions and entries equal to FILL tie, so once a row holds
// fewer than k values above FILL, every later pass returns the lowest
// position that holds FILL, again and again: by then every position holds
// FILL (an original FILL entry or a masked one), so that is position 0.  In
// float32, -0.0 and +0.0 tie and the lower position wins; a value is
// returned as the element at its position.
//
// What bounds it on the H100: the bytes.  At the slice's join ([8192, 1024]
// int32, k = 20) the matrix is 32 MB, read once, 0.0100 ms at 3.35 TB/s;
// the passes are 20 x 1024 compares a row, 0.0025 ms at the card's 32-bit
// rate.  The first design (one Triton program per 4 rows, three full
// reductions and a select over the resident tile per pass) spent ~60
// operations an element on the passes and reached a tenth of the bound.
//
// Design: one warp per row, the row in shared memory.
// - a lane of the warp copies the row in with one bulk TMA copy
//   (cp.async.bulk, completing on the warp's mbarrier): no registers or
//   instructions are spent on the load, and every warp of the SM has its
//   row in flight at once;
// - lane l owns the 16-byte pieces 32 c + (l ^ (c & 7)) of the row, c <
//   W / 128: a lane's columns ascend with c, one pass over them (conflict-
//   free: a step reads 32 consecutive pieces) gives each lane its best
//   (key, lowest position), and any lane's columns spread over all 32 banks;
// - a pass is two warp reductions, __reduce_max_sync over the lanes' best
//   keys and __reduce_min_sync over the positions of the lanes that hold
//   that key (redux.sync); then the warp re-finds the owner's best among
//   its columns ranked after the one just taken (lane i reads the owner's
//   columns i, i + 32, ...: one load a lane at W = 1024) with two more
//   reductions.  A lane's takes come in rank order, so "ranked after the
//   last take" is exactly "not yet masked": the row is never written;
// - once the max is FILL, every remaining pass returns (FILL, 0);
// - lane p of the warp keeps result p of each group of 32, and the group
//   is stored with one coalesced write per output, so k runs up to W.
// - a row wider than W_MAX (16384) is cut into segments of W_MAX columns
//   by the wrapper (ops/fused_topk.py, segmented_topk): the kernel takes
//   each segment's top-k in place (row pitch ldx), then the top-k of the
//   [B, nseg * k] concatenation of the winners, whose positions map back.
//   Equal values leave a segment in position order and segments lie in
//   column order, so ties stay on the lowest position.
// The float mode reduces on an order-preserving integer key in which -0.0
// and +0.0 are equal (both map to 0).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS_MAX = 8;                        // rows a CTA
constexpr int W_MAX = 16384;                        // the row in shared memory: 64 KB
constexpr int32_t FLOAT_FILL_BITS = (int32_t)0xff800000u;  // -inf

// The reduction key of an element: the int32 itself, or an order-preserving
// map of the float's bits in which -0.0 and +0.0 both map to 0.
template <bool FLOAT>
__device__ __forceinline__ int32_t key_of(int32_t bits) {
  if constexpr (FLOAT) {
    if (bits == INT32_MIN) return 0;  // -0.0 ties with +0.0
    return bits >= 0 ? bits : bits ^ 0x7fffffff;
  } else {
    return bits;
  }
}

// The key of FILL: INT32_MIN, or the key of -inf.
template <bool FLOAT>
__device__ __forceinline__ int32_t fill_key() {
  return FLOAT ? (FLOAT_FILL_BITS ^ 0x7fffffff) : INT32_MIN;
}

// One bulk copy of `bytes` (a multiple of 16, from a 16-byte-aligned source)
// into shared memory at `dst`; it completes its bytes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Keep (key, pos) if its key is larger than bk's: callers start from FILL's
// key (no candidate: FILL entries never enter) and offer positions in
// ascending order, so an equal key keeps the lower position already held.
__device__ __forceinline__ void offer(int32_t key, int pos, int32_t& bk, int& bp) {
  if (key > bk) {
    bk = key;
    bp = pos;
  }
}

// Row `blockIdx.x * warps + warp` of x [b, w] at a row pitch of ldx (w a
// multiple of 128) → out_v, out_i [b, k] (values by their bits, int32
// positions within the row).
template <bool FLOAT>
__global__ void __launch_bounds__(WARPS_MAX * 32)
fused_topk_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out_v,
                  int32_t* __restrict__ out_i, int b, int w, int k, int ldx) {
  extern __shared__ __align__(16) int32_t rows_s[];
  __shared__ __align__(8) uint64_t bar[WARPS_MAX];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= b) return;
  int32_t* const rs = rows_s + (size_t)warp * w;
  const int32_t FILLK = fill_key<FLOAT>();

  if (lane == 0) {
    mbar_init(&bar[warp], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(&bar[warp], (unsigned)w * 4u);
    bulk_load(smem_u32(rs), x + (size_t)row * ldx, (unsigned)w * 4u, &bar[warp]);
  }
  __syncwarp();
  mbar_wait(&bar[warp], 0);

  // Each lane's best (key, lowest position) above FILL over its own columns.
  int32_t bk = FILLK;
  int bp = INT_MAX;
  const int npiece = w >> 7;  // pieces a lane
  const int4* const rs4 = reinterpret_cast<const int4*>(rs);
#pragma unroll 8
  for (int c = 0; c < npiece; ++c) {
    const int piece = 32 * c + (lane ^ (c & 7));
    const int4 v = rs4[piece];
    offer(key_of<FLOAT>(v.x), 4 * piece, bk, bp);
    offer(key_of<FLOAT>(v.y), 4 * piece + 1, bk, bp);
    offer(key_of<FLOAT>(v.z), 4 * piece + 2, bk, bp);
    offer(key_of<FLOAT>(v.w), 4 * piece + 3, bk, bp);
  }

  const int per_lane = w >> 5;  // columns a lane owns
  bool done = false;            // the row holds only FILL (warp-uniform)
  int32_t* const ov = out_v + (size_t)row * k;
  int32_t* const oi = out_i + (size_t)row * k;
  for (int p0 = 0; p0 < k; p0 += 32) {
    const int n = min(32, k - p0);
    int32_t rk = FILLK;
    int rp = 0;
    int q = 0;  // passes taken in this group before the row ran out
    for (; !done && q < n; ++q) {
      const int32_t m = __reduce_max_sync(FULL, bk);
      if (m == FILLK) {
        done = true;
        break;
      }
      const int pos = __reduce_min_sync(FULL, bk == m ? bp : INT_MAX);
      if (lane == q) {
        rk = m;
        rp = pos;
      }
      // The owner of pos re-finds its best among its columns ranked after
      // (m, pos), the warp reading them side by side.
      const int piece = pos >> 2, pc = piece >> 5;
      const int o = (piece & 31) ^ (pc & 7);
      int32_t nk = FILLK;
      int np = INT_MAX;
      for (int j = lane; j < per_lane; j += 32) {
        const int c = j >> 2;
        const int col = 4 * (32 * c + (o ^ (c & 7))) + (j & 3);
        const int32_t kj = key_of<FLOAT>(rs[col]);
        if (kj < m || (kj == m && col > pos)) offer(kj, col, nk, np);
      }
      const int32_t m2 = __reduce_max_sync(FULL, nk);
      const int p2 = __reduce_min_sync(FULL, nk == m2 ? np : INT_MAX);
      if (lane == o) {
        bk = m2;
        bp = p2;
      }
    }
    if (lane < n) {
      const bool took = lane < q;
      const int ps = took ? rp : 0;
      int32_t val;
      if constexpr (FLOAT)
        val = took ? rs[ps] : FLOAT_FILL_BITS;
      else
        val = took ? rk : INT32_MIN;
      ov[p0 + lane] = val;
      oi[p0 + lane] = ps;
    }
  }
}

// The rows a CTA holds at width w: the most resident warps an SM can hold
// (shared memory, registers), ties to more rows a CTA.  Cached per width.
template <bool FLOAT>
int rows_per_cta(int w, int smem_limit) {
  static int cache[W_MAX / 128 + 1] = {0};
  int& got = cache[w / 128];
  if (got) return got;
  int best = 1, best_warps = -1;
  for (int r = 1; r <= WARPS_MAX; ++r) {
    const int smem = r * w * 4;
    if (smem > smem_limit) break;
    int ctas = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fused_topk_kernel<FLOAT>, r * 32,
                                                      smem) != cudaSuccess)
      return -1;
    if (ctas * r >= best_warps) {
      best = r;
      best_warps = ctas * r;
    }
  }
  got = best;
  return got;
}

// The dynamic shared memory a CTA may take on the current device, after
// letting the kernel take it: past 48 KB a launch is refused unless the
// attribute allows it.  The attribute is per device, so it is set once per
// device, on its first call there, and no later call (one under CUDA graph
// capture, say) touches it.  Returns a CUDA error as a negative number.
template <bool FLOAT>
int smem_limit(int dev) {
  constexpr int MAX_DEVICES = 64;
  static int limit[MAX_DEVICES] = {0};
  int optin = 0;
  if (dev < 0 || dev >= MAX_DEVICES) return -(int)cudaErrorInvalidDevice;
  if (!limit[dev]) {
    if (const cudaError_t e =
            cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
      return -(int)e;
    const int lim = optin - (int)(WARPS_MAX * sizeof(uint64_t));
    if (const cudaError_t e = cudaFuncSetAttribute(
            fused_topk_kernel<FLOAT>, cudaFuncAttributeMaxDynamicSharedMemorySize, lim))
      return -(int)e;
    limit[dev] = lim;
  }
  return limit[dev];
}

template <bool FLOAT>
int launch(const void* x, void* vals, void* idx, int b, int w, int k, int ldx, int dev,
           cudaStream_t s) {
  const int lim = smem_limit<FLOAT>(dev);
  if (lim < 0) return -lim;
  if (w * 4 > lim) return (int)cudaErrorInvalidValue;
  const int r = rows_per_cta<FLOAT>(w, lim);
  if (r < 1) return (int)cudaErrorInvalidConfiguration;
  const unsigned grid = (unsigned)((b + r - 1) / r);
  fused_topk_kernel<FLOAT><<<grid, r * 32, (size_t)r * w * 4, s>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(vals), static_cast<int32_t*>(idx), b,
      w, k, ldx);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry for ctypes: x [b, w] int32 (is_float = 0) or float32 by its bits
// (is_float = 1) at a row pitch of ldx elements (a multiple of 4; a column
// segment of a wider matrix), 16-byte aligned; vals [b, k] of x's type and
// idx [b, k] int32, all on device `dev`, and `stream` one of its streams.
// Makes `dev` current for the launch (and
// restores the caller's device), launches on `stream`, allocates nothing,
// and returns cudaGetLastError() (0 = launched).  The wrapper guarantees w
// a multiple of 128 in [128, 16384] and 1 <= k <= w.
extern "C" int fused_topk_rows(const void* x, void* vals, void* idx, int b, int w, int k,
                               int ldx, int is_float, int dev, void* stream) {
  if (b == 0) return 0;
  if (w < 128 || w % 128 || w > W_MAX || k < 1 || k > w || ldx < w || ldx % 4)
    return (int)cudaErrorInvalidValue;
  int cur = 0;
  if (const cudaError_t e = cudaGetDevice(&cur)) return (int)e;
  if (cur != dev)
    if (const cudaError_t e = cudaSetDevice(dev)) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = is_float ? launch<true>(x, vals, idx, b, w, k, ldx, dev, s)
                           : launch<false>(x, vals, idx, b, w, k, ldx, dev, s);
  if (cur != dev) cudaSetDevice(cur);
  return err;
}
