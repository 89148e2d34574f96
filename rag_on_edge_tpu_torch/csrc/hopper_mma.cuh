// Hopper building blocks shared by the kernels that run wgmma fed by TMA:
// K8's bf16 mode (tiled_matmul.cu), K5's bf16 and int8 modes
// (bruteforce_accum.cu), K3's bf16 and int8 modes (bruteforce_fused.cu),
// K1's int8 and bf16 modes (ivf_accum_planes.cu) and K4's, K6's and K7's
// int8 modes and K6's and K7's bf16 modes (ivf_grouped_scan.cu), and the
// tensor-core paths of the probes K12 and K14 (hw_probe.cu); K2
// (fused_topk.cu) takes the mbarrier helpers for its bulk row copies, K13
// (hw_probe.cu) for its ring.
//
// - mbarrier helpers: init, a parity wait (as a C++ loop, and as one PTX
//   loop), a plain arrive and the producer's arrive with an expected
//   transaction byte count; the proxy fence that makes threads' own
//   shared-memory writes visible to wgmma;
// - TMA: one 2-D or 3-D box from a tensor map into shared memory,
//   completing its bytes on an mbarrier (out-of-bounds elements arrive as
//   zeros and count toward the bytes);
// - wgmma: the shared-memory descriptor of a 128-byte-swizzled operand and
//   wgmma.mma_async m64nNk16 bf16 -> f32 for N = 64, 128 and 256, with A
//   K-major and B MN-major (the transpose-B bit), so B is read as it lies
//   N-contiguous in device memory, and for N = 16 and 32 with A MN-major
//   (the transpose-A bit) and B K-major; wgmma.mma_async m64nNk32 s8 -> s32 for
//   N = 16, 32, 64 and 128, with A and B both K-major (8-bit operands have
//   no transpose bit); m64n128k32 s8 and m64n128k16 bf16 with A in
//   registers (K14's twisted resident operand); a copy of a fragment;
// - the in-shared transpose of an N-major int8 slab unit, as TMA lands it,
//   into the K-major swizzled tile an 8-bit wgmma operand must be (K1's B,
//   K4's, K6's and K7's A);
// - the order-preserving int32 key of an fp32 score and its inverse (every
//   float mode's ranking);
// - host: cuTensorMapEncodeTiled through the runtime's entry-point lookup
//   (the libraries link libcudart only), the bf16 and 8-bit tensor maps
//   (128-byte swizzle; an 8-bit 3-D map swizzled or not) and an unswizzled
//   map of 32-bit words.
//
// The accumulator fragment of m64nNk16 (f32) and of m64nNk32 (s32): thread
// t of the warpgroup holds d[i] at row 16 (t / 32) + (t % 32) / 4 + 8 ((i /
// 2) % 2) and column 8 (i / 4) + 2 (t % 4) + i % 2, for i < N / 2.
#pragma once
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The same wait as one PTX loop (the K5 and K3 consumers; their wgmma
// groups stay asynchronous with it).
__device__ __forceinline__ void mbar_wait_loop(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The order-preserving int32 key of an fp32 score (IEEE-754 total order:
// -0 sorts just below +0), as the JAX kernels' _monotone_key.
__device__ __forceinline__ int32_t monotone_key(float x) {
  const int32_t m = __float_as_int(x);
  return m >= 0 ? m : m ^ 0x7FFFFFFF;
}

// Its inverse, as the JAX kernels' _key_to_f32.
__device__ __forceinline__ float key_to_f32(int32_t k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

// Copy an accumulator fragment out with explicit moves, right after its
// wgmma groups retired: code that reads the copy in a loop around wgmma
// keeps the groups asynchronous, where reading the fragment itself has
// ptxas serialize them.
template <int R>
__device__ __forceinline__ void copy_acc(const float (&d)[R], float (&e)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("mov.b32 %0, %1;" : "=f"(e[i]) : "f"(d[i]));
}
template <int R>
__device__ __forceinline__ void copy_acc(const int32_t (&d)[R], int32_t (&e)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("mov.b32 %0, %1;" : "=r"(e[i]) : "r"(d[i]));
}

// Order this thread's generic shared-memory writes before later reads by
// the async proxy (wgmma operands it staged itself); a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One TMA box at element coordinates (c0 innermost, c1) into shared memory
// at `dst`; the copy completes its bytes on `bar`.  Out-of-bounds elements
// arrive as zeros and count toward the bytes.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// The same for a 3-D map (c0 innermost, c1, c2 outermost).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled operand at
// shared address `addr` (1 KB-aligned swizzle atoms): the leading and stride
// byte offsets in 16-byte units, layout type 1 (128B swizzle) in bits 62-63.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// Keep the accumulators in place around the asynchronous wgmma (no copy
// of them may be moved across it).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(int32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D[64 x 64] = A[64 x 16] (K-major) @ B[16 x 64] (MN-major: transpose-B 1),
// plus D where `accumulate` is not 0.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] = A[64 x 16] (K-major) @ B[16 x 128] (MN-major: transpose-B 1),
// plus D where `accumulate` is not 0.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 256] += A[64 x 16] (K-major) @ B[16 x 256] (MN-major: transpose-B 1).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x N] = A[64 x 16] (MN-major: transpose-A 1) @ B[16 x N] (K-major),
// bf16 -> f32, plus D where `accumulate` is not 0, for N = 32 and 16: K6's
// and K7's bf16 modes, whose A is the slab [d, bins] as TMA lands it.
__device__ __forceinline__ void wgmma_m64n32k16_ta(float (&d)[16], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "},"
      " %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_m64n16k16_ta(float (&d)[8], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "},"
      " %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 16] (s32) = A[64 x 32] @ B[32 x 16], both s8 and K-major, plus D
// where `accumulate` is not 0.
__device__ __forceinline__ void wgmma_m64n16k32_s8(int32_t (&d)[8], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "},"
      " %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 32] (s32) = A[64 x 32] @ B[32 x 32], both s8 and K-major, plus D
// where `accumulate` is not 0.
__device__ __forceinline__ void wgmma_m64n32k32_s8(int32_t (&d)[16], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "},"
      " %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (s32) = A[64 x 32] @ B[32 x 64], both s8 and K-major (8-bit
// operands have no transpose bit), plus D where `accumulate` is not 0.
__device__ __forceinline__ void wgmma_m64n64k32_s8(int32_t (&d)[32], uint64_t da, uint64_t db,
                                                  int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "},"
      " %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (s32) = A[64 x 32] @ B[32 x 128], both s8 and K-major, plus D
// where `accumulate` is not 0.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int32_t (&d)[64], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "},"
      " %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same products with A in registers (K-major: the only layout an
// 8-bit A takes from registers): thread t of the warpgroup gives, for its
// rows r = 16 (t / 32) + (t % 32) / 4 and r + 8, the four 32-bit words of
// one 32-byte k-step {row r bytes 4 (t % 4) .. +3, row r + 8 the same,
// row r bytes 16 + 4 (t % 4) .. +3, row r + 8 the same} (for bf16, bytes
// of the two elements 2 (t % 4), +1 and 8 + 2 (t % 4), +1): the layout of
// mma.sync's m16n8k32 / m16n8k16 A fragment, one warp a 16-row slice.
// The registers must not change until the group that reads them retires.
// D[64 x 128] (s32) = A[64 x 32] (registers) @ B[32 x 128] (K-major),
// plus D where `accumulate` is not 0 (the instruction of CUTLASS's 64x128x32
// S32S8S8 RS_TN GMMA atom).
__device__ __forceinline__ void wgmma_m64n128k32_s8_rs(int32_t (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 128] (f32) = A[64 x 16] (registers) @ B[16 x 128] (MN-major: the
// transpose-B bit), bf16, plus D where `accumulate` is not 0 (the
// instruction of CUTLASS's 64x128x16 F32BF16BF16 RS GMMA atom, tnspB set).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// Transpose one int8 unit of a slab [d, blk] (N-major, the JAX layout) for
// wgmma, by a CTA of 256 threads: `raw` holds four TMA boxes [128 d][16 bins]
// (box g: bins 16g..16g+15, `box_words` 32-bit words apart: 512 as TMA
// lands them, 516 where K12 pads a box so that a row's chunks written side
// by side fall on distinct banks), `bk` receives [64 bins][128 d] K-major in the
// 128-byte swizzle (16-byte chunk j of bin row n at j ^ (n % 8)).  Thread
// (warp, lane) takes bin quad m = 2 warp + lane % 2 and d quads q = lane / 2
// and q + 16: four words, a 4 x 4 byte tile, per quad.  It loads row 4q + (k
// ^ r) as word k, r = (q / 2) % 4, so a warp's loads spread over the banks
// (two-way); the selectors undo the rotation.
__device__ __forceinline__ void transpose_unit(const uint32_t* __restrict__ raw, uint8_t* bk,
                                               int box_words = 512) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = (warp << 1) | (lane & 1);
  const int g = m >> 2, w = m & 3;
  const int r = (lane >> 2) & 3;
  // Stage 1 pairs words {0, 1} and {2, 3}; r's low bit swaps each pair's
  // operands, its high bit swaps the pairs (each a selector's nibble ^ 4).
  const uint32_t s1lo = (r & 1) ? 0x1504u : 0x5140u, s1hi = (r & 1) ? 0x3726u : 0x7362u;
  const uint32_t s2a = (r & 2) ? 0x1054u : 0x5410u, s2b = (r & 2) ? 0x3276u : 0x7632u;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int q = (lane >> 1) + 16 * a;
    uint32_t x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = raw[g * box_words + (4 * q + (k ^ r)) * 4 + w];
    const uint32_t lo0 = __byte_perm(x[0], x[1], s1lo), hi0 = __byte_perm(x[0], x[1], s1hi);
    const uint32_t lo1 = __byte_perm(x[2], x[3], s1lo), hi1 = __byte_perm(x[2], x[3], s1hi);
    const uint32_t out[4] = {__byte_perm(lo0, lo1, s2a), __byte_perm(lo0, lo1, s2b),
                             __byte_perm(hi0, hi1, s2a), __byte_perm(hi0, hi1, s2b)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 4 * m + i;  // bin row; word out[i] holds its d 4q .. 4q+3
      *reinterpret_cast<uint32_t*>(bk + n * 128 + ((((q >> 2) ^ (n & 7)) << 4) | ((q & 3) << 2))) =
          out[i];
    }
  }
}


// ------------------------------------------------------------------ host

// cuTensorMapEncodeTiled, a driver function, through the runtime's entry
// point lookup: the library links libcudart only.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                       &found) != cudaSuccess)
    return nullptr;
#else
  if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
      cudaSuccess)
    return nullptr;
#endif
  return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(fn) : nullptr;
}

// A row-major bf16 [rows, cols] matrix at a row pitch of `pitch` elements
// as a 128-byte-swizzled tensor map of [box_rows, 64] boxes.
int bf16_map(EncodeTiled encode, CUtensorMap* map, const void* base, int rows, int cols,
             int pitch, int box_rows) {
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)pitch * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows}, step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dim,
                            stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A bf16 [planes, rows, cols] array, its rows `pitch` elements apart (a
// multiple of 8; 0: cols) and its planes rows * pitch, as a
// 128-byte-swizzled 3-D tensor map of [1, box_rows, 64] boxes: a box never
// crosses a plane, so rows past `rows` and columns past `cols` arrive as
// zeros, not as the next plane's first rows or a row's pad.
int bf16_map_3d(EncodeTiled encode, CUtensorMap* map, const void* base, int planes, int rows,
                int cols, int box_rows, int pitch = 0) {
  if (pitch == 0) pitch = cols;
  const cuuint64_t dim[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t stride[2] = {(cuuint64_t)pitch * 2, (cuuint64_t)rows * pitch * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1}, step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dim,
                            stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A row-major 8-bit [rows, cols] matrix at a row pitch of `pitch` bytes (a
// multiple of 16) as a 128-byte-swizzled tensor map of [box_rows, 128]
// boxes: a K-major operand of the s8 wgmma, 128 k a box.
int int8_map(EncodeTiled encode, CUtensorMap* map, const void* base, long long rows, int cols,
             int pitch, int box_rows) {
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_rows}, step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dim,
                            stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A contiguous 8-bit [planes, rows, cols] array (cols a multiple of 16) as
// a 3-D tensor map of [1, box_rows, box_cols] boxes, 128-byte-swizzled
// (box_cols 128: a K-major wgmma operand) or not: a box never crosses a
// plane, so rows past `rows` and columns past `cols` arrive as zeros.
int int8_map_3d(EncodeTiled encode, CUtensorMap* map, const void* base, int planes, int rows,
                int cols, int box_cols, int box_rows, bool swizzle) {
  const cuuint64_t dim[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t stride[2] = {(cuuint64_t)cols, (cuuint64_t)rows * cols};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1}, step[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dim,
                            stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A row-major array of 32-bit words [rows, cols] (cols a multiple of 4
// where rows > 1) as an unswizzled tensor map of [1, box_cols] boxes: the
// bias words streamed beside K3's, K5's and K1's int8 tiles.  Words past cols
// arrive as zeros.
int word_map(EncodeTiled encode, CUtensorMap* map, const void* base, int rows, int cols,
             int box_cols) {
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)(cols + 3) / 4 * 16};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, 1}, step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<void*>(base), dim,
                            stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace
