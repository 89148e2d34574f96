// mma.sync fragments shared by the tensor-core kernels: K8's tiled GEMM
// (tiled_matmul.cu) and the hardware probes K12 and K14 (hw_probe.cu).
//
// Operand tiles live in shared memory as [128 rows][16 words] (64 bytes of
// K a row; a word is 4 int8 or 2 bf16 K-neighbours) with the 4-word group
// XOR-swizzled by row bits, so ldmatrix.x4 reads A and B^T fragments free
// of bank conflicts.  B, stored N-contiguous in device memory, is
// transposed on its way to shared memory (BStage, __byte_perm), because the
// mma B operand wants K-contiguous words per column and ldmatrix cannot
// transpose 8-bit data.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KB = 64;              // bytes of K per tile (mma path)
constexpr int KW = KB / 4;          // 32-bit words of K per tile row

// Word offset of (row r, K-word w) in a [128][16]-word tile: the 4-word
// group is XORed with bits 1-4 of r.  A fragment read (8 consecutive rows,
// one word of a group each) then hits 32 distinct banks.
__device__ __forceinline__ int swz(int r, int w) {
  const int h = ((r >> 1) ^ (r >> 3)) & 3;
  return r * KW + ((((w >> 2) ^ h) << 2) | (w & 3));
}

enum class Elem { kI8, kBF16 };

template <Elem E>
struct Mma;

template <>
struct Mma<Elem::kI8> {
  using Acc = int32_t;
  static constexpr int kEs = 1;  // bytes per element
  __device__ __forceinline__ static void run(Acc (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Mma<Elem::kBF16> {
  using Acc = float;
  static constexpr int kEs = 2;
  __device__ __forceinline__ static void run(Acc (&c)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
        "{%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

// Four 8x8 matrices of 16-bit elements (here 16-byte rows of any type) from
// shared memory; lane i gives the address of row i % 8 of matrix i / 8, and
// register j of lane t holds word t % 4 of row t / 4 of matrix j: exactly
// an mma.sync A or B fragment when the rows are its rows.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint32_t* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// B tile transposition: P rows of K in one 32-bit word per column.
template <int P>
struct BStage;

template <>
struct BStage<4> {  // int8: 4 K-rows x 4 columns -> 4 column words
  __device__ __forceinline__ static void transpose(const uint32_t (&w)[4], uint32_t (&o)[4]) {
    const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), hi01 = __byte_perm(w[0], w[1], 0x7362);
    const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140), hi23 = __byte_perm(w[2], w[3], 0x7362);
    o[0] = __byte_perm(lo01, lo23, 0x5410);
    o[1] = __byte_perm(lo01, lo23, 0x7632);
    o[2] = __byte_perm(hi01, hi23, 0x5410);
    o[3] = __byte_perm(hi01, hi23, 0x7632);
  }
};

template <>
struct BStage<2> {  // bf16: 2 K-rows x 2 columns -> 2 column words
  __device__ __forceinline__ static void transpose(const uint32_t (&w)[2], uint32_t (&o)[2]) {
    o[0] = __byte_perm(w[0], w[1], 0x5410);
    o[1] = __byte_perm(w[0], w[1], 0x7632);
  }
};

}  // namespace
