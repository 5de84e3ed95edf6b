// Helpers shared by the port's bf16 tensor-core kernels: fragment loads,
// bf16 packing and the mma.sync m16n8k16 product.
//
// Fragment layout of m16n8k16 (g = lane / 4, c2 = (lane % 4) * 2):
//   A (16x16, row-major): a0 = A[g][c2..c2+1],   a1 = A[g+8][c2..c2+1],
//                         a2 = A[g][c2+8..c2+9], a3 = A[g+8][c2+8..c2+9];
//   B (16x8, k x n):      b0 = B[c2..c2+1][g],   b1 = B[c2+8..c2+9][g];
//   C/D (16x8):           d0, d1 = C[g][c2..c2+1], d2, d3 = C[g+8][c2..c2+1].
// So an accumulator of two neighbouring 16x8 tiles is, packed to bf16, the
// A operand of one 16-deep k-step, and B is read from a tile stored
// [n][k] (k contiguous) as 32-bit pairs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats as a bf16 pair, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, column-major)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows [0, 16) and columns [0, 16) of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile,
                                       int ld, int g, int c2) {
  const __nv_bfloat16* base = tile + g * ld + c2;
  a[0] = ld32(base);
  a[1] = ld32(base + 8 * ld);
  a[2] = ld32(base + 8);
  a[3] = ld32(base + 8 * ld + 8);
}

// A bf16 view whose start and (b, s, h) element strides are 16-byte
// aligned: every row can be staged with 16-byte vector loads.
inline bool aligned16(const void* ptr, int64_t sb, int64_t ss, int64_t sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 8 == 0 && ss % 8 == 0 &&
         sh % 8 == 0;
}

}  // namespace
