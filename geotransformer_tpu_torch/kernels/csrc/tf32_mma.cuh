// f32 products on Hopper's tensor cores (3xTF32) and cp.async staging: the
// helpers that attention.cu, the KPConv kernels (kpconv_common.cuh) and
// gse_bwd.cu share.
//
// mma.sync m16n8k8 TF32 keeps 10 mantissa bits of each operand. Splitting an
// f32 value x into big = tf32(x) and small = tf32(x - big) and summing the
// three products small * big + big * small + big * big drops only
// small * small (~2^-22 |x y|), which keeps the sum at f32 accuracy.
// Fragment layout of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row): a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4],
//                    a3 = A[g + 8][t + 4]
//   B (8 x 8, col):  b0 = B[t][g], b1 = B[t + 4][g]
//   C (16 x 8):      c0 = C[g][2t], c1 = C[g][2t + 1], c2 = C[g + 8][2t],
//                    c3 = C[g + 8][2t + 1]

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronous; zeros where !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(shared_address(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(shared_address(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// x = big + small + O(2^-22 |x|), both halves TF32 (cvt.rna: round to
// nearest, ties away, the low 13 bits zero); x - big is exact in f32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(x - __uint_as_float(big)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += a b to about f32 accuracy (3xTF32): the two cross terms, then the
// big product, into a fresh tile that one f32 add brings into acc
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(t, a_small, b_big);
  mma_tf32(t, a_big, b_small);
  mma_tf32(t, a_big, b_big);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}
