// What the geometric structure embedding's forward (gse.cu) and backward
// (gse_bwd.cu) share: the pair indices, bit for bit, and the 3xTF32
// tensor-core helpers over TF32 halves stored once (and the one-pass
// helper of the forward's bfloat16 instances).

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tf32_mma.cuh"

// The offset v = p_j - p_i of pair (i, j), by subtraction.
__device__ __forceinline__ float3 pair_offset(const float* __restrict__ points, int i, int j) {
  return make_float3(points[3 * j + 0] - points[3 * i + 0], points[3 * j + 1] - points[3 * i + 1],
                     points[3 * j + 2] - points[3 * i + 2]);
}

// Distance index of a pair: |v| / sigma_d.
__device__ __forceinline__ float distance_index(float3 v, float sigma_d) {
  return sqrtf(v.x * v.x + v.y * v.y + v.z * v.z) / sigma_d;
}

// Angle index k (of A) of a pair (i, j) from its offset v. The angle is
// rounded one operation at a time (no contraction into FMAs), in the order
// the plain version (kernels/gse.py:_pair_indices) writes it: forward,
// backward and plain version take bit-identical angle indices, so a
// projection tie is settled on the same numbers. The + 0 turns a -0 dot
// product (v = 0 on the diagonal) into +0: atan2(+0, -0) would be pi, the
// XLA path's diagonal angle is 0.
__device__ __forceinline__ float angle_index(float3 v, const float* __restrict__ ref_vectors,
                                             int i, int k, int A, float factor_a) {
  const float* u = ref_vectors + (static_cast<size_t>(i) * A + k) * 3;
  const float cx = __fsub_rn(__fmul_rn(u[1], v.z), __fmul_rn(u[2], v.y));
  const float cy = __fsub_rn(__fmul_rn(u[2], v.x), __fmul_rn(u[0], v.z));
  const float cz = __fsub_rn(__fmul_rn(u[0], v.y), __fmul_rn(u[1], v.x));
  const float s = __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy)), __fmul_rn(cz, cz)));
  const float c = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(u[0], v.x), __fmul_rn(u[1], v.y)), __fmul_rn(u[2], v.z)),
      0.0f);
  return __fmul_rn(atan2f(s, c), factor_a);
}

// Distance index (idx[A]) and angle indices (idx[0..A-1]) of pair (i, j).
__device__ __forceinline__ void pair_indices(const float* __restrict__ points,
                                             const float* __restrict__ ref_vectors,
                                             int i, int j, int A, float sigma_d,
                                             float factor_a, float* idx) {
  const float3 v = pair_offset(points, i, j);
  idx[A] = distance_index(v, sigma_d);
  for (int k = 0; k < A; ++k) idx[k] = angle_index(v, ref_vectors, i, k, A, factor_a);
}

// Round x up to a multiple of m.
__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// x as its two TF32 halves at big[at], small[at]
__device__ __forceinline__ void store_split(uint32_t* big, uint32_t* small, int at, float x) {
  uint32_t b, s;
  split_tf32(x, b, s);
  big[at] = b;
  small[at] = s;
}

// acc[m N + n] += a[m] b[n] for M x N independent 16 x 8
// tiles, each as 3xTF32 into a fresh tile that one f32 add brings into the
// accumulator (mma_3xtf32's sums), the M N chains issued interleaved so
// that no mma waits on the one before it
template <int M, int N>
__device__ __forceinline__ void mma_3xtf32_grid(float (&acc)[M * N][4],
                                                const uint32_t (&a_big)[M][4],
                                                const uint32_t (&a_small)[M][4],
                                                const uint32_t (&b_big)[N][2],
                                                const uint32_t (&b_small)[N][2]) {
  float t[M * N][4];
#pragma unroll
  for (int i = 0; i < M * N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) t[i][e] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < M * N; ++i) mma_tf32(t[i], a_small[i / N], b_big[i % N]);
#pragma unroll
  for (int i = 0; i < M * N; ++i) mma_tf32(t[i], a_big[i / N], b_small[i % N]);
#pragma unroll
  for (int i = 0; i < M * N; ++i) mma_tf32(t[i], a_big[i / N], b_big[i % N]);
#pragma unroll
  for (int i = 0; i < M * N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += t[i][e];
  }
}

// acc[m N + n] += a[m] b[n] in one TF32 pass, for operands that are TF32
// values already (the bfloat16 point's bases and weights: each product is
// then exact), into a fresh tile as mma_3xtf32_grid, so the tensor cores'
// truncating sums run over a step's terms only
template <int M, int N>
__device__ __forceinline__ void mma_tf32_grid(float (&acc)[M * N][4], const uint32_t (&a)[M][4],
                                              const uint32_t (&b)[N][2]) {
  float t[M * N][4];
#pragma unroll
  for (int i = 0; i < M * N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) t[i][e] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < M * N; ++i) mma_tf32(t[i], a[i / N], b[i % N]);
#pragma unroll
  for (int i = 0; i < M * N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += t[i][e];
  }
}
