// What the geometric structure embedding's forward (gse.cu) and backward
// (gse_bwd.cu) share: the pair indices, bit for bit, and the 3xTF32
// tensor-core helpers over TF32 halves stored once.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tf32_mma.cuh"

// Distance index (idx[A]) and angle indices (idx[0..A-1]) of pair (i, j).
// The angles are rounded one operation at a time (no contraction into FMAs),
// in the order the plain version (kernels/gse.py:_pair_indices) writes them:
// forward, backward and plain version take bit-identical angle indices, so a
// projection tie is settled on the same numbers. The + 0 turns a -0 dot
// product (v = 0 on the diagonal) into +0: atan2(+0, -0) would be pi, the
// XLA path's diagonal angle is 0.
__device__ __forceinline__ void pair_indices(const float* __restrict__ points,
                                             const float* __restrict__ ref_vectors,
                                             int i, int j, int A, float sigma_d,
                                             float factor_a, float* idx) {
  const float vx = points[3 * j + 0] - points[3 * i + 0];
  const float vy = points[3 * j + 1] - points[3 * i + 1];
  const float vz = points[3 * j + 2] - points[3 * i + 2];
  idx[A] = sqrtf(vx * vx + vy * vy + vz * vz) / sigma_d;
  for (int k = 0; k < A; ++k) {
    const float* u = ref_vectors + (static_cast<size_t>(i) * A + k) * 3;
    const float cx = __fsub_rn(__fmul_rn(u[1], vz), __fmul_rn(u[2], vy));
    const float cy = __fsub_rn(__fmul_rn(u[2], vx), __fmul_rn(u[0], vz));
    const float cz = __fsub_rn(__fmul_rn(u[0], vy), __fmul_rn(u[1], vx));
    const float s = __fsqrt_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy)), __fmul_rn(cz, cz)));
    const float c = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(u[0], vx), __fmul_rn(u[1], vy)), __fmul_rn(u[2], vz)),
        0.0f);
    idx[k] = __fmul_rn(atan2f(s, c), factor_a);
  }
}

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
