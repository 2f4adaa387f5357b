// Geometric structure embedding for Hopper (sm_90a), f32 on the CUDA cores.
//
// Replaces geotransformer_tpu/kernels/gse.py:gse_embedding_full (pallas_call
// at :262; body _gse_full_kernel :132, geometry _tile_indices :85). For each
// pair (i, j) of one cloud's superpoints:
//   d      = |p_j - p_i| / sigma_d
//   a_k    = atan2(|u_ik x v|, u_ik . v) * 180 / (sigma_a pi),  v = p_j - p_i
//   e[i,j] = sincos(d) @ W_d + max_k sincos(a_k) @ W_a + b_d + b_a
// where sincos(x) is the interleaved basis [sin(x w_0), cos(x w_0), ...].
//
// What bounds it here: the four (pairs x 256) @ (256 x 256) basis
// projections, ~0.5 MFLOP per pair (~0.05 TFLOP per cloud at 3DMatch size),
// done here in f32 FMA. A block takes one row i and 32 columns j; the basis
// of those 32 pairs is built chunk by chunk (32 basis rows at a time) in
// shared memory next to the matching 32 rows of W, and each thread keeps a
// 4-pair x C/32-channel register tile of the running projection and of the
// running max over the k angle projections. W is read from L2 once per
// block and projection pass. The (N, N, C) output is written once, f32 (the
// JAX kernel stores bf16, EMBED_DTYPE at kernels/gse.py:36). Tensor cores
// (bf16 wgmma) are the later redesign's work.
//
// Geometry is direct: v = p_j - p_i by subtraction, the angle by atan2f of
// the cross and dot products, so the diagonal (v = 0) gives angle 0 exactly
// as the XLA path does; sincosf/atan2f replace the TPU kernel's polynomial
// sin/cos/atan2 (Mosaic had no inverse trig). The interleaved basis indexes
// W's rows directly, with no sin-row / cos-row split. Pairs outside the
// valid rectangle [0, n_valid)^2 are written as zeros, and blocks entirely
// outside it do nothing else (the valid-rectangle skip).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 32;      // pairs (columns j) per block
constexpr int kChunk = 32;      // basis rows per shared-memory chunk
constexpr int kMaxAngles = 4;   // angle_k
constexpr int kMaxChannels = 256;

template <int CPT>  // channels per thread; C = 32 * CPT
__global__ void __launch_bounds__(kThreads) gse_kernel(
    const float* __restrict__ points,       // (N, 3)
    const float* __restrict__ ref_vectors,  // (N, A, 3)
    const float* __restrict__ w_d,          // (C, C) rows = basis dims
    const float* __restrict__ w_a,          // (C, C)
    const float* __restrict__ bias,         // (C,) = b_d + b_a
    const float* __restrict__ div_term,     // (C / 2,)
    const int32_t* __restrict__ n_valid,    // scalar
    float* __restrict__ out,                // (N, N, C)
    int N, int A, float sigma_d, float factor_a) {
  constexpr int C = 32 * CPT;
  __shared__ float idx_s[kMaxAngles + 1][kPairs];
  __shared__ float basis_s[kPairs][kChunk];
  __shared__ float w_s[kChunk * C];

  const int tid = threadIdx.x;
  const int i = blockIdx.y;
  const int j0 = blockIdx.x * kPairs;
  const int pairs = min(kPairs, N - j0);
  const int nv = min(*n_valid, N);
  float* out_tile = out + (static_cast<size_t>(i) * N + j0) * C;

  if (i >= nv || j0 >= nv) {
    for (int e = tid; e < pairs * C; e += kThreads) out_tile[e] = 0.0f;
    return;
  }

  if (tid < kPairs) {
    const int j = j0 + tid;
    float d_idx = 0.0f;
    float a_idx[kMaxAngles] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (j < N) {
      const float vx = points[3 * j + 0] - points[3 * i + 0];
      const float vy = points[3 * j + 1] - points[3 * i + 1];
      const float vz = points[3 * j + 2] - points[3 * i + 2];
      d_idx = sqrtf(vx * vx + vy * vy + vz * vz) / sigma_d;
      for (int k = 0; k < A; ++k) {
        const float* u = ref_vectors + (static_cast<size_t>(i) * A + k) * 3;
        const float cx = u[1] * vz - u[2] * vy;
        const float cy = u[2] * vx - u[0] * vz;
        const float cz = u[0] * vy - u[1] * vx;
        const float s = sqrtf(cx * cx + cy * cy + cz * cz);
        // + 0.0f turns a -0 dot product (v = 0 on the diagonal) into +0:
        // atan2(+0, -0) would be pi, the XLA path's diagonal angle is 0
        const float c = (u[0] * vx + u[1] * vy + u[2] * vz) + 0.0f;
        a_idx[k] = atan2f(s, c) * factor_a;
      }
    }
    for (int k = 0; k < kMaxAngles; ++k) idx_s[k][tid] = a_idx[k];
    idx_s[A][tid] = d_idx;
  }

  const int pg = tid / 32;  // pairs 4 pg .. 4 pg + 3 (one warp shares them)
  const int cl = tid % 32;  // channels cl + 32 jj
  float amax[4][CPT];
  float cur[4][CPT];

  // Passes 0 .. A-1 project the angle bases with W_a and fold their max;
  // pass A projects the distance basis with W_d.
  for (int pass = 0; pass <= A; ++pass) {
    const float* w = pass < A ? w_a : w_d;
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) cur[pp][jj] = 0.0f;
    }
    for (int f0 = 0; f0 < C; f0 += kChunk) {
      __syncthreads();  // idx_s written / previous chunk consumed
      for (int e = tid; e < kPairs * kChunk / 2; e += kThreads) {
        const int p = e / (kChunk / 2);
        const int fr = e % (kChunk / 2);
        float s, c;
        sincosf(idx_s[pass][p] * div_term[f0 / 2 + fr], &s, &c);
        basis_s[p][2 * fr] = s;
        basis_s[p][2 * fr + 1] = c;
      }
      for (int e = tid; e < kChunk * C; e += kThreads) {
        w_s[e] = w[static_cast<size_t>(f0) * C + e];
      }
      __syncthreads();
#pragma unroll 4
      for (int ff = 0; ff < kChunk; ++ff) {
        float wv[CPT];
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj) wv[jj] = w_s[ff * C + cl + 32 * jj];
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          const float b = basis_s[4 * pg + pp][ff];
#pragma unroll
          for (int jj = 0; jj < CPT; ++jj) cur[pp][jj] = fmaf(b, wv[jj], cur[pp][jj]);
        }
      }
    }
    if (pass < A) {
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj) {
          amax[pp][jj] = pass == 0 ? cur[pp][jj] : fmaxf(amax[pp][jj], cur[pp][jj]);
        }
      }
    }
  }

#pragma unroll
  for (int pp = 0; pp < 4; ++pp) {
    const int p = 4 * pg + pp;
    const int j = j0 + p;
    if (p >= pairs) continue;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) {
      const int c = cl + 32 * jj;
      out_tile[static_cast<size_t>(p) * C + c] =
          j < nv ? cur[pp][jj] + amax[pp][jj] + bias[c] : 0.0f;
    }
  }
}

template <int CPT>
int launch(const float* points, const float* ref_vectors, const float* w_d,
           const float* w_a, const float* bias, const float* div_term,
           const int32_t* n_valid, float* out, int N, int A, float sigma_d,
           float factor_a, cudaStream_t stream) {
  const dim3 grid((N + kPairs - 1) / kPairs, N);
  gse_kernel<CPT><<<grid, kThreads, 0, stream>>>(
      points, ref_vectors, w_d, w_a, bias, div_term, n_valid, out, N, A,
      sigma_d, factor_a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int gse_embedding_launch(const float* points, const float* ref_vectors,
                         const float* w_d, const float* w_a, const float* bias,
                         const float* div_term, const int32_t* n_valid,
                         float* out, int N, int A, int C, float sigma_d,
                         float factor_a, void* stream) {
  if (A < 1 || A > kMaxAngles || C > kMaxChannels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return launch<1>(points, ref_vectors, w_d, w_a, bias, div_term, n_valid, out, N, A, sigma_d, factor_a, s);
    case 64: return launch<2>(points, ref_vectors, w_d, w_a, bias, div_term, n_valid, out, N, A, sigma_d, factor_a, s);
    case 128: return launch<4>(points, ref_vectors, w_d, w_a, bias, div_term, n_valid, out, N, A, sigma_d, factor_a, s);
    case 256: return launch<8>(points, ref_vectors, w_d, w_a, bias, div_term, n_valid, out, N, A, sigma_d, factor_a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
