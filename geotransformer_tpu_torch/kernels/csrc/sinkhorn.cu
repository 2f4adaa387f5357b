// Log-domain Sinkhorn iterations for Hopper (sm_90a), one block per patch.
//
// Replaces geotransformer_tpu/kernels/sinkhorn.py:sinkhorn_log_iterations
// (pallas_call at :85; body _sinkhorn_kernel :28): for each patch, T rounds of
//   u = log_mu - logsumexp_n(S + v),  v = log_nu - logsumexp_m(S + u)
// and the result S + u + v. Masked slots hold -1e12 (finite), so empty
// padded patches stay finite exactly as in the JAX versions.
//
// What bounds it here: latency, not bytes or FLOPs. A patch is at most
// 65 x 65 f32 (17 KB); the XLA scan streams it from memory twice per
// iteration, this kernel reads it once, keeps it in shared memory for all
// iterations, and writes the result once. Each row / column logsumexp is
// one warp (max, then sum of exp, by shuffle reductions); 8 warps share the
// rows, then the columns, with a barrier between the two half-steps. The
// row stride N1 = 65 is odd, so a warp walking a column hits 32 distinct
// banks.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kThreads) sinkhorn_kernel(
    const float* __restrict__ scores,  // (P, M1, N1)
    const float* __restrict__ log_mu,  // (P, M1)
    const float* __restrict__ log_nu,  // (P, N1)
    float* __restrict__ out,           // (P, M1, N1)
    int M1, int N1, int iterations) {
  extern __shared__ float smem[];
  float* s = smem;       // (M1, N1)
  float* u = s + M1 * N1;
  float* v = u + M1;
  float* lmu = v + N1;
  float* lnu = lmu + M1;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t base = static_cast<size_t>(blockIdx.x) * M1 * N1;

  for (int e = tid; e < M1 * N1; e += kThreads) s[e] = scores[base + e];
  for (int m = tid; m < M1; m += kThreads) {
    u[m] = 0.0f;
    lmu[m] = log_mu[static_cast<size_t>(blockIdx.x) * M1 + m];
  }
  for (int n = tid; n < N1; n += kThreads) {
    v[n] = 0.0f;
    lnu[n] = log_nu[static_cast<size_t>(blockIdx.x) * N1 + n];
  }
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    for (int m = warp; m < M1; m += kWarps) {
      const float* row = s + m * N1;
      float mx = -INFINITY;
      for (int n = lane; n < N1; n += 32) mx = fmaxf(mx, row[n] + v[n]);
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int n = lane; n < N1; n += 32) sum += expf(row[n] + v[n] - mx);
      sum = warp_sum(sum);
      if (lane == 0) u[m] = lmu[m] - (mx + logf(sum));
    }
    __syncthreads();
    for (int n = warp; n < N1; n += kWarps) {
      float mx = -INFINITY;
      for (int m = lane; m < M1; m += 32) mx = fmaxf(mx, s[m * N1 + n] + u[m]);
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int m = lane; m < M1; m += 32) sum += expf(s[m * N1 + n] + u[m] - mx);
      sum = warp_sum(sum);
      if (lane == 0) v[n] = lnu[n] - (mx + logf(sum));
    }
    __syncthreads();
  }

  for (int e = tid; e < M1 * N1; e += kThreads) {
    out[base + e] = s[e] + u[e / N1] + v[e % N1];
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int sinkhorn_launch(const float* scores, const float* log_mu, const float* log_nu,
                    float* out, int P, int M1, int N1, int iterations,
                    void* stream) {
  if (M1 < 1 || N1 < 1 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return 0;
  const size_t smem = sizeof(float) * (static_cast<size_t>(M1) * N1 + 2 * M1 + 2 * N1);
  cudaError_t err = cudaFuncSetAttribute(
      sinkhorn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sinkhorn_kernel<<<P, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      scores, log_mu, log_nu, out, M1, N1, iterations);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
