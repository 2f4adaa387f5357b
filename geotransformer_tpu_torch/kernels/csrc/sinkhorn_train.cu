// Log-domain Sinkhorn for training, forward and backward, for Hopper
// (sm_90a), one block per patch.
//
// Replaces geotransformer_tpu/kernels/sinkhorn.py:_fwd_train (pallas_call at
// :211, body _sinkhorn_fwd_train_kernel :127) and _bwd_train (pallas_call at
// :245, body _sinkhorn_bwd_kernel :146), the custom_vjp of
// sinkhorn_log_iterations_train.
//
// Forward: the inference kernel's iteration (sinkhorn.cu), same arithmetic in
// the same order, so `out` is bitwise the inference result; before iteration
// k it also stores v_{k-1} (v_hist[k], N1 floats) — the only state the
// reverse sweep cannot rebuild cheaply.
//
// Backward: the exact reverse of the T iterations (JAX :152-183). For
// k = T-1 .. 0, with v_prev = v_hist[k]:
//   u_k   = log_mu - LSE_n(S + v_prev)              (recomputed)
//   dnu  += dv;  A = softmax_m(S + u_k);  dS -= A dv;  du -= sum_n A dv
//   dmu  += du;  B = softmax_n(S + v_prev); dS -= B du; dv = -sum_m B du; du = 0
// starting from dS = dout, du = sum_n dout, dv = sum_m dout. S and dS (2 x 17
// KB at 65 x 65) stay in shared memory for all T iterations; each row or
// column reduction is one warp, with a barrier between passes.
//
// What bounds it: latency. A patch is ~4k elements, each iteration is 2
// (forward) or 4 (backward) barrier-separated passes of exp and warp
// reductions; bytes (the scores once in, once out) are a few MB for the whole
// call. Masked slots hold -1e12 (finite): every exponent difference stays
// finite, so masked rows and columns give finite values, never NaN.

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

__global__ void __launch_bounds__(kThreads) sinkhorn_fwd_train_kernel(
    const float* __restrict__ scores,  // (P, M1, N1)
    const float* __restrict__ log_mu,  // (P, M1)
    const float* __restrict__ log_nu,  // (P, N1)
    float* __restrict__ out,           // (P, M1, N1)
    float* __restrict__ v_hist,        // (P, T, N1)
    int M1, int N1, int iterations) {
  extern __shared__ float smem[];
  float* s = smem;  // (M1, N1)
  float* u = s + M1 * N1;
  float* v = u + M1;
  float* lmu = v + N1;
  float* lnu = lmu + M1;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t base = static_cast<size_t>(blockIdx.x) * M1 * N1;
  float* hist = v_hist + static_cast<size_t>(blockIdx.x) * iterations * N1;

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
    for (int n = tid; n < N1; n += kThreads) hist[static_cast<size_t>(it) * N1 + n] = v[n];
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

__global__ void __launch_bounds__(kThreads) sinkhorn_bwd_train_kernel(
    const float* __restrict__ scores,  // (P, M1, N1)
    const float* __restrict__ log_mu,  // (P, M1)
    const float* __restrict__ v_hist,  // (P, T, N1)
    const float* __restrict__ dout,    // (P, M1, N1)
    float* __restrict__ d_scores,      // (P, M1, N1)
    float* __restrict__ d_mu,          // (P, M1)
    float* __restrict__ d_nu,          // (P, N1)
    int M1, int N1, int iterations) {
  extern __shared__ float smem[];
  float* s = smem;              // (M1, N1)
  float* ds = s + M1 * N1;      // (M1, N1)
  float* lmu = ds + M1 * N1;    // (M1,)
  float* u = lmu + M1;          // u_k
  float* lse_n = u + M1;        // LSE_n(S + v_prev) per row
  float* du = lse_n + M1;
  float* dmu = du + M1;
  float* vp = dmu + M1;         // v_prev (N1,)
  float* lse_m = vp + N1;       // LSE_m(S + u_k) per column
  float* dv = lse_m + N1;
  float* dnu = dv + N1;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t base = static_cast<size_t>(blockIdx.x) * M1 * N1;
  const float* hist = v_hist + static_cast<size_t>(blockIdx.x) * iterations * N1;

  for (int e = tid; e < M1 * N1; e += kThreads) {
    s[e] = scores[base + e];
    ds[e] = dout[base + e];
  }
  for (int m = tid; m < M1; m += kThreads) {
    lmu[m] = log_mu[static_cast<size_t>(blockIdx.x) * M1 + m];
    dmu[m] = 0.0f;
  }
  for (int n = tid; n < N1; n += kThreads) dnu[n] = 0.0f;
  __syncthreads();
  // du = sum_n dout, dv = sum_m dout
  for (int m = warp; m < M1; m += kWarps) {
    float acc = 0.0f;
    for (int n = lane; n < N1; n += 32) acc += ds[m * N1 + n];
    acc = warp_sum(acc);
    if (lane == 0) du[m] = acc;
  }
  for (int n = warp; n < N1; n += kWarps) {
    float acc = 0.0f;
    for (int m = lane; m < M1; m += 32) acc += ds[m * N1 + n];
    acc = warp_sum(acc);
    if (lane == 0) dv[n] = acc;
  }
  __syncthreads();

  for (int it = iterations - 1; it >= 0; --it) {
    for (int n = tid; n < N1; n += kThreads) vp[n] = hist[static_cast<size_t>(it) * N1 + n];
    __syncthreads();
    // 1. rows: lse_n = LSE_n(S + v_prev), u_k = log_mu - lse_n
    for (int m = warp; m < M1; m += kWarps) {
      const float* row = s + m * N1;
      float mx = -INFINITY;
      for (int n = lane; n < N1; n += 32) mx = fmaxf(mx, row[n] + vp[n]);
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int n = lane; n < N1; n += 32) sum += expf(row[n] + vp[n] - mx);
      sum = warp_sum(sum);
      if (lane == 0) {
        const float l = mx + logf(sum);
        lse_n[m] = l;
        u[m] = lmu[m] - l;
      }
    }
    __syncthreads();
    // 2. columns: lse_m = LSE_m(S + u_k); dnu += dv
    for (int n = warp; n < N1; n += kWarps) {
      float mx = -INFINITY;
      for (int m = lane; m < M1; m += 32) mx = fmaxf(mx, s[m * N1 + n] + u[m]);
      mx = warp_max(mx);
      float sum = 0.0f;
      for (int m = lane; m < M1; m += 32) sum += expf(s[m * N1 + n] + u[m] - mx);
      sum = warp_sum(sum);
      if (lane == 0) {
        lse_m[n] = mx + logf(sum);
        dnu[n] += dv[n];
      }
    }
    __syncthreads();
    // 3. rows: g = A dv, dS -= g, du -= sum_n g, dmu += du; then h = B du, dS -= h
    for (int m = warp; m < M1; m += kWarps) {
      const float* row = s + m * N1;
      float* drow = ds + m * N1;
      const float um = u[m];
      const float du_in = du[m];  // read before the shuffle: lane 0 rewrites it below
      float acc = 0.0f;
      for (int n = lane; n < N1; n += 32) {
        const float g = expf(row[n] + um - lse_m[n]) * dv[n];
        drow[n] -= g;
        acc += g;
      }
      acc = warp_sum(acc);
      const float dum = du_in - acc;
      const float ln = lse_n[m];
      for (int n = lane; n < N1; n += 32) drow[n] -= expf(row[n] + vp[n] - ln) * dum;
      if (lane == 0) {
        du[m] = dum;
        dmu[m] += dum;
      }
    }
    __syncthreads();
    // 4. columns: dv_{k-1} = -sum_m B du; then du = 0
    for (int n = warp; n < N1; n += kWarps) {
      const float vn = vp[n];
      float acc = 0.0f;
      for (int m = lane; m < M1; m += 32) acc += expf(s[m * N1 + n] + vn - lse_n[m]) * du[m];
      acc = warp_sum(acc);
      if (lane == 0) dv[n] = -acc;
    }
    __syncthreads();
    for (int m = tid; m < M1; m += kThreads) du[m] = 0.0f;
    // (the next iteration's first barrier orders this before du is read)
  }

  for (int e = tid; e < M1 * N1; e += kThreads) d_scores[base + e] = ds[e];
  for (int m = tid; m < M1; m += kThreads) d_mu[static_cast<size_t>(blockIdx.x) * M1 + m] = dmu[m];
  for (int n = tid; n < N1; n += kThreads) d_nu[static_cast<size_t>(blockIdx.x) * N1 + n] = dnu[n];
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int sinkhorn_fwd_train_launch(const float* scores, const float* log_mu, const float* log_nu,
                              float* out, float* v_hist, int P, int M1, int N1, int iterations,
                              void* stream) {
  if (M1 < 1 || N1 < 1 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return 0;
  const size_t smem = sizeof(float) * (static_cast<size_t>(M1) * N1 + 2 * M1 + 2 * N1);
  cudaError_t err = cudaFuncSetAttribute(sinkhorn_fwd_train_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sinkhorn_fwd_train_kernel<<<P, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      scores, log_mu, log_nu, out, v_hist, M1, N1, iterations);
  return static_cast<int>(cudaGetLastError());
}

int sinkhorn_bwd_train_launch(const float* scores, const float* log_mu, const float* v_hist,
                              const float* dout, float* d_scores, float* d_mu, float* d_nu,
                              int P, int M1, int N1, int iterations, void* stream) {
  if (M1 < 1 || N1 < 1 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return 0;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(M1) * N1 + 5 * M1 + 4 * N1);
  cudaError_t err = cudaFuncSetAttribute(sinkhorn_bwd_train_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sinkhorn_bwd_train_kernel<<<P, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      scores, log_mu, v_hist, dout, d_scores, d_mu, d_nu, M1, N1, iterations);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
