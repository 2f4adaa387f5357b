// Log-domain Sinkhorn for training, the backward, for Hopper (sm_90a), one
// block per patch.
//
// Replaces geotransformer_tpu/kernels/sinkhorn.py:_bwd_train (pallas_call at
// :245, body _sinkhorn_bwd_kernel :146), the backward of the custom_vjp of
// sinkhorn_log_iterations_train; its forward, _fwd_train, is the inference
// kernel storing v before each iteration (sinkhorn.cu, STORE_HIST).
//
// Backward: the exact reverse of the T iterations (JAX :152-183). For
// k = T-1 .. 0, with v_prev = v_hist[k]:
//   u_k   = log_mu - LSE_n(S + v_prev)              (recomputed)
//   dnu  += dv;  A = softmax_m(S + u_k);  dS -= A dv;  du -= sum_n A dv
//   dmu  += du;  B = softmax_n(S + v_prev); dS -= B du; dv = -sum_m B du; du = 0
// starting from dS = dout, du = sum_n dout, dv = sum_m dout. 32 warps a
// patch, each owning a fixed set of rows, dS in registers and S in shared
// memory; the row passes of iteration k and the row LSE of iteration k - 1
// share one sweep, followed by one merge of the warps' column partials (the
// column LSE and dv): two barriers an iteration (see
// sinkhorn_bwd_train_kernel).
//
// Those instances hold a lane's dS entries in registers (SLOTS <= 5: M1,
// N1 <= 160). Any other shape takes sinkhorn_bwd_general_kernel: the same
// sweep and merge, in the same order, with no register arrays: dS in the
// d_scores output itself (each entry read and written by the one lane that
// owns it), the row state and the vectors in shared memory, v_hist read
// from global memory, S in shared memory where it fits and else read from
// global memory (L2) every iteration, and the three (32, N1) column
// partials in shared memory where they fit, else in a global scratch the
// wrapper allocates. The wrapper alone picks the instance and where the
// general kernel keeps S and the partials (kernels/sinkhorn.py:
// backward_route); the launch only checks that they fit.
// tests/test_torch_sinkhorn_bwd_order.py emulates the order at any shape.
//
// What bounds it: latency. A patch is ~17k elements at 129 x 129, and each
// iteration is a chain of warp reductions and barriers: a sweep and a
// merge. Bytes (the scores once in, once out) are a few MB for the whole
// call.
// Masked slots hold -1e12 (finite): every exponent difference stays finite,
// so masked rows and columns give finite values, never NaN.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "launch_common.cuh"

namespace {

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

// --- backward: one row sweep and one column merge an iteration -----------
//
// A block of kBwdWarps warps takes one patch. Warp w owns rows w + W r
// (r < SLOTS) for the whole call, lane l the columns l + 32 j (j < SLOTS);
// dS of those entries stays in the lane's registers, S in shared memory.
// Iteration k's row passes and iteration k - 1's first row pass share one
// sweep, so each iteration is a sweep, a barrier, a merge of the warps'
// column partials and a barrier:
//   sweep k (each warp over its rows, all columns):
//     pass 3 of k:   g = exp(S + u_k - lse_m) dv;  dS -= g;  du = du_in - sum_n g;
//                    dmu += du;  h = exp(S + v_hist[k] - lse_n) du;  dS -= h;
//                    per-lane column sums of h over the warp's rows (pass 4)
//     pass 1 of k-1: lse_n' = LSE_n(S + v_hist[k-1]), u_{k-1} = log_mu - lse_n'
//                    (the row state of the next sweep, in registers)
//     pass 2 of k-1: per-lane column (max, sum exp) of S + u_{k-1} over the
//                    warp's rows
//   merge (warp w, columns w + W q; lane i reads warp i's partials):
//     lse_m = LSE over the warps' (max, sum) pairs, dv_{k-1} = -sum of the
//     warps' h sums (xor butterflies, lane 0's value: a fixed order),
//     dnu += dv_{k-1}; the merging threads also stage v_hist[k-2].
// Four expf an element and iteration (g, h, the row and column LSE). The
// prologue sweep takes du = sum_n dout, the column partials of dout (dv =
// sum_m dout) and passes 1-2 of iteration T - 1.
constexpr int kBwdWarps = 32;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kMaxSlots = 5;  // rows a warp and columns a lane: M1, N1 <= 160

// Row LSE of S + v over the lane's columns and the warp: the same value in
// every lane (lane 0's).
template <int SLOTS>
__device__ __forceinline__ float row_lse(const float* __restrict__ row, const float* __restrict__ v,
                                         int lane, int N1) {
  float t[SLOTS];
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int n = lane + 32 * j;
    t[j] = n < N1 ? row[n] + v[n] : -INFINITY;
    mx = fmaxf(mx, t[j]);
  }
  mx = __shfl_sync(0xffffffffu, warp_max(mx), 0);
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    if (lane + 32 * j < N1) sum += expf(t[j] - mx);
  }
  return __shfl_sync(0xffffffffu, mx + logf(warp_sum(sum)), 0);
}

template <int SLOTS>
__global__ void __launch_bounds__(kBwdThreads, 1) sinkhorn_bwd_train_kernel(
    const float* __restrict__ scores,  // (P, M1, N1)
    const float* __restrict__ log_mu,  // (P, M1)
    const float* __restrict__ v_hist,  // (P, T, N1)
    const float* __restrict__ dout,    // (P, M1, N1)
    float* __restrict__ d_scores,      // (P, M1, N1)
    float* __restrict__ d_mu,          // (P, M1)
    float* __restrict__ d_nu,          // (P, N1)
    int M1, int N1, int iterations) {
  constexpr int W = kBwdWarps;
  extern __shared__ float smem[];
  float* s = smem;                   // (M1, N1)
  float* part_max = s + M1 * N1;     // (W, N1) a warp's column max of S + u
  float* part_sum = part_max + W * N1;  // (W, N1) its sum of exp(S + u - max)
  float* part_h = part_sum + W * N1;    // (W, N1) its column sum of h (of dout first)
  float* lse_m = part_h + W * N1;    // (N1,)
  float* dv = lse_m + N1;            // (N1,)
  float* dnu = dv + N1;              // (N1,)
  float* vbuf = dnu + N1;            // (2, N1): v_hist[k] in vbuf[k & 1]
  float* lmu = vbuf + 2 * N1;        // (M1,)
  float* du0 = lmu + M1;             // (M1,) sum_n dout
  float* dmu = du0 + M1;             // (M1,)

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t base = static_cast<size_t>(blockIdx.x) * M1 * N1;
  const float* hist = v_hist + static_cast<size_t>(blockIdx.x) * iterations * N1;
  const int T = iterations;

  for (int e = tid; e < M1 * N1; e += kBwdThreads) s[e] = scores[base + e];
  for (int m = tid; m < M1; m += kBwdThreads) {
    lmu[m] = log_mu[static_cast<size_t>(blockIdx.x) * M1 + m];
    dmu[m] = 0.0f;
  }
  for (int n = tid; n < N1; n += kBwdThreads) {
    dnu[n] = 0.0f;
    if (T >= 1) vbuf[((T - 1) & 1) * N1 + n] = hist[static_cast<size_t>(T - 1) * N1 + n];
    if (T >= 2) vbuf[((T - 2) & 1) * N1 + n] = hist[static_cast<size_t>(T - 2) * N1 + n];
  }
  float ds[SLOTS][SLOTS];
#pragma unroll
  for (int r = 0; r < SLOTS; ++r) {
    const int m = warp + W * r;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int n = lane + 32 * j;
      ds[r][j] = m < M1 && n < N1 ? dout[base + static_cast<size_t>(m) * N1 + n] : 0.0f;
    }
  }
  __syncthreads();

  // Column (max, sum exp) of S + u over the warp's rows, into the partials.
  float u[SLOTS], lse_n[SLOTS];
  auto column_partials = [&]() {
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int n = lane + 32 * j;
      if (n >= N1) continue;
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < SLOTS; ++r) {
        const int m = warp + W * r;
        if (m < M1) mx = fmaxf(mx, s[m * N1 + n] + u[r]);
      }
      float sum = 0.0f;
#pragma unroll
      for (int r = 0; r < SLOTS; ++r) {
        const int m = warp + W * r;
        if (m < M1) sum += expf(s[m * N1 + n] + u[r] - mx);
      }
      part_max[warp * N1 + n] = mx;
      part_sum[warp * N1 + n] = sum;
    }
  };
  // Pass 1 of iteration k over the warp's rows: u_k and lse_n in registers.
  auto row_pass = [&](int k) {
    const float* v = vbuf + (k & 1) * N1;
#pragma unroll
    for (int r = 0; r < SLOTS; ++r) {
      const int m = warp + W * r;
      if (m < M1) {
        lse_n[r] = row_lse<SLOTS>(s + m * N1, v, lane, N1);
        u[r] = lmu[m] - lse_n[r];
      }
    }
  };
  // The merge of the warps' column partials; dv_sign -1 turns the h sums
  // into dv_{k-1}, +1 the dout sums into the prologue's dv.
  auto merge = [&](bool with_lse, float dv_sign) {
    for (int n = warp; n < N1; n += W) {
      const float pm = part_max[lane * N1 + n];
      const float ph = part_h[lane * N1 + n];
      const float total = __shfl_sync(0xffffffffu, warp_sum(ph), 0);
      if (with_lse) {
        const float mx = __shfl_sync(0xffffffffu, warp_max(pm), 0);
        const float sum = warp_sum(part_sum[lane * N1 + n] * expf(pm - mx));
        if (lane == 0) lse_m[n] = mx + logf(sum);
      }
      if (lane == 0) {
        dv[n] = dv_sign * total;
        dnu[n] += dv[n];
      }
    }
  };

  if (T == 0) {
    for (int n = tid; n < N1; n += kBwdThreads) d_nu[static_cast<size_t>(blockIdx.x) * N1 + n] = 0.0f;
  } else {
    // prologue: du = sum_n dout, column sums of dout, passes 1-2 of T - 1
#pragma unroll
    for (int r = 0; r < SLOTS; ++r) {
      const int m = warp + W * r;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) acc += ds[r][j];
      acc = warp_sum(acc);
      if (lane == 0 && m < M1) du0[m] = acc;
    }
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int n = lane + 32 * j;
      float acc = 0.0f;
#pragma unroll
      for (int r = 0; r < SLOTS; ++r) acc += ds[r][j];
      if (n < N1) part_h[warp * N1 + n] = acc;
    }
    row_pass(T - 1);
    column_partials();
    __syncthreads();
    merge(true, 1.0f);
    __syncthreads();

    for (int k = T - 1; k >= 0; --k) {
      // pass 3 of k with the row state of k, its h column sums
      const float* vk = vbuf + (k & 1) * N1;
      float hcol[SLOTS];
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) hcol[j] = 0.0f;
#pragma unroll
      for (int r = 0; r < SLOTS; ++r) {
        const int m = warp + W * r;
        if (m >= M1) continue;
        const float* row = s + m * N1;
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < SLOTS; ++j) {
          const int n = lane + 32 * j;
          if (n < N1) {
            const float g = expf(row[n] + u[r] - lse_m[n]) * dv[n];
            ds[r][j] -= g;
            acc += g;
          }
        }
        acc = warp_sum(acc);
        const float dum = __shfl_sync(0xffffffffu, (k == T - 1 ? du0[m] : 0.0f) - acc, 0);
        if (lane == 0) dmu[m] += dum;
#pragma unroll
        for (int j = 0; j < SLOTS; ++j) {
          const int n = lane + 32 * j;
          if (n < N1) {
            const float h = expf(row[n] + vk[n] - lse_n[r]) * dum;
            ds[r][j] -= h;
            hcol[j] += h;
          }
        }
      }
      if (k == 0) break;
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        const int n = lane + 32 * j;
        if (n < N1) part_h[warp * N1 + n] = hcol[j];
      }
      // passes 1-2 of k - 1
      row_pass(k - 1);
      column_partials();
      __syncthreads();
      merge(true, -1.0f);
      // v_hist[k - 2] into the buffer v_hist[k] leaves
      if (k >= 2) {
        for (int n = tid; n < N1; n += kBwdThreads) {
          vbuf[(k & 1) * N1 + n] = hist[static_cast<size_t>(k - 2) * N1 + n];
        }
      }
      __syncthreads();
    }
    for (int n = tid; n < N1; n += kBwdThreads) {
      d_nu[static_cast<size_t>(blockIdx.x) * N1 + n] = dnu[n];
    }
  }

#pragma unroll
  for (int r = 0; r < SLOTS; ++r) {
    const int m = warp + W * r;
    if (m >= M1) continue;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int n = lane + 32 * j;
      if (n < N1) d_scores[base + static_cast<size_t>(m) * N1 + n] = ds[r][j];
    }
    if (lane == 0) d_mu[static_cast<size_t>(blockIdx.x) * M1 + m] = dmu[m];
  }
}


// Any M1, N1: the sweep and merge of sinkhorn_bwd_train_kernel over memory
// instead of registers (see the header). Warp w owns rows w + 32 r, lane l
// columns l + 32 j, as there.
__global__ void __launch_bounds__(kBwdThreads, 1) sinkhorn_bwd_general_kernel(
    const float* __restrict__ scores,  // (P, M1, N1)
    const float* __restrict__ log_mu,  // (P, M1)
    const float* __restrict__ v_hist,  // (P, T, N1)
    const float* __restrict__ dout,    // (P, M1, N1)
    float* __restrict__ d_scores,      // (P, M1, N1), dS as it goes
    float* __restrict__ d_mu,          // (P, M1)
    float* __restrict__ d_nu,          // (P, N1)
    float* __restrict__ scratch,       // (P, 3, W, N1) where !part_shared
    int M1, int N1, int iterations, bool s_shared, bool part_shared) {
  constexpr int W = kBwdWarps;
  extern __shared__ float smem[];
  const size_t p = blockIdx.x;
  float* lse_m = smem;      // (N1,)
  float* dv = lse_m + N1;   // (N1,)
  float* dnu = dv + N1;     // (N1,)
  float* lmu = dnu + N1;    // (M1,)
  float* du0 = lmu + M1;    // (M1,) sum_n dout
  float* dmu = du0 + M1;    // (M1,)
  float* u = dmu + M1;      // (M1,) the row state of the sweep
  float* lse_n = u + M1;    // (M1,)
  float* rest = lse_n + M1;
  float* part_max = part_shared ? rest : scratch + p * 3 * W * N1;  // (W, N1)
  float* part_sum = part_max + W * N1;                               // (W, N1)
  float* part_h = part_sum + W * N1;                                 // (W, N1)
  if (part_shared) rest += 3 * W * N1;
  const size_t base = p * M1 * N1;
  const float* hist = v_hist + p * iterations * N1;
  float* ds = d_scores + base;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int T = iterations;

  const float* s = scores + base;
  if (s_shared) {
    for (int e = tid; e < M1 * N1; e += kBwdThreads) rest[e] = scores[base + e];
    s = rest;
  }
  for (int m = tid; m < M1; m += kBwdThreads) {
    lmu[m] = log_mu[p * M1 + m];
    dmu[m] = 0.0f;
  }
  for (int n = tid; n < N1; n += kBwdThreads) dnu[n] = 0.0f;
  for (int m = warp; m < M1; m += W) {
    for (int n = lane; n < N1; n += 32) {
      ds[static_cast<size_t>(m) * N1 + n] = dout[base + static_cast<size_t>(m) * N1 + n];
    }
  }
  __syncthreads();

  // the row LSE of S + v over the lane's columns and the warp (lane 0's)
  auto row_lse = [&](const float* row, const float* v) {
    float mx = -INFINITY;
    for (int n = lane; n < N1; n += 32) mx = fmaxf(mx, row[n] + v[n]);
    mx = __shfl_sync(0xffffffffu, warp_max(mx), 0);
    float sum = 0.0f;
    for (int n = lane; n < N1; n += 32) sum += expf(row[n] + v[n] - mx);
    return __shfl_sync(0xffffffffu, mx + logf(warp_sum(sum)), 0);
  };
  // pass 1 of iteration k over the warp's rows: u_k and lse_n
  auto row_pass = [&](int k) {
    const float* v = hist + static_cast<size_t>(k) * N1;
    for (int m = warp; m < M1; m += W) {
      const float lse = row_lse(s + static_cast<size_t>(m) * N1, v);
      if (lane == 0) {
        lse_n[m] = lse;
        u[m] = lmu[m] - lse;
      }
    }
    __syncwarp();
  };
  // column (max, sum exp) of S + u over the warp's rows, into the partials
  auto column_partials = [&]() {
    for (int n = lane; n < N1; n += 32) {
      float mx = -INFINITY;
      for (int m = warp; m < M1; m += W) mx = fmaxf(mx, s[static_cast<size_t>(m) * N1 + n] + u[m]);
      float sum = 0.0f;
      for (int m = warp; m < M1; m += W) sum += expf(s[static_cast<size_t>(m) * N1 + n] + u[m] - mx);
      part_max[warp * N1 + n] = mx;
      part_sum[warp * N1 + n] = sum;
    }
  };
  // the merge of the warps' column partials, as the register kernel's
  auto merge = [&](bool with_lse, float dv_sign) {
    for (int n = warp; n < N1; n += W) {
      const float pm = part_max[lane * N1 + n];
      const float ph = part_h[lane * N1 + n];
      const float total = __shfl_sync(0xffffffffu, warp_sum(ph), 0);
      if (with_lse) {
        const float mx = __shfl_sync(0xffffffffu, warp_max(pm), 0);
        const float sum = warp_sum(part_sum[lane * N1 + n] * expf(pm - mx));
        if (lane == 0) lse_m[n] = mx + logf(sum);
      }
      if (lane == 0) {
        dv[n] = dv_sign * total;
        dnu[n] += dv[n];
      }
    }
  };

  if (T == 0) {
    for (int n = tid; n < N1; n += kBwdThreads) d_nu[p * N1 + n] = 0.0f;
  } else {
    // prologue: du = sum_n dout, column sums of dout, passes 1-2 of T - 1
    for (int m = warp; m < M1; m += W) {
      float acc = 0.0f;
      for (int n = lane; n < N1; n += 32) acc += ds[static_cast<size_t>(m) * N1 + n];
      acc = warp_sum(acc);
      if (lane == 0) du0[m] = acc;
    }
    for (int n = lane; n < N1; n += 32) {
      float acc = 0.0f;
      for (int m = warp; m < M1; m += W) acc += ds[static_cast<size_t>(m) * N1 + n];
      part_h[warp * N1 + n] = acc;
    }
    row_pass(T - 1);
    column_partials();
    __syncthreads();
    merge(true, 1.0f);
    __syncthreads();

    for (int k = T - 1; k >= 0; --k) {
      // pass 3 of k with the row state of k; h summed down the warp's rows
      // into its part_h row (each lane its own columns)
      const float* vk = hist + static_cast<size_t>(k) * N1;
      for (int n = lane; n < N1; n += 32) part_h[warp * N1 + n] = 0.0f;
      for (int m = warp; m < M1; m += W) {
        const float* row = s + static_cast<size_t>(m) * N1;
        float* ds_row = ds + static_cast<size_t>(m) * N1;
        const float um = u[m];
        float acc = 0.0f;
        for (int n = lane; n < N1; n += 32) {
          const float g = expf(row[n] + um - lse_m[n]) * dv[n];
          ds_row[n] -= g;
          acc += g;
        }
        acc = warp_sum(acc);
        const float dum = __shfl_sync(0xffffffffu, (k == T - 1 ? du0[m] : 0.0f) - acc, 0);
        if (lane == 0) dmu[m] += dum;
        const float ln = lse_n[m];
        for (int n = lane; n < N1; n += 32) {
          const float h = expf(row[n] + vk[n] - ln) * dum;
          ds_row[n] -= h;
          part_h[warp * N1 + n] += h;
        }
      }
      if (k == 0) break;
      __syncwarp();  // the row state of k is read before pass 1 of k - 1 overwrites it
      row_pass(k - 1);
      column_partials();
      __syncthreads();
      merge(true, -1.0f);
      __syncthreads();
    }
    for (int n = tid; n < N1; n += kBwdThreads) d_nu[p * N1 + n] = dnu[n];
  }
  __syncthreads();
  for (int m = tid; m < M1; m += kBwdThreads) d_mu[p * M1 + m] = dmu[m];
}

using launch_util::allow_smem;

// Whether a register instance holds (M1, N1): SLOTS <= 5.
bool register_instance_fits(int M1, int N1) {
  return ((M1 > N1 ? M1 : N1) + 31) / 32 <= kMaxSlots;
}

template <int SLOTS>
int launch_bwd(const float* scores, const float* log_mu, const float* v_hist, const float* dout,
               float* d_scores, float* d_mu, float* d_nu, int P, int M1, int N1, int iterations,
               size_t smem, cudaStream_t stream) {
  const cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(sinkhorn_bwd_train_kernel<SLOTS>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sinkhorn_bwd_train_kernel<SLOTS><<<P, kBwdThreads, smem, stream>>>(
      scores, log_mu, v_hist, dout, d_scores, d_mu, d_nu, M1, N1, iterations);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// general, s_shared, part_shared: the instance (kernels/sinkhorn.py:
// backward_route); `scratch` (P, 3, 32, N1) where the general kernel's
// partials do not sit in shared memory, else null.
int sinkhorn_bwd_train_launch(const float* scores, const float* log_mu, const float* v_hist,
                              const float* dout, float* d_scores, float* d_mu, float* d_nu,
                              float* scratch, int P, int M1, int N1, int iterations, int general,
                              int s_shared, int part_shared, void* stream) {
  if (M1 < 1 || N1 < 1 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return 0;
  const int slots = ((M1 > N1 ? M1 : N1) + 31) / 32;  // rows a warp, columns a lane
  if (general) {
    const size_t smem = sizeof(float) * (3 * static_cast<size_t>(N1) + 5 * static_cast<size_t>(M1) +
                                         (s_shared ? static_cast<size_t>(M1) * N1 : 0) +
                                         (part_shared ? 3 * static_cast<size_t>(kBwdWarps) * N1 : 0));
    const int block_bytes = launch_util::device_limits().block_bytes;
    if (smem > static_cast<size_t>(block_bytes) ||
        (!part_shared && scratch == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err =
        allow_smem(reinterpret_cast<const void*>(sinkhorn_bwd_general_kernel), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sinkhorn_bwd_general_kernel<<<P, kBwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        scores, log_mu, v_hist, dout, d_scores, d_mu, d_nu, scratch, M1, N1, iterations,
        s_shared != 0, part_shared != 0);
    return static_cast<int>(cudaGetLastError());
  }
  if (!register_instance_fits(M1, N1)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (static_cast<size_t>(M1) * N1 +
                                       static_cast<size_t>(3 * kBwdWarps + 5) * N1 + 3 * M1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (slots) {
    case 1: return launch_bwd<1>(scores, log_mu, v_hist, dout, d_scores, d_mu, d_nu, P, M1, N1, iterations, smem, s);
    case 2: return launch_bwd<2>(scores, log_mu, v_hist, dout, d_scores, d_mu, d_nu, P, M1, N1, iterations, smem, s);
    case 3: return launch_bwd<3>(scores, log_mu, v_hist, dout, d_scores, d_mu, d_nu, P, M1, N1, iterations, smem, s);
    case 4: return launch_bwd<4>(scores, log_mu, v_hist, dout, d_scores, d_mu, d_nu, P, M1, N1, iterations, smem, s);
    default: return launch_bwd<5>(scores, log_mu, v_hist, dout, d_scores, d_mu, d_nu, P, M1, N1, iterations, smem, s);
  }
}

}  // extern "C"
