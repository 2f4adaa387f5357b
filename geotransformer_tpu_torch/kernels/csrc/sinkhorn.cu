// Log-domain Sinkhorn iterations for Hopper (sm_90a), one block per patch:
// the inference loop and, the same kernel storing v before each iteration,
// the training forward.
//
// Replaces geotransformer_tpu/kernels/sinkhorn.py:sinkhorn_log_iterations
// (pallas_call at :85; body _sinkhorn_kernel :28) and _fwd_train (pallas_call
// at :211, body _sinkhorn_fwd_train_kernel :127): for each patch, T rounds of
//   u = log_mu - logsumexp_n(S + v),  v = log_nu - logsumexp_m(S + u)
// and the result S + u + v; the training forward also keeps v_{k-1} before
// iteration k (v_hist[k], zeros first), the state the backward
// (sinkhorn_train.cu) cannot rebuild cheaply. Both are one template
// (STORE_HIST), so the training forward's result is bit for bit the
// inference result. Masked slots hold -1e12 (finite): every exponent
// difference stays finite, so empty padded patches stay finite exactly as
// in the JAX versions.
//
// What bounds it: the exponentials. Two an element and iteration (the row
// and the column log-sum-exp), 16 a clock an SM on the special function
// units, with ~12 other instructions an element and iteration around them;
// the bytes (the scores once in, once out) are a few MB a call. Each
// exponential is of x = t - max <= 0, taken as 2^(x log2(e)): a multiply
// and one ex2.approx (one SFU instruction, relative error ~2^-22), where
// expf would issue ~8 instructions; near the max, where the terms matter,
// the multiply's rounding is below an ulp of the result. Logarithms (one a
// row or column) are logf.
//
// Design: 16 warps a patch. Warp w owns rows w + 16 r for the whole call,
// lane l the columns l + 32 j (j < SLOTS); S sits in shared memory, u of the
// warp's rows in registers. An iteration is one sweep and one merge:
//   sweep (each warp over its rows): the row LSE of S + v by a warp
//     reduction gives u for the warp's rows; each lane then takes its
//     columns' (max, sum exp) of S + u over the warp's rows (the warp's
//     column partials) into shared memory;
//   barrier;
//   merge: 16 lanes a column (lane i reads warp i's partials), 2 columns a
//     warp at a time: the column LSE by xor butterflies over the 16 lanes,
//     lane 0's value; v = log_nu - LSE;
//   barrier.
// The partials of all N1 columns take 32 N1 floats. Where S and they do not
// fit in a block's shared memory (M1 = N1 >= 225), the GROUPED kernel reads
// log_mu and log_nu from global memory and runs the column partials and the
// merge a group of gw columns at a time, a barrier pair a group: each
// column's sums are the same, in the same order, either way. The same
// sums in the same order on every run. Two patches share an SM where P
// exceeds the SMs and both fit (512 threads, at most 64 registers a
// thread: P = 256 at inference runs in one wave on 132 SMs), else one (at
// most 128 registers; P = 128 in training); the arithmetic is the same
// either way. These instances take M1, N1 <= 256 (SLOTS <= 8) with
// M1 N1 + N1 + 512 floats of shared memory (every square patch up to
// 239 x 239 on an H100). Any other shape takes the GENERAL kernel
// (sinkhorn_general_kernel): the same sweep and merge, in the same order,
// with no register arrays: u and v in shared memory, each lane walking its
// columns n = l + 32 j and each warp its rows w + 16 r for as many as the
// patch has; S in shared memory where it fits, else read from global memory
// (L2) every iteration; the column partials of all N1 columns in shared
// memory where they fit, else in a global scratch the wrapper allocates.
// Each sum is the one a register instance of that many slots would take,
// in the same order (tests/test_torch_sinkhorn_fwd_order.py states it).
// The wrapper alone picks the instance, the register instance's group
// width and where the general kernel keeps S and the partials
// (kernels/sinkhorn.py:forward_route, a plain function); the launch only
// checks that what it is given fits the shape and a block.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "launch_common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// e^x for x <= 0: 2^(x log2(e)), one SFU instruction after the multiply
// (+0 for -inf and below the normal range)
__device__ __forceinline__ float exp_le0(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(__fmul_rn(x, kLog2e)));
  return y;
}

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSlots = 8;       // columns a lane, rows 2 SLOTS a warp: M1, N1 <= 256
constexpr int kTwoSlots = 5;       // two patches an SM up to M1, N1 <= 160 (64 registers)
constexpr int kMergeLanes = kWarps;  // lanes a column in the merge: one a warp partial
constexpr int kMinGroup = 16;      // columns a partial group at least

// One patch a block. GROUPED: log_mu, log_nu read from global memory, the
// column partials and the merge a group of gw columns at a time; else
// log_mu, log_nu in shared memory and the partials of all N1 columns
// (gw = N1).
template <int SLOTS, bool STORE_HIST, int BLOCKS, bool GROUPED>
__global__ void __launch_bounds__(kThreads, BLOCKS) sinkhorn_kernel(
    const float* __restrict__ scores,  // (P, M1, N1)
    const float* __restrict__ log_mu,  // (P, M1)
    const float* __restrict__ log_nu,  // (P, N1)
    float* __restrict__ out,           // (P, M1, N1)
    float* __restrict__ v_hist,        // (P, T, N1) where STORE_HIST
    int M1, int N1, int iterations, int gw) {
  constexpr int ROWS = (32 * SLOTS + kWarps - 1) / kWarps;  // rows a warp at most
  extern __shared__ float smem[];
  float* s = smem;                          // (M1, N1)
  float* part_max = s + M1 * N1;            // (16, gw) each warp's column max of S + u
  float* part_sum = part_max + kWarps * gw;  // (16, gw) its sum of exp(S + u - max)
  float* v = part_sum + kWarps * gw;        // (N1,)
  // (N1,) and (M1,) in shared memory, or the patch's rows of the inputs
  const float* lnu = GROUPED ? log_nu + static_cast<size_t>(blockIdx.x) * N1 : v + N1;
  const float* lmu = GROUPED ? log_mu + static_cast<size_t>(blockIdx.x) * M1 : v + 2 * N1;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t base = static_cast<size_t>(blockIdx.x) * M1 * N1;

  for (int e = tid; e < M1 * N1; e += kThreads) s[e] = scores[base + e];
  for (int n = tid; n < N1; n += kThreads) v[n] = 0.0f;
  if (!GROUPED) {
    for (int n = tid; n < N1; n += kThreads) {
      v[N1 + n] = log_nu[static_cast<size_t>(blockIdx.x) * N1 + n];
    }
    for (int m = tid; m < M1; m += kThreads) {
      v[2 * N1 + m] = log_mu[static_cast<size_t>(blockIdx.x) * M1 + m];
    }
  }
  // a warp's rows beyond M1 read row M1 - 1 and are never used: the sweep
  // has no branch
  int row[ROWS];
  float u[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    row[r] = min(warp + kWarps * r, M1 - 1);
    u[r] = 0.0f;
  }
  int col[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) col[j] = min(lane + 32 * j, N1 - 1);
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    if (STORE_HIST) {
      float* hist = v_hist + (static_cast<size_t>(blockIdx.x) * iterations + it) * N1;
      for (int n = tid; n < N1; n += kThreads) hist[n] = v[n];
    }
    // sweep: u of the warp's rows ...
    float vj[SLOTS];
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) vj[j] = v[col[j]];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float* srow = s + row[r] * N1;
      float t[SLOTS];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        t[j] = lane + 32 * j < N1 ? srow[col[j]] + vj[j] : -INFINITY;
        mx = fmaxf(mx, t[j]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        if (lane + 32 * j < N1) sum += exp_le0(t[j] - mx);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      u[r] = lmu[row[r]] - __shfl_sync(0xffffffffu, mx + logf(sum), 0);
    }
    // ... and the warp's column partials of S + u, a barrier, the merge, a
    // barrier: once, or a group of gw columns at a time
    for (int c0 = 0; c0 < (GROUPED ? N1 : 1); c0 += (GROUPED ? gw : 1)) {
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        const int n = lane + 32 * j;
        if (GROUPED && (n < c0 || n >= c0 + gw)) continue;
        float t[ROWS];
        float mx = -INFINITY;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          t[r] = s[row[r] * N1 + col[j]] + u[r];
          if (warp + kWarps * r < M1) mx = fmaxf(mx, t[r]);
        }
        float sum = 0.0f;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (warp + kWarps * r < M1) sum += exp_le0(t[r] - mx);
        }
        if (n < N1) {
          part_max[warp * gw + n - c0] = mx;
          part_sum[warp * gw + n - c0] = sum;
        }
      }
      __syncthreads();
      // merge: columns c0 + 32 q + 2 warp + lane / 16, lane % 16 reading
      // warp lane % 16's partials (a warp without rows: max -inf, sum 0)
      const int width = GROUPED ? min(gw, N1 - c0) : N1;
#pragma unroll
      for (int q = 0; q < SLOTS; ++q) {
        if (GROUPED && 32 * q >= width) break;
        const int k = 32 * q + 2 * warp + lane / kMergeLanes;
        const int at = (lane % kMergeLanes) * gw + min(k, width - 1);
        const float pm = part_max[at];
        float mx = pm;
#pragma unroll
        for (int o = kMergeLanes / 2; o > 0; o >>= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        }
        float sum = __fmul_rn(part_sum[at], exp_le0(pm - mx));
#pragma unroll
        for (int o = kMergeLanes / 2; o > 0; o >>= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        }
        if (lane % kMergeLanes == 0 && k < width) v[c0 + k] = lnu[c0 + k] - (mx + logf(sum));
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int m = warp + kWarps * r;
    if (m >= M1) continue;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int n = lane + 32 * j;
      if (n < N1) out[base + static_cast<size_t>(m) * N1 + n] = s[m * N1 + n] + u[r] + v[n];
    }
  }
}

// Any M1, N1: the sweep and merge of sinkhorn_kernel over memory instead of
// registers. u (M1) and v (N1) in shared memory; S in shared memory where
// s_shared, else the scores in global memory; the partials in shared memory
// where part_shared, else the patch's (2, 16, N1) of `scratch`.
template <bool STORE_HIST>
__global__ void __launch_bounds__(kThreads, 1) sinkhorn_general_kernel(
    const float* __restrict__ scores,  // (P, M1, N1)
    const float* __restrict__ log_mu,  // (P, M1)
    const float* __restrict__ log_nu,  // (P, N1)
    float* __restrict__ out,           // (P, M1, N1)
    float* __restrict__ v_hist,        // (P, T, N1) where STORE_HIST
    float* __restrict__ scratch,       // (P, 2, 16, N1) where !part_shared
    int M1, int N1, int iterations, bool s_shared, bool part_shared) {
  extern __shared__ float smem[];
  const size_t p = blockIdx.x;
  float* u = smem;        // (M1,)
  float* v = u + M1;      // (N1,)
  float* rest = v + N1;
  float* part_max = part_shared ? rest : scratch + p * 2 * kWarps * N1;  // (16, N1)
  float* part_sum = part_max + kWarps * N1;                               // (16, N1)
  if (part_shared) rest += 2 * kWarps * N1;
  const float* lnu = log_nu + p * N1;
  const float* lmu = log_mu + p * M1;
  const size_t base = p * M1 * N1;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const float* s = scores + base;
  if (s_shared) {
    for (int e = tid; e < M1 * N1; e += kThreads) rest[e] = scores[base + e];
    s = rest;
  }
  for (int n = tid; n < N1; n += kThreads) v[n] = 0.0f;
  for (int m = tid; m < M1; m += kThreads) u[m] = 0.0f;
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    if (STORE_HIST) {
      float* hist = v_hist + (p * iterations + it) * N1;
      for (int n = tid; n < N1; n += kThreads) hist[n] = v[n];
    }
    // sweep: u of the warp's rows (the row LSE of S + v) ...
    for (int m = warp; m < M1; m += kWarps) {
      const float* srow = s + static_cast<size_t>(m) * N1;
      float mx = -INFINITY;
      for (int n = lane; n < N1; n += 32) mx = fmaxf(mx, srow[n] + v[n]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.0f;
      for (int n = lane; n < N1; n += 32) sum += exp_le0(srow[n] + v[n] - mx);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float lse = __shfl_sync(0xffffffffu, mx + logf(sum), 0);
      if (lane == 0) u[m] = lmu[m] - lse;
    }
    __syncwarp();
    // ... and the warp's column partials of S + u
    for (int n = lane; n < N1; n += 32) {
      float mx = -INFINITY;
      for (int m = warp; m < M1; m += kWarps) mx = fmaxf(mx, s[static_cast<size_t>(m) * N1 + n] + u[m]);
      float sum = 0.0f;
      for (int m = warp; m < M1; m += kWarps) {
        sum += exp_le0(s[static_cast<size_t>(m) * N1 + n] + u[m] - mx);
      }
      part_max[warp * N1 + n] = mx;
      part_sum[warp * N1 + n] = sum;
    }
    __syncthreads();
    // merge: columns 32 q + 2 warp + lane / 16, lane % 16 reading warp
    // lane % 16's partials (a warp without rows: max -inf, sum 0)
    for (int q = 0; 32 * q < N1; ++q) {
      const int k = 32 * q + 2 * warp + lane / kMergeLanes;
      const int at = (lane % kMergeLanes) * N1 + min(k, N1 - 1);
      const float pm = part_max[at];
      float mx = pm;
#pragma unroll
      for (int o = kMergeLanes / 2; o > 0; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      float sum = __fmul_rn(part_sum[at], exp_le0(pm - mx));
#pragma unroll
      for (int o = kMergeLanes / 2; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      }
      if (lane % kMergeLanes == 0 && k < N1) v[k] = lnu[k] - (mx + logf(sum));
    }
    __syncthreads();
  }

  for (int m = warp; m < M1; m += kWarps) {
    for (int n = lane; n < N1; n += 32) {
      out[base + static_cast<size_t>(m) * N1 + n] = s[static_cast<size_t>(m) * N1 + n] + u[m] + v[n];
    }
  }
}

using launch_util::Limits;
using launch_util::allow_smem;
using launch_util::device_limits;

// Whether a register instance fits (M1, N1) with the column partials of
// group columns at a time (grouped: S, v and those partials), or of all N1
// columns (group 0: S, the partials, v, log_nu and log_mu); its bytes.
bool register_instance_fits(int M1, int N1, int group, size_t& smem) {
  const int slots = ((M1 > N1 ? M1 : N1) + 31) / 32;
  const bool grouped = group > 0;
  if (slots > kMaxSlots || (grouped && (slots != kMaxSlots || group < kMinGroup))) return false;
  const size_t area = static_cast<size_t>(M1) * N1;
  smem = sizeof(float) * (area + 2 * kWarps * static_cast<size_t>(grouped ? group : N1) + N1 +
                          (grouped ? 0 : static_cast<size_t>(N1) + M1));
  return smem <= static_cast<size_t>(device_limits().block_bytes);
}

// general: the general kernel, S in shared memory where s_shared, the
// partials where part_shared (else in scratch); else a register instance,
// its partials group columns at a time (0: all N1).
template <bool STORE_HIST>
int launch(const float* scores, const float* log_mu, const float* log_nu, float* out,
           float* v_hist, float* scratch, int P, int M1, int N1, int iterations, bool general,
           bool s_shared, bool part_shared, int group, cudaStream_t stream) {
  if (M1 < 1 || N1 < 1 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return 0;
  const Limits& limits = device_limits();
  const int slots = ((M1 > N1 ? M1 : N1) + 31) / 32;
  if (general) {
    const size_t smem = sizeof(float) * (static_cast<size_t>(M1) + N1 +
                                         (s_shared ? static_cast<size_t>(M1) * N1 : 0) +
                                         (part_shared ? 2 * static_cast<size_t>(kWarps) * N1 : 0));
    if (smem > static_cast<size_t>(limits.block_bytes) || (!part_shared && scratch == nullptr)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    auto kernel = sinkhorn_general_kernel<STORE_HIST>;
    const cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<P, kThreads, smem, stream>>>(scores, log_mu, log_nu, out, v_hist, scratch, M1, N1,
                                          iterations, s_shared, part_shared);
    return static_cast<int>(cudaGetLastError());
  }
  size_t smem = 0;
  if (!register_instance_fits(M1, N1, group, smem)) return static_cast<int>(cudaErrorInvalidValue);
  const bool grouped = group > 0;
  const int gw = grouped ? group : N1;
  // two patches an SM where there are more patches than SMs and both fit
  // (at most 64 registers a thread), else one (at most 128); 1 KB of an
  // SM's shared memory is reserved a block
  const bool two = slots <= kTwoSlots && P > limits.sms &&
                   2 * (smem + 1024) <= static_cast<size_t>(limits.sm_bytes);
  auto run = [&](auto kernel) {
    const cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<P, kThreads, smem, stream>>>(scores, log_mu, log_nu, out, v_hist, M1, N1,
                                          iterations, gw);
    return static_cast<int>(cudaGetLastError());
  };
  if (grouped) return run(sinkhorn_kernel<kMaxSlots, STORE_HIST, 1, true>);
  switch (slots) {
    case 1: return two ? run(sinkhorn_kernel<1, STORE_HIST, 2, false>) : run(sinkhorn_kernel<1, STORE_HIST, 1, false>);
    case 2: return two ? run(sinkhorn_kernel<2, STORE_HIST, 2, false>) : run(sinkhorn_kernel<2, STORE_HIST, 1, false>);
    case 3: return two ? run(sinkhorn_kernel<3, STORE_HIST, 2, false>) : run(sinkhorn_kernel<3, STORE_HIST, 1, false>);
    case 4: return two ? run(sinkhorn_kernel<4, STORE_HIST, 2, false>) : run(sinkhorn_kernel<4, STORE_HIST, 1, false>);
    case 5: return two ? run(sinkhorn_kernel<5, STORE_HIST, 2, false>) : run(sinkhorn_kernel<5, STORE_HIST, 1, false>);
    case 6: return run(sinkhorn_kernel<6, STORE_HIST, 1, false>);
    case 7: return run(sinkhorn_kernel<7, STORE_HIST, 1, false>);
    default: return run(sinkhorn_kernel<8, STORE_HIST, 1, false>);
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A block's shared memory at most on the current device, in bytes.
int sinkhorn_block_bytes() { return device_limits().block_bytes; }

// general, s_shared, part_shared, group: the instance (kernels/sinkhorn.py:
// forward_route); `scratch` (P, 2, 16, N1) where the general kernel's
// partials do not sit in shared memory, else null.
int sinkhorn_launch(const float* scores, const float* log_mu, const float* log_nu,
                    float* out, float* scratch, int P, int M1, int N1, int iterations,
                    int general, int s_shared, int part_shared, int group, void* stream) {
  return launch<false>(scores, log_mu, log_nu, out, nullptr, scratch, P, M1, N1, iterations,
                       general, s_shared, part_shared, group, static_cast<cudaStream_t>(stream));
}

// the same, and v before each iteration into v_hist (P, T, N1)
int sinkhorn_fwd_train_launch(const float* scores, const float* log_mu, const float* log_nu,
                              float* out, float* v_hist, float* scratch, int P, int M1, int N1,
                              int iterations, int general, int s_shared, int part_shared,
                              int group, void* stream) {
  return launch<true>(scores, log_mu, log_nu, out, v_hist, scratch, P, M1, N1, iterations,
                      general, s_shared, part_shared, group, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
