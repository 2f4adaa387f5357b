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
// fit in a block's shared memory (M1 = N1 > 225), the GROUPED kernel reads
// log_mu and log_nu from global memory and runs the column partials and the
// merge a group of gw columns at a time, a barrier pair a group: each
// column's sums are the same, in the same order, either way. The same
// sums in the same order on every run. Two patches share an SM where P
// exceeds the SMs and both fit (512 threads, at most 64 registers a
// thread: P = 256 at inference runs in one wave on 132 SMs), else one (at
// most 128 registers; P = 128 in training); the arithmetic is the same
// either way. Capacity: M1, N1 <= 256 (SLOTS <= 8) and M1 N1 + N1 + 512
// floats of shared memory (every square patch up to 239 x 239 on an H100).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

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

// the SM count and shared-memory limits of the current device, read once
struct Limits {
  int sms = 0;
  int block_bytes = 0;  // a block's shared memory at most (opt-in)
  int sm_bytes = 0;     // an SM's
};

const Limits& device_limits() {
  constexpr int kMaxDevices = 64;
  static Limits cache[kMaxDevices];
  int device = 0;
  cudaGetDevice(&device);
  Limits& d = cache[device < kMaxDevices ? device : 0];
  if (d.sms == 0) {
    cudaDeviceGetAttribute(&d.block_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    cudaDeviceGetAttribute(&d.sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
    cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, device);
  }
  return d;
}

template <bool STORE_HIST>
int launch(const float* scores, const float* log_mu, const float* log_nu, float* out,
           float* v_hist, int P, int M1, int N1, int iterations, cudaStream_t stream) {
  if (M1 < 1 || N1 < 1 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int slots = ((M1 > N1 ? M1 : N1) + 31) / 32;
  if (slots > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  if (P == 0) return 0;
  const Limits& limits = device_limits();
  // S, the partials of all N1 columns, v, log_nu and log_mu where they fit
  // (always for M1, N1 <= 224), else S, v and the partials of the most
  // columns (a multiple of 16) that fit beside them
  constexpr long long kFloat = sizeof(float);
  const long long area = static_cast<long long>(M1) * N1;
  const bool grouped = kFloat * (area + (2 * kWarps + 2) * N1 + M1) > limits.block_bytes;
  const long long room = (limits.block_bytes - kFloat * (area + N1)) / (kFloat * 2 * kWarps);
  const int gw = grouped ? static_cast<int>(room / kMinGroup * kMinGroup) : N1;
  if (grouped && (slots != kMaxSlots || gw < kMinGroup)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(
      kFloat * (area + 2 * kWarps * gw + N1 + (grouped ? 0 : N1 + M1)));
  // two patches an SM where there are more patches than SMs and both fit
  // (at most 64 registers a thread), else one (at most 128); 1 KB of an
  // SM's shared memory is reserved a block
  const bool two = slots <= kTwoSlots && P > limits.sms &&
                   2 * (smem + 1024) <= static_cast<size_t>(limits.sm_bytes);
  auto run = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
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

// M1, N1 <= 256; S, v and the column partials of 16 columns in a block's
// shared memory (every square patch up to 239 x 239 on an H100)
int sinkhorn_launch(const float* scores, const float* log_mu, const float* log_nu,
                    float* out, int P, int M1, int N1, int iterations,
                    void* stream) {
  return launch<false>(scores, log_mu, log_nu, out, nullptr, P, M1, N1, iterations,
                       static_cast<cudaStream_t>(stream));
}

// the same, and v before each iteration into v_hist (P, T, N1)
int sinkhorn_fwd_train_launch(const float* scores, const float* log_mu, const float* log_nu,
                              float* out, float* v_hist, int P, int M1, int N1, int iterations,
                              void* stream) {
  return launch<true>(scores, log_mu, log_nu, out, v_hist, P, M1, N1, iterations,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
