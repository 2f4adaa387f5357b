// KPConv backward over the inverse neighbour table, for Hopper (sm_90a), f32
// on the CUDA cores.
//
// Replaces geotransformer_tpu/kernels/kpconv.py:kpconv_bwd_fused (pallas_call
// at :884, body _kpconv_bwd_kernel :651). The forward gathered support rows
// per query; its gradient would scatter per edge. The inverse table turns the
// scatter into a gather: row n lists the queries q_j whose neighbour lists
// hold n (sentinel M), so for each support row
//   infl[n, j, k] = max(0, 1 - |s_n - q_j - kp_k| / sigma)   (support - query,
//                   the forward's offset; the disposition is not symmetric)
//   u[n, k, d]    = sum_j infl[n, j, k] gdiv[q_j, d]         gdiv = dout / count
//   d_s[n, c]     = sum_{k, d} u[n, k, d] W[k, c, d]
//   d_pool[n, p]  = sum_j [pool[n, p] == pooled[q_j, p]] dpool[q_j, p] / ties[q_j, p]
// and dW[k, c, d] = sum_n s[n, c] u[n, k, d] is a reduction over all rows.
//
// Design. kpconv_bwd_kernel takes TN support rows a block: it stages their
// (TN, J) inverse indices and (TN, J, K) influences in shared memory, forms u
// with one thread per (row, output channel) holding K accumulators (gdiv rows
// are read coalesced across d, straight through the inverse table: no
// pre-gathered query block as the TPU kernel had), keeps u in shared memory
// for the d_s contraction (QB rows per thread share each weight read, W
// pre-transposed to (K, D, C) so the read is coalesced across c) and also
// writes it to memory. dW is then a plain product s^T u per kernel point:
// kpconv_dw_partial_kernel gives each block a 32 x 32 tile of one dW[k] and
// one slice of the rows (split N), writing a partial sum; kpconv_dw_reduce
// adds the slices in a fixed order. No float atomics: the result is the same
// on every run.
//
// What bounds it here: at 3DMatch sizes the u pass reads one gdiv row per
// inverse edge (~1.1M edges at stage 0, x C_out floats, mostly from L2) and
// the d_s and dW contractions are 2 N K C D FMAs each; all three are f32 on
// the CUDA cores. Tensor cores for the two contractions are later work.
//
// Sentinel edges (value M) contribute zero. Ties in the pooled max share the
// gradient evenly (the forward's tie count, as XLA's reduce-max VJP does),
// shadow columns' shares are dropped; equality is exact because the pooled
// values are f32 copies of the pool features.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxKernelPoints = 16;
constexpr int kTile = 32;        // dW tile: 32 c x 32 d
constexpr int kTileThreads = 64; // 4 x 4 outputs a thread
constexpr size_t kSmemBudget = 64 * 1024;

template <int QB>
__global__ void __launch_bounds__(kThreads) kpconv_bwd_kernel(
    const float* __restrict__ s_points,    // (N, 3)
    const float* __restrict__ q_points,    // (M, 3)
    const float* __restrict__ gdiv,        // (M, D)
    const int32_t* __restrict__ inv,       // (N, J), sentinel M
    const float* __restrict__ kp,          // (K, 3)
    const float* __restrict__ wt,          // (K, D, C)
    const float* __restrict__ pool_feats,  // (N, P) or null
    const float* __restrict__ pooled,      // (M, P) or null
    const float* __restrict__ dpt,         // (M, P) dpool / ties, or null
    float* __restrict__ u_out,             // (N, K, D)
    float* __restrict__ d_s,               // (N, C)
    float* __restrict__ d_pool,            // (N, P) or null
    int N, int M, int J, int K, int C, int D, int P, int tn, float sigma) {
  extern __shared__ float smem[];
  int32_t* inv_s = reinterpret_cast<int32_t*>(smem);  // (tn, J)
  float* kp_s = smem + tn * J;                         // (K, 3)
  float* infl_s = kp_s + 3 * kMaxKernelPoints;         // (tn, J, K)
  float* u_s = infl_s + tn * J * K;                    // (tn, K, D)

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * tn;

  int any_valid = 0;
  for (int i = tid; i < tn * J; i += kThreads) {
    const int n = n0 + i / J;
    int q = M;
    if (n < N) {
      q = inv[static_cast<size_t>(n) * J + i % J];
      if (q < 0 || q >= M) q = M;
    }
    inv_s[i] = q;
    any_valid |= (q < M);
  }
  for (int i = tid; i < 3 * K; i += kThreads) kp_s[i] = kp[i];
  if (!__syncthreads_or(any_valid)) {
    // No row of the tile is any query's neighbour: every gradient is zero.
    for (int i = tid; i < tn * K * D; i += kThreads) {
      const int n = n0 + i / (K * D);
      if (n < N) u_out[static_cast<size_t>(n0) * K * D + i] = 0.0f;
    }
    for (int i = tid; i < tn * C; i += kThreads) {
      if (n0 + i / C < N) d_s[static_cast<size_t>(n0) * C + i] = 0.0f;
    }
    if (d_pool != nullptr) {
      for (int i = tid; i < tn * P; i += kThreads) {
        if (n0 + i / P < N) d_pool[static_cast<size_t>(n0) * P + i] = 0.0f;
      }
    }
    return;
  }

  // Influences of every (support row, inverse edge) slot of the tile.
  for (int i = tid; i < tn * J; i += kThreads) {
    const int q = inv_s[i];
    float* dst = infl_s + i * K;
    if (q < M) {
      const int n = n0 + i / J;
      const float ox = s_points[3 * n + 0] - q_points[3 * q + 0];
      const float oy = s_points[3 * n + 1] - q_points[3 * q + 1];
      const float oz = s_points[3 * n + 2] - q_points[3 * q + 2];
      for (int k = 0; k < K; ++k) {
        const float dx = ox - kp_s[3 * k + 0];
        const float dy = oy - kp_s[3 * k + 1];
        const float dz = oz - kp_s[3 * k + 2];
        const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
        dst[k] = fmaxf(1.0f - dist / sigma, 0.0f);
      }
    } else {
      for (int k = 0; k < K; ++k) dst[k] = 0.0f;
    }
  }
  __syncthreads();

  // u[n, k, d] = sum_j infl[n, j, k] * gdiv[q_j, d]
  for (int pair = tid; pair < tn * D; pair += kThreads) {
    const int nl = pair / D;
    const int d = pair % D;
    float acc[kMaxKernelPoints];
#pragma unroll
    for (int k = 0; k < kMaxKernelPoints; ++k) acc[k] = 0.0f;
    const int32_t* iv = inv_s + nl * J;
    const float* inf = infl_s + nl * J * K;
    for (int j = 0; j < J; ++j) {
      const int q = iv[j];
      if (q < M) {
        const float g = gdiv[static_cast<size_t>(q) * D + d];
#pragma unroll
        for (int k = 0; k < kMaxKernelPoints; ++k) {
          if (k < K) acc[k] = fmaf(inf[j * K + k], g, acc[k]);
        }
      }
    }
    const int n = n0 + nl;
#pragma unroll
    for (int k = 0; k < kMaxKernelPoints; ++k) {
      if (k < K) {
        u_s[(nl * K + k) * D + d] = acc[k];
        if (n < N) u_out[(static_cast<size_t>(n) * K + k) * D + d] = acc[k];
      }
    }
  }

  // Shortcut max-pool: this row gets dpool / ties from every query whose
  // pooled value equals its own feature.
  if (d_pool != nullptr) {
    for (int i = tid; i < tn * P; i += kThreads) {
      const int nl = i / P;
      const int p = i % P;
      const int n = n0 + nl;
      if (n >= N) continue;
      const float v = pool_feats[static_cast<size_t>(n) * P + p];
      float acc = 0.0f;
      for (int j = 0; j < J; ++j) {
        const int q = inv_s[nl * J + j];
        if (q < M && pooled[static_cast<size_t>(q) * P + p] == v) {
          acc += dpt[static_cast<size_t>(q) * P + p];
        }
      }
      d_pool[static_cast<size_t>(n) * P + p] = acc;
    }
  }
  __syncthreads();

  // d_s[n, c] = sum_{k, d} u[n, k, d] * Wt[k, d, c], QB rows per thread.
  const int kd_total = K * D;
  for (int o = tid; o < (tn / QB) * C; o += kThreads) {
    const int na = QB * (o / C);
    const int c = o % C;
    const float* uu = u_s + na * kd_total;
    float acc[QB];
#pragma unroll
    for (int r = 0; r < QB; ++r) acc[r] = 0.0f;
    for (int kd = 0; kd < kd_total; ++kd) {
      const float wv = wt[static_cast<size_t>(kd) * C + c];
#pragma unroll
      for (int r = 0; r < QB; ++r) acc[r] = fmaf(uu[r * kd_total + kd], wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < QB; ++r) {
      const int n = n0 + na + r;
      if (n < N) d_s[static_cast<size_t>(n) * C + c] = acc[r];
    }
  }
}

// part[s, k, c, d] = sum over rows n of slice s of s_feats[n, c] * u[n, k, d]
// Grid: (c tiles x d tiles, K, slices); 64 threads, a 4 x 4 register tile each.
__global__ void __launch_bounds__(kTileThreads) kpconv_dw_partial_kernel(
    const float* __restrict__ s_feats,  // (N, C)
    const float* __restrict__ u,        // (N, K, D)
    float* __restrict__ part,           // (S, K, C, D)
    int N, int K, int C, int D, int rows_per_slice) {
  __shared__ float sf[kTile][kTile + 1];  // [row][c]
  __shared__ float us[kTile][kTile + 1];  // [row][d]
  const int tiles_d = (D + kTile - 1) / kTile;
  const int c0 = (blockIdx.x / tiles_d) * kTile;
  const int d0 = (blockIdx.x % tiles_d) * kTile;
  const int k = blockIdx.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int tc = (tid / 8) * 4;
  const int td = (tid % 8) * 4;
  const int begin = s * rows_per_slice;
  const int end = min(N, begin + rows_per_slice);

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
  }
  for (int nb = begin; nb < end; nb += kTile) {
    for (int e = tid; e < kTile * kTile; e += kTileThreads) {
      const int r = e / kTile;
      const int col = e % kTile;
      const int n = nb + r;
      const bool row_ok = n < end;
      sf[r][col] = (row_ok && c0 + col < C) ? s_feats[static_cast<size_t>(n) * C + c0 + col] : 0.0f;
      us[r][col] = (row_ok && d0 + col < D)
                       ? u[(static_cast<size_t>(n) * K + k) * D + d0 + col] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kTile; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sf[r][tc + i];
        b[i] = us[r][td + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(a[i], b[jj], acc[i][jj]);
      }
    }
    __syncthreads();
  }
  float* dst = part + (static_cast<size_t>(s) * K + k) * C * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + tc + i;
    if (c >= C) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int d = d0 + td + jj;
      if (d < D) dst[static_cast<size_t>(c) * D + d] = acc[i][jj];
    }
  }
}

// dW[e] = sum_s part[s, e], slices added in order.
__global__ void __launch_bounds__(kThreads) kpconv_dw_reduce_kernel(
    const float* __restrict__ part, float* __restrict__ dw, int S, int total) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  float acc = 0.0f;
  for (int s = 0; s < S; ++s) acc += part[static_cast<size_t>(s) * total + e];
  dw[e] = acc;
}

size_t bwd_smem_bytes(int tn, int J, int K, int D) {
  return sizeof(float) * (static_cast<size_t>(tn) * J + 3 * kMaxKernelPoints +
                          static_cast<size_t>(tn) * J * K + static_cast<size_t>(tn) * K * D);
}

// Support rows per block: the largest of 32, 16, 8, 4 whose staged indices,
// influences and u fit the budget (two blocks an SM), at least 4.
int support_tile(int J, int K, int D) {
  int tn = 32;
  while (tn > 4 && bwd_smem_bytes(tn, J, K, D) > kSmemBudget) tn /= 2;
  return tn;
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Number of row slices the dW pass uses for these sizes: enough blocks to
// fill the card, at least 64 rows a slice. The wrapper sizes the partial
// buffer (slices, K, C, D) with it.
int kpconv_dw_slices(int N, int K, int C, int D) {
  const int tiles = ((C + kTile - 1) / kTile) * ((D + kTile - 1) / kTile);
  int slices = (8 * 132 + tiles * K - 1) / (tiles * K);
  const int max_slices = (N + 63) / 64;
  if (slices > max_slices) slices = max_slices;
  return slices < 1 ? 1 : slices;
}

int kpconv_bwd_launch(const float* s_feats, const float* s_points,
                      const float* q_points, const float* gdiv,
                      const int32_t* inv, const float* kp, const float* wt,
                      const float* pool_feats, const float* pooled,
                      const float* dpt, float* u, float* part, float* d_s,
                      float* dw, float* d_pool, int N, int M, int J, int K,
                      int C, int D, int P, float sigma, void* stream) {
  if (K < 1 || K > kMaxKernelPoints || J < 1 || C < 1 || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 0) {
    return static_cast<int>(cudaMemsetAsync(dw, 0, sizeof(float) * K * C * D, st));
  }
  const int tn = support_tile(J, K, D);
  const size_t smem = bwd_smem_bytes(tn, J, K, D);
  const int blocks = (N + tn - 1) / tn;
  cudaError_t err;
  if (tn * C >= 4 * kThreads) {
    err = cudaFuncSetAttribute(kpconv_bwd_kernel<4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kpconv_bwd_kernel<4><<<blocks, kThreads, smem, st>>>(
        s_points, q_points, gdiv, inv, kp, wt, pool_feats, pooled, dpt, u, d_s, d_pool,
        N, M, J, K, C, D, P, tn, sigma);
  } else {
    err = cudaFuncSetAttribute(kpconv_bwd_kernel<2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kpconv_bwd_kernel<2><<<blocks, kThreads, smem, st>>>(
        s_points, q_points, gdiv, inv, kp, wt, pool_feats, pooled, dpt, u, d_s, d_pool,
        N, M, J, K, C, D, P, tn, sigma);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int slices = kpconv_dw_slices(N, K, C, D);
  const int rows_per_slice = (N + slices - 1) / slices;
  const dim3 grid(((C + kTile - 1) / kTile) * ((D + kTile - 1) / kTile), K, slices);
  float* target = slices == 1 ? dw : part;
  kpconv_dw_partial_kernel<<<grid, kTileThreads, 0, st>>>(s_feats, u, target, N, K, C, D,
                                                          rows_per_slice);
  err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return static_cast<int>(err);
  const int total = K * C * D;
  kpconv_dw_reduce_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      part, dw, slices, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
