// KPConv forward kernels for Hopper (sm_90a), f32 on the CUDA cores.
//
// kpconv_fused replaces geotransformer_tpu/kernels/kpconv.py:kpconv_fused
// (pallas_call at :426/:467, body _kpconv_kernel_body :160, valid-tile skip
// _kpconv_kernel :90); its unnormalized mode (raw sums and raw count) is the
// two passes of the split-table conv kpconv_split_fused (:1288).
// kpconv_stream_fused replaces kpconv_stream_fused (:1679, body
// _kpconv_stream_kernel :1642), the c_in == 1 input conv; kpconv_union
// replaces kpconv_union_input_fused (:1135, pallas_call :1199), the c_in == 1
// input conv over per-tile neighbour unions.
//
// What bounds them here. The TPU kernel read one pre-gathered (M, H, 12 + C)
// block because XLA's gather engine fed it; on this card that block would be
// the largest tensor of the backbone (~0.2 GB at stage 0) written once and
// read once. This kernel instead reads neighbour coordinates and features
// straight through the index table: a block of TQ queries stages its
// (TQ, H) indices and (TQ, H, K) influences in shared memory, then each
// thread owns one (query, channel) pair and accumulates
// T[q, k, c] = sum_h infl[q, h, k] * f[n(q, h), c] in K registers (neighbour
// feature rows are read coalesced across c). T stays in shared memory and
// is contracted with W (K * C_in, C_out) by a plain loop in which every
// thread keeps QB (2 or 4) queries' outputs, so each weight read from L2
// feeds QB FMAs. The weight stream (15 C^2 floats per block) bounds the
// wide late stages, the feature gather stage 0; tensor cores and a larger
// query tile are the later redesign's work.
//
// The union conv: the TPU kernel scored every query against all U union
// candidates through a membership matrix (Mosaic has no per-lane gather), U /
// H (~38) times the geometry the edges need. Here the tile's union is staged
// in shared memory once and each query indexes it per edge, which computes
// the same sums over the edges alone; what the union saves is the support
// reads, one per distinct row of the tile instead of one per edge.
//
// For training, kpconv_fused also writes the per-query count divisor and,
// with the pool, the number of columns tied at the max: the residuals of the
// inverse-table backward (kpconv_bwd.cu), which cannot recompute a
// query-side quantity from its support-side view. The stream conv writes its
// t1 = sum_h infl * feat (M, K) and count, all its weight gradient needs.
//
// Geometry is exact f32: offsets by direct subtraction, |off - kp_k| by a
// direct sqrt (the expanded |off|^2 - 2 off.kp + |kp|^2 form of the TPU
// kernel was a workaround for the MXU's single bf16 pass). A query whose
// mask is off sees only shadow neighbours: output 0, count 1, pool 0 —
// what the TPU kernel writes on skipped tiles. A block whose queries are
// all masked writes zeros and returns (the valid-tile skip).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxKernelPoints = 16;

template <int QB>
__global__ void __launch_bounds__(kThreads) kpconv_fused_kernel(
    const float* __restrict__ s_feats,      // (N, C)
    const float* __restrict__ q_points,     // (M, 3)
    const float* __restrict__ s_points,     // (N, 3)
    const int32_t* __restrict__ nbr,        // (M, H), sentinel N
    const float* __restrict__ posflag,      // (N,) 1 where the feature sum > 0
    const float* __restrict__ kp,           // (K, 3)
    const float* __restrict__ w,            // (K, C, D)
    const uint8_t* __restrict__ q_mask,     // (M,) or null
    const float* __restrict__ pool_feats,   // (N, P) or null
    float* __restrict__ out,                // (M, D)
    float* __restrict__ pooled,             // (M, P) or null
    float* __restrict__ count_out,          // (M,) or null
    float* __restrict__ ties_out,           // (M, P) or null (with pooled)
    float* __restrict__ t1_out,             // (M, K) or null (C == 1 only)
    int M, int N, int H, int K, int C, int D, int P, int pool_cols, int normalize,
    int tq, float sigma) {
  extern __shared__ float smem[];
  int32_t* nbr_s = reinterpret_cast<int32_t*>(smem);  // (tq, H)
  float* kp_s = smem + tq * H;                         // (K, 3)
  float* cnt_s = kp_s + 3 * kMaxKernelPoints;          // (tq,)
  float* infl_s = cnt_s + tq;                          // (tq, H, K)
  float* t_s = infl_s + tq * H * K;                    // (tq, K, C)

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * tq;

  int any_valid = 0;
  for (int i = tid; i < tq * H; i += kThreads) {
    const int q = q0 + i / H;
    int n = N;
    if (q < M && (q_mask == nullptr || q_mask[q])) {
      n = nbr[static_cast<size_t>(q) * H + i % H];
      if (n < 0 || n >= N) n = N;
    }
    nbr_s[i] = n;
    any_valid |= (n < N);
  }
  for (int i = tid; i < 3 * K; i += kThreads) kp_s[i] = kp[i];
  if (!__syncthreads_or(any_valid)) {
    // Every query of the tile is padding (or has no neighbour): the compute
    // path would write exactly these zeros.
    for (int i = tid; i < tq * D; i += kThreads) {
      const int q = q0 + i / D;
      if (q < M) out[static_cast<size_t>(q) * D + i % D] = 0.0f;
    }
    if (pooled != nullptr) {
      const float all_shadow = fmaxf(static_cast<float>(min(pool_cols, H)), 1.0f);
      for (int i = tid; i < tq * P; i += kThreads) {
        const int q = q0 + i / P;
        if (q >= M) continue;
        pooled[static_cast<size_t>(q) * P + i % P] = 0.0f;
        if (ties_out != nullptr) ties_out[static_cast<size_t>(q) * P + i % P] = all_shadow;
      }
    }
    if (count_out != nullptr) {
      for (int ql = tid; ql < tq; ql += kThreads) {
        if (q0 + ql < M) count_out[q0 + ql] = normalize ? 1.0f : 0.0f;
      }
    }
    if (t1_out != nullptr) {
      for (int i = tid; i < tq * K; i += kThreads) {
        if (q0 + i / K < M) t1_out[static_cast<size_t>(q0) * K + i] = 0.0f;
      }
    }
    return;
  }

  // Kernel-point influences of every (query, neighbour) slot of the tile.
  for (int i = tid; i < tq * H; i += kThreads) {
    const int n = nbr_s[i];
    float* dst = infl_s + i * K;
    if (n < N) {
      const int q = q0 + i / H;
      const float ox = s_points[3 * n + 0] - q_points[3 * q + 0];
      const float oy = s_points[3 * n + 1] - q_points[3 * q + 1];
      const float oz = s_points[3 * n + 2] - q_points[3 * q + 2];
      for (int k = 0; k < K; ++k) {
        const float dx = ox - kp_s[3 * k + 0];
        const float dy = oy - kp_s[3 * k + 1];
        const float dz = oz - kp_s[3 * k + 2];
        const float d = sqrtf(dx * dx + dy * dy + dz * dz);
        dst[k] = fmaxf(1.0f - d / sigma, 0.0f);
      }
    } else {
      for (int k = 0; k < K; ++k) dst[k] = 0.0f;
    }
  }
  // Neighbour count: supports whose feature sum is positive, at least 1
  // (the reference quirk, kpconv.py:113-116); unnormalized (one pass of a
  // split conv) the raw count, which the split combine clamps once.
  for (int ql = tid; ql < tq; ql += kThreads) {
    float c = 0.0f;
    for (int h = 0; h < H; ++h) {
      const int n = nbr_s[ql * H + h];
      if (n < N) c += posflag[n];
    }
    cnt_s[ql] = normalize ? fmaxf(c, 1.0f) : c;
    if (count_out != nullptr && q0 + ql < M) count_out[q0 + ql] = cnt_s[ql];
  }
  __syncthreads();

  // T[q, k, c] = sum_h infl[q, h, k] * f[n(q, h), c]
  for (int pair = tid; pair < tq * C; pair += kThreads) {
    const int ql = pair / C;
    const int c = pair % C;
    float acc[kMaxKernelPoints];
#pragma unroll
    for (int k = 0; k < kMaxKernelPoints; ++k) acc[k] = 0.0f;
    const int32_t* nb = nbr_s + ql * H;
    const float* inf = infl_s + ql * H * K;
    for (int h = 0; h < H; ++h) {
      const int n = nb[h];
      if (n < N) {
        const float f = s_feats[static_cast<size_t>(n) * C + c];
#pragma unroll
        for (int k = 0; k < kMaxKernelPoints; ++k) {
          if (k < K) acc[k] = fmaf(inf[h * K + k], f, acc[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxKernelPoints; ++k) {
      if (k < K) t_s[(ql * K + k) * C + c] = acc[k];
    }
    // the input conv's weight-gradient residual t1[q, k] = T[q, k, 0]
    if (t1_out != nullptr && q0 + ql < M) {
#pragma unroll
      for (int k = 0; k < kMaxKernelPoints; ++k) {
        if (k < K) t1_out[static_cast<size_t>(q0 + ql) * K + k] = acc[k];
      }
    }
  }

  // Shortcut max-pool over the first pool_cols columns; shadows read 0
  // (the reference's implicit clamp at 0, functional.py:54-67).
  if (pooled != nullptr) {
    const int cols = pool_cols < H ? pool_cols : H;
    for (int i = tid; i < tq * P; i += kThreads) {
      const int ql = i / P;
      const int c = i % P;
      const int q = q0 + ql;
      if (q >= M) continue;
      float m = cols > 0 ? -INFINITY : 0.0f;
      for (int h = 0; h < cols; ++h) {
        const int n = nbr_s[ql * H + h];
        const float v = n < N ? pool_feats[static_cast<size_t>(n) * P + c] : 0.0f;
        m = fmaxf(m, v);
      }
      pooled[static_cast<size_t>(q) * P + c] = m;
      if (ties_out != nullptr) {
        // columns equal to the max (shadows read 0), at least 1: the
        // even split of the max's gradient, as XLA's reduce-max VJP does
        float ties = 0.0f;
        for (int h = 0; h < cols; ++h) {
          const int n = nbr_s[ql * H + h];
          const float v = n < N ? pool_feats[static_cast<size_t>(n) * P + c] : 0.0f;
          ties += v == m ? 1.0f : 0.0f;
        }
        ties_out[static_cast<size_t>(q) * P + c] = fmaxf(ties, 1.0f);
      }
    }
  }
  __syncthreads();

  // out[q, d] = sum_{k, c} T[q, k, c] * W[k, c, d] / count[q] (no division
  // unnormalized), QB queries per thread so each weight read feeds QB FMAs.
  const int kc_total = K * C;
  for (int o = tid; o < (tq / QB) * D; o += kThreads) {
    const int qa = QB * (o / D);
    const int d = o % D;
    const float* t = t_s + qa * kc_total;
    float acc[QB];
#pragma unroll
    for (int j = 0; j < QB; ++j) acc[j] = 0.0f;
    for (int kc = 0; kc < kc_total; ++kc) {
      const float wv = w[static_cast<size_t>(kc) * D + d];
#pragma unroll
      for (int j = 0; j < QB; ++j) acc[j] = fmaf(t[j * kc_total + kc], wv, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      const int q = q0 + qa + j;
      if (q < M) out[static_cast<size_t>(q) * D + d] = normalize ? acc[j] / cnt_s[qa + j] : acc[j];
    }
  }
}

constexpr int kStreamQueries = 16;

__global__ void __launch_bounds__(kThreads) kpconv_stream_kernel(
    const float* __restrict__ stream,  // (5, M, H): off xyz, posflag, feat
    const float* __restrict__ kp,      // (K, 3)
    const float* __restrict__ w,       // (K, 1, D)
    float* __restrict__ out,           // (M, D)
    float* __restrict__ t1_out,        // (M, K) or null
    float* __restrict__ count_out,     // (M,) or null
    int M, int H, int K, int D, float sigma) {
  extern __shared__ float smem[];
  float* planes = smem;                            // (5, kStreamQueries, H)
  float* t1_s = planes + 5 * kStreamQueries * H;   // (kStreamQueries, K)
  float* cnt_s = t1_s + kStreamQueries * K;        // (kStreamQueries,)
  float* kp_s = cnt_s + kStreamQueries;            // (K, 3)

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kStreamQueries;
  const int rows = min(kStreamQueries, M - q0);
  const int tile = kStreamQueries * H;

  // The tile's rows of each plane are contiguous: coalesced loads.
  for (int p = 0; p < 5; ++p) {
    const float* src = stream + static_cast<size_t>(p) * M * H + static_cast<size_t>(q0) * H;
    for (int i = tid; i < tile; i += kThreads) {
      planes[p * tile + i] = i < rows * H ? src[i] : 0.0f;
    }
  }
  for (int i = tid; i < 3 * K; i += kThreads) kp_s[i] = kp[i];
  __syncthreads();

  // t1[q, k] = sum_h infl(off[q, h], kp_k) * feat[q, h], exact f32.
  for (int i = tid; i < kStreamQueries * K; i += kThreads) {
    const int ql = i / K;
    const int k = i % K;
    const float kx = kp_s[3 * k + 0];
    const float ky = kp_s[3 * k + 1];
    const float kz = kp_s[3 * k + 2];
    float acc = 0.0f;
    for (int h = 0; h < H; ++h) {
      const int j = ql * H + h;
      const float dx = planes[j] - kx;
      const float dy = planes[tile + j] - ky;
      const float dz = planes[2 * tile + j] - kz;
      const float d = sqrtf(dx * dx + dy * dy + dz * dz);
      acc = fmaf(fmaxf(1.0f - d / sigma, 0.0f), planes[4 * tile + j], acc);
    }
    t1_s[i] = acc;
    if (t1_out != nullptr && ql < rows) t1_out[static_cast<size_t>(q0 + ql) * K + k] = acc;
  }
  for (int ql = tid; ql < kStreamQueries; ql += kThreads) {
    float c = 0.0f;
    for (int h = 0; h < H; ++h) c += planes[3 * tile + ql * H + h];
    cnt_s[ql] = fmaxf(c, 1.0f);
    if (count_out != nullptr && ql < rows) count_out[q0 + ql] = cnt_s[ql];
  }
  __syncthreads();

  // out[q, d] = sum_k t1[q, k] * W[k, 0, d] / count[q]
  for (int o = tid; o < rows * D; o += kThreads) {
    const int ql = o / D;
    const int d = o % D;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc = fmaf(t1_s[ql * K + k], w[k * D + d], acc);
    out[static_cast<size_t>(q0 + ql) * D + d] = acc / cnt_s[ql];
  }
}

constexpr int kUnionThreads = 256;

// Union-gather input conv (c_in == 1): one block per query tile. The tile's
// union of support rows is staged once in shared memory as (x, y, z, feat,
// posflag) and the tile's (tile, H) positions into it beside; each thread then
// owns (query, kernel point) pairs and walks the query's H positions into the
// staged union, accumulating t1[q, k] = sum_h infl * feat and, for k == 0, the
// count of positive-feature neighbours. out = t1 W[:, 0, :] / max(count, 1).
__global__ void __launch_bounds__(kUnionThreads) kpconv_union_kernel(
    const float* __restrict__ s_feats,    // (N,) the c_in == 1 features
    const float* __restrict__ s_points,   // (N, 3)
    const float* __restrict__ q_points,   // (M, 3)
    const int32_t* __restrict__ rows,     // (T, U), sentinel N
    const int32_t* __restrict__ sel,      // (M, H), sentinel U
    const float* __restrict__ kp,         // (K, 3)
    const float* __restrict__ w,          // (K, 1, D)
    float* __restrict__ out,              // (M, D)
    float* __restrict__ count_out,        // (M,) or null
    float* __restrict__ t1_out,           // (M, K) or null
    int M, int N, int U, int H, int K, int D, int tile, float sigma) {
  extern __shared__ float smem[];
  float* un = smem;                                     // (U, 5)
  int32_t* sel_s = reinterpret_cast<int32_t*>(un + 5 * U);  // (tile, H)
  float* kp_s = reinterpret_cast<float*>(sel_s + tile * H);  // (K, 3)
  float* t1_s = kp_s + 3 * kMaxKernelPoints;           // (tile, K)
  float* cnt_s = t1_s + tile * kMaxKernelPoints;       // (tile,)

  const int tid = threadIdx.x;
  const int t = blockIdx.x;
  const int q0 = t * tile;
  const int rows_here = min(tile, M - q0);

  for (int u = tid; u < U; u += kUnionThreads) {
    const int n = rows[static_cast<size_t>(t) * U + u];
    float* e = un + 5 * u;
    if (n >= 0 && n < N) {
      const float f = s_feats[n];
      e[0] = s_points[3 * n + 0];
      e[1] = s_points[3 * n + 1];
      e[2] = s_points[3 * n + 2];
      e[3] = f;
      e[4] = f > 0.0f ? 1.0f : 0.0f;
    } else {
      e[0] = e[1] = e[2] = e[3] = e[4] = 0.0f;
    }
  }
  for (int i = tid; i < tile * H; i += kUnionThreads) {
    const int u = i < rows_here * H ? sel[static_cast<size_t>(q0) * H + i] : U;
    sel_s[i] = (u >= 0 && u < U) ? u : U;
  }
  for (int i = tid; i < 3 * K; i += kUnionThreads) kp_s[i] = kp[i];
  __syncthreads();

  for (int i = tid; i < rows_here * K; i += kUnionThreads) {
    const int ql = i / K;
    const int k = i % K;
    const int q = q0 + ql;
    const float ox = q_points[3 * q + 0];
    const float oy = q_points[3 * q + 1];
    const float oz = q_points[3 * q + 2];
    float acc = 0.0f;
    float cnt = 0.0f;
    for (int h = 0; h < H; ++h) {
      const int u = sel_s[ql * H + h];
      if (u >= U) continue;
      const float* e = un + 5 * u;
      // (s - q) - kp_k: the offset first, as every KPConv of the port
      const float dx = (e[0] - ox) - kp_s[3 * k + 0];
      const float dy = (e[1] - oy) - kp_s[3 * k + 1];
      const float dz = (e[2] - oz) - kp_s[3 * k + 2];
      const float d = sqrtf(dx * dx + dy * dy + dz * dz);
      acc = fmaf(fmaxf(1.0f - d / sigma, 0.0f), e[3], acc);
      cnt += e[4];
    }
    t1_s[ql * kMaxKernelPoints + k] = acc;
    if (t1_out != nullptr) t1_out[static_cast<size_t>(q) * K + k] = acc;
    if (k == 0) {
      cnt_s[ql] = fmaxf(cnt, 1.0f);
      if (count_out != nullptr) count_out[q] = cnt_s[ql];
    }
  }
  __syncthreads();

  for (int o = tid; o < rows_here * D; o += kUnionThreads) {
    const int ql = o / D;
    const int d = o % D;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc = fmaf(t1_s[ql * kMaxKernelPoints + k], w[k * D + d], acc);
    out[static_cast<size_t>(q0 + ql) * D + d] = acc / cnt_s[ql];
  }
}

// Query tile: T holds TQ * K * C floats (30 KB at C <= 64, 61 KB above).
int query_tile(int c) {
  int tq = (c <= 64 ? 512 : 1024) / (c > 0 ? c : 1);
  tq = tq < 4 ? 4 : (tq > 32 ? 32 : tq);
  return tq & ~3;
}

// Queries per thread in the weight contraction: enough (query group,
// channel) slots for all threads, at most 4.
int queries_per_thread(int tq, int d) {
  return tq * d >= 4 * kThreads ? 4 : 2;
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int kpconv_fused_launch(const float* s_feats, const float* q_points,
                        const float* s_points, const int32_t* nbr,
                        const float* posflag, const float* kp, const float* w,
                        const uint8_t* q_mask, const float* pool_feats,
                        float* out, float* pooled, float* count_out,
                        float* ties_out, float* t1_out, int M, int N, int H, int K,
                        int C, int D, int P, int pool_cols, int normalize, float sigma,
                        void* stream) {
  if (K < 1 || K > kMaxKernelPoints || H < 1 || C < 1 || D < 1 || (t1_out != nullptr && C != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  const int tq = query_tile(C);
  const size_t smem = sizeof(float) * (static_cast<size_t>(tq) * H + 3 * kMaxKernelPoints +
                                       tq + static_cast<size_t>(tq) * H * K +
                                       static_cast<size_t>(tq) * K * C);
  const int blocks = (M + tq - 1) / tq;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (queries_per_thread(tq, D) == 4) {
    err = cudaFuncSetAttribute(kpconv_fused_kernel<4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kpconv_fused_kernel<4><<<blocks, kThreads, smem, s>>>(
        s_feats, q_points, s_points, nbr, posflag, kp, w, q_mask, pool_feats, out,
        pooled, count_out, ties_out, t1_out, M, N, H, K, C, D, P, pool_cols, normalize, tq,
        sigma);
  } else {
    err = cudaFuncSetAttribute(kpconv_fused_kernel<2>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kpconv_fused_kernel<2><<<blocks, kThreads, smem, s>>>(
        s_feats, q_points, s_points, nbr, posflag, kp, w, q_mask, pool_feats, out,
        pooled, count_out, ties_out, t1_out, M, N, H, K, C, D, P, pool_cols, normalize, tq,
        sigma);
  }
  return static_cast<int>(cudaGetLastError());
}

int kpconv_stream_launch(const float* stream_planes, const float* kp,
                         const float* w, float* out, float* t1_out,
                         float* count_out, int M, int H, int K, int D,
                         float sigma, void* stream) {
  if (K < 1 || H < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const size_t smem = sizeof(float) * (5 * kStreamQueries * static_cast<size_t>(H) +
                                       kStreamQueries * K + kStreamQueries + 3 * K);
  cudaError_t err = cudaFuncSetAttribute(
      kpconv_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (M + kStreamQueries - 1) / kStreamQueries;
  kpconv_stream_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      stream_planes, kp, w, out, t1_out, count_out, M, H, K, D, sigma);
  return static_cast<int>(cudaGetLastError());
}

int kpconv_union_launch(const float* s_feats, const float* s_points, const float* q_points,
                        const int32_t* rows, const int32_t* sel, const float* kp,
                        const float* w, float* out, float* count_out, float* t1_out, int M,
                        int N, int U, int H, int K, int D, int tile, float sigma,
                        void* stream) {
  if (K < 1 || K > kMaxKernelPoints || H < 1 || D < 1 || U < 1 || tile < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  const size_t smem = sizeof(float) * (5 * static_cast<size_t>(U) + static_cast<size_t>(tile) * H +
                                       3 * kMaxKernelPoints +
                                       static_cast<size_t>(tile) * kMaxKernelPoints + tile);
  cudaError_t err = cudaFuncSetAttribute(
      kpconv_union_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (M + tile - 1) / tile;
  kpconv_union_kernel<<<blocks, kUnionThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      s_feats, s_points, q_points, rows, sel, kp, w, out, count_out, t1_out, M, N, U, H, K, D,
      tile, sigma);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
