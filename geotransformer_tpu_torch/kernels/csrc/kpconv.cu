// KPConv forward kernels for Hopper (sm_90a).
//
// kpconv_conv_launch replaces geotransformer_tpu/kernels/kpconv.py:
// kpconv_fused (pallas_call at :426/:467, body _kpconv_kernel_body :160,
// valid-tile skip _kpconv_kernel :90) and kpconv_split_fused (:1288), which
// on the TPU reaches the same pallas_call once for the head and once for the
// tail and combines them in XLA. Here a conv is two kernels of
// kpconv_common.cuh, whole table or split alike:
//   1. the edge pass: T[q, k, c] = sum_h infl[q, h, k] f[n(q, h), c] into an
//      (M, K * C) workspace, with the count divisor and the shortcut
//      max-pool and its tie counts; a split table is walked in the same pass
//      (each query's head columns, then its tail row through tail_rank), so
//      count = max(count_h + count_t, 1), pooled = max(pooled_h, pooled_t)
//      with a missing tail row as the zero shadow row, and ties counted
//      against the combined max, as the two passes and the combine did;
//   2. the contraction out = T W / count (W viewed as (K * C, D)) on the
//      tensor cores in 3xTF32 (f32 accuracy), W read once per 64-128 queries.
// What bounded the kernel it replaces (chip_smoke.py on an H100 80GB HBM3 at
// 700 W): a 4-32-query tile held T in shared memory and streamed all of W
// through L2 per block onto the CUDA cores (~2 GB of L2 reads for one
// stage-5 KITTI conv); a split conv paid that twice and a torch combine.
// Now the contraction runs at tensor-core rates and the edge pass, bound by
// its FMAs on the CUDA cores and the gathers from L2, sizes its tile by the
// thread count alone.
//
// kpconv_stream_fused replaces kpconv_stream_fused (:1679, body
// _kpconv_stream_kernel :1642), the c_in == 1 input conv; kpconv_union
// replaces kpconv_union_input_fused (:1135, pallas_call :1199), the c_in == 1
// input conv over per-tile neighbour unions.
//
// The union conv: the TPU kernel scored every query against all U union
// candidates through a membership matrix (Mosaic has no per-lane gather), U /
// H (~38) times the geometry the edges need. Here the tile's union is staged
// in shared memory once and each query indexes it per edge, which computes
// the same sums over the edges alone; what the union saves is the support
// reads, one per distinct row of the tile instead of one per edge.
//
// For training the conv also writes the per-query count divisor and, with
// the pool, the number of columns tied at the max: the residuals of the
// inverse-table backward (kpconv_bwd.cu), which cannot recompute a
// query-side quantity from its support-side view. At c_in == 1 the workspace
// T is t1 = sum_h infl * feat (M, K), the input conv's weight-gradient
// residual. The stream conv writes its t1 and count, all its weight gradient
// needs.
//
// Geometry is exact f32: offsets by direct subtraction, |off - kp_k| by a
// direct sqrt (the expanded |off|^2 - 2 off.kp + |kp|^2 form of the TPU
// kernel was a workaround for the MXU's single bf16 pass). A query whose
// mask is off sees only shadow neighbours: output 0, count 1, pool 0 —
// what the TPU kernel writes on skipped tiles. A tile of the contraction
// whose queries have no edge writes zeros and reads nothing (the valid-tile
// skip).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "kpconv_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxKernelPoints = 16;

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

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Floats of the split-K workspace of a conv's contraction (M x K C) (K C x
// D) (0: none); the wrapper allocates it for kpconv_conv_launch.
long long kpconv_conv_workspace(int M, int K, int C, int D) {
  return kpconv::contraction_workspace(M, D, K * C, kpconv::tensor_core_widths(C, D));
}

// One KPConv: the edge pass into the workspaces t_ws (M, K * C) and div_ws
// (M,), then the contraction into out (through part_ws, the split-K
// partial sums, where kpconv_conv_workspace asks for them). head (M, H1)
// sentinel N; tail (M2, H2) and tail_rank (M,) (sentinel M2) or null for a
// whole table; pool_head and pool_tail the pooled columns of the head and
// of a tail row.
int kpconv_conv_launch(const float* s_feats, const float* q_points, const float* s_points,
                       const int32_t* head, const int32_t* tail, const int32_t* tail_rank,
                       const float* posflag, const float* kp, const float* w,
                       const uint8_t* q_mask, const float* pool_feats, float* t_ws,
                       float* div_ws, float* part_ws, float* out, float* pooled,
                       float* count_out, float* ties_out, int M, int N, int H1, int H2, int M2,
                       int K, int C, int D, int P, int pool_head, int pool_tail, float sigma,
                       void* stream) {
  if (D < 1 || H1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kpconv::EdgeArgs e{};
  e.feats = s_feats;
  e.self_pts = q_points;
  e.other_pts = s_points;
  e.head = head;
  e.tail = tail;
  e.rank = tail_rank;
  e.mask = q_mask;
  e.kp = kp;
  e.t_out = t_ws;
  e.R = M;
  e.n_other = N;
  e.C = C;
  e.K = K;
  e.h1 = H1;
  e.h2 = H2;
  e.r2 = M2;
  e.sigma = sigma;
  kpconv::FwdExtras x{};
  x.posflag = posflag;
  x.div_out = div_ws;
  x.count_out = count_out;
  x.pool_feats = pool_feats;
  x.pooled = pool_feats != nullptr ? pooled : nullptr;
  x.ties = pool_feats != nullptr ? ties_out : nullptr;
  x.P = P;
  x.pool_head = pool_head;
  x.pool_tail = pool_tail;
  const int pool_width = pool_feats == nullptr ? 0
                         : min(pool_head, H1) + (tail != nullptr ? min(pool_tail, H2) : 0);
  int err = kpconv::launch_edges<false>(e, x, pool_width, st);
  if (err != 0) return err;
  kpconv::GemmArgs g{};
  g.a = t_ws;
  g.lda = K * C;
  g.b = w;
  g.ldb = D;
  g.c = out;
  g.ldc = D;
  g.div = div_ws;
  g.M = M;
  g.N = D;
  g.Kdim = K * C;
  g.k_per_z = K * C;
  return kpconv::launch_contraction(g, kpconv::tensor_core_widths(C, D), part_ws, st);
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
