// The two passes every KPConv of the port is built from, forward
// (kpconv.cu) and backward (kpconv_bwd.cu):
//
// 1. edge_kernel: per row r of a neighbour table (a query of the forward,
//    a support row of the backward) and kernel point k,
//      T[r, k, c] = sum_e infl(r, e, k) * feats[n(r, e), c]
//    with infl = max(0, 1 - |off - kp_k| / sigma) and off the edge's exact
//    offset: support - query (the forward's s_n - q_r; the backward's
//    s_r - q_n). The table has two parts: row r walks its head columns
//    head[r, :] and then, when it has one, its tail row tail[rank[r], :]
//    (the split tables of preprocess.build_split_tables); a whole table is
//    a head alone. So a split table takes one pass, and the unsplit table is
//    never built. A block of 256 threads takes tr rows; each thread owns one
//    row and V = 4 channels (1 where C % 4 != 0) and keeps 16 x V
//    accumulators; the block stages a chunk of each row's edges at a time
//    (indices and the 16 influences of each edge, K padded to 16 with
//    zeros) in shared memory, so the tile does not depend on the table
//    width. Any K and C (kernels/kpconv.py:edge_route, which the launcher
//    checks): K > 16 walks the edges once a chunk of 16 kernel points, and a
//    row of more than 256 channel groups once a pass of 256 groups, each
//    pass with its own accumulators; each kernel point's sum is the same as
//    in one pass. Feature rows are read as float4 through the index, coalesced
//    across a row's threads, four edges' loads in flight at once. T goes to
//    a workspace (R, K * C) that the wrapper allocates.
//    The forward also writes each query's divisor (the count of neighbours
//    whose feature sum is positive, at least 1; 0 for a query without an
//    edge) and the shortcut max-pool with its tie counts; the backward the
//    pool's gradient. Both read the table again from L1/L2 for these.
//
// 2. gemm_3xtf32_kernel: C = A B (/ div[m] per row), an f32 product on the
//    tensor cores: tiles of 64-128 rows x 32-64 columns, A and B staged by
//    16-byte cp.async through a four-stage ring of 32-deep k slices, 8 warps
//    each holding a 16-32 x 8-32 tile of mma.sync m16n8k8 TF32 accumulators
//    with the 3xTF32 split (tf32_mma.cuh), a fixed summation order and no
//    atomics (the same result every run). Each ring stage's products (32 k,
//    three TF32 products a k8 step) go into a fresh tile that one f32 add
//    brings into the accumulator: a 7,680-term sum then stands within 1e-6
//    of max|exact|, as a plain f32 product does, which one add a k8 step
//    missed (tests/test_torch_kpconv_tc.py emulates the kernel's order). A rows of a tile whose divisors
//    are all 0 (queries without an edge) give a tile of zeros without a
//    read. It computes the forward's out = T (M, K C) W (K C, D) / count,
//    the backward's d_s = u (N, K D) Wt (K D, C) and, with A read
//    transposed (k-major), the backward's dW[k] = s^T (C x N) u[:, k, :]
//    (N x D) over slices of the rows (grid y: k, z: the slice).
//    gemm_f32_kernel is its CUDA-core form for the widths the tensor-core
//    tiles do not take (C or D below 8 or not a multiple of 4: the c_in = 1
//    input conv, narrow test widths).
//
// Geometry is exact f32: offsets by direct subtraction, a direct sqrt (as
// the plain versions). Sentinel indices (>= the gathered row count) and
// masked queries contribute nothing.
//
// The bfloat16 points (PrecisionConfig.kpconv_mxu and kpconv_table, the
// JAX kernels' MXU_DTYPE and TABLE_DTYPE at geotransformer_tpu/kernels/
// kpconv.py:249-256, :269-273, :342-365, :699-725, :842-845) are instances,
// never flags read at run time: edge_kernel<.., RM> takes a set of kRound*
// bits (round to nearest even, as the values are read): the forward at
// C_in > 1 and kpconv_mxu rounds each staged influence and each loaded
// feature (kRoundInfl | kRoundFeats); kpconv_table rounds each loaded
// feature and each pool value (kRoundFeats | kRoundPool: the gathered
// table's own rounding; the count stays the f32 posflag's); the backward at
// kpconv_mxu rounds the influences, each gdiv value and each u sum
// (kRoundSums: a split inverse table's head sum and tail sum each rounded
// before they add, as the JAX backward's two calls do), at kpconv_table the
// row's own pool features for the tie equality. gemm_f32_kernel<ROUND>
// rounds A (bit 1) and B (bit 2) as it reads them: the C_in = 1 product
// t1 W both, the backward's dW = round(s)^T u A only. gemm_3xtf32_kernel<..,
// EXACT> takes bfloat16-valued operands as the TF32 values they are:
// EXACT 1 rounds A as it reads it and runs two products a k8 step (A W at
// f32 W: the backward's d_s = round(u) Wt; the split route's dW), EXACT 2
// rounds A and B and runs one (dW = round(s)^T round(u), exact products). A
// product of two bfloat16 values is exact in f32, so the FMAs sum exact
// products as before; the forward's 3xTF32 contraction T W is f32 at either
// point, as the JAX kernel's t @ W[k].

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "launch_common.cuh"
#include "tf32_mma.cuh"

namespace kpconv {

constexpr int kThreads = 256;
constexpr int kMaxKernelPoints = 16;
constexpr int kSMs = 132;  // H100 SXM

// the edge pass's rounding instances: bits of edge_kernel's RM
constexpr int kRoundInfl = 1;   // each staged influence
constexpr int kRoundFeats = 2;  // each value of a gathered row (features; gdiv)
constexpr int kRoundPool = 4;   // each pool value (forward: gathered; backward: the row's own)
constexpr int kRoundSums = 8;   // the backward's sums: head and tail rounded apart, then added

// ---- the contraction --------------------------------------------------------

struct GemmArgs {
  const float* a;    // (M x Kdim): a[m * lda + k], or k-major a[k * lda + m]
  const float* b;    // (Kdim x N): b[k * ldb + n], + blockIdx.y * b_step_y
  float* c;          // (M x N): c[m * ldc + n], + y * c_step_y + z * c_step_z
  const float* div;  // (M,) or null: row m divided by div[m]; 0 gives zeros
  const float* skip; // (M,) or null: a tile whose rows all read 0 here writes zeros
  long long b_step_y, c_step_y, c_step_z;
  int lda, ldb, ldc, M, N, Kdim;
  int k_per_z;       // slice z sums k in [z * k_per_z, (z + 1) * k_per_z)
};

constexpr int kBK = 32;     // k depth of one ring stage
constexpr int kStages = 4;  // ring depth: three stages in flight behind the one read

template <int BM, int BN, bool KMAJOR>
struct GemmSmem {
  // A: m-major rows padded to kBK + 4 floats, k-major rows to BM + 8; B rows
  // to BN + 8: every fragment read of a warp falls in 32 distinct banks and
  // every row stays 16-byte aligned for cp.async
  static constexpr int kA = KMAJOR ? kBK * (BM + 8) : BM * (kBK + 4);
  static constexpr int kB = kBK * (BN + 8);
  static constexpr int kStage = kA + kB;
  static constexpr int kBytes = kStages * kStage * static_cast<int>(sizeof(float));
};

// EXACT: 0 3xTF32; 1 A rounded to bfloat16 as read, its small half 0, two
// products a k8 step; 2 A and B rounded, one (see the header)
template <int BM, int BN, int WARPS_M, int WARPS_N, bool KMAJOR, int EXACT = 0>
__global__ void __launch_bounds__(kThreads) gemm_3xtf32_kernel(GemmArgs p) {
  static_assert(WARPS_M * WARPS_N * 32 == kThreads, "8 warps");
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  static_assert(MT >= 1 && NT >= 1 && WM % 16 == 0 && WN % 8 == 0, "warp tile");
  using S = GemmSmem<BM, BN, KMAJOR>;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int tiles_n = (p.N + BN - 1) / BN;
  const int m0 = (blockIdx.x / tiles_n) * BM;
  const int n0 = (blockIdx.x % tiles_n) * BN;
  const float* b = p.b + blockIdx.y * p.b_step_y;
  float* c = p.c + blockIdx.y * p.c_step_y + blockIdx.z * p.c_step_z;
  const int k_begin = blockIdx.z * p.k_per_z;
  const int k_end = min(p.Kdim, k_begin + p.k_per_z);

  if (p.skip != nullptr) {
    int live = 0;
    for (int r = tid; r < BM; r += kThreads) live |= (m0 + r < p.M && p.skip[m0 + r] != 0.0f);
    if (!__syncthreads_or(live)) {
      // every row of the tile is a query without an edge
      for (int e = tid; e < BM * BN; e += kThreads) {
        const int r = m0 + e / BN, col = n0 + e % BN;
        if (r < p.M && col < p.N) c[static_cast<size_t>(r) * p.ldc + col] = 0.0f;
      }
      return;
    }
  }

  const int wm0 = (warp / WARPS_N) * WM;
  const int wn0 = (warp % WARPS_N) * WN;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    }
  }

  // 16-byte chunks; past M, N or the k range they read nothing and land as zeros
  auto load_stage = [&](int stage, int k0) {
    float* sa = smem + stage * S::kStage;
    float* sb = sa + S::kA;
    if (KMAJOR) {
      for (int i = tid; i < kBK * BM / 4; i += kThreads) {
        const int kk = i / (BM / 4), m4 = i % (BM / 4);
        const int k = k0 + kk, m = m0 + 4 * m4;
        const bool ok = k < k_end && m < p.M;
        cp_async16(sa + kk * (BM + 8) + 4 * m4,
                   ok ? p.a + static_cast<size_t>(k) * p.lda + m : p.a, ok);
      }
    } else {
      for (int i = tid; i < BM * kBK / 4; i += kThreads) {
        const int r = i / (kBK / 4), k4 = i % (kBK / 4);
        const int m = m0 + r, k = k0 + 4 * k4;
        const bool ok = m < p.M && k < k_end;
        cp_async16(sa + r * (kBK + 4) + 4 * k4,
                   ok ? p.a + static_cast<size_t>(m) * p.lda + k : p.a, ok);
      }
    }
    for (int i = tid; i < kBK * BN / 4; i += kThreads) {
      const int kk = i / (BN / 4), n4 = i % (BN / 4);
      const int k = k0 + kk, n = n0 + 4 * n4;
      const bool ok = k < k_end && n < p.N;
      cp_async16(sb + kk * (BN + 8) + 4 * n4, ok ? b + static_cast<size_t>(k) * p.ldb + n : b,
                 ok);
    }
  };

  const int ktiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ktiles) load_stage(st, k_begin + st * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // this stage has landed; later ones may be in flight
    __syncthreads();  // ... for every thread, and the slot read last round is free
    if (kt + kStages - 1 < ktiles) {
      load_stage((kt + kStages - 1) % kStages, k_begin + (kt + kStages - 1) * kBK);
    }
    cp_async_commit();
    const float* sa = smem + (kt % kStages) * S::kStage;
    const float* sb = sa + S::kA;
    // the stage's 12 products a tile go into a fresh tile, added to acc
    // once: an f32 sum of 1/4 as many terms as one add a k8 step would make
    float tile[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) tile[i][j][e] = 0.0f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t a_big[MT][4], a_small[MT][4], b_big[NT][2], b_small[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm0 + 16 * i + g;
        float v[4];
        if (KMAJOR) {
          v[0] = sa[(kk + t) * (BM + 8) + r];
          v[1] = sa[(kk + t) * (BM + 8) + r + 8];
          v[2] = sa[(kk + t + 4) * (BM + 8) + r];
          v[3] = sa[(kk + t + 4) * (BM + 8) + r + 8];
        } else {
          v[0] = sa[r * (kBK + 4) + kk + t];
          v[1] = sa[(r + 8) * (kBK + 4) + kk + t];
          v[2] = sa[r * (kBK + 4) + kk + t + 4];
          v[3] = sa[(r + 8) * (kBK + 4) + kk + t + 4];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (EXACT >= 1) v[e] = round_bf16(v[e]);
          split_tf32(v[e], a_big[i][e], a_small[i][e]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = wn0 + 8 * j + g;
        float w0 = sb[(kk + t) * (BN + 8) + col], w1 = sb[(kk + t + 4) * (BN + 8) + col];
        if constexpr (EXACT == 2) {
          w0 = round_bf16(w0);
          w1 = round_bf16(w1);
        }
        split_tf32(w0, b_big[j][0], b_small[j][0]);
        split_tf32(w1, b_big[j][1], b_small[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if constexpr (EXACT == 0) mma_tf32(tile[i][j], a_small[i], b_big[j]);
          if constexpr (EXACT <= 1) mma_tf32(tile[i][j], a_big[i], b_small[j]);
          mma_tf32(tile[i][j], a_big[i], b_big[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += tile[i][j][e];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n0 + wn0 + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm0 + 16 * i + g + 8 * h;
        if (row >= p.M || col >= p.N) continue;
        float x = acc[i][j][2 * h], y = acc[i][j][2 * h + 1];
        if (p.div != nullptr) {
          const float d = p.div[row];
          x = d != 0.0f ? x / d : 0.0f;
          y = d != 0.0f ? y / d : 0.0f;
        }
        *reinterpret_cast<float2*>(c + static_cast<size_t>(row) * p.ldc + col) =
            make_float2(x, y);
      }
    }
  }
}

// The CUDA-core form: one thread an output, the k range summed in order;
// ROUND: bit 1 A, bit 2 B rounded to bfloat16 as they are read.
template <int ROUND>
__global__ void __launch_bounds__(kThreads) gemm_f32_kernel(GemmArgs p, int kmajor) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<long long>(p.M) * p.N) return;
  const int m = static_cast<int>(idx / p.N), n = static_cast<int>(idx % p.N);
  const float* b = p.b + blockIdx.y * p.b_step_y;
  float* c = p.c + blockIdx.y * p.c_step_y + blockIdx.z * p.c_step_z;
  const int k_begin = blockIdx.z * p.k_per_z;
  const int k_end = min(p.Kdim, k_begin + p.k_per_z);
  float acc = 0.0f;
  for (int k = k_begin; k < k_end; ++k) {
    float a = kmajor ? p.a[static_cast<size_t>(k) * p.lda + m]
                     : p.a[static_cast<size_t>(m) * p.lda + k];
    float w = b[static_cast<size_t>(k) * p.ldb + n];
    if constexpr ((ROUND & 1) != 0) a = round_bf16(a);
    if constexpr ((ROUND & 2) != 0) w = round_bf16(w);
    acc = fmaf(a, w, acc);
  }
  if (p.div != nullptr) {
    const float d = p.div[m];
    acc = d != 0.0f ? acc / d : 0.0f;
  }
  c[static_cast<size_t>(m) * p.ldc + n] = acc;
}

// Widths the tensor-core tiles take: 16-byte rows and at least one n8 tile.
inline bool tensor_core_widths(int c, int d) {
  return c >= 8 && d >= 8 && c % 4 == 0 && d % 4 == 0;
}

template <int BM, int BN, int WARPS_M, int WARPS_N, bool KMAJOR, int EXACT = 0>
int launch_gemm_tc(const GemmArgs& p, int grid_y, int grid_z, cudaStream_t stream) {
  constexpr int bytes = GemmSmem<BM, BN, KMAJOR>::kBytes;
  auto kernel = gemm_3xtf32_kernel<BM, BN, WARPS_M, WARPS_N, KMAJOR, EXACT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN), grid_y, grid_z);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// round: gemm_f32_kernel's ROUND (0, 1 or 3)
inline int launch_gemm_f32(const GemmArgs& p, int kmajor, int grid_y, int grid_z,
                           cudaStream_t stream, int round = 0) {
  const long long outputs = static_cast<long long>(p.M) * p.N;
  const dim3 grid(static_cast<unsigned>((outputs + kThreads - 1) / kThreads), grid_y, grid_z);
  if (round == 3) {
    gemm_f32_kernel<3><<<grid, kThreads, 0, stream>>>(p, kmajor);
  } else if (round == 1) {
    gemm_f32_kernel<1><<<grid, kThreads, 0, stream>>>(p, kmajor);
  } else if (round == 0) {
    gemm_f32_kernel<0><<<grid, kThreads, 0, stream>>>(p, kmajor);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// c[e] = sum_s part[s, e] (slices in order), divided by div[row] if given
__global__ void __launch_bounds__(kThreads) reduce_slices_kernel(
    const float* __restrict__ part, float* __restrict__ c, const float* __restrict__ div,
    int slices, int M, int N) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long total = static_cast<long long>(M) * N;
  if (e >= total) return;
  float acc = 0.0f;
  for (int s = 0; s < slices; ++s) acc += part[s * total + e];
  if (div != nullptr) {
    const float d = div[e / N];
    acc = d != 0.0f ? acc / d : 0.0f;
  }
  c[e] = acc;
}

// The contraction's tiles and k slices for an M x N output over Kdim: 64
// columns from N = 64 on, else 32; 128 rows where that gives a wave of
// blocks, else 64; and where even 64-row tiles leave the card short of two
// waves, as many k slices (of at least 4 ring stages each) as fill them.
struct ContractionPlan {
  int bm, bn, slices, k_per_slice;
};

inline ContractionPlan plan_contraction(int M, int N, int Kdim) {
  ContractionPlan plan;
  plan.bn = N >= 64 ? 64 : 32;
  const int tiles_n = (N + plan.bn - 1) / plan.bn;
  plan.bm = ((M + 127) / 128) * tiles_n >= kSMs ? 128 : 64;
  const int tiles = ((M + plan.bm - 1) / plan.bm) * tiles_n;
  const int ktiles = (Kdim + kBK - 1) / kBK;
  int slices = 1;
  if (tiles < kSMs) slices = min((2 * kSMs + tiles - 1) / tiles, max(ktiles / kStages, 1));
  plan.k_per_slice = ((ktiles + slices - 1) / slices) * kBK;
  plan.slices = (Kdim + plan.k_per_slice - 1) / plan.k_per_slice;
  return plan;
}

// Floats of the partial-sum workspace the contraction needs (0: none).
inline long long contraction_workspace(int M, int N, int Kdim, bool tensor_cores) {
  if (!tensor_cores || M == 0 || N == 0) return 0;
  const ContractionPlan plan = plan_contraction(M, N, Kdim);
  return plan.slices > 1 ? static_cast<long long>(plan.slices) * M * N : 0;
}

// C (M x N) = A (M x Kdim, m-major) B [/ div]: the forward's out = T W /
// count and the backward's d_s = u Wt. ``part`` holds the split-K partial
// sums (contraction_workspace floats). round_operands: A and B rounded to
// bfloat16 (the C_in = 1 product at the bfloat16 point; CUDA cores only);
// exact_a: A is bfloat16-valued (the backward's rounded u at the bfloat16
// point), two products a k8 step on the tensor cores, the plain f32 product
// on the CUDA cores.
inline int launch_contraction(GemmArgs p, bool tensor_cores, float* part, cudaStream_t stream,
                              bool round_operands = false, bool exact_a = false) {
  if (p.M == 0 || p.N == 0) return 0;
  if (!tensor_cores) return launch_gemm_f32(p, 0, 1, 1, stream, round_operands ? 3 : 0);
  if (round_operands) return static_cast<int>(cudaErrorInvalidValue);
  const ContractionPlan plan = plan_contraction(p.M, p.N, p.Kdim);
  float* out = p.c;
  const float* div = p.div;
  p.skip = div;
  if (plan.slices > 1) {
    if (part == nullptr || p.ldc != p.N) return static_cast<int>(cudaErrorInvalidValue);
    p.c = part;
    p.c_step_z = static_cast<long long>(p.M) * p.N;
    p.k_per_z = plan.k_per_slice;
    p.div = nullptr;
  }
  int err;
  if (exact_a) {
    if (plan.bn == 64) {
      err = plan.bm == 128 ? launch_gemm_tc<128, 64, 4, 2, false, 1>(p, 1, plan.slices, stream)
                           : launch_gemm_tc<64, 64, 2, 4, false, 1>(p, 1, plan.slices, stream);
    } else {
      err = plan.bm == 128 ? launch_gemm_tc<128, 32, 4, 2, false, 1>(p, 1, plan.slices, stream)
                           : launch_gemm_tc<64, 32, 4, 2, false, 1>(p, 1, plan.slices, stream);
    }
  } else if (plan.bn == 64) {
    err = plan.bm == 128 ? launch_gemm_tc<128, 64, 4, 2, false>(p, 1, plan.slices, stream)
                         : launch_gemm_tc<64, 64, 2, 4, false>(p, 1, plan.slices, stream);
  } else {
    err = plan.bm == 128 ? launch_gemm_tc<128, 32, 4, 2, false>(p, 1, plan.slices, stream)
                         : launch_gemm_tc<64, 32, 4, 2, false>(p, 1, plan.slices, stream);
  }
  if (err != 0 || plan.slices == 1) return err;
  const long long total = static_cast<long long>(p.M) * p.N;
  reduce_slices_kernel<<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0,
                         stream>>>(part, out, div, plan.slices, p.M, p.N);
  return static_cast<int>(cudaGetLastError());
}

// ---- the edge pass ----------------------------------------------------------

struct EdgeArgs {
  const float* feats;      // (n_other, C): gathered through the table
  const float* self_pts;   // (R, 3): the table's rows
  const float* other_pts;  // (n_other, 3)
  const int32_t* head;     // (R, h1), sentinel n_other
  const int32_t* tail;     // (r2, h2) or null
  const int32_t* rank;     // (R,) tail row of each row, sentinel r2 (with tail)
  const uint8_t* mask;     // (R,) or null: rows that are off see no edge
  const float* kp;         // (K, 3)
  float* t_out;            // (R, K * C)
  int R, n_other, C, K, h1, h2, r2;
  int tpr, tr, chunk;      // threads a row, rows a block, edges a chunk (a multiple of 4)
  int kp_chunks, passes;   // chunks of 16 kernel points, passes over a row's channel groups
  int pool_width;          // pooled columns of a row (0: no pool)
  int pool_chunk;          // of them the pool phase stages at a time (pool_route)
  float sigma;
};

// the forward's extras: the count divisor and the shortcut max-pool
struct FwdExtras {
  const float* posflag;     // (n_other,) 1 where the feature sum is positive
  float* div_out;           // (R,) the contraction's divisor, 0 without an edge
  float* count_out;         // (R,) or null: the count residual, max(count, 1)
  const float* pool_feats;  // (n_other, P) or null
  float* pooled;            // (R, P) or null
  float* ties;              // (R, P) or null
  int P, pool_head, pool_tail;  // pooled columns of the head, of a tail row
};

// the backward's extra: the max-pool's gradient
struct BwdExtras {
  const float* pool_feats;  // (R, P) or null: this pass's rows
  const float* pooled;      // (n_other, P)
  const float* dpt;         // (n_other, P) dpool / ties
  float* d_pool;            // (R, P) or null
  int P;
};

__device__ __forceinline__ int tail_row_of(const EdgeArgs& p, int row) {
  if (p.tail == nullptr) return -1;
  const int r = p.rank[row];
  return (r >= 0 && r < p.r2) ? r : -1;
}

__device__ __forceinline__ int checked(const EdgeArgs& p, int n) {
  return (n >= 0 && n < p.n_other) ? n : p.n_other;
}

// column h of a row: its head columns, then those of its tail row (tail_row
// from tail_row_of; none: sentinels)
__device__ __forceinline__ int edge_at(const EdgeArgs& p, int row, int tail_row, int h) {
  if (h < p.h1) return checked(p, p.head[static_cast<size_t>(row) * p.h1 + h]);
  if (tail_row < 0) return p.n_other;
  return checked(p, p.tail[static_cast<size_t>(tail_row) * p.h2 + h - p.h1]);
}

template <int V>
__device__ __forceinline__ void load_row(const float* src, bool ok, float (&f)[V]) {
  if constexpr (V == 4) {
    const float4 x = ok ? *reinterpret_cast<const float4*>(src) : make_float4(0.f, 0.f, 0.f, 0.f);
    f[0] = x.x;
    f[1] = x.y;
    f[2] = x.z;
    f[3] = x.w;
  } else {
    f[0] = ok ? *src : 0.0f;
  }
}

// Shared memory of the edge pass, in 4-byte words: the chunk's influences
// (TR rows of E x 16, each row padded by 4 floats so the rows a warp reads
// fall in distinct banks), reused after the chunk loop for the pool phase's
// staged indices (TR x pool_chunk), then the chunk's indices, the kernel
// points, and each row's count, edge flag and tail row.
struct EdgeSmem {
  int row_stride, big, idx, kp, cnt, live, tails, words;
  __host__ __device__ EdgeSmem(int tr, int e, int pool_width) {
    row_stride = e * kMaxKernelPoints + 4;
    big = tr * row_stride > tr * pool_width ? tr * row_stride : tr * pool_width;
    idx = big;
    kp = idx + tr * e;
    cnt = kp + 3 * kMaxKernelPoints;
    live = cnt + tr;
    tails = live + tr;
    words = tails + tr;
  }
};

// The forward's shortcut max-pool of a block's rows over their staged
// columns (-1: absent; the sentinel: a shadow reading 0): max and tie count
// in one pass (a larger value restarts the count); a split row without a
// tail row is the zero shadow row, which enters the max but adds no tie.
// The columns come W a chunk (pool_route): a chunk after the first resumes
// the running max and tie count that the last one left in pooled and ties
// (each (row, channel) has one thread throughout), and only the last
// settles them, so the max is the same bits and the count the same number
// as in one pass. RP: each pool value rounded to bfloat16 as it is read
// (kpconv_table: the max and its ties over the gathered table's values).
template <int VP, bool RP>
__device__ void pool_rows(const EdgeArgs& p, const FwdExtras& x, const int32_t* cols_s,
                          const int32_t* tails_s, int r0, int W, bool first, bool last) {
  const int groups = x.P / VP;
  for (int i = threadIdx.x; i < p.tr * groups; i += kThreads) {
    const int ql = i / groups, ch = (i % groups) * VP;
    const int r = r0 + ql;
    if (r >= p.R) continue;
    const int32_t* cs = cols_s + ql * W;
    float m[VP], ties[VP];
#pragma unroll
    for (int v = 0; v < VP; ++v) {
      const size_t at = static_cast<size_t>(r) * x.P + ch + v;
      m[v] = first ? -INFINITY : x.pooled[at];
      ties[v] = first || x.ties == nullptr ? 0.0f : x.ties[at];
    }
    for (int h = 0; h < W; h += 4) {
      float val[4][VP];
      bool has[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n = h + u < W ? cs[h + u] : -1;
        has[u] = n >= 0;
        load_row<VP>(x.pool_feats + static_cast<size_t>(n >= 0 && n < p.n_other ? n : 0) * x.P + ch,
                     n >= 0 && n < p.n_other, val[u]);
        if constexpr (RP) {
#pragma unroll
          for (int v = 0; v < VP; ++v) val[u][v] = round_bf16(val[u][v]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (!has[u]) continue;
#pragma unroll
        for (int v = 0; v < VP; ++v) {
          if (val[u][v] > m[v]) {
            m[v] = val[u][v];
            ties[v] = 1.0f;
          } else if (val[u][v] == m[v]) {
            ties[v] += 1.0f;
          }
        }
      }
    }
    if (!last) {  // the running max and count, for the next chunk
#pragma unroll
      for (int v = 0; v < VP; ++v) {
        const size_t at = static_cast<size_t>(r) * x.P + ch + v;
        x.pooled[at] = m[v];
        if (x.ties != nullptr) x.ties[at] = ties[v];
      }
      continue;
    }
    const bool zero_shadow = p.tail != nullptr && tails_s[ql] < 0;
#pragma unroll
    for (int v = 0; v < VP; ++v) {
      if (zero_shadow && m[v] < 0.0f) {
        m[v] = 0.0f;  // the zero shadow row of a missing tail row: no tie
        ties[v] = 0.0f;
      }
      if (m[v] == -INFINITY) m[v] = 0.0f;  // no pooled column at all
      x.pooled[static_cast<size_t>(r) * x.P + ch + v] = m[v];
      if (x.ties != nullptr) x.ties[static_cast<size_t>(r) * x.P + ch + v] = fmaxf(ties[v], 1.0f);
    }
  }
}

// The backward's pool gradient of a block's rows: each gets dpool / ties
// from every query whose pooled value equals its own feature (equality is
// exact: the pooled values are f32 copies of the pool features). A chunk
// of W columns after the first resumes the sum the last one left in d_pool:
// the same sum in the same order as in one pass. RP: the row's own pool
// features rounded to bfloat16 (kpconv_table: the forward pooled rounded
// values).
template <int VP, bool RP>
__device__ void pool_grad_rows(const EdgeArgs& p, const BwdExtras& x, const int32_t* cols_s,
                               int r0, int W, bool first) {
  const int groups = x.P / VP;
  for (int i = threadIdx.x; i < p.tr * groups; i += kThreads) {
    const int ql = i / groups, ch = (i % groups) * VP;
    const int r = r0 + ql;
    if (r >= p.R) continue;
    const int32_t* cs = cols_s + ql * W;
    float own[VP], sum[VP];
    load_row<VP>(x.pool_feats + static_cast<size_t>(r) * x.P + ch, true, own);
#pragma unroll
    for (int v = 0; v < VP; ++v) {
      if constexpr (RP) own[v] = round_bf16(own[v]);
      sum[v] = first ? 0.0f : x.d_pool[static_cast<size_t>(r) * x.P + ch + v];
    }
    for (int h = 0; h < W; h += 4) {
      float pv[4][VP], dv[4][VP];
      bool ok[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = h + u < W ? cs[h + u] : p.n_other;
        ok[u] = q < p.n_other;
        const size_t at = static_cast<size_t>(ok[u] ? q : 0) * x.P + ch;
        load_row<VP>(x.pooled + at, ok[u], pv[u]);
        load_row<VP>(x.dpt + at, ok[u], dv[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < VP; ++v) {
          if (ok[u] && pv[u][v] == own[v]) sum[v] += dv[u][v];
        }
      }
    }
#pragma unroll
    for (int v = 0; v < VP; ++v) x.d_pool[static_cast<size_t>(r) * x.P + ch + v] = sum[v];
  }
}

// RM: the kRound* bits of the instance (0: the float32 point).
template <int V, bool BWD, typename Extras, int RM = 0>
__global__ void __launch_bounds__(kThreads) edge_kernel(EdgeArgs p, Extras x) {
  // the backward's u rounded a part of the table at a time: the head's
  // columns, then (where a row of the block has one) the tail's
  constexpr bool kParts = BWD && (RM & kRoundSums) != 0;
  extern __shared__ __align__(16) float smem[];
  const int E = p.chunk, TR = p.tr;
  const EdgeSmem L(TR, E, p.pool_chunk);
  float* infl_s = smem;                                             // (TR, row_stride)
  int32_t* idx_s = reinterpret_cast<int32_t*>(smem + L.idx);        // (TR, E)
  float* kp_s = smem + L.kp;                                        // (16, 3)
  float* cnt_s = smem + L.cnt;                                      // (TR,)
  int32_t* live_s = reinterpret_cast<int32_t*>(smem + L.live);      // (TR,)
  int32_t* tails_s = reinterpret_cast<int32_t*>(smem + L.tails);    // (TR,) tail row or -1

  const int tid = threadIdx.x;
  const int tpr = p.tpr, groups = p.C / V;
  const int rl = tid / tpr, cl = tid % tpr;
  const int r0 = blockIdx.x * TR;
  const int row = r0 + rl;
  const bool owner = rl < TR && row < p.R;

  // the first chunk's kernel points (16, zeros past K)
  for (int i = tid; i < 3 * kMaxKernelPoints; i += kThreads) kp_s[i] = i < 3 * p.K ? p.kp[i] : 0.0f;
  // each row's tail row, read once; the tail columns are walked only where
  // a row of the block has one
  int has_tail = 0;
  for (int i = tid; i < TR; i += kThreads) {
    cnt_s[i] = 0.0f;
    live_s[i] = 0;
    tails_s[i] = r0 + i < p.R ? tail_row_of(p, r0 + i) : -1;
    has_tail |= tails_s[i] >= 0;
  }
  const int cols = p.h1 + (__syncthreads_or(has_tail) ? p.h2 : 0);

  // pass: kernel points k0 .. k0 + 15 (K past 16: a chunk a pass) of the
  // thread's channel group cg (past 256 groups a row: 256 a pass)
  for (int pass = 0; pass < p.kp_chunks * p.passes; ++pass) {
    const int k0 = (pass / p.passes) * kMaxKernelPoints;
    const int cg = (pass % p.passes) * tpr + cl;
    const bool mine = owner && cg < groups;
    if (pass > 0 && pass % p.passes == 0) {  // the next chunk's kernel points
      __syncthreads();  // the last pass's are read
      for (int i = tid; i < 3 * kMaxKernelPoints; i += kThreads) {
        kp_s[i] = 3 * k0 + i < 3 * p.K ? p.kp[3 * k0 + i] : 0.0f;
      }
      __syncthreads();
    }

    float acc[kMaxKernelPoints][V];
#pragma unroll
    for (int k = 0; k < kMaxKernelPoints; ++k) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[k][v] = 0.0f;
    }

    // the edges of columns [lo, hi) of the block's rows into acc
    auto walk = [&](int lo, int hi) {
      for (int c0 = lo; c0 < hi; c0 += E) {
        // indices and influences of edges [c0, c0 + E) of every row of the
        // block (at most two a thread: their loads are issued together); the
        // forward also counts each row's edges here, in the first pass
        int any = 0;
        int slot[2], nn[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = tid + u * kThreads;
          slot[u] = i;
          nn[u] = p.n_other;
          if (i < TR * E) {
            const int ql = i / E, h = c0 + i % E;
            const int r = r0 + ql;
            if (r < p.R && h < hi && (p.mask == nullptr || p.mask[r])) {
              nn[u] = edge_at(p, r, tails_s[ql], h);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int i = slot[u];
          if (i >= TR * E) continue;
          const int ql = i / E, e = i % E;
          const int r = r0 + ql, n = nn[u];
          idx_s[i] = n;
          float4* dst =
              reinterpret_cast<float4*>(infl_s + ql * L.row_stride + e * kMaxKernelPoints);
          if (n < p.n_other) {
            any = 1;
            if constexpr (!BWD) {
              if (pass == 0) {
                atomicAdd(cnt_s + ql, x.posflag[n]);  // 0s and 1s: exact in any order
                live_s[ql] = 1;
              }
            }
            const float sx = BWD ? p.self_pts[3 * r + 0] : p.other_pts[3 * n + 0];
            const float sy = BWD ? p.self_pts[3 * r + 1] : p.other_pts[3 * n + 1];
            const float sz = BWD ? p.self_pts[3 * r + 2] : p.other_pts[3 * n + 2];
            const float qx = BWD ? p.other_pts[3 * n + 0] : p.self_pts[3 * r + 0];
            const float qy = BWD ? p.other_pts[3 * n + 1] : p.self_pts[3 * r + 1];
            const float qz = BWD ? p.other_pts[3 * n + 2] : p.self_pts[3 * r + 2];
            const float ox = sx - qx, oy = sy - qy, oz = sz - qz;  // support - query
            float w[kMaxKernelPoints];
#pragma unroll
            for (int k = 0; k < kMaxKernelPoints; ++k) {
              w[k] = 0.0f;
              if (k0 + k < p.K) {
                const float dx = ox - kp_s[3 * k + 0];
                const float dy = oy - kp_s[3 * k + 1];
                const float dz = oz - kp_s[3 * k + 2];
                const float d = sqrtf(dx * dx + dy * dy + dz * dz);
                w[k] = fmaxf(1.0f - d / p.sigma, 0.0f);
                if constexpr ((RM & kRoundInfl) != 0) w[k] = round_bf16(w[k]);
              }
            }
#pragma unroll
            for (int q = 0; q < kMaxKernelPoints / 4; ++q) {
              dst[q] = make_float4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
            }
          } else {
#pragma unroll
            for (int q = 0; q < kMaxKernelPoints / 4; ++q) dst[q] = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
        if (!__syncthreads_or(any)) continue;  // no edge of the block in this chunk

        if (mine) {
          const int32_t* iv = idx_s + rl * E;
          const float4* inf = reinterpret_cast<const float4*>(infl_s + rl * L.row_stride);
          for (int e = 0; e < E; e += 4) {
            int n[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) n[u] = iv[e + u];
            if (n[0] >= p.n_other && n[1] >= p.n_other && n[2] >= p.n_other &&
                n[3] >= p.n_other) {
              continue;
            }
            float f[4][V];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const bool ok = n[u] < p.n_other;
              load_row<V>(p.feats + static_cast<size_t>(ok ? n[u] : 0) * p.C + cg * V, ok, f[u]);
              if constexpr ((RM & kRoundFeats) != 0) {
#pragma unroll
                for (int v = 0; v < V; ++v) f[u][v] = round_bf16(f[u][v]);
              }
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
#pragma unroll
              for (int q = 0; q < kMaxKernelPoints / 4; ++q) {
                const float4 w = inf[(e + u) * (kMaxKernelPoints / 4) + q];
#pragma unroll
                for (int v = 0; v < V; ++v) {
                  acc[4 * q + 0][v] = fmaf(w.x, f[u][v], acc[4 * q + 0][v]);
                  acc[4 * q + 1][v] = fmaf(w.y, f[u][v], acc[4 * q + 1][v]);
                  acc[4 * q + 2][v] = fmaf(w.z, f[u][v], acc[4 * q + 2][v]);
                  acc[4 * q + 3][v] = fmaf(w.w, f[u][v], acc[4 * q + 3][v]);
                }
              }
            }
          }
        }
        __syncthreads();  // the chunk is read before the next one is staged
      }
    };

    if constexpr (kParts) {
      // each part's sums rounded to bfloat16, the tail's added to the head's
      // (the thread reads back only what it wrote)
      auto store_rounded = [&](bool add) {
        if (!mine) return;
        float* dst = p.t_out + static_cast<size_t>(row) * p.K * p.C + cg * V;
#pragma unroll
        for (int k = 0; k < kMaxKernelPoints; ++k) {
          if (k0 + k >= p.K) break;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float x = round_bf16(acc[k][v]);
            dst[(k0 + k) * p.C + v] = add ? dst[(k0 + k) * p.C + v] + x : x;
          }
        }
      };
      const bool two = cols > p.h1;  // the same for the whole block
      walk(0, two ? p.h1 : cols);
      store_rounded(false);
      if (two) {
#pragma unroll
        for (int k = 0; k < kMaxKernelPoints; ++k) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[k][v] = 0.0f;
        }
        walk(p.h1, cols);
        store_rounded(true);
      }
      continue;
    } else {
      walk(0, cols);
    }

    if (mine) {
      float* dst = p.t_out + static_cast<size_t>(row) * p.K * p.C + cg * V;
#pragma unroll
      for (int k = 0; k < kMaxKernelPoints; ++k) {
        if (k0 + k >= p.K) break;
        if constexpr (V == 4) {
          *reinterpret_cast<float4*>(dst + (k0 + k) * p.C) =
              make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
        } else {
          dst[(k0 + k) * p.C] = acc[k][0];
        }
      }
    }
  }

  if constexpr (!BWD) {
    // count divisor: neighbours whose feature sum is positive, at least 1
    // (the reference quirk, kpconv.py:113-116)
    __syncthreads();
    for (int ql = tid; ql < TR; ql += kThreads) {
      const int r = r0 + ql;
      if (r >= p.R) continue;
      const float cnt = fmaxf(cnt_s[ql], 1.0f);
      if (x.count_out != nullptr) x.count_out[r] = cnt;
      x.div_out[r] = live_s[ql] ? cnt : 0.0f;
    }
  }
  if (p.pool_width == 0) return;

  // The pool phase: each row's pooled columns staged as indices (-1: a
  // column the row does not have), pool_chunk columns at a time (all of
  // them where they fit: every shipped configuration), then one thread a
  // (row, group of VP channels) walks them, four columns' loads in flight
  // at once.
  int32_t* cols_s = reinterpret_cast<int32_t*>(smem);  // (TR, W)
  for (int w0 = 0; w0 < p.pool_width; w0 += p.pool_chunk) {
    const int W = min(p.pool_chunk, p.pool_width - w0);
    const bool first = w0 == 0, last = w0 + W >= p.pool_width;
    if (!first) __syncthreads();  // the last chunk's columns are read
    if constexpr (!BWD) {
      const int cols1 = min(x.pool_head, p.h1);
      for (int i = tid; i < TR * W; i += kThreads) {
        const int ql = i / W, h = w0 + i % W;
        const int r = r0 + ql;
        int n = -1;
        if (r < p.R) {
          const int tr_ = tails_s[ql];
          const int cols2 = tr_ >= 0 ? min(x.pool_tail, p.h2) : 0;
          const bool on = p.mask == nullptr || p.mask[r];
          if (h < cols1) {
            n = on ? edge_at(p, r, tr_, h) : p.n_other;
          } else if (h - cols1 < cols2) {
            n = on ? edge_at(p, r, tr_, p.h1 + h - cols1) : p.n_other;
          }
        }
        cols_s[i] = n;
      }
      __syncthreads();
      constexpr bool RP = (RM & kRoundPool) != 0;
      if (x.P % 4 == 0) {
        pool_rows<4, RP>(p, x, cols_s, tails_s, r0, W, first, last);
      } else {
        pool_rows<1, RP>(p, x, cols_s, tails_s, r0, W, first, last);
      }
    } else {
      for (int i = tid; i < TR * W; i += kThreads) {
        const int ql = i / W, h = w0 + i % W;
        const int r = r0 + ql;
        cols_s[i] = r < p.R ? edge_at(p, r, tails_s[ql], h) : p.n_other;
      }
      __syncthreads();
      constexpr bool RP = (RM & kRoundPool) != 0;
      if (x.P % 4 == 0) {
        pool_grad_rows<4, RP>(p, x, cols_s, r0, W, first);
      } else {
        pool_grad_rows<1, RP>(p, x, cols_s, r0, W, first);
      }
    }
  }
}

// The edge pass's shape for K kernel points and C channels
// (kernels/kpconv.py:edge_route, which the wrapper passes and the launcher
// checks): V channels a thread (4 where C % 4 == 0), threads a row (the
// row's C / V channel groups, at most 256), rows a block (256 / threads a
// row, at most 64), chunks of 16 kernel points, passes over the channel
// groups.
struct EdgeRoute {
  int v, tpr, tr, kp_chunks, passes;
};

inline EdgeRoute edge_route(int K, int C) {
  EdgeRoute r;
  r.v = C % 4 == 0 ? 4 : 1;
  const int groups = C / r.v;
  r.tpr = groups < kThreads ? groups : kThreads;
  r.tr = min(kThreads / r.tpr, 64);
  r.kp_chunks = (K + kMaxKernelPoints - 1) / kMaxKernelPoints;
  r.passes = (groups + r.tpr - 1) / r.tpr;
  return r;
}

// Edges a chunk (the staged influences at most 32 KB, 4 to 64 edges, no
// more than the table is wide) for tr rows a block over `width` columns.
inline int edge_chunk(int tr, int width) {
  int e = (8192 / (kMaxKernelPoints * tr)) & ~3;
  e = max(4, min(e, 64));
  return max(4, min(e, (width + 3) & ~3));  // tr * chunk <= 512: two staged edges a thread at most
}

// The pool phase's columns a chunk (kernels/kpconv.py:pool_route): all
// pool_width where they fit a block's `block_bytes` of shared memory beside
// the rest of the layout, else 8192 / tr words of indices a chunk (at most
// the 32 KB of the influences they reuse).
inline int pool_chunk_of(int tr, int width, int pool_width, int block_bytes) {
  if (pool_width == 0) return 0;
  const EdgeSmem whole(tr, edge_chunk(tr, width), pool_width);
  if (sizeof(float) * static_cast<size_t>(whole.words) <= static_cast<size_t>(block_bytes)) {
    return pool_width;
  }
  return max(4, (8192 / tr) & ~3);
}

// The pool phase stages pool_chunk of a row's pool_width columns at a time.
// `route` must be edge_route(K, C)'s and pool_chunk pool_chunk_of's.
// round_mode: the instance's kRound* bits, one of the forward's 0,
// kRoundInfl | kRoundFeats (kpconv_mxu at C_in > 1), kRoundFeats |
// kRoundPool (kpconv_table) and all three, or the backward's 0,
// kRoundInfl | kRoundFeats | kRoundSums (kpconv_mxu), kRoundPool
// (kpconv_table) and all four.
template <bool BWD, typename Extras>
int launch_edges(EdgeArgs p, const Extras& x, int pool_width, int pool_chunk,
                 const EdgeRoute& route, cudaStream_t stream, int round_mode = 0) {
  if (p.K < 1 || p.C < 1 || p.h1 < 0 || (p.tail != nullptr && p.h2 < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EdgeRoute want = edge_route(p.K, p.C);
  if (route.v != want.v || route.tpr != want.tpr || route.tr != want.tr ||
      route.kp_chunks != want.kp_chunks || route.passes != want.passes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int width = p.h1 + (p.tail != nullptr ? p.h2 : 0);
  if (pool_chunk != pool_chunk_of(route.tr, width, pool_width,
                                  launch_util::device_limits().block_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.R == 0) return 0;
  const int v = route.v;
  p.tpr = route.tpr;
  p.tr = route.tr;
  p.kp_chunks = route.kp_chunks;
  p.passes = route.passes;
  p.chunk = edge_chunk(p.tr, width);
  p.pool_width = pool_width;
  p.pool_chunk = pool_chunk;
  const EdgeSmem L(p.tr, p.chunk, pool_chunk);
  const size_t smem = sizeof(float) * static_cast<size_t>(L.words);
  const int blocks = (p.R + p.tr - 1) / p.tr;
  auto run = [&](auto kernel) {
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    }
    if (err == cudaSuccess) kernel<<<blocks, kThreads, smem, stream>>>(p, x);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  };
  auto instance = [&](auto rm) {
    constexpr int RM = decltype(rm)::value;
    return v == 4 ? run(edge_kernel<4, BWD, Extras, RM>) : run(edge_kernel<1, BWD, Extras, RM>);
  };
  using MxuBits = std::integral_constant<int, BWD ? kRoundInfl | kRoundFeats | kRoundSums
                                                  : kRoundInfl | kRoundFeats>;
  using TableBits = std::integral_constant<int, BWD ? kRoundPool : kRoundFeats | kRoundPool>;
  using AllBits = std::integral_constant<int, MxuBits::value | TableBits::value>;
  if (round_mode == 0) return instance(std::integral_constant<int, 0>{});
  if (round_mode == MxuBits::value) return instance(MxuBits{});
  if (round_mode == TableBits::value) return instance(TableBits{});
  if (round_mode == AllBits::value) return instance(AllBits{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace kpconv
