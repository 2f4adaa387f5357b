// Geometric structure embedding, parameter gradients, for Hopper (sm_90a),
// f32 on the CUDA cores.
//
// Replaces geotransformer_tpu/kernels/gse.py:_gse_full_bwd (pallas_call at
// :413, body _gse_full_bwd_kernel :290). The forward (gse.cu) is
//   e[i, j, c] = sum_f B_d[i, j, f] W_d[f, c] + max_k sum_f B_k[i, j, f] W_a[f, c] + b_d + b_a
// with B the interleaved sin/cos bases of the pair's distance and k angle
// indices. Given de = dL/de over the valid rectangle [0, n_valid)^2:
//   dW_d[f, c] = sum_{ij} B_d[i, j, f] de[i, j, c]
//   dW_a[f, c] = sum_{ij} B_{k*}[i, j, f] de[i, j, c],  k* = k*(i, j, c) the
//                FIRST k attaining the max (the JAX kernel's rule, :361-371)
//   db         = sum_{ij} de[i, j, c]            (db_d = db_a)
// Points and reference vectors get no gradient (batch geometry).
//
// Design, three launches:
//   1. gse_argmax_kernel recomputes the k angle projections exactly as the
//      forward does (one row i, 32 columns j a block; bases built 32 rows at
//      a time in shared memory beside the matching rows of W_a; a 4-pair x
//      C/32-channel register tile a thread) and stores k* as one byte per
//      (pair, channel). Blocks outside the valid rectangle return at once.
//      Where the best two projections lie within f32 rounding of each other
//      (2^-18 of sum_f |W_a[f, c]|; off the diagonal), it leaves k*
//      undecided, and gse_tie_kernel settles it by the float64 argmax, as
//      the plain version routes every entry: f32 rounding in either never
//      picks the k (a tie routed to another k moved dW_a by ~|de|, 1e-4 of
//      a small gradient, on the ModelNet path in one state of training).
//   2. gse_wgrad_partial_kernel: a block owns 32 basis rows f of both dW
//      and one slice of the valid pairs. For 32 pairs at a time it rebuilds
//      the bases of its 32 rows for the distance and every angle in shared
//      memory (the same sincosf of the same index as the forward), then
//      every thread, one channel c, adds B[f] de[c] into 32 / (256 / C)
//      rows of dW_d and of dW_a (B_{k*} picked per channel). Each slice
//      writes its own partial sums.
//   3. gse_wgrad_reduce_kernel adds the slices in a fixed order: no float
//      atomics, the same result on every run.
// What bounds it: the work is 2 (A + 2) C^2 FMAs a valid pair (A argmax
// projections, two weight products), ~0.2 TFLOP per cloud at 3DMatch size,
// f32 on the CUDA cores; de (N^2 C f32) is read once by pass 1 and once per
// 32-row block of pass 2. Tensor cores are the later redesign's work.
//
// Geometry is the forward's: v = p_j - p_i by subtraction, angles by atan2f
// of the cross and dot products with the +0 that makes the diagonal angle 0
// (all k tie there, their bases are equal, and first-argmax and an even
// split give the same gradient).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 32;       // pairs per block (pass 1) / per batch (pass 2)
constexpr int kChunk = 32;       // basis rows per shared-memory chunk
constexpr int kMaxAngles = 4;
constexpr int kMaxChannels = 256;
constexpr uint8_t kUndecided = 0xFF;  // k* of a tie within f32 rounding, settled in float64
// A projection sum_f B[f] W_a[f, c] of C f32 terms (|B| <= 1) errs by at
// most C 2^-24 sum_f |W_a[f, c]| (wabs) and, its roundings falling either
// way, by a few sqrt(C) 2^-24 wabs in practice: about 2^-20 wabs at C = 256.
// Where the best two of the A projections are closer than 2^-18 wabs, pass 1
// leaves the choice to float64.
constexpr float kTieTolerance = 3.814697265625e-06f;  // 2^-18

// Distance index (idx[A]) and angle indices (idx[0..A-1]) of pair (i, j).
// The angles are rounded one operation at a time (no contraction into FMAs),
// in the order the plain version (kernels/gse.py:_pair_indices) writes them:
// both take bit-identical angle indices, so a projection tie is settled on
// the same numbers.
__device__ __forceinline__ void pair_indices(const float* __restrict__ points,
                                             const float* __restrict__ ref_vectors,
                                             int i, int j, int A, float sigma_d,
                                             float factor_a, float* idx) {
  const float vx = points[3 * j + 0] - points[3 * i + 0];
  const float vy = points[3 * j + 1] - points[3 * i + 1];
  const float vz = points[3 * j + 2] - points[3 * i + 2];
  idx[A] = sqrtf(vx * vx + vy * vy + vz * vz) / sigma_d;
  for (int k = 0; k < A; ++k) {
    const float* u = ref_vectors + (static_cast<size_t>(i) * A + k) * 3;
    const float cx = __fsub_rn(__fmul_rn(u[1], vz), __fmul_rn(u[2], vy));
    const float cy = __fsub_rn(__fmul_rn(u[2], vx), __fmul_rn(u[0], vz));
    const float cz = __fsub_rn(__fmul_rn(u[0], vy), __fmul_rn(u[1], vx));
    const float s = __fsqrt_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cy, cy)), __fmul_rn(cz, cz)));
    const float c = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(u[0], vx), __fmul_rn(u[1], vy)), __fmul_rn(u[2], vz)),
        0.0f);
    idx[k] = __fmul_rn(atan2f(s, c), factor_a);
  }
}

template <int CPT>  // channels per thread; C = 32 * CPT
__global__ void __launch_bounds__(kThreads) gse_argmax_kernel(
    const float* __restrict__ points,       // (N, 3)
    const float* __restrict__ ref_vectors,  // (N, A, 3)
    const float* __restrict__ w_a,          // (C, C)
    const float* __restrict__ div_term,     // (C / 2,)
    const int32_t* __restrict__ n_valid,
    const float* __restrict__ wabs,         // (C,) sum_f |W_a[f, c]|
    uint8_t* __restrict__ kstar,            // (N, N, C)
    int N, int A, float sigma_d, float factor_a) {
  constexpr int C = 32 * CPT;
  __shared__ float idx_s[kMaxAngles + 1][kPairs];
  __shared__ float basis_s[kPairs][kChunk];
  __shared__ float w_s[kChunk * C];

  const int tid = threadIdx.x;
  const int i = blockIdx.y;
  const int j0 = blockIdx.x * kPairs;
  const int nv = min(*n_valid, N);
  if (i >= nv || j0 >= nv) return;

  if (tid < kPairs) {
    float idx[kMaxAngles + 1] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (j0 + tid < N) pair_indices(points, ref_vectors, i, j0 + tid, A, sigma_d, factor_a, idx);
    for (int k = 0; k <= A; ++k) idx_s[k][tid] = idx[k];
  }

  const int pg = tid / 32;
  const int cl = tid % 32;
  float best[4][CPT], second[4][CPT];
  uint8_t arg[4][CPT];
  float cur[4][CPT];
  for (int pass = 0; pass < A; ++pass) {
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) cur[pp][jj] = 0.0f;
    }
    for (int f0 = 0; f0 < C; f0 += kChunk) {
      __syncthreads();
      for (int e = tid; e < kPairs * kChunk / 2; e += kThreads) {
        const int p = e / (kChunk / 2);
        const int fr = e % (kChunk / 2);
        float s, c;
        sincosf(idx_s[pass][p] * div_term[f0 / 2 + fr], &s, &c);
        basis_s[p][2 * fr] = s;
        basis_s[p][2 * fr + 1] = c;
      }
      for (int e = tid; e < kChunk * C; e += kThreads) {
        w_s[e] = w_a[static_cast<size_t>(f0) * C + e];
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
    // first k attaining the max: a later k replaces only a strictly larger one
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) {
        if (pass == 0) {
          best[pp][jj] = cur[pp][jj];
          second[pp][jj] = -INFINITY;
          arg[pp][jj] = 0;
        } else if (cur[pp][jj] > best[pp][jj]) {
          second[pp][jj] = best[pp][jj];
          best[pp][jj] = cur[pp][jj];
          arg[pp][jj] = static_cast<uint8_t>(pass);
        } else {
          second[pp][jj] = fmaxf(second[pp][jj], cur[pp][jj]);
        }
      }
    }
  }

  // on the diagonal every k ties exactly with equal bases: any k, the first
#pragma unroll
  for (int pp = 0; pp < 4; ++pp) {
    const int j = j0 + 4 * pg + pp;
    if (j >= nv) continue;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) {
      const int c = cl + 32 * jj;
      const bool tie = j != i && best[pp][jj] - second[pp][jj] <= kTieTolerance * wabs[c];
      kstar[(static_cast<size_t>(i) * N + j) * C + c] = tie ? kUndecided : arg[pp][jj];
    }
  }
}

// k* of the entries pass 1 left undecided: the A projections in float64 over
// bases whose arguments are the f32 products idx * div_term of pass 1 and
// whose sines and cosines are exact to float64; the first k attaining the
// max. A thread looks at one entry of the valid square; a warp settles its
// undecided entries one after the other, each lane taking every 32nd
// frequency and an xor butterfly adding the lanes' sums (the same sum in
// every lane). The plain version routes every entry by the float64 argmax.
__global__ void __launch_bounds__(kThreads) gse_tie_kernel(
    const float* __restrict__ points, const float* __restrict__ ref_vectors,
    const float* __restrict__ w_a, const float* __restrict__ div_term,
    const int32_t* __restrict__ n_valid, uint8_t* __restrict__ kstar, int N, int A, int C,
    float sigma_d, float factor_a) {
  const int nv = min(*n_valid, N);
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x % 32;
  const bool inside = e < static_cast<long long>(nv) * nv * C;
  const bool mine =
      inside && kstar[(e / (static_cast<long long>(C) * nv) * N + (e / C) % nv) * C + e % C] ==
                    kUndecided;
  unsigned undecided = __ballot_sync(0xffffffffu, mine);
  while (undecided != 0) {
    const int src = __ffs(undecided) - 1;
    undecided &= undecided - 1;
    const long long t = __shfl_sync(0xffffffffu, e, src);
    const int c = static_cast<int>(t % C);
    const int j = static_cast<int>((t / C) % nv);
    const int i = static_cast<int>(t / (static_cast<long long>(C) * nv));
    float idx[kMaxAngles + 1];
    pair_indices(points, ref_vectors, i, j, A, sigma_d, factor_a, idx);
    double best = 0.0;
    int arg = 0;
    for (int k = 0; k < A; ++k) {
      double proj = 0.0;
      for (int fr = lane; fr < C / 2; fr += 32) {
        double sn, cs;
        sincos(static_cast<double>(idx[k] * div_term[fr]), &sn, &cs);
        proj = fma(sn, static_cast<double>(w_a[static_cast<size_t>(2 * fr) * C + c]), proj);
        proj = fma(cs, static_cast<double>(w_a[static_cast<size_t>(2 * fr + 1) * C + c]), proj);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) proj += __shfl_xor_sync(0xffffffffu, proj, off);
      if (k == 0 || proj > best) {
        best = proj;
        arg = k;
      }
    }
    if (lane == src) kstar[(static_cast<size_t>(i) * N + j) * C + c] = static_cast<uint8_t>(arg);
  }
}

// Partial weight gradients of 32 basis rows [f0, f0 + 32) over one slice of
// the valid pairs (enumerated row-major over the n_valid x n_valid square).
template <int C>
__global__ void __launch_bounds__(kThreads) gse_wgrad_partial_kernel(
    const float* __restrict__ points, const float* __restrict__ ref_vectors,
    const float* __restrict__ div_term, const int32_t* __restrict__ n_valid,
    const float* __restrict__ de,        // (N, N, C)
    const uint8_t* __restrict__ kstar,   // (N, N, C)
    float* __restrict__ part_d,          // (S, C, C)
    float* __restrict__ part_a,          // (S, C, C)
    float* __restrict__ part_b,          // (S, C)
    int N, int A, float sigma_d, float factor_a) {
  constexpr int G = kThreads / C;     // row groups
  constexpr int R = kChunk / G;       // rows a thread
  __shared__ float idx_s[kMaxAngles + 1][kPairs];
  __shared__ float basis_s[kMaxAngles + 1][kPairs][kChunk + 1];

  const int tid = threadIdx.x;
  const int c = tid % C;
  const int g = tid / C;
  const int f0 = blockIdx.x * kChunk;
  const int s = blockIdx.y;
  const int slices = gridDim.y;
  const int nv = min(*n_valid, N);
  const long long total = static_cast<long long>(nv) * nv;
  const long long begin = total * s / slices;
  const long long end = total * (s + 1) / slices;

  float acc_d[R], acc_a[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc_d[r] = 0.0f;
    acc_a[r] = 0.0f;
  }
  float acc_b = 0.0f;

  for (long long q0 = begin; q0 < end; q0 += kPairs) {
    const int pairs = static_cast<int>(min(static_cast<long long>(kPairs), end - q0));
    __syncthreads();  // previous batch consumed
    if (tid < kPairs) {
      float idx[kMaxAngles + 1] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (tid < pairs) {
        const long long q = q0 + tid;
        pair_indices(points, ref_vectors, static_cast<int>(q / nv), static_cast<int>(q % nv),
                     A, sigma_d, factor_a, idx);
      }
      for (int k = 0; k <= A; ++k) idx_s[k][tid] = idx[k];
    }
    __syncthreads();
    for (int e = tid; e < (A + 1) * kPairs * (kChunk / 2); e += kThreads) {
      const int pass = e / (kPairs * (kChunk / 2));
      const int rest = e % (kPairs * (kChunk / 2));
      const int p = rest / (kChunk / 2);
      const int fr = rest % (kChunk / 2);
      float sn, cs;
      sincosf(idx_s[pass][p] * div_term[f0 / 2 + fr], &sn, &cs);
      basis_s[pass][p][2 * fr] = sn;
      basis_s[pass][p][2 * fr + 1] = cs;
    }
    __syncthreads();
    for (int p = 0; p < pairs; ++p) {
      const long long q = q0 + p;
      const size_t e = (static_cast<size_t>(q / nv) * N + static_cast<size_t>(q % nv)) * C + c;
      const float dv = de[e];
      const int ks = kstar[e];
      acc_b += dv;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int f = g + G * r;
        acc_d[r] = fmaf(basis_s[A][p][f], dv, acc_d[r]);
        acc_a[r] = fmaf(basis_s[ks][p][f], dv, acc_a[r]);
      }
    }
  }

  float* pd = part_d + static_cast<size_t>(s) * C * C;
  float* pa = part_a + static_cast<size_t>(s) * C * C;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int f = f0 + g + G * r;
    pd[static_cast<size_t>(f) * C + c] = acc_d[r];
    pa[static_cast<size_t>(f) * C + c] = acc_a[r];
  }
  if (blockIdx.x == 0 && g == 0) part_b[static_cast<size_t>(s) * C + c] = acc_b;
}

// dW_d, dW_a, db = sums of the slices' partials, in slice order.
__global__ void __launch_bounds__(kThreads) gse_wgrad_reduce_kernel(
    const float* __restrict__ part_d, const float* __restrict__ part_a,
    const float* __restrict__ part_b, float* __restrict__ dw_d, float* __restrict__ dw_a,
    float* __restrict__ db, int S, int C) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int cc = C * C;
  if (e < cc) {
    float sd = 0.0f, sa = 0.0f;
    for (int s = 0; s < S; ++s) {
      sd += part_d[static_cast<size_t>(s) * cc + e];
      sa += part_a[static_cast<size_t>(s) * cc + e];
    }
    dw_d[e] = sd;
    dw_a[e] = sa;
  } else if (e < cc + C) {
    float sb = 0.0f;
    for (int s = 0; s < S; ++s) sb += part_b[static_cast<size_t>(s) * C + (e - cc)];
    db[e - cc] = sb;
  }
}

template <int CPT>
int launch(const float* points, const float* ref_vectors, const float* w_a, const float* wabs,
           const float* div_term, const int32_t* n_valid, const float* de, uint8_t* kstar,
           float* part_d, float* part_a, float* part_b, float* dw_d, float* dw_a, float* db,
           int N, int A, int S, float sigma_d, float factor_a, cudaStream_t stream) {
  constexpr int C = 32 * CPT;
  gse_argmax_kernel<CPT><<<dim3((N + kPairs - 1) / kPairs, N), kThreads, 0, stream>>>(
      points, ref_vectors, w_a, div_term, n_valid, wabs, kstar, N, A, sigma_d, factor_a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long entries = static_cast<long long>(N) * N * C;  // covers the valid square
  gse_tie_kernel<<<static_cast<unsigned>((entries + kThreads - 1) / kThreads), kThreads, 0,
                   stream>>>(points, ref_vectors, w_a, div_term, n_valid, kstar, N, A, C,
                             sigma_d, factor_a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gse_wgrad_partial_kernel<C><<<dim3(C / kChunk, S), kThreads, 0, stream>>>(
      points, ref_vectors, div_term, n_valid, de, kstar, part_d, part_a, part_b, N, A,
      sigma_d, factor_a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gse_wgrad_reduce_kernel<<<(C * C + C + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part_d, part_a, part_b, dw_d, dw_a, db, S, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Pair slices of pass 2: about four blocks an SM over the C / 32 row
// blocks, at least 64 pairs a slice. The wrapper sizes the partials with it.
int gse_bwd_slices(int N, int C) {
  const int row_blocks = C / kChunk > 0 ? C / kChunk : 1;
  int slices = (4 * 132 + row_blocks - 1) / row_blocks;
  const int max_slices = (N * N + 63) / 64;
  if (slices > max_slices) slices = max_slices;
  return slices < 1 ? 1 : slices;
}

int gse_bwd_launch(const float* points, const float* ref_vectors, const float* w_a,
                   const float* wabs, const float* div_term, const int32_t* n_valid,
                   const float* de, uint8_t* kstar, float* part_d, float* part_a, float* part_b,
                   float* dw_d, float* dw_a, float* db, int N, int A, int C, int S,
                   float sigma_d, float factor_a, void* stream) {
  if (A < 1 || A > kMaxAngles || C > kMaxChannels || S < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 0) {
    cudaMemsetAsync(dw_d, 0, sizeof(float) * C * C, s);
    cudaMemsetAsync(dw_a, 0, sizeof(float) * C * C, s);
    return static_cast<int>(cudaMemsetAsync(db, 0, sizeof(float) * C, s));
  }
  switch (C) {
    case 32: return launch<1>(points, ref_vectors, w_a, wabs, div_term, n_valid, de, kstar, part_d, part_a, part_b, dw_d, dw_a, db, N, A, S, sigma_d, factor_a, s);
    case 64: return launch<2>(points, ref_vectors, w_a, wabs, div_term, n_valid, de, kstar, part_d, part_a, part_b, dw_d, dw_a, db, N, A, S, sigma_d, factor_a, s);
    case 128: return launch<4>(points, ref_vectors, w_a, wabs, div_term, n_valid, de, kstar, part_d, part_a, part_b, dw_d, dw_a, db, N, A, S, sigma_d, factor_a, s);
    case 256: return launch<8>(points, ref_vectors, w_a, wabs, div_term, n_valid, de, kstar, part_d, part_a, part_b, dw_d, dw_a, db, N, A, S, sigma_d, factor_a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
