// Geometric structure embedding, parameter gradients, for Hopper (sm_90a):
// the products on the tensor cores (3xTF32 mma.sync), one pass over de.
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
// Design, three launches. gse_indices_kernel writes the A + 1 indices of
// every valid pair once. gse_bwd_kernel: a block owns 64 channels (a
// c-block; all C where C < 64, 32 at C = 96) and one slice of the valid pairs
// (enumerated row-major over the n_valid x n_valid square), walked in tiles
// of 16 pairs, each tile's indices and de fetched into registers while the
// tile before it runs. For each tile:
//   1. the A + 1 bases of the 16 pairs in shared memory, each value split
//      once into TF32 halves (big, small) as it is built (the same sincosf
//      of the same f32 arguments as the forward), and the tile's de for the
//      c-block, split the same way;
//   2. the A projections P_k = B_k W_a[:, c-block] (16 x 64 each, over all
//      C basis rows) as 3xTF32 mma.sync m16n8k8: warp w takes the 8
//      channels 8 w .., its A chains interleaved; W_a's c-block stays in
//      shared memory in f32 and is split as it is read;
//   3. the first argmax over k in registers (k* never leaves shared
//      memory). Where the best two projections lie within 2^-18 of
//      sum_f |W_a[f, c]| (off the diagonal), the entry is undecided: the
//      block settles it in float64 (one warp an entry), as the plain
//      version routes every entry, before any product uses k*;
//   4. dW_d += B_d^T de and dW_a += sum_k B_k^T (de * [k* = k]) as 3xTF32
//      mma.sync, warp w owning the 16-row tiles w, w + 8 of both (all 64
//      channels), its (row tile, channel tile) chains interleaved, the mask
//      applied as the de fragment is read.
// mma.sync issues in program order: a 3xTF32 product's three mma depend on
// each other, so independent tiles' mma are interleaved (mma_3xtf32_grid)
// and no mma waits on the one just before it. Each block writes its
// slice's partial sums (and db, and its count of entries settled in
// float64); gse_wgrad_reduce_kernel adds the slices in a fixed order. No
// float atomics: the same result on every run.
//
// What bounds it: operations. The minimum work is (A + 2) C^2 multiply-adds
// a valid pair (A projections, two weight products), three TF32 products
// each on the tensor cores; the kernel runs 2 A + 1 products (dW_a as A
// masked products) and builds every basis once a c-block (C / 64 times a
// pair). de is read once.
//
// Geometry is the forward's: v = p_j - p_i by subtraction, angles by atan2f
// of the cross and dot products with the +0 that makes the diagonal angle 0
// (all k tie there, their bases are equal, and first-argmax and an even
// split give the same gradient).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "gse_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;          // pairs a tile: the m16 of a projection
constexpr int kMaxAngles = 3;  // A <= 3: the bases of 16 pairs fill shared memory at C = 256
constexpr uint8_t kUndecided = 0xFF;
// channels a block (a c-block): 64, or 32 where C is not a multiple of 64
__host__ __device__ constexpr int block_channels(int C) {
  return C < 64 ? C : C % 64 == 0 ? 64 : 32;
}
// A projection sum_f B[f] W_a[f, c] of C terms (|B| <= 1) as 3xTF32 products
// added in f32 stands within 2^-23 of sum_f |W_a[f, c]| (wabs) of float64
// in the CPU emulation at C = 256 (tests/test_torch_gse_bwd_tc.py holds it
// within 2^-19 wabs, half the band below).
// Where the best two of the A projections are closer than 2^-18 wabs, the
// choice goes to float64.
constexpr float kTieTolerance = 3.814697265625e-06f;  // 2^-18

// The pair indices of every valid pair (row-major over the n_valid square),
// A + 1 floats a pair: the main kernel's c-blocks all read them.
__global__ void __launch_bounds__(kThreads) gse_indices_kernel(
    const float* __restrict__ points, const float* __restrict__ ref_vectors,
    const int32_t* __restrict__ n_valid, float* __restrict__ idx_out, int N, int A,
    float sigma_d, float factor_a) {
  const int nv = min(*n_valid, N);
  const long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= static_cast<long long>(nv) * nv) return;
  float idx[kMaxAngles + 1];
  pair_indices(points, ref_vectors, static_cast<int>(q / nv), static_cast<int>(q % nv), A,
               sigma_d, factor_a, idx);
  for (int k = 0; k <= A; ++k) idx_out[q * (A + 1) + k] = idx[k];
}

// Shared memory of a block, in 32-bit words: W_a's c-block (f32), the
// bases and de's tile as TF32 halves, the pairs' indices and state, the
// frequencies, the channels' sum |W_a|, the tile's undecided entries (16-bit)
// and k* (bytes).
template <int C, int A>
struct Layout {
  static constexpr int BC = block_channels(C);
  static constexpr int RS = BC + 8;  // W and de rows: B-fragment reads in 32 banks
  static constexpr int BS = C + 4;   // basis rows: projection A-fragment reads in 32 banks
  static constexpr int w = 0;
  static constexpr int bases = w + C * RS;
  static constexpr int de = bases + 2 * (A + 1) * kTile * BS;
  static constexpr int idx = de + 2 * kTile * RS;
  static constexpr int info = idx + (A + 1) * kTile;
  static constexpr int freqs = info + kTile;
  static constexpr int wabs = freqs + C / 2;
  static constexpr int ties = wabs + BC;
  static constexpr int tie_count = ties + kTile * BC / 2;
  static constexpr int kstar = tie_count + 1;
  static constexpr int words = kstar + kTile * BC / 4;
};

template <int C, int A>
__global__ void __launch_bounds__(kThreads, 1) gse_bwd_kernel(
    const float* __restrict__ w_a,          // (C, C)
    const float* __restrict__ div_term,     // (C / 2,)
    const int32_t* __restrict__ n_valid,
    const float* __restrict__ pair_idx,     // (n_valid^2, A + 1) from gse_indices_kernel
    const float* __restrict__ de,           // (N, N, C)
    float* __restrict__ part_d,             // (S, C, C)
    float* __restrict__ part_a,             // (S, C, C)
    float* __restrict__ part_b,             // (S, C)
    int32_t* __restrict__ part_ties,        // (S, C / BC)
    int N) {
  using L = Layout<C, A>;
  constexpr int BC = L::BC, RS = L::RS, BS = L::BS;
  constexpr int NT = BC / 8;          // 8-channel tiles of the c-block
  constexpr int MT = C / 16;          // 16-row tiles of dW
  constexpr int MW = (MT + kWarps - 1) / kWarps;  // of them a warp
  static_assert(MT % kWarps == 0 || MW == 1, "every warp's row tiles within C");
  static_assert(C % BC == 0 && NT % 4 == 0, "whole c-blocks of 4-tile groups");
  constexpr int STEPS = C / 8;        // k8 steps of a projection
  extern __shared__ uint32_t smem[];
  float* w_s = reinterpret_cast<float*>(smem + L::w);
  uint32_t* b_big = smem + L::bases;
  uint32_t* b_small = b_big + (A + 1) * kTile * BS;
  uint32_t* de_big = smem + L::de;
  uint32_t* de_small = de_big + kTile * RS;
  float* idx_s = reinterpret_cast<float*>(smem + L::idx);
  int* info_s = reinterpret_cast<int*>(smem + L::info);  // 0 none, 1 pair, 2 diagonal pair
  float* freq_s = reinterpret_cast<float*>(smem + L::freqs);
  float* wabs_s = reinterpret_cast<float*>(smem + L::wabs);
  uint16_t* ties_s = reinterpret_cast<uint16_t*>(smem + L::ties);
  int* tie_count = reinterpret_cast<int*>(smem + L::tie_count);
  uint8_t* kstar_s = reinterpret_cast<uint8_t*>(smem + L::kstar);  // (16, BC)

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int c0 = blockIdx.x * BC;
  const int s = blockIdx.y;
  const int nv = min(*n_valid, N);
  const long long total = static_cast<long long>(nv) * nv;
  const long long begin = total * s / gridDim.y;
  const long long end = total * (s + 1) / gridDim.y;

  // W_a's c-block, each channel's sum_f |W_a[f, c]|, the frequencies
  for (int e = tid; e < C * BC; e += kThreads) {
    const int f = e / BC, c = e % BC;
    w_s[f * RS + c] = w_a[static_cast<size_t>(f) * C + c0 + c];
  }
  if (tid < BC) {
    float sum = 0.0f;
    for (int f = 0; f < C; ++f) sum += fabsf(w_a[static_cast<size_t>(f) * C + c0 + tid]);
    wabs_s[tid] = sum;
  }
  for (int fr = tid; fr < C / 2; fr += kThreads) freq_s[fr] = div_term[fr];
  if (tid == 0) *tie_count = 0;

  float acc_d[MW][NT][4], acc_a[MW][NT][4];  // rows 16 (warp + 8 m) .., channels 8 n ..
#pragma unroll
  for (int m = 0; m < MW; ++m) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_d[m][n][e] = acc_a[m][n][e] = 0.0f;
    }
  }
  // de: pair slot tid / 16, channels DC (tid % 16) ..; db of those
  constexpr int DC = BC / 16;
  float db[DC];
#pragma unroll
  for (int i = 0; i < DC; ++i) db[i] = 0.0f;
  int settled = 0;

  // the next tile's indices and de, fetched into registers a tile ahead
  float idx_next = 0.0f;
  float de_next[DC];
  auto fetch = [&](long long q0) {
    const int pairs = static_cast<int>(min(static_cast<long long>(kTile), end - q0));
    if (tid < kTile * (A + 1)) {
      idx_next = tid / (A + 1) < pairs ? pair_idx[q0 * (A + 1) + tid] : 0.0f;
    }
    const int p = tid / 16;
    const long long q = q0 + p;
    const float* src = de + (static_cast<size_t>(q / nv) * N + static_cast<size_t>(q % nv)) * C +
                       c0 + DC * (tid % 16);
#pragma unroll
    for (int i = 0; i < DC; ++i) de_next[i] = p < pairs ? src[i] : 0.0f;
  };
  if (begin < end) fetch(begin);

  for (long long q0 = begin; q0 < end; q0 += kTile) {
    const int pairs = static_cast<int>(min(static_cast<long long>(kTile), end - q0));
    __syncthreads();  // the previous tile is consumed
    // 1. the tile's indices, state and de (split), then the next tile's fetch
    if (tid < kTile * (A + 1)) idx_s[(tid % (A + 1)) * kTile + tid / (A + 1)] = idx_next;
    if (tid < kTile) {
      const long long q = q0 + tid;
      info_s[tid] = tid >= pairs ? 0 : q / nv == q % nv ? 2 : 1;
    }
#pragma unroll
    for (int i = 0; i < DC; ++i) {
      db[i] += de_next[i];
      store_split(de_big, de_small, (tid / 16) * RS + DC * (tid % 16) + i, de_next[i]);
    }
    if (q0 + kTile < end) fetch(q0 + kTile);
    __syncthreads();
    // the bases: a thread takes two frequencies of one (basis, pair) row at a
    // time and stores their (sin, cos) halves as one 16-byte word each
    constexpr int FR2 = C / 4;
#pragma unroll 4
    for (int it = 0; it < ((A + 1) * kTile * FR2 + kThreads - 1) / kThreads; ++it) {
      const int e = tid + kThreads * it;
      if (e >= (A + 1) * kTile * FR2) break;
      const int row = e / FR2, j = e % FR2;  // row = k 16 + p
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (row % kTile < pairs) {
        const float x = idx_s[row];
        sincosf(x * freq_s[2 * j], &v[0], &v[1]);
        sincosf(x * freq_s[2 * j + 1], &v[2], &v[3]);
      }
      uint4 big, small;
      split_tf32(v[0], big.x, small.x);
      split_tf32(v[1], big.y, small.y);
      split_tf32(v[2], big.z, small.z);
      split_tf32(v[3], big.w, small.w);
      *reinterpret_cast<uint4*>(b_big + row * BS + 4 * j) = big;
      *reinterpret_cast<uint4*>(b_small + row * BS + 4 * j) = small;
    }
    __syncthreads();

    // 2-3. projections and the first argmax: warp w takes the 8 channels
    // 8 w .. over all basis rows, its A chains (two k8 steps at a time)
    // interleaved; entries within the band go to float64
    if (warp < NT) {
      float proj[A][4];
#pragma unroll
      for (int k = 0; k < A; ++k) {
#pragma unroll
        for (int e = 0; e < 4; ++e) proj[k][e] = 0.0f;
      }
      const int wc = warp * 8 + g;
#pragma unroll 2
      for (int step = 0; step < STEPS; ++step) {
        const int f = 8 * step + t;
        const float w0 = w_s[f * RS + wc], w1 = w_s[(f + 4) * RS + wc];
        uint32_t wb[1][2], ws[1][2];
        split_tf32(w0, wb[0][0], ws[0][0]);
        split_tf32(w1, wb[0][1], ws[0][1]);
        uint32_t ab[A][4], as[A][4];
#pragma unroll
        for (int k = 0; k < A; ++k) {
          const uint32_t* bb = b_big + k * kTile * BS;
          const uint32_t* bs = b_small + k * kTile * BS;
          ab[k][0] = bb[g * BS + f];
          ab[k][1] = bb[(g + 8) * BS + f];
          ab[k][2] = bb[g * BS + f + 4];
          ab[k][3] = bb[(g + 8) * BS + f + 4];
          as[k][0] = bs[g * BS + f];
          as[k][1] = bs[(g + 8) * BS + f];
          as[k][2] = bs[g * BS + f + 4];
          as[k][3] = bs[(g + 8) * BS + f + 4];
        }
        mma_3xtf32_grid<A, 1>(proj, ab, as, wb, ws);
      }
      // C fragment: e -> (pair g + 8 (e / 2), channel 8 w + 2 t + e % 2)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = g + 8 * (e / 2), c = warp * 8 + 2 * t + e % 2;
        float best = proj[0][e], second = -INFINITY;
        int arg = 0;
#pragma unroll
        for (int k = 1; k < A; ++k) {
          if (proj[k][e] > best) {
            second = best;
            best = proj[k][e];
            arg = k;
          } else {
            second = fmaxf(second, proj[k][e]);
          }
        }
        // on the diagonal every k ties exactly with equal bases: any k, the first
        const bool tie = info_s[p] == 1 && best - second <= kTieTolerance * wabs_s[c];
        kstar_s[p * BC + c] = tie ? kUndecided : static_cast<uint8_t>(arg);
        if (tie) ties_s[atomicAdd(tie_count, 1)] = static_cast<uint16_t>(p * BC + c);
      }
    }
    __syncthreads();
    const int ties = *tie_count;
    if (ties > 0) {
      // k* of each undecided entry: the A projections in float64 over bases
      // whose arguments are the f32 products idx * div_term and whose sines
      // and cosines are exact to float64; lanes take every 32nd frequency,
      // an xor butterfly adds them
      for (int e = warp; e < ties; e += kWarps) {
        const int p = ties_s[e] / BC, c = ties_s[e] % BC;
        double best = 0.0;
        int arg = 0;
        for (int k = 0; k < A; ++k) {
          double sum = 0.0;
          for (int fr = lane; fr < C / 2; fr += 32) {
            double sn, cs;
            sincos(static_cast<double>(idx_s[k * kTile + p] * freq_s[fr]), &sn, &cs);
            sum = fma(sn, static_cast<double>(w_s[2 * fr * RS + c]), sum);
            sum = fma(cs, static_cast<double>(w_s[(2 * fr + 1) * RS + c]), sum);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
          if (k == 0 || sum > best) {
            best = sum;
            arg = k;
          }
        }
        if (lane == 0) kstar_s[p * BC + c] = static_cast<uint8_t>(arg);
      }
      settled += ties;
      __syncthreads();
      if (tid == 0) *tie_count = 0;
    }

    // 4. dW_d += B_d^T de, dW_a += sum_k B_k^T (de [k* = k]): warp w owns
    // the 16-row tiles w, w + 8 of both; a (k8 step, 4 channel tiles) group
    // reads de and k* once for all A + 1 bases, each product's (row tile,
    // channel tile) chains interleaved
    if (warp < MT) {
#pragma unroll
      for (int step = 0; step < kTile / 8; ++step) {
        const int p = 8 * step + t;
#pragma unroll
        for (int n0 = 0; n0 < NT; n0 += 4) {
          uint32_t de_b[4][2], de_s[4][2];
          int ks[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int c = (n0 + n) * 8 + g;
            de_b[n][0] = de_big[p * RS + c];
            de_b[n][1] = de_big[(p + 4) * RS + c];
            de_s[n][0] = de_small[p * RS + c];
            de_s[n][1] = de_small[(p + 4) * RS + c];
            ks[n][0] = kstar_s[p * BC + c];
            ks[n][1] = kstar_s[(p + 4) * BC + c];
          }
#pragma unroll
          for (int k = 0; k <= A; ++k) {  // k = A: the distance basis, dW_d
            const uint32_t* bb = b_big + k * kTile * BS;
            const uint32_t* bs = b_small + k * kTile * BS;
            uint32_t ab[MW][4], as[MW][4];
#pragma unroll
            for (int m = 0; m < MW; ++m) {
              const int f = (warp + kWarps * m) * 16 + g;
              ab[m][0] = bb[p * BS + f];
              ab[m][1] = bb[p * BS + f + 8];
              ab[m][2] = bb[(p + 4) * BS + f];
              ab[m][3] = bb[(p + 4) * BS + f + 8];
              as[m][0] = bs[p * BS + f];
              as[m][1] = bs[p * BS + f + 8];
              as[m][2] = bs[(p + 4) * BS + f];
              as[m][3] = bs[(p + 4) * BS + f + 8];
            }
            uint32_t db_[4][2], ds_[4][2];
#pragma unroll
            for (int n = 0; n < 4; ++n) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const bool keep = k == A || ks[n][h] == k;
                db_[n][h] = keep ? de_b[n][h] : 0u;
                ds_[n][h] = keep ? de_s[n][h] : 0u;
              }
            }
            float tile[MW * 4][4];
#pragma unroll
            for (int i = 0; i < MW * 4; ++i) {
#pragma unroll
              for (int e = 0; e < 4; ++e) tile[i][e] = 0.0f;
            }
            mma_3xtf32_grid<MW, 4>(tile, ab, as, db_, ds_);
#pragma unroll
            for (int m = 0; m < MW; ++m) {
#pragma unroll
              for (int n = 0; n < 4; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  if (k == A) {
                    acc_d[m][n0 + n][e] += tile[m * 4 + n][e];
                  } else {
                    acc_a[m][n0 + n][e] += tile[m * 4 + n][e];
                  }
                }
              }
            }
          }
        }
      }
    }
  }

  // the slice's partial sums
  float* pd = part_d + static_cast<size_t>(s) * C * C;
  float* pa = part_a + static_cast<size_t>(s) * C * C;
  if (warp < MT) {
#pragma unroll
    for (int m = 0; m < MW; ++m) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const size_t at = static_cast<size_t>((warp + kWarps * m) * 16 + g + 8 * (e / 2)) * C +
                            c0 + n * 8 + 2 * t + e % 2;
          pd[at] = acc_d[m][n][e];
          pa[at] = acc_a[m][n][e];
        }
      }
    }
  }
  __syncthreads();
  float* db_s = reinterpret_cast<float*>(b_big);  // (16, BC): each pair slot's db, in slot order
#pragma unroll
  for (int i = 0; i < DC; ++i) db_s[(tid / 16) * BC + DC * (tid % 16) + i] = db[i];
  __syncthreads();
  if (tid < BC) {
    float sum = 0.0f;
    for (int p = 0; p < kTile; ++p) sum += db_s[p * BC + tid];
    part_b[static_cast<size_t>(s) * C + c0 + tid] = sum;
  }
  if (tid == 0) part_ties[static_cast<size_t>(s) * gridDim.x + blockIdx.x] = settled;
}

// dW_d, dW_a, db = sums of the slices' partials, in slice order; the count
// of entries settled in float64.
__global__ void __launch_bounds__(kThreads) gse_wgrad_reduce_kernel(
    const float* __restrict__ part_d, const float* __restrict__ part_a,
    const float* __restrict__ part_b, const int32_t* __restrict__ part_ties,
    float* __restrict__ dw_d, float* __restrict__ dw_a, float* __restrict__ db,
    int32_t* __restrict__ settled, int S, int C) {
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
  } else if (e == cc + C) {
    int sum = 0;
    for (int b = 0; b < S * (C / block_channels(C)); ++b) sum += part_ties[b];
    *settled = sum;
  }
}

template <int C, int A>
int launch(const float* points, const float* ref_vectors, const float* w_a, const float* div_term,
           const int32_t* n_valid, const float* de, float* pair_idx, float* part_d, float* part_a,
           float* part_b, int32_t* part_ties, float* dw_d, float* dw_a, float* db,
           int32_t* settled, int N, int S, float sigma_d, float factor_a, cudaStream_t stream) {
  const long long pairs = static_cast<long long>(N) * N;  // covers the valid square
  gse_indices_kernel<<<static_cast<unsigned>((pairs + kThreads - 1) / kThreads), kThreads, 0,
                       stream>>>(points, ref_vectors, n_valid, pair_idx, N, A, sigma_d, factor_a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(uint32_t) * Layout<C, A>::words;
  err = cudaFuncSetAttribute(gse_bwd_kernel<C, A>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gse_bwd_kernel<C, A><<<dim3(C / block_channels(C), S), kThreads, smem, stream>>>(
      w_a, div_term, n_valid, pair_idx, de, part_d, part_a, part_b, part_ties, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gse_wgrad_reduce_kernel<<<(C * C + C + 1 + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part_d, part_a, part_b, part_ties, dw_d, dw_a, db, settled, S, C);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_angles(int A, const float* points, const float* ref_vectors, const float* w_a,
                  const float* div_term, const int32_t* n_valid, const float* de, float* pair_idx,
                  float* part_d, float* part_a, float* part_b, int32_t* part_ties, float* dw_d,
                  float* dw_a, float* db, int32_t* settled, int N, int S, float sigma_d,
                  float factor_a, cudaStream_t stream) {
  switch (A) {
    case 1: return launch<C, 1>(points, ref_vectors, w_a, div_term, n_valid, de, pair_idx, part_d, part_a, part_b, part_ties, dw_d, dw_a, db, settled, N, S, sigma_d, factor_a, stream);
    case 2: return launch<C, 2>(points, ref_vectors, w_a, div_term, n_valid, de, pair_idx, part_d, part_a, part_b, part_ties, dw_d, dw_a, db, settled, N, S, sigma_d, factor_a, stream);
    case 3: return launch<C, 3>(points, ref_vectors, w_a, div_term, n_valid, de, pair_idx, part_d, part_a, part_b, part_ties, dw_d, dw_a, db, settled, N, S, sigma_d, factor_a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Pair slices: about one block an SM over the c-blocks, at least one tile
// a slice. The wrapper sizes the partials with it.
int gse_bwd_slices(int N, int C) {
  const int c_blocks = C >= 32 ? C / block_channels(C) : 1;
  int slices = (132 + c_blocks - 1) / c_blocks;
  const int max_slices = (N * N + kTile - 1) / kTile;
  if (slices > max_slices) slices = max_slices;
  return slices < 1 ? 1 : slices;
}

// A (angles) in 1..3, C in {32, 64, 96, 128, 256}; pair_idx holds N^2 (A + 1)
// floats.
int gse_bwd_launch(const float* points, const float* ref_vectors, const float* w_a,
                   const float* div_term, const int32_t* n_valid, const float* de,
                   float* pair_idx, float* part_d, float* part_a, float* part_b,
                   int32_t* part_ties, float* dw_d, float* dw_a, float* db, int32_t* settled,
                   int N, int A, int C, int S, float sigma_d, float factor_a, void* stream) {
  if (A < 1 || A > kMaxAngles || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 0) {
    cudaMemsetAsync(dw_d, 0, sizeof(float) * C * C, s);
    cudaMemsetAsync(dw_a, 0, sizeof(float) * C * C, s);
    cudaMemsetAsync(settled, 0, sizeof(int32_t), s);
    return static_cast<int>(cudaMemsetAsync(db, 0, sizeof(float) * C, s));
  }
  switch (C) {
    case 32: return launch_angles<32>(A, points, ref_vectors, w_a, div_term, n_valid, de, pair_idx, part_d, part_a, part_b, part_ties, dw_d, dw_a, db, settled, N, S, sigma_d, factor_a, s);
    case 64: return launch_angles<64>(A, points, ref_vectors, w_a, div_term, n_valid, de, pair_idx, part_d, part_a, part_b, part_ties, dw_d, dw_a, db, settled, N, S, sigma_d, factor_a, s);
    case 96: return launch_angles<96>(A, points, ref_vectors, w_a, div_term, n_valid, de, pair_idx, part_d, part_a, part_b, part_ties, dw_d, dw_a, db, settled, N, S, sigma_d, factor_a, s);
    case 128: return launch_angles<128>(A, points, ref_vectors, w_a, div_term, n_valid, de, pair_idx, part_d, part_a, part_b, part_ties, dw_d, dw_a, db, settled, N, S, sigma_d, factor_a, s);
    case 256: return launch_angles<256>(A, points, ref_vectors, w_a, div_term, n_valid, de, pair_idx, part_d, part_a, part_b, part_ties, dw_d, dw_a, db, settled, N, S, sigma_d, factor_a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
