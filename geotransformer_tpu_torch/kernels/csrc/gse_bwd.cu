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
// Shapes (kernels/gse.py:gse_route picks the instance; the launcher checks
// it): any even C and any A. The basis rows go in CH chunks of FC rows (an
// instance: a multiple of 32 up to 256; CH = 1 up to C = 256), the angles
// in groups of G = 3 (the last one partial). Operands are padded as they
// are staged: W_a's rows and columns past C and the frequencies past
// C / 2 read as zeros, de's channels past C as zeros, and only rows and
// channels below C are stored.
// Where C is one chunk's width and A = 3 (every shipped configuration: C =
// 96, 128, 256) a RESIDENT instance, every width and trip count a constant,
// keeps W_a's c-block and each tile's A + 1 bases in shared memory
// throughout, as below. Otherwise the projections are summed over the chunks
// (W_a's chunk staged in its turn) a group of angles at a time, the best and
// second-best carried across the groups, before k* is chosen; then the
// block's own chunk of basis rows (blocks across the grid, one a chunk) is
// rebuilt a group at a time for dW_a and dW_d.
//
// Design, three launches. gse_indices_kernel writes the A + 1 indices of
// every valid pair once. gse_bwd_kernel: a block owns 64 channels (a
// c-block; 32 where the chunk's rows are no multiple of 64) of one chunk of
// dW's rows and one slice of the valid pairs (enumerated row-major over the
// n_valid x n_valid square), walked in tiles of 16 pairs, each tile's
// indices and de fetched into registers while the tile before it runs. For
// each tile:
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
// pair; past one chunk or one group twice, and the projections once a row
// chunk). de is read once a row chunk.
//
// The bfloat16 basis point (PrecisionConfig.gse_basis, the JAX kernel's
// BASIS_DTYPE: geotransformer_tpu/kernels/gse.py:322-372, 386-387) is an
// instance of each kernel (BF): every basis value and W_a rounded to
// bfloat16 as built and staged, so the projections and the first argmax
// over k are the rounded operands'; de rounded before both weight products
// (the JAX wgrad's cot.astype(BASIS_DTYPE), :344), db summed from de as it
// comes. Bases, W_a and de are then TF32 values and every product exact, so
// each takes one TF32 pass of mma.sync (mma_tf32_grid) where 3xTF32 takes
// three. Entries whose best two projections lie within the band settle in
// float64 on the rounded operands: the f64 sines and cosines rounded to f32
// and then to bfloat16, the staged W_a rounded, so the settled k* is the
// rounded projections' argmax, as the plain version's. A bfloat16
// embedding's cotangent arrives widened to f32 by the wrapper; at
// gse_basis float32 it runs the float32 instance, as the JAX kernel's f32
// wgrad does.
//
// Geometry is the forward's: v = p_j - p_i by subtraction, angles by atan2f
// of the cross and dot products with the +0 that makes the diagonal angle 0
// (all k tie there, their bases are equal, and first-argmax and an even
// split give the same gradient).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "gse_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;          // pairs a tile: the m16 of a projection
constexpr int kGroup = 3;          // angles a group: 16 pairs' bases fill shared memory at FC = 256
constexpr int kChunk = 32;         // the basis rows' granule
constexpr int kMaxRows = 256;      // the widest row chunk
// k* of an entry: a byte in the resident instance (A = 3), 16 bits in the
// general one (any A below 0xFFFF); the largest value marks an undecided
// entry (a tie to settle in float64)
template <bool RESIDENT>
using KStar = typename std::conditional<RESIDENT, uint8_t, uint16_t>::type;
__host__ __device__ constexpr int undecided(bool resident) { return resident ? 0xFF : 0xFFFF; }
// channels a block (a c-block): 64, or 32 where the chunk's rows are not a
// multiple of 64
__host__ __device__ constexpr int block_channels(int FC) { return FC % 64 == 0 ? 64 : 32; }
// A projection sum_f B[f] W_a[f, c] of C terms (|B| <= 1) as 3xTF32 products
// added in f32 stands within 2^-23 of sum_f |W_a[f, c]| (wabs) of float64
// in the CPU emulation at C = 256 (tests/test_torch_gse_bwd_tc.py holds it
// within 2^-19 wabs, half the band below, at C = 256 and 512).
// Where the best two of the A projections are closer than 2^-18 wabs, the
// choice goes to float64.
constexpr float kTieTolerance = 3.814697265625e-06f;  // 2^-18

// The pair indices of every valid pair (row-major over the n_valid square),
// A + 1 floats a pair (the distance last): the main kernel's blocks all read
// them.
__global__ void __launch_bounds__(kThreads) gse_indices_kernel(
    const float* __restrict__ points, const float* __restrict__ ref_vectors,
    const int32_t* __restrict__ n_valid, float* __restrict__ idx_out, int N, int A,
    float sigma_d, float factor_a) {
  const int nv = min(*n_valid, N);
  const long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= static_cast<long long>(nv) * nv) return;
  const int i = static_cast<int>(q / nv);
  const float3 v = pair_offset(points, i, static_cast<int>(q % nv));
  for (int k = 0; k < A; ++k) idx_out[q * (A + 1) + k] = angle_index(v, ref_vectors, i, k, A, factor_a);
  idx_out[q * (A + 1) + A] = distance_index(v, sigma_d);
}

// Shared memory of a block, in 32-bit words: W_a's c-block (f32) over the
// chunk's rows, the bases of a group (and the distance) and de's tile as
// TF32 halves, the pairs' indices and state, the chunk's frequencies, the
// channels' sum |W_a|, the tile's undecided entries (16-bit) and k* (bytes
// where RESIDENT, else 16-bit).
template <int FC, bool RESIDENT>
struct Layout {
  static constexpr int G = kGroup;
  static constexpr int BC = block_channels(FC);
  static constexpr int RS = BC + 8;  // W and de rows: B-fragment reads in 32 banks
  static constexpr int BS = FC + 4;  // basis rows: projection A-fragment reads in 32 banks
  static constexpr int w = 0;
  static constexpr int bases = w + FC * RS;
  static constexpr int de = bases + 2 * (G + 1) * kTile * BS;
  static constexpr int idx = de + 2 * kTile * RS;
  static constexpr int info = idx + (G + 1) * kTile;
  static constexpr int freqs = info + kTile;
  static constexpr int wabs = freqs + FC / 2;
  static constexpr int ties = wabs + BC;
  static constexpr int tie_count = ties + kTile * BC / 2;
  static constexpr int kstar = tie_count + 1;
  static constexpr int words = kstar + kTile * BC * static_cast<int>(sizeof(KStar<RESIDENT>)) / 4;
};

template <int FC, bool RESIDENT, bool BF>
__global__ void __launch_bounds__(kThreads, 1) gse_bwd_kernel(
    const float* __restrict__ w_a,          // (C, C)
    const float* __restrict__ div_term,     // (C / 2,)
    const int32_t* __restrict__ n_valid,
    const float* __restrict__ pair_idx,     // (n_valid^2, A + 1) from gse_indices_kernel
    const float* __restrict__ de,           // (N, N, C)
    float* __restrict__ part_d,             // (S, C, C)
    float* __restrict__ part_a,             // (S, C, C)
    float* __restrict__ part_b,             // (S, C)
    int32_t* __restrict__ part_ties,        // (S, CB)
    int N, int C_in, int A_in, int CH_in) {
  using L = Layout<FC, RESIDENT>;
  constexpr int G = kGroup;
  // RESIDENT: C = FC in one chunk and A = G (one group), every width and
  // trip count a constant; W_a's c-block and each tile's bases stay in
  // shared memory throughout
  const int C = RESIDENT ? FC : C_in, A = RESIDENT ? G : A_in, CH = RESIDENT ? 1 : CH_in;
  constexpr bool resident = RESIDENT;
  constexpr int BC = L::BC, RS = L::RS, BS = L::BS;
  constexpr int NT = BC / 8;          // 8-channel tiles of the c-block
  constexpr int MT = FC / 16;         // 16-row tiles of the chunk's dW rows
  constexpr int MW = (MT + kWarps - 1) / kWarps;  // of them a warp
  // C = 160, 192, 224: the row tiles are no multiple of the warps, the last
  // round's warps past MT take none
  constexpr bool kRagged = MT % kWarps != 0 && MW > 1;
  static_assert(NT % 4 == 0, "whole c-blocks of 4-tile groups");
  constexpr int STEPS = FC / 8;       // k8 steps of a chunk
  extern __shared__ uint32_t smem[];
  float* w_s = reinterpret_cast<float*>(smem + L::w);
  uint32_t* b_big = smem + L::bases;
  uint32_t* b_small = b_big + (G + 1) * kTile * BS;
  uint32_t* de_big = smem + L::de;
  uint32_t* de_small = de_big + kTile * RS;
  float* idx_s = reinterpret_cast<float*>(smem + L::idx);
  int* info_s = reinterpret_cast<int*>(smem + L::info);  // 0 none, 1 pair, 2 diagonal pair
  float* freq_s = reinterpret_cast<float*>(smem + L::freqs);
  float* wabs_s = reinterpret_cast<float*>(smem + L::wabs);
  uint16_t* ties_s = reinterpret_cast<uint16_t*>(smem + L::ties);
  int* tie_count = reinterpret_cast<int*>(smem + L::tie_count);
  using KS = KStar<RESIDENT>;
  KS* kstar_s = reinterpret_cast<KS*>(smem + L::kstar);  // (16, BC)

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int cb = blockIdx.x / CH, r = blockIdx.x % CH;  // c-block, row chunk
  const int c0 = cb * BC, r0 = r * FC;
  const int s = blockIdx.y;
  const int nv = min(*n_valid, N);
  const long long total = static_cast<long long>(nv) * nv;
  const long long begin = total * s / gridDim.y;
  const long long end = total * (s + 1) / gridDim.y;
  const int half = C / 2;
  const int groups = RESIDENT ? 1 : (A + G - 1) / G;

  // W_a's c-block over chunk q's rows (zeros past row or column C)
  auto stage_w = [&](int q) {
    for (int e = tid; e < FC * BC; e += kThreads) {
      const int f = q * FC + e / BC, c = c0 + e % BC;
      const float x = f < C && c < C ? w_a[static_cast<size_t>(f) * C + c] : 0.0f;
      w_s[(e / BC) * RS + e % BC] = BF ? round_bf16(x) : x;
    }
  };
  // chunk q's frequencies (zeros past C / 2)
  auto stage_freqs = [&](int q) {
    for (int fr = tid; fr < FC / 2; fr += kThreads) {
      const int f = q * (FC / 2) + fr;
      freq_s[fr] = f < half ? div_term[f] : 0.0f;
    }
  };
  // each channel's sum_f |W_a[f, c]|, the frequencies
  if (tid < BC) {
    float sum = 0.0f;
    if (c0 + tid < C) {
      for (int f = 0; f < C; ++f) {
        const float x = w_a[static_cast<size_t>(f) * C + c0 + tid];
        sum += fabsf(BF ? round_bf16(x) : x);
      }
    }
    wabs_s[tid] = sum;
  }
  if (CH == 1) {
    stage_w(0);
    stage_freqs(0);
  }
  if (tid == 0) *tie_count = 0;

  float acc_d[MW][NT][4], acc_a[MW][NT][4];  // rows r0 + 16 (warp + 8 m) .., channels 8 n ..
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

  // the next tile's indices (resident: all A + 1 of them) and de, fetched
  // into registers a tile ahead
  float idx_next = 0.0f;
  float de_next[DC];
  auto fetch = [&](long long q0) {
    const int pairs = static_cast<int>(min(static_cast<long long>(kTile), end - q0));
    if (resident && tid < kTile * (A + 1)) {
      idx_next = tid / (A + 1) < pairs ? pair_idx[q0 * (A + 1) + tid] : 0.0f;
    }
    const int p = tid / 16;
    const long long q = q0 + p;
    const int ch = c0 + DC * (tid % 16);
    const float* src =
        de + (static_cast<size_t>(q / nv) * N + static_cast<size_t>(q % nv)) * C + ch;
#pragma unroll
    for (int i = 0; i < DC; ++i) de_next[i] = p < pairs && ch + i < C ? src[i] : 0.0f;
  };
  if (begin < end) fetch(begin);

  // the bases of slots 0 .. G - 1 (angles g0 ..; zeros past A) and, with
  // `distance`, slot G (the distance; else zeros) over chunk q's rows, from
  // the indices and frequencies in shared memory: a thread takes two
  // frequencies of one (basis, pair) row at a time and stores their (sin,
  // cos) halves as one 16-byte word each
  auto build = [&](int pairs) {
    constexpr int FR2 = FC / 4;
#pragma unroll 4
    for (int it = 0; it < ((G + 1) * kTile * FR2 + kThreads - 1) / kThreads; ++it) {
      const int e = tid + kThreads * it;
      if (e >= (G + 1) * kTile * FR2) break;
      const int row = e / FR2, j = e % FR2;  // row = k 16 + p
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (row % kTile < pairs) {
        const float x = idx_s[row];
        sincosf(x * freq_s[2 * j], &v[0], &v[1]);
        sincosf(x * freq_s[2 * j + 1], &v[2], &v[3]);
        if constexpr (BF) {
#pragma unroll
          for (int e2 = 0; e2 < 4; ++e2) v[e2] = round_bf16(v[e2]);
        }
      }
      uint4 big, small;
      split_tf32(v[0], big.x, small.x);
      split_tf32(v[1], big.y, small.y);
      split_tf32(v[2], big.z, small.z);
      split_tf32(v[3], big.w, small.w);
      *reinterpret_cast<uint4*>(b_big + row * BS + 4 * j) = big;
      *reinterpret_cast<uint4*>(b_small + row * BS + 4 * j) = small;
    }
  };
  // past the resident case: the group's indices from pair_idx, slot G the
  // distance's where asked for (slots past A, and the distance slot
  // otherwise, get index 0: finite bases that no product reads)
  auto load_indices = [&](long long q0, int pairs, int g0, bool distance) {
    if (tid < (G + 1) * kTile) {
      const int k = tid / kTile, p = tid % kTile;
      const int angle = k < G ? g0 + k : A;
      const bool on = p < pairs && (k < G ? angle < A : distance);
      idx_s[tid] = on ? pair_idx[(q0 + p) * (A + 1) + angle] : 0.0f;
    }
  };

  for (long long q0 = begin; q0 < end; q0 += kTile) {
    const int pairs = static_cast<int>(min(static_cast<long long>(kTile), end - q0));
    __syncthreads();  // the previous tile is consumed
    // 1. the tile's indices, state and de (split), then the next tile's fetch
    if (resident && tid < kTile * (A + 1)) idx_s[(tid % (A + 1)) * kTile + tid / (A + 1)] = idx_next;
    if (tid < kTile) {
      const long long q = q0 + tid;
      info_s[tid] = tid >= pairs ? 0 : q / nv == q % nv ? 2 : 1;
    }
#pragma unroll
    for (int i = 0; i < DC; ++i) {
      db[i] += de_next[i];
      store_split(de_big, de_small, (tid / 16) * RS + DC * (tid % 16) + i,
                  BF ? round_bf16(de_next[i]) : de_next[i]);
    }
    if (q0 + kTile < end) fetch(q0 + kTile);
    __syncthreads();
    if (resident) {
      build(pairs);
      __syncthreads();
    }

    // 2-3. projections and the first argmax: warp w takes the 8 channels
    // 8 w .. over all basis rows, a group's chains (two k8 steps at a time)
    // interleaved; the best two carried across the groups; entries within
    // the band go to float64
    float best[4], second[4];
    int arg[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) best[e] = second[e] = -INFINITY, arg[e] = 0;
    for (int gi = 0; gi < groups; ++gi) {
      const int g0 = gi * G;
      float proj[G][4];
#pragma unroll
      for (int k = 0; k < G; ++k) {
#pragma unroll
        for (int e = 0; e < 4; ++e) proj[k][e] = 0.0f;
      }
      for (int q = 0; q < CH; ++q) {
        if (!resident) {
          __syncthreads();  // the last chunk's W, indices and bases are read
          if (CH > 1) {
            stage_w(q);
            stage_freqs(q);
          }
          load_indices(q0, pairs, g0, false);
          __syncthreads();
          build(pairs);
          __syncthreads();
        }
        if (warp < NT) {
          const int wc = warp * 8 + g;
#pragma unroll 2
          for (int step = 0; step < STEPS; ++step) {
            const int f = 8 * step + t;
            const float w0 = w_s[f * RS + wc], w1 = w_s[(f + 4) * RS + wc];
            uint32_t wb[1][2], ws[1][2];
            split_tf32(w0, wb[0][0], ws[0][0]);
            split_tf32(w1, wb[0][1], ws[0][1]);
            uint32_t ab[G][4], as[G][4];
#pragma unroll
            for (int k = 0; k < G; ++k) {
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
            if constexpr (BF) {
              mma_tf32_grid<G, 1>(proj, ab, wb);
            } else {
              mma_3xtf32_grid<G, 1>(proj, ab, as, wb, ws);
            }
          }
        }
      }
      // the group's projections in angle order: the first maximum, and the
      // second best beside it
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (g0 + k >= A) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (g0 + k == 0) {
            best[e] = proj[k][e];
          } else if (proj[k][e] > best[e]) {
            second[e] = best[e];
            best[e] = proj[k][e];
            arg[e] = g0 + k;
          } else {
            second[e] = fmaxf(second[e], proj[k][e]);
          }
        }
      }
    }
    if (warp < NT) {
      // C fragment: e -> (pair g + 8 (e / 2), channel 8 w + 2 t + e % 2)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = g + 8 * (e / 2), c = warp * 8 + 2 * t + e % 2;
        // on the diagonal every k ties exactly with equal bases: any k, the first
        // (channels past C have no weights: no choice to settle)
        const bool tie = info_s[p] == 1 && c0 + c < C &&
                         best[e] - second[e] <= kTieTolerance * wabs_s[c];
        kstar_s[p * BC + c] =
            tie ? static_cast<KS>(undecided(RESIDENT)) : static_cast<KS>(arg[e]);
        if (tie) ties_s[atomicAdd(tie_count, 1)] = static_cast<uint16_t>(p * BC + c);
      }
    }
    __syncthreads();
    const int ties = *tie_count;
    if (ties > 0) {
      // k* of each undecided entry: the A projections in float64 over bases
      // whose arguments are the f32 products idx * div_term and whose sines
      // and cosines are exact to float64; lanes take every 32nd frequency,
      // an xor butterfly adds them. W_a and the frequencies from shared
      // memory where one chunk holds them all, the indices where the tile
      // holds them all (resident), else through L1
      for (int e = warp; e < ties; e += kWarps) {
        const int p = ties_s[e] / BC, c = ties_s[e] % BC;
        const float* w_col = w_a + c0 + c;
        double best64 = 0.0;
        int arg64 = 0;
        for (int k = 0; k < A; ++k) {
          const float x = resident ? idx_s[k * kTile + p] : pair_idx[(q0 + p) * (A + 1) + k];
          double sum = 0.0;
          for (int fr = lane; fr < half; fr += 32) {
            double sn, cs;
            sincos(static_cast<double>(x * (CH == 1 ? freq_s[fr] : div_term[fr])), &sn, &cs);
            float w0 = CH == 1 ? w_s[2 * fr * RS + c] : w_col[static_cast<size_t>(2 * fr) * C];
            float w1 =
                CH == 1 ? w_s[(2 * fr + 1) * RS + c] : w_col[static_cast<size_t>(2 * fr + 1) * C];
            if constexpr (BF) {  // the rounded operands (w_s holds them already)
              sn = round_bf16(__double2float_rn(sn));
              cs = round_bf16(__double2float_rn(cs));
              w0 = round_bf16(w0);
              w1 = round_bf16(w1);
            }
            sum = fma(sn, static_cast<double>(w0), sum);
            sum = fma(cs, static_cast<double>(w1), sum);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
          if (k == 0 || sum > best64) {
            best64 = sum;
            arg64 = k;
          }
        }
        if (lane == 0) kstar_s[p * BC + c] = static_cast<KS>(arg64);
      }
      settled += ties;
      __syncthreads();
      if (tid == 0) *tie_count = 0;
    }

    // 4. dW_d += B_d^T de, dW_a += sum_k B_k^T (de [k* = k]) over the
    // block's rows: warp w owns the 16-row tiles w, w + 8 of both; a (k8
    // step, 4 channel tiles) group reads de and k* once for all the slots'
    // bases, each product's (row tile, channel tile) chains interleaved.
    // Past the resident case the block's chunk is rebuilt a group at a time,
    // the distance with the last.
    for (int gi = 0; gi < (resident ? 1 : groups); ++gi) {
      const int g0 = gi * G;
      const bool with_d = gi == groups - 1;
      if (!resident) {
        __syncthreads();  // the last bases are read
        if (CH > 1) stage_freqs(r);
        load_indices(q0, pairs, g0, with_d);
        __syncthreads();
        build(pairs);
        __syncthreads();
      }
      if (warp >= MT) continue;
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
          for (int k = 0; k <= G; ++k) {  // k = G: the distance basis, dW_d
            if (k == G ? !with_d : g0 + k >= A) continue;
            const uint32_t* bb = b_big + k * kTile * BS;
            const uint32_t* bs = b_small + k * kTile * BS;
            uint32_t ab[MW][4], as[MW][4];
#pragma unroll
            for (int m = 0; m < MW; ++m) {
              const int f = (kRagged && warp + kWarps * m >= MT ? warp : warp + kWarps * m) * 16 + g;
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
                const bool keep = k == G || ks[n][h] == g0 + k;
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
            if constexpr (BF) {
              mma_tf32_grid<MW, 4>(tile, ab, db_);
            } else {
              mma_3xtf32_grid<MW, 4>(tile, ab, as, db_, ds_);
            }
#pragma unroll
            for (int m = 0; m < MW; ++m) {
#pragma unroll
              for (int n = 0; n < 4; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  if (k == G) {
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

  // the slice's partial sums over the block's rows and channels below C
  float* pd = part_d + static_cast<size_t>(s) * C * C;
  float* pa = part_a + static_cast<size_t>(s) * C * C;
  if (warp < MT) {
#pragma unroll
    for (int m = 0; m < MW; ++m) {
      if (kRagged && warp + kWarps * m >= MT) continue;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + (warp + kWarps * m) * 16 + g + 8 * (e / 2);
          const int col = c0 + n * 8 + 2 * t + e % 2;
          if (row >= C || col >= C) continue;
          const size_t at = static_cast<size_t>(row) * C + col;
          pd[at] = acc_d[m][n][e];
          pa[at] = acc_a[m][n][e];
        }
      }
    }
  }
  if (r != 0) return;  // db and the settled count: the first row chunk's blocks
  __syncthreads();
  float* db_s = reinterpret_cast<float*>(b_big);  // (16, BC): each pair slot's db, in slot order
#pragma unroll
  for (int i = 0; i < DC; ++i) db_s[(tid / 16) * BC + DC * (tid % 16) + i] = db[i];
  __syncthreads();
  if (tid < BC && c0 + tid < C) {
    float sum = 0.0f;
    for (int p = 0; p < kTile; ++p) sum += db_s[p * BC + tid];
    part_b[static_cast<size_t>(s) * C + c0 + tid] = sum;
  }
  if (tid == 0) part_ties[static_cast<size_t>(s) * (gridDim.x / CH) + cb] = settled;
}

// dW_d, dW_a, db = sums of the slices' partials, in slice order; the count
// of entries settled in float64.
__global__ void __launch_bounds__(kThreads) gse_wgrad_reduce_kernel(
    const float* __restrict__ part_d, const float* __restrict__ part_a,
    const float* __restrict__ part_b, const int32_t* __restrict__ part_ties,
    float* __restrict__ dw_d, float* __restrict__ dw_a, float* __restrict__ db,
    int32_t* __restrict__ settled, int S, int C, int CB) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long cc = static_cast<long long>(C) * C;
  if (e < cc) {
    float sd = 0.0f, sa = 0.0f;
    for (int s = 0; s < S; ++s) {
      sd += part_d[s * cc + e];
      sa += part_a[s * cc + e];
    }
    dw_d[e] = sd;
    dw_a[e] = sa;
  } else if (e < cc + C) {
    float sb = 0.0f;
    for (int s = 0; s < S; ++s) sb += part_b[static_cast<size_t>(s) * C + (e - cc)];
    db[e - cc] = sb;
  } else if (e == cc + C) {
    int sum = 0;
    for (int b = 0; b < S * CB; ++b) sum += part_ties[b];
    *settled = sum;
  }
}

// The instance of (C, A) (kernels/gse.py:gse_route, which the wrapper
// follows): CH chunks of FC basis rows, CB c-blocks; resident: C = FC in
// one chunk and A = kGroup.
struct Route {
  int FC, CH, CB;
  bool resident;
};

inline Route route_of(int C, int A) {
  Route r;
  const int rows = round_up(C, kChunk);
  r.CH = (rows + kMaxRows - 1) / kMaxRows;
  r.FC = round_up((rows + r.CH - 1) / r.CH, kChunk);
  r.resident = r.CH == 1 && A == kGroup && C == r.FC;
  const int bc = block_channels(r.FC);
  r.CB = (C + bc - 1) / bc;
  return r;
}

template <int FC, bool RESIDENT, bool BF>
int launch(const float* points, const float* ref_vectors, const float* w_a, const float* div_term,
           const int32_t* n_valid, const float* de, float* pair_idx, float* part_d, float* part_a,
           float* part_b, int32_t* part_ties, float* dw_d, float* dw_a, float* db,
           int32_t* settled, int N, int C, int A, int CH, int CB, int S, int words, float sigma_d,
           float factor_a, cudaStream_t stream) {
  if (words != Layout<FC, RESIDENT>::words) return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = static_cast<long long>(N) * N;  // covers the valid square
  gse_indices_kernel<<<static_cast<unsigned>((pairs + kThreads - 1) / kThreads), kThreads, 0,
                       stream>>>(points, ref_vectors, n_valid, pair_idx, N, A, sigma_d, factor_a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(uint32_t) * Layout<FC, RESIDENT>::words;
  err = cudaFuncSetAttribute(gse_bwd_kernel<FC, RESIDENT, BF>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gse_bwd_kernel<FC, RESIDENT, BF><<<dim3(CB * CH, S), kThreads, smem, stream>>>(
      w_a, div_term, n_valid, pair_idx, de, part_d, part_a, part_b, part_ties, N, C, A, CH);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long outputs = static_cast<long long>(C) * C + C + 1;
  gse_wgrad_reduce_kernel<<<static_cast<unsigned>((outputs + kThreads - 1) / kThreads), kThreads,
                            0, stream>>>(part_d, part_a, part_b, part_ties, dw_d, dw_a, db,
                                         settled, S, C, CB);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Pair slices: about one block an SM over the blocks of a slice (c-blocks
// times row chunks), at least one tile a slice. The wrapper sizes the
// partials with it.
int gse_bwd_slices(int N, int blocks) {
  int slices = (132 + blocks - 1) / blocks;
  const int max_slices = (N * N + kTile - 1) / kTile;
  if (slices > max_slices) slices = max_slices;
  return slices < 1 ? 1 : slices;
}

// The route (FC basis rows a chunk, CH chunks, CB c-blocks, resident, a
// block's shared memory in words) must be route_of(C, A)'s:
// kernels/gse.py:gse_route computes it. C even, 1 <= A < 0xFFFF (k* is a
// byte in the resident instance, whose A is 3, 16 bits in the general one,
// the largest value undecided); pair_idx holds N^2 (A + 1) floats, the
// partials S slices of (C, C), (C,) and (CB,). basis_bf16: the bfloat16
// basis point's instance.
int gse_bwd_launch(const float* points, const float* ref_vectors, const float* w_a,
                   const float* div_term, const int32_t* n_valid, const float* de,
                   float* pair_idx, float* part_d, float* part_a, float* part_b,
                   int32_t* part_ties, float* dw_d, float* dw_a, float* db, int32_t* settled,
                   int N, int A, int C, int FC, int CH, int CB, int resident, int S, int words,
                   int basis_bf16, float sigma_d, float factor_a, void* stream) {
  const Route r = route_of(C, A);
  if (A < 1 || A >= undecided(r.resident) || C < 2 || C % 2 != 0 || S < 1 || FC != r.FC ||
      CH != r.CH || CB != r.CB || (resident != 0) != r.resident) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 0) {
    cudaMemsetAsync(dw_d, 0, sizeof(float) * C * C, s);
    cudaMemsetAsync(dw_a, 0, sizeof(float) * C * C, s);
    cudaMemsetAsync(settled, 0, sizeof(int32_t), s);
    return static_cast<int>(cudaMemsetAsync(db, 0, sizeof(float) * C, s));
  }
#define GSE_BWD_ARGS                                                                         \
  points, ref_vectors, w_a, div_term, n_valid, de, pair_idx, part_d, part_a, part_b, part_ties, \
      dw_d, dw_a, db, settled, N, C, A, CH, CB, S, words, sigma_d, factor_a, s
#define GSE_BWD_ROWS(W) \
  case 4 * W: return launch<W, false, false>(GSE_BWD_ARGS); \
  case 4 * W + 1: return launch<W, true, false>(GSE_BWD_ARGS); \
  case 4 * W + 2: return launch<W, false, true>(GSE_BWD_ARGS); \
  case 4 * W + 3: return launch<W, true, true>(GSE_BWD_ARGS)
  switch (4 * FC + (r.resident ? 1 : 0) + (basis_bf16 != 0 ? 2 : 0)) {
    GSE_BWD_ROWS(32);
    GSE_BWD_ROWS(64);
    GSE_BWD_ROWS(96);
    GSE_BWD_ROWS(128);
    GSE_BWD_ROWS(160);
    GSE_BWD_ROWS(192);
    GSE_BWD_ROWS(224);
    GSE_BWD_ROWS(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GSE_BWD_ROWS
#undef GSE_BWD_ARGS
}

}  // extern "C"
