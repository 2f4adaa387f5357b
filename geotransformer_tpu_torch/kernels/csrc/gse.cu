// Geometric structure embedding for Hopper (sm_90a): the basis projections
// on the tensor cores (3xTF32 mma.sync).
//
// Replaces geotransformer_tpu/kernels/gse.py:gse_embedding_full (pallas_call
// at :262; body _gse_full_kernel :132, geometry _tile_indices :85). For each
// pair (i, j) of one cloud's superpoints:
//   d      = |p_j - p_i| / sigma_d
//   a_k    = atan2(|u_ik x v|, u_ik . v) * 180 / (sigma_a pi),  v = p_j - p_i
//   e[i,j] = sincos(d) @ W_d + max_k sincos(a_k) @ W_a + b_d + b_a
// where sincos(x) is the interleaved basis [sin(x w_0), cos(x w_0), ...].
//
// What bounds it: operations. Each valid pair takes A + 1 products of its
// (1 x C) basis with a (C x C) matrix, 2 (A + 1) C^2 flops (~0.5 MFLOP at
// C = 256), three TF32 products each on the tensor cores (3xTF32: f32
// accuracy from TF32 halves), and (A + 1) C / 2 sincosf.
//
// Shapes (kernels/gse.py:gse_route picks the instance; the launcher checks
// it): any even C and any A, in two kernels of one design. gse_kernel<C>
// takes C in {32, 64, 96, 128, 256} with A <= 4 (every shipped width; its
// widths, chunk counts and offsets all constants). gse_general_kernel<BC>
// takes the rest: the basis rows are C rounded up to a multiple of 32 (K);
// the output channels go in NB channel blocks of BC each (an instance: a
// multiple of 32 up to 256; NB = 1 up to C = 256, blocks across the grid
// past it). Its operands are padded as they are staged: W's rows and
// columns past C read as zeros, the frequencies past C / 2 as zeros
// (div_term is C's own, exp(-2 j ln 10000 / C)), and only the first C
// channels are stored, with row stride C; the angles go in groups of up to
// kGroup, the running max carried across the groups, each group restarting
// the chunk pipeline. (One kernel for both, its counts and offsets made
// constants where they could be, measured 1-12 % slower than gse_kernel on
// the shipped paths of an H100: compare_checkouts.py.)
//
// Design, two launches. gse_weights_kernel splits W_a and W_d once a call
// into TF32 halves (big, small), stored in mma.sync's B-fragment order a
// channel block at a time, so a block copies them with 16-byte cp.async and
// a lane reads its fragment with one 8-byte load. The main kernel: a block
// takes P valid pairs (64 past 128 channels, 128 below; the n_valid x
// n_valid square enumerated row-major from the device-side n_valid, no host
// sync) and the BC channels of its channel block (gse_kernel: all C), 16
// warps as 2 x 8 (pairs x channels; 4 x 4 where BC / 8 is no multiple of 8).
// It walks the angle projections (a group at a time), then the distance
// projection, each in chunks of 32 basis rows:
//   - the chunk's W halves come through a two-stage cp.async ring, one
//     chunk ahead;
//   - the chunk's bases of the P pairs are built one chunk ahead from the
//     pairs' indices in shared memory (one sincosf a pair and frequency:
//     each pair's bases are built once) and stored split, in the
//     A-fragment order (one 16-byte load a lane and m-tile);
//   - each warp adds the chunk's products into its (P / 2) x (C / 8)
//     accumulator, every W fragment serving all its m-tiles and every basis
//     fragment all its n-tiles; a k8 step's three TF32 products of the
//     m-tiles (up to four) of one n-tile go into fresh tiles, their mma
//     interleaved, and one f32 add a step brings each into the accumulator
//     (mma_3xtf32_grid): the tensor cores' truncating sums then run over a
//     step's terms only, never over the accumulator (taken straight into
//     it, a projection loses about three bits: tests/test_torch_gse_fwd_tc.py);
//     the next chunk's basis items and W copies are issued between the k8
//     steps, so one warp's sincosf and copies overlap other warps' mma.
// One barrier a chunk. After angle projection k the accumulator folds into
// the running max, which sits in shared memory (P C floats, each thread's
// fragment elements lane-major): the registers hold the products (32 a
// thread at BC >= 128, and up to 16 of fresh tiles), not the state between
// them. After the distance projection the epilogue adds the max and the bias and
// stores the tile. W is read from L2 A + 1 times a block, (A + 1) K BC 8
// bytes a P pairs. Pairs outside [0, n_valid)^2 are written as zeros by the
// blocks after the valid tiles (exactly those bytes). No float atomics: the
// same result every run.
//
// Geometry: angle_index (gse_common.cuh), the backward's and, bit for bit,
// the plain version's angle indices; the diagonal (v = 0) gives angle 0
// exactly as the XLA path does; sincosf/atan2f replace the TPU kernel's
// polynomial sin/cos/atan2 (Mosaic had no inverse trig). The interleaved
// basis indexes W's rows directly, with no sin-row / cos-row split.
//
// Precision (PrecisionConfig; the JAX kernel's BASIS_DTYPE and EMBED_DTYPE,
// geotransformer_tpu/kernels/gse.py:35-36, :171-172, :201-219, :283). The
// float32 point runs the 3xTF32 products above and stores f32. The
// bfloat16 basis point (the BF16 instances): gse_weights_kernel rounds W_d
// and W_a to bfloat16 once a call, and each basis sin / cos is rounded as
// it is built (once a pair); a bfloat16 value is a TF32 value, so its small
// half is 0 and one mma.sync TF32 pass gives every product exactly
// (mma_tf32_grid: a third of the 3xTF32 products); the max over the angles
// and the bias stay f32. The bfloat16 embedding point (OutT, the output
// type: float or __nv_bfloat16): the f32 sum is stored rounded to bfloat16
// (round to nearest even), half the bytes, exact zeros outside the valid
// rectangle as at f32. The four points are four instances of each kernel,
// so the float32 instance's code is the one it was before: with the output
// type a run-time flag of the stores instead (two instances a width), the
// float32 forward read 6.5-10 % slower on an H100 (compare_checkouts.py on
// the 3DMatch and KITTI forwards).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "gse_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// pairs a block: 64 for more than 128 channels, 128 below (16-pair m-tiles),
// so that a thread's accumulator is at most 32 registers
__host__ __device__ constexpr int block_pairs(int C) { return C > 128 ? 64 : 128; }
constexpr int kChunk = 32;      // basis rows a chunk: four k8 steps
constexpr int kSteps = kChunk / 8;
constexpr int kMaxAngles = 4;   // gse_kernel's angles, gse_general_kernel's a group
constexpr int kGroup = kMaxAngles;
constexpr int kStages = 2;      // W and the bases, one chunk ahead
constexpr int kMaxBlock = 256;  // the widest channel block

// W's halves in B-fragment order: for matrix m (0 W_a, 1 W_d), channel
// block b, k8 step s, n-tile n (channels BC b + 8 n ..), lane l = 4 g + t
// and h in {0, 1},
//   frag[(((m NB + b) (K / 8) + s) (BC / 8) + n) 64 + 2 l + h]
//     = half of W[8 s + t + 4 h][BC b + 8 n + g]   (0 past row or column C)
// big halves first, then the small halves (2 K NB BC words each). A chunk of
// a matrix's channel block (32 basis rows) is 32 BC contiguous words of each
// half.
// rb: the weights rounded to bfloat16 first (the bfloat16 basis point).
__global__ void __launch_bounds__(256) gse_weights_kernel(const float* __restrict__ w_a,
                                                          const float* __restrict__ w_d,
                                                          uint32_t* __restrict__ frag, int C,
                                                          int K, int BC, int NB, bool rb) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  const int words = 2 * K * NB * BC;
  if (e >= words) return;
  const int h = e & 1, l = (e >> 1) & 31;
  int rest = e >> 6;
  const int n = rest % (BC / 8);
  rest /= BC / 8;
  const int s = rest % (K / 8);
  rest /= K / 8;
  const int b = rest % NB, m = rest / NB;
  const int row = 8 * s + l % 4 + 4 * h, col = BC * b + 8 * n + l / 4;
  float x = row < C && col < C ? (m == 0 ? w_a : w_d)[static_cast<size_t>(row) * C + col] : 0.0f;
  if (rb) x = round_bf16(x);
  store_split(frag, frag + words, e, x);
}

// Channels ch and ch + 1 of a pair at dst: f32, or bfloat16 rounded to
// nearest even (the bfloat16 embedding point).
__device__ __forceinline__ void store_pair(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

// Shared memory of a block of gse_kernel, in 32-bit words.
template <int C>
struct ExactLayout {
  static constexpr int kPairs = block_pairs(C);
  static constexpr int w_stage = 2 * kChunk * C;        // big, small
  static constexpr int b_stage = 2 * kPairs * kChunk;   // big, small
  static constexpr int w = 0;
  static constexpr int bases = w + kStages * w_stage;
  static constexpr int amax = bases + kStages * b_stage;   // (kPairs C): the running max
  static constexpr int idx = amax + kPairs * C;            // (kMaxAngles + 1, kPairs)
  static constexpr int rows = idx + (kMaxAngles + 1) * kPairs;  // i of each pair
  static constexpr int cols = rows + kPairs;                    // j of each pair
  static constexpr int freqs = cols + kPairs;
  static constexpr int words = freqs + C / 2;
};

// BF16: the bfloat16 basis point (bases rounded as built, one TF32 pass);
// OutT: the embedding's type, float or (the bfloat16 embedding point)
// __nv_bfloat16.
template <int C, bool BF16, typename OutT>
__global__ void __launch_bounds__(kThreads, 1) gse_kernel(
    const float* __restrict__ points,       // (N, 3)
    const float* __restrict__ ref_vectors,  // (N, A, 3)
    const uint32_t* __restrict__ w_frag,    // gse_weights_kernel's halves
    const float* __restrict__ bias,         // (C,) = b_d + b_a
    const float* __restrict__ div_term,     // (C / 2,)
    const int32_t* __restrict__ n_valid,    // scalar
    OutT* __restrict__ out,                 // (N, N, C)
    int N, int A, float sigma_d, float factor_a) {
  using L = ExactLayout<C>;
  constexpr int kPairs = L::kPairs;
  constexpr int NT = C / 8;                        // n-tiles of C
  constexpr int WARPS_N = NT % 8 == 0 ? 8 : 4;     // warps across the channels (4 at C = 32, 96)
  constexpr int MT = kPairs / 16 / (kWarps / WARPS_N);  // m-tiles a warp
  constexpr int WN = NT / WARPS_N;                 // n-tiles a warp
  constexpr int CHUNKS = C / kChunk;
  // a group of fresh tiles: MG m-tiles by GN = 1 n-tile, at most four
  // tiles (16 registers; at C = 256 the kernel then spills 36 bytes a
  // thread, two n-tiles a group spill more)
  constexpr int GN = 1;
  constexpr int MG = MT < 4 ? MT : 4;
  constexpr int NG = WN / GN, MGS = MT / MG;
  constexpr int T = MG * GN;  // tiles a group
  constexpr int PIECES = 2 * 8 * C / kThreads;     // 16-byte W pieces a thread a chunk
  constexpr int ITEMS = kPairs * kChunk / 2 / kThreads;  // basis items a thread a chunk
  static_assert(PIECES >= 1 && kSteps % ITEMS == 0, "the block shape");
  static_assert(NT % WARPS_N == 0 && MT >= 1 && MT % MG == 0, "the warp tiling");
  extern __shared__ uint32_t smem[];
  float* idx_s = reinterpret_cast<float*>(smem + L::idx);
  int* row_s = reinterpret_cast<int*>(smem + L::rows);
  int* col_s = reinterpret_cast<int*>(smem + L::cols);
  float* freq_s = reinterpret_cast<float*>(smem + L::freqs);

  const int tid = threadIdx.x;
  const int nv = min(*n_valid, N);
  const long long valid = static_cast<long long>(nv) * nv;
  const long long tiles = (valid + kPairs - 1) / kPairs;
  const long long block = blockIdx.x;

  if (block >= tiles) {
    // zeros: the pairs outside the valid square, rows i < n_valid (columns
    // n_valid ..) first, then the rows n_valid .., kPairs a block
    const long long z0 = (block - tiles) * kPairs;
    const long long zeros = static_cast<long long>(N) * N - valid;
    if (z0 >= zeros) return;
    const int count = static_cast<int>(min(static_cast<long long>(kPairs), zeros - z0));
    const long long side = static_cast<long long>(nv) * (N - nv);
    // 16 bytes a store: 4 f32 or 8 bfloat16 channels (C is a multiple of 32)
    constexpr int kPer = C * static_cast<int>(sizeof(OutT)) / 16;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int e = tid; e < count * kPer; e += kThreads) {
      const long long r = z0 + e / kPer;
      long long i, j;
      if (r < side) {
        i = r / (N - nv);
        j = nv + r % (N - nv);
      } else {
        i = nv + (r - side) / N;
        j = (r - side) % N;
      }
      reinterpret_cast<uint4*>(out + (i * N + j) * C)[e % kPer] = zero;
    }
    return;
  }

  const long long q0 = block * kPairs;
  const int pairs = static_cast<int>(min(static_cast<long long>(kPairs), valid - q0));
  const int chunks = (A + 1) * CHUNKS;

  // chunk c of projection c / CHUNKS (A: the distance) into W stage c % 2:
  // 16-byte pieces (8 C a half), the thread's pieces i with i % kSteps ==
  // step (all of them for step -1)
  auto fetch_w = [&](int c, int step) {
    const int m = c / CHUNKS < A ? 0 : 1;
    const uint32_t* src = w_frag + (static_cast<size_t>(m) * NT + 4 * (c % CHUNKS)) * NT * 64;
    uint32_t* dst = smem + L::w + (c % kStages) * L::w_stage;
#pragma unroll
    for (int i = 0; i < PIECES; ++i) {
      if (step >= 0 && i % kSteps != step) continue;
      const int e = tid + kThreads * i;
      const int half = e / (8 * C), piece = e % (8 * C);
      cp_async16(reinterpret_cast<float*>(dst + half * kChunk * C + 4 * piece),
                 reinterpret_cast<const float*>(src + static_cast<size_t>(half) * 2 * C * C +
                                                4 * piece),
                 true);
    }
  };
  fetch_w(0, -1);
  cp_async_commit();

  if (tid < kPairs) {
    float idx[kMaxAngles + 1] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    int i = 0, j = 0;
    if (tid < pairs) {
      const long long q = q0 + tid;
      i = static_cast<int>(q / nv);
      j = static_cast<int>(q % nv);
      pair_indices(points, ref_vectors, i, j, A, sigma_d, factor_a, idx);
    }
    for (int k = 0; k <= A; ++k) idx_s[k * kPairs + tid] = idx[k];
    row_s[tid] = i;
    col_s[tid] = j;
  }
  for (int f = tid; f < C / 2; f += kThreads) freq_s[f] = div_term[f];
  __syncthreads();

  // item it (of ITEMS) of the bases of chunk c, in stage c % 2: a thread
  // takes (pair, frequency) items; sin and cos of frequency f are basis
  // rows 2 f and 2 f + 1, in the A fragment of m-tile pair / 16, k8 step
  // (f % 16) / 4: word ((m-tile 4 + step) 32 + lane) 4 + e, lane
  // 4 (row % 8) + col % 4, e = row / 8 + 2 (col / 4), col = 2 (f % 4)
  // (+ 1 for the cosine)
  auto build = [&](int c, int it) {
    const int p = c / CHUNKS, f0 = (c % CHUNKS) * (kChunk / 2);
    uint32_t* big = smem + L::bases + (c % kStages) * L::b_stage;
    uint32_t* small = big + kPairs * kChunk;
    const int e = tid + kThreads * it;
    const int fl = e % (kChunk / 2), pr = e / (kChunk / 2);
    float sn, cs;
    sincosf(idx_s[p * kPairs + pr] * freq_s[f0 + fl], &sn, &cs);
    if constexpr (BF16) {
      sn = round_bf16(sn);
      cs = round_bf16(cs);
    }
    const int row = pr % 16, col = 2 * (fl % 4);
    const int at = (((pr / 16) * 4 + fl / 4) * 32 + 4 * (row % 8) + col % 4) * 4 + row / 8 +
                   2 * (col / 4);
    store_split(big, small, at, sn);
    store_split(big, small, at + 4, cs);  // the next lane, same element
  };
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) build(0, it);

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;  // m-tiles MT wm .., n-tiles WN wn ..
  // tile (m-tile MT wm + mi, n-tile WN wn + ni) in group [(ni / GN) MGS +
  // mi / MG] at [(mi % MG) GN + ni % GN]; element e of the warp's tile i
  // (group g, tile i % T: i = g T + ..) keeps its running max at
  // amax_s[((warp MT WN + i) 4 + e) 32 + lane]
  float cur[NG * MGS][T][4];
#pragma unroll
  for (int g = 0; g < NG * MGS; ++g) {
#pragma unroll
    for (int i = 0; i < T; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) cur[g][i][e] = 0.0f;
    }
  }
  float* amax_s = reinterpret_cast<float*>(smem + L::amax) + warp * MT * WN * 128 + lane;

  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // W and bases of c visible; stages of c - 1 free

    // each k8 step's products, and a share of the next chunk's bases and W
    // between them, so that one warp's sincosf and copies overlap the other
    // warps' mma
    const uint32_t* wb = smem + L::w + (c % kStages) * L::w_stage;
    const uint32_t* ws = wb + kChunk * C;
    const uint32_t* bb = smem + L::bases + (c % kStages) * L::b_stage;
    const uint32_t* bs = bb + kPairs * kChunk;
#pragma unroll
    for (int step = 0; step < kSteps; ++step) {
      uint32_t ab[MT][4], as[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int at = (((MT * wm + mi) * 4 + step) * 32 + lane) * 4;
        const uint4 b4 = *reinterpret_cast<const uint4*>(bb + at);
        const uint4 s4 = *reinterpret_cast<const uint4*>(bs + at);
        ab[mi][0] = b4.x, ab[mi][1] = b4.y, ab[mi][2] = b4.z, ab[mi][3] = b4.w;
        as[mi][0] = s4.x, as[mi][1] = s4.y, as[mi][2] = s4.z, as[mi][3] = s4.w;
      }
#pragma unroll
      for (int ng = 0; ng < NG; ++ng) {
        uint32_t fb[GN][2], fs[GN][2];
#pragma unroll
        for (int ni = 0; ni < GN; ++ni) {
          const int at = ((step * NT + WN * wn + GN * ng + ni) * 32 + lane) * 2;
          const uint2 b2 = *reinterpret_cast<const uint2*>(wb + at);
          const uint2 s2 = *reinterpret_cast<const uint2*>(ws + at);
          fb[ni][0] = b2.x, fb[ni][1] = b2.y;
          fs[ni][0] = s2.x, fs[ni][1] = s2.y;
        }
#pragma unroll
        for (int mg = 0; mg < MGS; ++mg) {
          uint32_t gb[MG][4], gs[MG][4];  // the group's basis fragments
#pragma unroll
          for (int mi = 0; mi < MG; ++mi) {
#pragma unroll
            for (int e = 0; e < 4; ++e) gb[mi][e] = ab[MG * mg + mi][e], gs[mi][e] = as[MG * mg + mi][e];
          }
          if constexpr (BF16) {
            mma_tf32_grid<MG, GN>(cur[ng * MGS + mg], gb, fb);
          } else {
            mma_3xtf32_grid<MG, GN>(cur[ng * MGS + mg], gb, gs, fb, fs);
          }
        }
      }
      if (c + 1 < chunks && step % (kSteps / ITEMS) == 0) build(c + 1, step / (kSteps / ITEMS));
      if (c + 1 < chunks) fetch_w(c + 1, step);
    }
    if (c + 1 < chunks) cp_async_commit();

    if (c % CHUNKS != CHUNKS - 1) continue;
    const int p = c / CHUNKS;
    if (p < A) {  // an angle projection: into the running max
#pragma unroll
      for (int g = 0; g < NG * MGS; ++g) {
#pragma unroll
        for (int i = 0; i < T; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float* a = amax_s + ((g * T + i) * 4 + e) * 32;
            *a = p == 0 ? cur[g][i][e] : fmaxf(*a, cur[g][i][e]);
            cur[g][i][e] = 0.0f;
          }
        }
      }
      continue;
    }
    // the distance projection: + max + bias, stored; C fragment element e
    // of tile (mi, ni): pair 16 (MT wm + mi) + g + 8 (e / 2), channel
    // 8 (WN wn + ni) + 2 t + e % 2
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pr = 16 * (MT * wm + mi) + g + 8 * h;
        if (pr >= pairs) continue;
        OutT* dst = out + (static_cast<size_t>(row_s[pr]) * N + col_s[pr]) * C;
#pragma unroll
        for (int ni = 0; ni < WN; ++ni) {
          const int ch = 8 * (WN * wn + ni) + 2 * t;
          const int grp = (ni / GN) * MGS + mi / MG, i = grp * T + (mi % MG) * GN + ni % GN;
          const float* v = cur[grp][(mi % MG) * GN + ni % GN];
          const float a0 = amax_s[(i * 4 + 2 * h) * 32], a1 = amax_s[(i * 4 + 2 * h + 1) * 32];
          store_pair(dst + ch, v[2 * h] + a0 + bias[ch], v[2 * h + 1] + a1 + bias[ch + 1]);
        }
      }
    }
  }
}

// Shared memory of a block of gse_general_kernel, in 32-bit words (the
// frequencies are read through L1).
template <int BC>
struct GeneralLayout {
  static constexpr int kPairs = block_pairs(BC);
  static constexpr int w_stage = 2 * kChunk * BC;       // big, small
  static constexpr int b_stage = 2 * kPairs * kChunk;   // big, small
  static constexpr int w = 0;
  static constexpr int bases = w + kStages * w_stage;
  static constexpr int amax = bases + kStages * b_stage;   // (kPairs BC): the running max
  static constexpr int idx = amax + kPairs * BC;           // (kGroup + 1, kPairs)
  static constexpr int rows = idx + (kGroup + 1) * kPairs;  // i of each pair
  static constexpr int cols = rows + kPairs;                // j of each pair
  static constexpr int words = cols + kPairs;
};

// BF16, OutT: as gse_kernel's.
template <int BC, bool BF16, typename OutT>
__global__ void __launch_bounds__(kThreads, 1) gse_general_kernel(
    const float* __restrict__ points,       // (N, 3)
    const float* __restrict__ ref_vectors,  // (N, A, 3)
    const uint32_t* __restrict__ w_frag,    // gse_weights_kernel's halves
    const float* __restrict__ bias,         // (C,) = b_d + b_a
    const float* __restrict__ div_term,     // (C / 2,)
    const int32_t* __restrict__ n_valid,    // scalar
    OutT* __restrict__ out,                 // (N, N, C)
    int N, int A, int C, int K, int NB, float sigma_d, float factor_a) {
  using L = GeneralLayout<BC>;
  constexpr int kPairs = L::kPairs;
  constexpr int NT = BC / 8;                       // n-tiles of the channel block
  constexpr int WARPS_N = NT % 8 == 0 ? 8 : 4;     // warps across the channels
  constexpr int MT = kPairs / 16 / (kWarps / WARPS_N);  // m-tiles a warp
  constexpr int WN = NT / WARPS_N;                 // n-tiles a warp
  // a group of fresh tiles: MG m-tiles by GN = 1 n-tile, at most four
  // tiles (16 registers; at BC = 256 the kernel then spills 36 bytes a
  // thread, two n-tiles a group spill more)
  constexpr int GN = 1;
  constexpr int MG = MT < 4 ? MT : 4;
  constexpr int NG = WN / GN, MGS = MT / MG;
  constexpr int T = MG * GN;  // tiles a group
  constexpr int PIECES = 2 * 8 * BC / kThreads;    // 16-byte W pieces a thread a chunk
  constexpr int ITEMS = kPairs * kChunk / 2 / kThreads;  // basis items a thread a chunk
  static_assert(PIECES >= 1 && kSteps % ITEMS == 0, "the block shape");
  static_assert(NT % WARPS_N == 0 && MT >= 1 && MT % MG == 0, "the warp tiling");
  extern __shared__ uint32_t smem[];
  float* idx_s = reinterpret_cast<float*>(smem + L::idx);
  int* row_s = reinterpret_cast<int*>(smem + L::rows);
  int* col_s = reinterpret_cast<int*>(smem + L::cols);

  const int tid = threadIdx.x;
  const int nv = min(*n_valid, N);
  const long long valid = static_cast<long long>(nv) * nv;
  const long long tiles = (valid + kPairs - 1) / kPairs;
  const long long block = blockIdx.x;

  if (block >= tiles * NB) {
    // zeros: the pairs outside the valid square, rows i < n_valid (columns
    // n_valid ..) first, then the rows n_valid .., kPairs a block
    const long long z0 = (block - tiles * NB) * kPairs;
    const long long zeros = static_cast<long long>(N) * N - valid;
    if (z0 >= zeros) return;
    const int count = static_cast<int>(min(static_cast<long long>(kPairs), zeros - z0));
    const long long side = static_cast<long long>(nv) * (N - nv);
    auto pair_row = [&](long long r) {
      long long i, j;
      if (r < side) {
        i = r / (N - nv);
        j = nv + r % (N - nv);
      } else {
        i = nv + (r - side) / N;
        j = (r - side) % N;
      }
      return out + (i * N + j) * C;
    };
    // 16-byte stores where a pair's row takes them, else a store of two
    // channels (8 bytes of f32, 4 of bfloat16)
    using Two = typename std::conditional<sizeof(OutT) == 4, uint2, uint32_t>::type;
    const int bytes = C * static_cast<int>(sizeof(OutT));
    if (bytes % 16 == 0) {
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      for (int e = tid; e < count * (bytes / 16); e += kThreads) {
        reinterpret_cast<uint4*>(pair_row(z0 + e / (bytes / 16)))[e % (bytes / 16)] = zero;
      }
    } else {
      for (int e = tid; e < count * (C / 2); e += kThreads) {
        reinterpret_cast<Two*>(pair_row(z0 + e / (C / 2)))[e % (C / 2)] = Two{};
      }
    }
    return;
  }

  const int cb = static_cast<int>(block % NB);   // the channel block
  const long long q0 = (block / NB) * kPairs;
  const int pairs = static_cast<int>(min(static_cast<long long>(kPairs), valid - q0));
  const int CHUNKS = K / kChunk;  // chunks a projection
  const int half = C / 2;         // real frequencies; those past them are 0

  if (tid < kPairs) {
    int i = 0, j = 0;
    if (tid < pairs) {
      const long long q = q0 + tid;
      i = static_cast<int>(q / nv);
      j = static_cast<int>(q % nv);
    }
    row_s[tid] = i;
    col_s[tid] = j;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;  // m-tiles MT wm .., n-tiles WN wn ..
  // tile (m-tile MT wm + mi, n-tile WN wn + ni) in group [(ni / GN) MGS +
  // mi / MG] at [(mi % MG) GN + ni % GN]; element e of the warp's tile i
  // (group g, tile i % T: i = g T + ..) keeps its running max at
  // amax_s[((warp MT WN + i) 4 + e) 32 + lane]
  float cur[NG * MGS][T][4];
#pragma unroll
  for (int g = 0; g < NG * MGS; ++g) {
#pragma unroll
    for (int i = 0; i < T; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) cur[g][i][e] = 0.0f;
    }
  }
  float* amax_s = reinterpret_cast<float*>(smem + L::amax) + warp * MT * WN * 128 + lane;

  // the angle groups: angles g0 .. g0 + ga - 1, then after the last group
  // the distance; a group restarts the chunk pipeline
  for (int g0 = 0; g0 < A; g0 += kGroup) {
    const int ga = min(kGroup, A - g0);
    const bool last = g0 + ga == A;
    const int chunks = (ga + (last ? 1 : 0)) * CHUNKS;
    if (g0 > 0) __syncthreads();  // the last group's stages and indices are read

    // chunk cc of the group's projection p (ga: the distance) into W stage
    // st: 16-byte pieces (8 BC a half), the thread's pieces i with
    // i % kSteps == step (all of them for step -1)
    auto fetch_w = [&](int p, int cc, int st, int step) {
      const int m = p < ga ? 0 : 1;
      const uint32_t* src =
          w_frag + ((static_cast<size_t>(m) * NB + cb) * (K / 8) + 4 * cc) * NT * 64;
      uint32_t* dst = smem + L::w + st * L::w_stage;
#pragma unroll
      for (int i = 0; i < PIECES; ++i) {
        if (step >= 0 && i % kSteps != step) continue;
        const int e = tid + kThreads * i;
        const int hf = e / (8 * BC), piece = e % (8 * BC);
        cp_async16(reinterpret_cast<float*>(dst + hf * kChunk * BC + 4 * piece),
                   reinterpret_cast<const float*>(
                       src + static_cast<size_t>(hf) * 2 * K * NB * BC + 4 * piece),
                   true);
      }
    };
    fetch_w(0, 0, 0, -1);
    cp_async_commit();

    if (tid < kPairs) {
      const int i = row_s[tid];
      const bool on = tid < pairs;
      const float3 v = pair_offset(points, i, col_s[tid]);
      for (int k = 0; k < ga; ++k) {
        idx_s[k * kPairs + tid] = on ? angle_index(v, ref_vectors, i, g0 + k, A, factor_a) : 0.0f;
      }
      if (last) idx_s[ga * kPairs + tid] = on ? distance_index(v, sigma_d) : 0.0f;
    }
    __syncthreads();

    // item it (of ITEMS) of the bases of chunk cc of projection p, in stage
    // st: a thread takes (pair, frequency) items; sin and cos of frequency f
    // are basis rows 2 f and 2 f + 1, in the A fragment of m-tile pair / 16,
    // k8 step (f % 16) / 4: word ((m-tile 4 + step) 32 + lane) 4 + e, lane
    // 4 (row % 8) + col % 4, e = row / 8 + 2 (col / 4), col = 2 (f % 4)
    // (+ 1 for the cosine)
    auto build = [&](int p, int cc, int st, int it) {
      const int f0 = cc * (kChunk / 2);
      uint32_t* big = smem + L::bases + st * L::b_stage;
      uint32_t* small = big + kPairs * kChunk;
      const int e = tid + kThreads * it;
      const int fl = e % (kChunk / 2), pr = e / (kChunk / 2);
      const float freq = f0 + fl < half ? __ldg(div_term + f0 + fl) : 0.0f;
      float sn, cs;
      sincosf(idx_s[p * kPairs + pr] * freq, &sn, &cs);
      if constexpr (BF16) {
        sn = round_bf16(sn);
        cs = round_bf16(cs);
      }
      const int row = pr % 16, col = 2 * (fl % 4);
      const int at = (((pr / 16) * 4 + fl / 4) * 32 + 4 * (row % 8) + col % 4) * 4 + row / 8 +
                     2 * (col / 4);
      store_split(big, small, at, sn);
      store_split(big, small, at + 4, cs);  // the next lane, same element
    };
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) build(0, 0, 0, it);

    for (int c = 0; c < chunks; ++c) {
      cp_async_wait<0>();
      __syncthreads();  // W and bases of c visible; stages of c - 1 free
      // the next chunk's projection and chunk, its stage
      const int pn = (c + 1) / CHUNKS, cn = (c + 1) % CHUNKS, sn = (c + 1) % kStages;

      // each k8 step's products, and a share of the next chunk's bases and W
      // between them, so that one warp's sincosf and copies overlap the other
      // warps' mma
      const uint32_t* wb = smem + L::w + (c % kStages) * L::w_stage;
      const uint32_t* ws = wb + kChunk * BC;
      const uint32_t* bb = smem + L::bases + (c % kStages) * L::b_stage;
      const uint32_t* bs = bb + kPairs * kChunk;
#pragma unroll
      for (int step = 0; step < kSteps; ++step) {
        uint32_t ab[MT][4], as[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const int at = (((MT * wm + mi) * 4 + step) * 32 + lane) * 4;
          const uint4 b4 = *reinterpret_cast<const uint4*>(bb + at);
          const uint4 s4 = *reinterpret_cast<const uint4*>(bs + at);
          ab[mi][0] = b4.x, ab[mi][1] = b4.y, ab[mi][2] = b4.z, ab[mi][3] = b4.w;
          as[mi][0] = s4.x, as[mi][1] = s4.y, as[mi][2] = s4.z, as[mi][3] = s4.w;
        }
#pragma unroll
        for (int ng = 0; ng < NG; ++ng) {
          uint32_t fb[GN][2], fs[GN][2];
#pragma unroll
          for (int ni = 0; ni < GN; ++ni) {
            const int at = ((step * NT + WN * wn + GN * ng + ni) * 32 + lane) * 2;
            const uint2 b2 = *reinterpret_cast<const uint2*>(wb + at);
            const uint2 s2 = *reinterpret_cast<const uint2*>(ws + at);
            fb[ni][0] = b2.x, fb[ni][1] = b2.y;
            fs[ni][0] = s2.x, fs[ni][1] = s2.y;
          }
#pragma unroll
          for (int mg = 0; mg < MGS; ++mg) {
            uint32_t gb[MG][4], gs[MG][4];  // the group's basis fragments
#pragma unroll
            for (int mi = 0; mi < MG; ++mi) {
#pragma unroll
              for (int e = 0; e < 4; ++e) gb[mi][e] = ab[MG * mg + mi][e], gs[mi][e] = as[MG * mg + mi][e];
            }
            if constexpr (BF16) {
              mma_tf32_grid<MG, GN>(cur[ng * MGS + mg], gb, fb);
            } else {
              mma_3xtf32_grid<MG, GN>(cur[ng * MGS + mg], gb, gs, fb, fs);
            }
          }
        }
        if (c + 1 < chunks && step % (kSteps / ITEMS) == 0) {
          build(pn, cn, sn, step / (kSteps / ITEMS));
        }
        if (c + 1 < chunks) fetch_w(pn, cn, sn, step);
      }
      if (c + 1 < chunks) cp_async_commit();

      if (c % CHUNKS != CHUNKS - 1) continue;
      const int p = c / CHUNKS;
      if (p < ga) {  // an angle projection: into the running max
#pragma unroll
        for (int g = 0; g < NG * MGS; ++g) {
#pragma unroll
          for (int i = 0; i < T; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float* a = amax_s + ((g * T + i) * 4 + e) * 32;
              *a = g0 + p == 0 ? cur[g][i][e] : fmaxf(*a, cur[g][i][e]);
              cur[g][i][e] = 0.0f;
            }
          }
        }
        continue;
      }
      // the distance projection: + max + bias, stored; C fragment element e
      // of tile (mi, ni): pair 16 (MT wm + mi) + g + 8 (e / 2), channel
      // BC cb + 8 (WN wn + ni) + 2 t + e % 2, the channels past C not stored
      const int g = lane / 4, t = lane % 4;
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int pr = 16 * (MT * wm + mi) + g + 8 * h;
          if (pr >= pairs) continue;
          OutT* dst = out + (static_cast<size_t>(row_s[pr]) * N + col_s[pr]) * C;
#pragma unroll
          for (int ni = 0; ni < WN; ++ni) {
            const int ch = BC * cb + 8 * (WN * wn + ni) + 2 * t;
            if (ch >= C) continue;
            const int grp = (ni / GN) * MGS + mi / MG, i = grp * T + (mi % MG) * GN + ni % GN;
            const float* v = cur[grp][(mi % MG) * GN + ni % GN];
            const float a0 = amax_s[(i * 4 + 2 * h) * 32], a1 = amax_s[(i * 4 + 2 * h + 1) * 32];
            store_pair(dst + ch, v[2 * h] + a0 + bias[ch], v[2 * h + 1] + a1 + bias[ch + 1]);
          }
        }
      }
    }
  }
}

template <int C, bool BF16, typename OutT>
int launch_exact(const float* points, const float* ref_vectors, const float* w_d,
                 const float* w_a, const float* bias, const float* div_term,
                 const int32_t* n_valid, uint32_t* w_frag, void* out, int N, int A, int words,
                 float sigma_d, float factor_a, cudaStream_t stream) {
  if (words != ExactLayout<C>::words || A > kMaxAngles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gse_weights_kernel<<<(2 * C * C + 255) / 256, 256, 0, stream>>>(w_a, w_d, w_frag, C, C, C, 1,
                                                                  BF16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(uint32_t) * ExactLayout<C>::words;
  err = cudaFuncSetAttribute(gse_kernel<C, BF16, OutT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the valid tiles, then the zero blocks: ceil(nv^2 / P) + ceil((N^2 -
  // nv^2) / P) <= ceil(N^2 / P) + 1 for every n_valid
  constexpr int kPairs = block_pairs(C);
  const long long blocks = (static_cast<long long>(N) * N + kPairs - 1) / kPairs + 1;
  gse_kernel<C, BF16, OutT><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      points, ref_vectors, w_frag, bias, div_term, n_valid, static_cast<OutT*>(out), N, A,
      sigma_d, factor_a);
  return static_cast<int>(cudaGetLastError());
}

template <int BC, bool BF16, typename OutT>
int launch_general(const float* points, const float* ref_vectors, const float* w_d,
                   const float* w_a, const float* bias, const float* div_term,
                   const int32_t* n_valid, uint32_t* w_frag, void* out, int N, int A, int C,
                   int K, int NB, int words, float sigma_d, float factor_a, cudaStream_t stream) {
  using L = GeneralLayout<BC>;
  if (words != L::words) return static_cast<int>(cudaErrorInvalidValue);
  const int frag_words = 2 * K * NB * BC;
  gse_weights_kernel<<<(frag_words + 255) / 256, 256, 0, stream>>>(w_a, w_d, w_frag, C, K, BC,
                                                                   NB, BF16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(uint32_t) * L::words;
  err = cudaFuncSetAttribute(gse_general_kernel<BC, BF16, OutT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the valid tiles (NB blocks each), then the zero blocks: NB ceil(nv^2 /
  // P) + ceil((N^2 - nv^2) / P) <= NB ceil(N^2 / P) + 1 for every n_valid
  constexpr int kPairs = block_pairs(BC);
  const long long blocks = NB * ((static_cast<long long>(N) * N + kPairs - 1) / kPairs) + 1;
  gse_general_kernel<BC, BF16, OutT><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      points, ref_vectors, w_frag, bias, div_term, n_valid, static_cast<OutT*>(out), N, A, C, K,
      NB, sigma_d, factor_a);
  return static_cast<int>(cudaGetLastError());
}

// The instance of (C, A) (kernels/gse.py:gse_route, which the wrapper
// follows): gse_kernel<C> (exact), or gse_general_kernel<BC> over K basis
// rows in NB channel blocks.
struct Route {
  bool exact;
  int K, BC, NB;
};

inline Route route_of(int C, int A) {
  Route r;
  r.exact = (C == 32 || C == 64 || C == 96 || C == 128 || C == 256) && A <= kMaxAngles;
  r.K = round_up(C, kChunk);
  r.NB = (r.K + kMaxBlock - 1) / kMaxBlock;
  r.BC = round_up((r.K + r.NB - 1) / r.NB, kChunk);
  return r;
}

// One gse_embedding_launch call's operands.
struct Call {
  const float* points;
  const float* ref_vectors;
  const float* w_d;
  const float* w_a;
  const float* bias;
  const float* div_term;
  const int32_t* n_valid;
  uint32_t* w_frag;
  void* out;
  int N, A, C, K, NB, words;
  float sigma_d, factor_a;
  cudaStream_t stream;
};

// The instance of width W (gse_kernel<W> where EXACT, else
// gse_general_kernel<W>) at the precision point: BF16 the bfloat16 basis
// point, OutT the embedding's type.
template <int W, bool EXACT, bool BF16, typename OutT>
int launch_instance(const Call& c) {
  if constexpr (EXACT) {
    return launch_exact<W, BF16, OutT>(c.points, c.ref_vectors, c.w_d, c.w_a, c.bias,
                                       c.div_term, c.n_valid, c.w_frag, c.out, c.N, c.A, c.words,
                                       c.sigma_d, c.factor_a, c.stream);
  } else {
    return launch_general<W, BF16, OutT>(c.points, c.ref_vectors, c.w_d, c.w_a, c.bias,
                                         c.div_term, c.n_valid, c.w_frag, c.out, c.N, c.A, c.C,
                                         c.K, c.NB, c.words, c.sigma_d, c.factor_a, c.stream);
  }
}

template <int W, bool EXACT>
int launch_point(const Call& c, bool basis_bf16, bool embed_bf16) {
  if (basis_bf16) {
    return embed_bf16 ? launch_instance<W, EXACT, true, __nv_bfloat16>(c)
                      : launch_instance<W, EXACT, true, float>(c);
  }
  return embed_bf16 ? launch_instance<W, EXACT, false, __nv_bfloat16>(c)
                    : launch_instance<W, EXACT, false, float>(c);
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The route (exact, K basis rows, BC channels a block, NB blocks, a block's
// shared memory in words) must be route_of(C, A)'s: kernels/gse.py:gse_route
// computes it. C even, A >= 1; w_frag holds 4 K NB BC words. basis_bf16:
// the bfloat16 basis point (the BF16 instances); embed_bf16: out holds
// bfloat16, else f32.
int gse_embedding_launch(const float* points, const float* ref_vectors, const float* w_d,
                         const float* w_a, const float* bias, const float* div_term,
                         const int32_t* n_valid, uint32_t* w_frag, void* out, int N, int A,
                         int C, int exact, int K, int BC, int NB, int words, int basis_bf16,
                         int embed_bf16, float sigma_d, float factor_a, void* stream) {
  const Route r = route_of(C, A);
  if (A < 1 || C < 2 || C % 2 != 0 || (exact != 0) != r.exact || K != r.K || BC != r.BC ||
      NB != r.NB) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  const Call call{points, ref_vectors, w_d, w_a, bias, div_term, n_valid, w_frag, out, N, A, C,
                  K, NB, words, sigma_d, factor_a, static_cast<cudaStream_t>(stream)};
  const bool basis = basis_bf16 != 0, embed = embed_bf16 != 0;
#define GSE_EXACT(W) \
  case W: return launch_point<W, true>(call, basis, embed)
#define GSE_GENERAL(W) \
  case W: return launch_point<W, false>(call, basis, embed)
  if (r.exact) {
    switch (C) {
      GSE_EXACT(32);
      GSE_EXACT(64);
      GSE_EXACT(96);
      GSE_EXACT(128);
      GSE_EXACT(256);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (BC) {
    GSE_GENERAL(32);
    GSE_GENERAL(64);
    GSE_GENERAL(96);
    GSE_GENERAL(128);
    GSE_GENERAL(160);
    GSE_GENERAL(192);
    GSE_GENERAL(224);
    GSE_GENERAL(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GSE_EXACT
#undef GSE_GENERAL
}

}  // extern "C"
