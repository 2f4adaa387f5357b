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
// Design, two launches. gse_weights_kernel splits W_a and W_d once a call
// into TF32 halves (big, small), stored in mma.sync's B-fragment order, so a
// block copies them with 16-byte cp.async and a lane reads its fragment with
// one 8-byte load. gse_kernel: a block takes P valid pairs (64 at C = 256,
// 128 below; the n_valid x n_valid square enumerated row-major from the
// device-side n_valid, no host sync) and all C channels, 16 warps as 2 x 8
// (pairs x channels; 4 x 4 at C = 32 and 96). It walks the A angle projections,
// then the distance projection, each in chunks of 32 basis rows:
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
// thread at C >= 128, and up to 16 of fresh tiles), not the state between
// them. After the distance projection the epilogue adds the max and the bias and
// stores the tile. W is read from L2 A + 1 times a block, (A + 1) C^2 8
// bytes a P pairs. Pairs outside [0, n_valid)^2 are written as zeros by the
// blocks after the valid tiles (exactly those bytes). No float atomics: the
// same result every run.
//
// Geometry: pair_indices (gse_common.cuh), the backward's and, bit for bit,
// the plain version's angle indices; the diagonal (v = 0) gives angle 0
// exactly as the XLA path does; sincosf/atan2f replace the TPU kernel's
// polynomial sin/cos/atan2 (Mosaic had no inverse trig). The interleaved
// basis indexes W's rows directly, with no sin-row / cos-row split. The
// output is f32 (the JAX kernel stores bf16, EMBED_DTYPE at
// kernels/gse.py:36).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "gse_common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// pairs a block: 64 at C = 256, 128 below (16-pair m-tiles), so that a
// thread's accumulator is 32 registers at C >= 128
__host__ __device__ constexpr int block_pairs(int C) { return C >= 256 ? 64 : 128; }
constexpr int kChunk = 32;      // basis rows a chunk: four k8 steps
constexpr int kSteps = kChunk / 8;
constexpr int kMaxAngles = 4;   // angle_k
constexpr int kStages = 2;      // W and the bases, one chunk ahead

// W's halves in B-fragment order: for matrix m (0 W_a, 1 W_d), k8 step s,
// n-tile n (channels 8 n ..), lane l = 4 g + t and h in {0, 1},
//   frag[((m (C / 8) + s) (C / 8) + n) 64 + 2 l + h] = half of W[8 s + t + 4 h][8 n + g]
// big halves first, then the small halves (2 C^2 words each). A chunk of a
// matrix (32 basis rows) is 32 C contiguous words of each half.
__global__ void __launch_bounds__(256) gse_weights_kernel(const float* __restrict__ w_a,
                                                          const float* __restrict__ w_d,
                                                          uint32_t* __restrict__ frag, int C) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= 2 * C * C) return;
  const int h = e & 1, l = (e >> 1) & 31, nt_count = C / 8;
  int rest = e >> 6;
  const int n = rest % nt_count;
  rest /= nt_count;
  const int s = rest % nt_count, m = rest / nt_count;
  const float x = (m == 0 ? w_a : w_d)[static_cast<size_t>(8 * s + l % 4 + 4 * h) * C + 8 * n +
                                       l / 4];
  store_split(frag, frag + 2 * C * C, e, x);
}

// Shared memory of a block, in 32-bit words.
template <int C>
struct Layout {
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

template <int C>
__global__ void __launch_bounds__(kThreads, 1) gse_kernel(
    const float* __restrict__ points,       // (N, 3)
    const float* __restrict__ ref_vectors,  // (N, A, 3)
    const uint32_t* __restrict__ w_frag,    // gse_weights_kernel's halves
    const float* __restrict__ bias,         // (C,) = b_d + b_a
    const float* __restrict__ div_term,     // (C / 2,)
    const int32_t* __restrict__ n_valid,    // scalar
    float* __restrict__ out,                // (N, N, C)
    int N, int A, float sigma_d, float factor_a) {
  using L = Layout<C>;
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
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int e = tid; e < count * (C / 4); e += kThreads) {
      const long long r = z0 + e / (C / 4);
      long long i, j;
      if (r < side) {
        i = r / (N - nv);
        j = nv + r % (N - nv);
      } else {
        i = nv + (r - side) / N;
        j = (r - side) % N;
      }
      reinterpret_cast<float4*>(out + (i * N + j) * C)[e % (C / 4)] = zero;
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
          mma_3xtf32_grid<MG, GN>(cur[ng * MGS + mg], gb, gs, fb, fs);
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
        float* dst = out + (static_cast<size_t>(row_s[pr]) * N + col_s[pr]) * C;
#pragma unroll
        for (int ni = 0; ni < WN; ++ni) {
          const int ch = 8 * (WN * wn + ni) + 2 * t;
          const int grp = (ni / GN) * MGS + mi / MG, i = grp * T + (mi % MG) * GN + ni % GN;
          const float* v = cur[grp][(mi % MG) * GN + ni % GN];
          const float a0 = amax_s[(i * 4 + 2 * h) * 32], a1 = amax_s[(i * 4 + 2 * h + 1) * 32];
          *reinterpret_cast<float2*>(dst + ch) =
              make_float2(v[2 * h] + a0 + bias[ch], v[2 * h + 1] + a1 + bias[ch + 1]);
        }
      }
    }
  }
}

template <int C>
int launch(const float* points, const float* ref_vectors, const float* w_d, const float* w_a,
           const float* bias, const float* div_term, const int32_t* n_valid, uint32_t* w_frag,
           float* out, int N, int A, float sigma_d, float factor_a, cudaStream_t stream) {
  gse_weights_kernel<<<(2 * C * C + 255) / 256, 256, 0, stream>>>(
      w_a, w_d, w_frag, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(uint32_t) * Layout<C>::words;
  err = cudaFuncSetAttribute(gse_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the valid tiles, then the zero blocks: ceil(nv^2 / P) + ceil((N^2 -
  // nv^2) / P) <= ceil(N^2 / P) + 1 for every n_valid
  constexpr int kPairs = block_pairs(C);
  const long long blocks = (static_cast<long long>(N) * N + kPairs - 1) / kPairs + 1;
  gse_kernel<C><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      points, ref_vectors, w_frag, bias, div_term, n_valid, out, N, A, sigma_d, factor_a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A (angles) in 1..4, C in {32, 64, 96, 128, 256}; w_frag holds 4 C^2 words.
int gse_embedding_launch(const float* points, const float* ref_vectors, const float* w_d,
                         const float* w_a, const float* bias, const float* div_term,
                         const int32_t* n_valid, uint32_t* w_frag, float* out, int N, int A,
                         int C, float sigma_d, float factor_a, void* stream) {
  if (A < 1 || A > kMaxAngles) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return launch<32>(points, ref_vectors, w_d, w_a, bias, div_term, n_valid, w_frag, out, N, A, sigma_d, factor_a, s);
    case 64: return launch<64>(points, ref_vectors, w_d, w_a, bias, div_term, n_valid, w_frag, out, N, A, sigma_d, factor_a, s);
    case 96: return launch<96>(points, ref_vectors, w_d, w_a, bias, div_term, n_valid, w_frag, out, N, A, sigma_d, factor_a, s);
    case 128: return launch<128>(points, ref_vectors, w_d, w_a, bias, div_term, n_valid, w_frag, out, N, A, sigma_d, factor_a, s);
    case 256: return launch<256>(points, ref_vectors, w_d, w_a, bias, div_term, n_valid, w_frag, out, N, A, sigma_d, factor_a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
