// The two attention kernels of the geometric transformer, for Hopper
// (sm_90a).
//
// pair_scores_kernel replaces geotransformer_tpu/kernels/attention.py:
// rpe_pair_scores (pallas_call at :175): the RPE pair-bias scores
//   out[i, h, j] = qw[i, h, :] . embed[i, j, :]
// of one cloud, zero outside the valid rectangle [0, nv_q) x [0, nv_k).
// What bounds it here: reading the (N, M, C) f32 embedding once (88 MB at
// 293 valid superpoints and C = 256: ~26 us at 3.35 TB/s); the H dot
// products per pair are ~H/2 flops a byte. A block takes one row i and 32
// columns j, stages qw[i] (H x C) in shared memory, and each warp reads the
// C channels of four pairs as float4 loads (coalesced along C, all four
// pairs' loads in flight before the arithmetic), then folds its H partial
// sums with shuffles. Blocks entirely outside the valid rectangle read
// nothing and write zeros (the valid-rectangle skip of the TPU kernel).
// f32 on the CUDA cores. The embedding is f32 or, at the bfloat16
// embedding point (PrecisionConfig.gse_embed), bfloat16 (half the bytes:
// four channels an 8-byte load), widened exactly to f32 as it is read; qw
// and the scores stay f32 (the JAX model's XLA einsum promotes the bfloat16
// embedding the same way, geotransformer_tpu/models/transformer.py:272-273).
//
// attention_kernel replaces geotransformer_tpu/kernels/attention.py:
// fused_masked_attention (pallas_call at :355):
//   out[i, h * dh + d] = sum_j softmax_j((q[h, i] . k[h, j] + bias[i, h, j])
//                                        * scale) v[h, j, d]
// over the keys j < nv_k that the key mask keeps, zero for query rows
// i >= nv_q and for rows without a kept key. What bounds it at these sizes
// (N, M <= ~640, dh <= 64, four heads; ~88 MFLOP and ~1.4 MB of bias a call
// at 3DMatch's 293 superpoints): latency, not bytes or flops, since the
// scores never reach device memory. The first kernel (8 threads a query
// row on the CUDA cores, 4 warps a block, 64-key chunks staged by scalar
// loads between two barriers) left about one warp per scheduler waiting on
// L2 and took 80 us a call on an H100 80GB HBM3 at 700 W (torch.profiler,
// chip_smoke.py). This design:
// - a block takes 16 query rows of one head (an m16 tile) and 8 warps; the
//   warps split the keys (warp w takes 16-key chunks w, w + 8, ...), each
//   with its own online softmax, and the block merges the 8 partial
//   (m, l, acc) in warp order at the end: twice the warps of the first
//   kernel on every live tile, and a fixed summation order (no atomics);
// - each warp stages its chunks (K, V and the 16 x 16 bias tile) with
//   16-byte cp.async into a two-stage ring of its own, so the next chunk's
//   loads are in flight during this chunk's math, with no block barrier in
//   the key loop (4-byte copies for a bias whose rows are not 16-byte
//   aligned); ~160 KB of dynamic shared memory at dh 64;
// - q k^T and p v run on the tensor cores as mma.sync m16n8k8 TF32 with the
//   3xTF32 split (big b + big s + small b of each f32 operand), which keeps
//   f32 accuracy: each k8 step lands in a fresh tile added to the f32
//   accumulator. The probabilities go from the score fragment to the A
//   fragment of p v without a trip through shared memory (A column t is
//   key 2t, column t + 4 key 2t + 1, and V's B fragment reads the same keys);
// - the q tile, too, is copied with cp.async, and the key mask becomes a
//   bitmap in shared memory while the q tile and the first chunks are in
//   flight: one memory latency before the key loop; tiles of padded rows
//   write zeros and read nothing.
//
// Every shape computes. The instances above serve the shipped
// configurations: pair_scores_kernel C a multiple of 4 up to 512, H <= 8
// and 16-byte aligned operands; attention_kernel head widths 8, 16, 32 and
// 64 with q, k and v 16-byte aligned. Any other C, H or alignment takes
// pair_scores_any_kernel (4-byte loads, heads 8 at a time); another head
// width up to 64, or a misaligned operand, attention_kernel of the next of
// those widths with 4-byte copies, the columns past dh zero in shared
// memory (exact under 3xTF32); dh > 64 attention_wide_kernel (64 output
// columns a block, K and V read in place).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "launch_common.cuh"

#include "tf32_mma.cuh"

namespace {

using launch_util::allow_smem;

// ---- RPE pair scores -------------------------------------------------------

constexpr int kMaxHeads = 8;
constexpr int kMaxGridY = 65535;  // a grid's y dimension at most: rows or heads a launch
constexpr int kPairThreads = 256;  // 8 warps
constexpr int kColsPerWarp = 4;
constexpr int kColsPerBlock = (kPairThreads / 32) * kColsPerWarp;  // 32

// Four channels 4 i .. 4 i + 3 of an f32 or bfloat16 embedding row, as f32
// (a bfloat16 value widens exactly).
__device__ __forceinline__ float4 load4(const float* row, size_t i) {
  return reinterpret_cast<const float4*>(row)[i];
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* row, size_t i) {
  const uint2 raw = reinterpret_cast<const uint2*>(row)[i];
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int CPL, typename E>  // float4 loads per lane and pair: C <= 128 * CPL
__global__ void __launch_bounds__(kPairThreads) pair_scores_kernel(
    const E* __restrict__ embed,         // (N, M, C) f32 or bfloat16
    const float* __restrict__ qw,        // (N, H, C)
    const int32_t* __restrict__ nv_q_ptr,  // or null: N
    const int32_t* __restrict__ nv_k_ptr,  // or null: M
    float* __restrict__ out,             // (N, H, M)
    int N, int M, int H, int C) {
  extern __shared__ float4 qw_s[];  // (H, C / 4)
  const int i = blockIdx.y;
  const int j0 = blockIdx.x * kColsPerBlock;
  const int nv_q = nv_q_ptr != nullptr ? min(*nv_q_ptr, N) : N;
  const int nv_k = nv_k_ptr != nullptr ? min(*nv_k_ptr, M) : M;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int c4s = C / 4;
  float* out_row = out + static_cast<size_t>(i) * H * M;

  if (i >= nv_q || j0 >= nv_k) {
    for (int e = tid; e < H * kColsPerBlock; e += kPairThreads) {
      const int j = j0 + e % kColsPerBlock;
      if (j < M) out_row[static_cast<size_t>(e / kColsPerBlock) * M + j] = 0.0f;
    }
    return;
  }

  const float4* qw_row = reinterpret_cast<const float4*>(qw + static_cast<size_t>(i) * H * C);
  for (int e = tid; e < H * c4s; e += kPairThreads) qw_s[e] = qw_row[e];
  __syncthreads();

  const E* e_row = embed + static_cast<size_t>(i) * M * C;
  const int jw = j0 + warp * kColsPerWarp;
  float4 ev[kColsPerWarp][CPL];
#pragma unroll
  for (int cc = 0; cc < kColsPerWarp; ++cc) {
    const int j = jw + cc;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c4 = lane + 32 * t;
      ev[cc][t] = (j < nv_k && c4 < c4s) ? load4(e_row, static_cast<size_t>(j) * c4s + c4)
                                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }

#pragma unroll
  for (int cc = 0; cc < kColsPerWarp; ++cc) {
    const int j = jw + cc;
    float acc[kMaxHeads];
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      acc[h] = 0.0f;
      if (h < H) {
#pragma unroll
        for (int t = 0; t < CPL; ++t) {
          const int c4 = lane + 32 * t;
          if (c4 < c4s) {
            const float4 w = qw_s[h * c4s + c4];
            const float4 e = ev[cc][t];
            acc[h] = fmaf(e.x, w.x, acc[h]);
            acc[h] = fmaf(e.y, w.y, acc[h]);
            acc[h] = fmaf(e.z, w.z, acc[h]);
            acc[h] = fmaf(e.w, w.w, acc[h]);
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          acc[h] += __shfl_xor_sync(0xffffffffu, acc[h], off);
        }
      }
    }
    if (j < M && lane < H) {
      float value = 0.0f;
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) {
        if (h == lane) value = acc[h];
      }
      out_row[static_cast<size_t>(lane) * M + j] = j < nv_k ? value : 0.0f;
    }
  }
}

// Any N, C, H and alignment: pair_scores_kernel's blocks and warps with
// 4-byte loads (lane l takes channels l, l + 32, ...), the heads a group of
// kMaxHeads at a time (the embedding row re-read from L1 for each group),
// qw[i] in shared memory where it fits a block, else read from global
// memory; rows past the grid's 65,535 in further launches from row0.
template <typename E>
__global__ void __launch_bounds__(kPairThreads) pair_scores_any_kernel(
    const E* __restrict__ embed,           // (N, M, C) f32 or bfloat16
    const float* __restrict__ qw,          // (N, H, C)
    const int32_t* __restrict__ nv_q_ptr,  // or null: N
    const int32_t* __restrict__ nv_k_ptr,  // or null: M
    float* __restrict__ out,               // (N, H, M)
    int N, int M, int H, int C, bool qw_shared, int row0) {
  extern __shared__ float4 qw4_s[];
  const int i = row0 + blockIdx.y;  // rows in grids of at most 65,535
  const int j0 = blockIdx.x * kColsPerBlock;
  const int nv_q = nv_q_ptr != nullptr ? min(*nv_q_ptr, N) : N;
  const int nv_k = nv_k_ptr != nullptr ? min(*nv_k_ptr, M) : M;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  float* out_row = out + static_cast<size_t>(i) * H * M;

  if (i >= nv_q || j0 >= nv_k) {
    for (int e = tid; e < H * kColsPerBlock; e += kPairThreads) {
      const int j = j0 + e % kColsPerBlock;
      if (j < M) out_row[static_cast<size_t>(e / kColsPerBlock) * M + j] = 0.0f;
    }
    return;
  }
  const float* qrow = qw + static_cast<size_t>(i) * H * C;
  if (qw_shared) {
    float* qw_s = reinterpret_cast<float*>(qw4_s);
    for (int e = tid; e < H * C; e += kPairThreads) qw_s[e] = qrow[e];
    __syncthreads();
    qrow = qw_s;
  }
  const E* e_row = embed + static_cast<size_t>(i) * M * C;
  for (int cc = 0; cc < kColsPerWarp; ++cc) {
    const int j = j0 + warp * kColsPerWarp + cc;
    if (j >= M) break;
    if (j >= nv_k) {
      for (int h = lane; h < H; h += 32) out_row[static_cast<size_t>(h) * M + j] = 0.0f;
      continue;
    }
    const E* e_pair = e_row + static_cast<size_t>(j) * C;
    for (int h0 = 0; h0 < H; h0 += kMaxHeads) {
      float acc[kMaxHeads];
#pragma unroll
      for (int hh = 0; hh < kMaxHeads; ++hh) acc[hh] = 0.0f;
      for (int c = lane; c < C; c += 32) {
        const float e = widen(e_pair[c]);
#pragma unroll
        for (int hh = 0; hh < kMaxHeads; ++hh) {
          if (h0 + hh < H) acc[hh] = fmaf(e, qrow[static_cast<size_t>(h0 + hh) * C + c], acc[hh]);
        }
      }
      float value = 0.0f;
#pragma unroll
      for (int hh = 0; hh < kMaxHeads; ++hh) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          acc[hh] += __shfl_xor_sync(0xffffffffu, acc[hh], off);
        }
        if (hh == lane) value = acc[hh];
      }
      if (lane < kMaxHeads && h0 + lane < H) {
        out_row[static_cast<size_t>(h0 + lane) * M + j] = value;
      }
    }
  }
}

template <int CPL, typename E>
int launch_pair_scores(const E* embed, const float* qw, const int32_t* nv_q,
                       const int32_t* nv_k, float* out, int N, int M, int H, int C,
                       cudaStream_t stream) {
  const dim3 grid((M + kColsPerBlock - 1) / kColsPerBlock, N);
  const size_t shared = static_cast<size_t>(H) * C * sizeof(float);
  pair_scores_kernel<CPL, E><<<grid, kPairThreads, shared, stream>>>(
      embed, qw, nv_q, nv_k, out, N, M, H, C);
  return static_cast<int>(cudaGetLastError());
}

// rpe_pair_scores over an f32 or a bfloat16 (E) embedding.
template <typename E>
int pair_scores(const E* embed, const float* qw, const int32_t* nv_q, const int32_t* nv_k,
                float* out, int N, int M, int H, int C, int vec4, cudaStream_t s) {
  if (!vec4) {  // any C, H and alignment
    const int block_bytes = launch_util::device_limits().block_bytes;
    const size_t qw_bytes = sizeof(float) * static_cast<size_t>(H) * C;
    const bool qw_shared = qw_bytes <= static_cast<size_t>(block_bytes);
    const size_t shared = qw_shared ? qw_bytes : 0;
    const cudaError_t err =
        allow_smem(reinterpret_cast<const void*>(pair_scores_any_kernel<E>), shared);
    if (err != cudaSuccess) return static_cast<int>(err);
    for (int row0 = 0; row0 < N; row0 += kMaxGridY) {
      const dim3 grid((M + kColsPerBlock - 1) / kColsPerBlock, min(kMaxGridY, N - row0));
      pair_scores_any_kernel<E><<<grid, kPairThreads, shared, s>>>(embed, qw, nv_q, nv_k, out, N,
                                                                  M, H, C, qw_shared, row0);
      const cudaError_t launched = cudaGetLastError();
      if (launched != cudaSuccess) return static_cast<int>(launched);
    }
    return 0;
  }
  switch ((C + 127) / 128) {
    case 1: return launch_pair_scores<1>(embed, qw, nv_q, nv_k, out, N, M, H, C, s);
    case 2: return launch_pair_scores<2>(embed, qw, nv_q, nv_k, out, N, M, H, C, s);
    case 3: return launch_pair_scores<3>(embed, qw, nv_q, nv_k, out, N, M, H, C, s);
    default: return launch_pair_scores<4>(embed, qw, nv_q, nv_k, out, N, M, H, C, s);
  }
}

// ---- fused masked attention ------------------------------------------------

constexpr int kAttnWarps = 8;
constexpr int kAttnThreads = 32 * kAttnWarps;  // 256
constexpr int kRows = 16;                      // query rows a block: one m16 tile
constexpr int kKeys = 16;                      // keys a warp stages at a time: two n8 tiles
constexpr int kBiasStride = kKeys + 8;         // floats: a half-warp's float2 reads, 16 banks
constexpr size_t kMaxShared = 232448;          // the opt-in limit of a block on sm_90

// Shared memory of the kernel, in floats: each warp owns a two-stage ring of
// (K chunk, V chunk, bias tile), rows padded to DH + 4 floats, so the mma
// fragment reads of K (8 keys x 4 dims) and V (4 key pairs x 8 dims) fall in
// 32 distinct banks and every row stays 16-byte aligned for cp.async. After
// the key loop the rings hold each warp's partial (16 x DH) output and its
// (m, l) per row for the merge. The block's 16 query rows follow the rings
// (same padding: the A fragment reads fall in 32 banks), then a bitmap of
// the kept keys.
template <int DH>
struct AttnLayout {
  static constexpr int kStride = DH + 4;
  static constexpr int kKV = kKeys * kStride;
  static constexpr int kStage = 2 * kKV + kRows * kBiasStride;
  static constexpr int kWarp = 2 * kStage;
  static constexpr int kRings = kAttnWarps * kWarp;
  static constexpr int kFloats = kRings + kRows * kStride;  // rings, then the q tile
  static_assert(kAttnWarps * kRows * (DH + 2) <= kRings, "the merge must fit in the rings");
};

// One warp's copies of keys [c0, c0 + 16): K and V rows (zeros past nv_k)
// and the (16 x 16) bias tile (zeros past N or nv_k), one commit group.
// VEC16: rows of DH floats by 16-byte copies; else rows of dw <= DH floats
// (any width, any 4-byte alignment) by 4-byte copies, zero-filled from dw
// to DH (the padding adds exact zeros to every product).
template <int DH, bool VEC16>
__device__ __forceinline__ void stage_chunk(float* stage, const float* k, const float* v,
                                            const float* bias, bool bias16, int c0, int row0,
                                            int h, int N, int M, int H, int nv_k, int dw,
                                            int lane) {
  using L = AttnLayout<DH>;
  float* k_s = stage;
  float* v_s = stage + L::kKV;
  float* b_s = stage + 2 * L::kKV;
  if constexpr (VEC16) {
    constexpr int kVecs = DH / 4;  // float4 a row
#pragma unroll
    for (int t = 0; t < kKeys * kVecs / 32; ++t) {
      const int e = lane + 32 * t;
      const int jj = e / kVecs, c4 = e % kVecs;
      const bool ok = c0 + jj < nv_k;
      const size_t src = (static_cast<size_t>(h) * M + (ok ? c0 + jj : 0)) * DH + 4 * c4;
      cp_async16(k_s + jj * L::kStride + 4 * c4, k + src, ok);
      cp_async16(v_s + jj * L::kStride + 4 * c4, v + src, ok);
    }
  } else {
#pragma unroll 4
    for (int e = lane; e < kKeys * DH; e += 32) {
      const int jj = e / DH, d = e % DH;
      const bool ok = c0 + jj < nv_k && d < dw;
      const size_t src = ok ? (static_cast<size_t>(h) * M + c0 + jj) * dw + d : 0;
      cp_async4(k_s + jj * L::kStride + d, k + src, ok);
      cp_async4(v_s + jj * L::kStride + d, v + src, ok);
    }
  }
  if (bias != nullptr) {
    if (bias16) {  // M % 4 == 0: four keys j..j+3 from j % 4 == 0 lie below M together
#pragma unroll
      for (int t = 0; t < kRows * kKeys / 4 / 32; ++t) {
        const int e = lane + 32 * t;
        const int r = e / 4, j = c0 + 4 * (e % 4);
        const bool ok = row0 + r < N && j < nv_k;
        const size_t src = ok ? (static_cast<size_t>(row0 + r) * H + h) * M + j : 0;
        cp_async16(b_s + r * kBiasStride + 4 * (e % 4), bias + src, ok);
      }
    } else {
#pragma unroll
      for (int t = 0; t < kRows * kKeys / 32; ++t) {
        const int e = lane + 32 * t;
        const int r = e / kKeys, j = c0 + e % kKeys;
        const bool ok = row0 + r < N && j < nv_k;
        const size_t src = ok ? (static_cast<size_t>(row0 + r) * H + h) * M + j : 0;
        cp_async4(b_s + r * kBiasStride + e % kKeys, bias + src, ok);
      }
    }
  }
  cp_async_commit();
}

// VEC16: q, k and v 16-byte aligned with head width DH; else head width
// dh <= DH (any, padded with zeros to DH in shared memory) and any 4-byte
// alignment, staged by 4-byte copies.
template <int DH, bool VEC16 = true>
__global__ void __launch_bounds__(kAttnThreads, 1) attention_kernel(
    const float* __restrict__ q,            // (H, N, dh)
    const float* __restrict__ k,            // (H, M, dh)
    const float* __restrict__ v,            // (H, M, dh)
    const float* __restrict__ bias,         // (N, H, M) or null
    const uint8_t* __restrict__ key_masks,  // (M,) or null
    const int32_t* __restrict__ nv_q_ptr,   // or null: N
    const int32_t* __restrict__ nv_k_ptr,   // or null: M
    float* __restrict__ out,                // (N, H * dh)
    int N, int M, int H, int dh, float scale, bool bias16) {
  using L = AttnLayout<DH>;
  const int dw = VEC16 ? DH : dh;  // the head width in device memory
  constexpr int kSteps = DH / 8;  // k8 steps of q . k, n8 tiles of p . v
  extern __shared__ float4 shared4[];
  float* shared = reinterpret_cast<float*>(shared4);
  float* q_s = shared + L::kRings;
  uint32_t* kept = reinterpret_cast<uint32_t*>(shared + L::kFloats);

  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma fragment row and column group
  const int nv_q = nv_q_ptr != nullptr ? max(0, min(*nv_q_ptr, N)) : N;
  const int nv_k = nv_k_ptr != nullptr ? max(0, min(*nv_k_ptr, M)) : M;
  const size_t hd = static_cast<size_t>(H) * dw;

  if (row0 >= nv_q) {  // a tile of padded rows: zeros, nothing read
    for (int e = tid; e < kRows * dw; e += kAttnThreads) {
      const int i = row0 + e / dw;
      if (i < N) out[i * hd + h * dw + e % dw] = 0.0f;
    }
    return;
  }

  // the q tile (rows past N as zeros), then warp w's first chunk (warp w
  // takes chunks w, w + 8, ...), all in flight while the block builds the
  // key bitmap: one memory latency before the key loop
  if constexpr (VEC16) {
    for (int e = tid; e < kRows * DH / 4; e += kAttnThreads) {
      const int r = e / (DH / 4), c4 = e % (DH / 4);
      const bool ok = row0 + r < N;
      cp_async16(q_s + r * L::kStride + 4 * c4,
                 q + (static_cast<size_t>(h) * N + (ok ? row0 + r : 0)) * DH + 4 * c4, ok);
    }
  } else {
    for (int e = tid; e < kRows * DH; e += kAttnThreads) {
      const int r = e / DH, d = e % DH;
      const bool ok = row0 + r < N && d < dw;
      cp_async4(q_s + r * L::kStride + d,
                q + (ok ? (static_cast<size_t>(h) * N + row0 + r) * dw + d : 0), ok);
    }
  }
  cp_async_commit();
  const int chunks = (nv_k + kKeys - 1) / kKeys;
  float* ring = shared + warp * L::kWarp;
  if (warp < chunks) {
    stage_chunk<DH, VEC16>(ring, k, v, bias, bias16, warp * kKeys, row0, h, N, M, H, nv_k, dw,
                           lane);
  } else {
    cp_async_commit();
  }
  for (int w = warp; w * 32 < nv_k; w += kAttnWarps) {
    const int j = w * 32 + lane;
    const bool ok = j < nv_k && (key_masks == nullptr || key_masks[j] != 0);
    const uint32_t bits = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) kept[w] = bits;
  }
  cp_async_wait<1>();  // the q tile (the first chunk may still be in flight)
  __syncthreads();     // the q tile and the bitmap are complete
  // A fragments of the 16 query rows
  uint32_t qa_big[kSteps][4], qa_small[kSteps][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = q_s[(g + 8 * (e % 2)) * L::kStride + 8 * s + t4 + 4 * (e / 2)];
      split_tf32(x, qa_big[s][e], qa_small[s][e]);
    }
  }

  float o[kSteps][4];  // rows g, g + 8 of the warp's partial output
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[s][e] = 0.0f;
  }
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};

  int stage = 0;
  for (int c = warp; c < chunks; c += kAttnWarps) {
    const int c0 = c * kKeys;
    if (c + kAttnWarps < chunks) {  // the next chunk's copies overlap this chunk's math
      stage_chunk<DH, VEC16>(ring + (stage ^ 1) * L::kStage, k, v, bias, bias16,
                             c0 + kAttnWarps * kKeys, row0, h, N, M, H, nv_k, dw, lane);
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();
    __syncwarp();
    const float* k_s = ring + stage * L::kStage;
    const float* v_s = k_s + L::kKV;
    const float* b_s = k_s + 2 * L::kKV;

    // scores of rows g, g + 8 and keys 2 t4, 2 t4 + 1 of each n8 tile
    float s_acc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[nt][e] = 0.0f;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const float* kr = k_s + (8 * nt + g) * L::kStride + 8 * s + t4;
        uint32_t b_big[2], b_small[2];
        split_tf32(kr[0], b_big[0], b_small[0]);
        split_tf32(kr[4], b_big[1], b_small[1]);
        mma_3xtf32(s_acc[nt], qa_big[s], qa_small[s], b_big, b_small);
      }
    }
    const uint32_t bits = kept[c0 / 32] >> (c0 % 32);
    float row_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = 8 * nt + 2 * t4 + e % 2;
        float x = s_acc[nt][e];
        if (bias != nullptr) x += b_s[(g + 8 * (e / 2)) * kBiasStride + jj];
        x *= scale;
        s_acc[nt][e] = (bits >> jj) & 1u ? x : -INFINITY;
        row_max[e / 2] = fmaxf(row_max[e / 2], s_acc[nt][e]);
      }
    }
    float correction[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 1));
      row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 2));
      const float m_new = fmaxf(m_run[r], row_max[r]);
      correction[r] = m_run[r] == -INFINITY ? 0.0f : expf(m_run[r] - m_new);  // 0 while empty
      m_run[r] = m_new;
      l_run[r] *= correction[r];
    }
    // probabilities as A fragments: A column t4 is key 2 t4 and column
    // t4 + 4 key 2 t4 + 1 (the sum over keys does not see their order; V's
    // B fragments below take the same keys)
    uint32_t pa_big[2][4], pa_small[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s_acc[nt][e];
        const float p = x == -INFINITY ? 0.0f : expf(x - m_run[e / 2]);
        l_run[e / 2] += p;
        const int slot = (e % 2) * 2 + e / 2;  // c0 -> a0, c2 -> a1, c1 -> a2, c3 -> a3
        split_tf32(p, pa_big[nt][slot], pa_small[nt][slot]);
      }
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[s][e] *= correction[e / 2];
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        const float* vr = v_s + (8 * kt + 2 * t4) * L::kStride + 8 * s + g;
        uint32_t b_big[2], b_small[2];
        split_tf32(vr[0], b_big[0], b_small[0]);
        split_tf32(vr[L::kStride], b_big[1], b_small[1]);
        mma_3xtf32(o[s], pa_big[kt], pa_small[kt], b_big, b_small);
      }
    }
    __syncwarp();  // the stage is read before the next prefetch overwrites it
    stage ^= 1;
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }

  // merge the 8 warps' partial softmaxes in warp order (the same sums every
  // run); the rings are free once every warp is past its loop
  __syncthreads();
  float* part = shared;                             // (warps, 16, DH)
  float* stats = shared + kAttnWarps * kRows * DH;  // (warps, 16, 2): m, l
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e / 2);
      part[(warp * kRows + r) * DH + 8 * s + 2 * t4 + e % 2] = o[s][e];
    }
  }
  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      stats[(warp * kRows + g + 8 * r) * 2] = m_run[r];
      stats[(warp * kRows + g + 8 * r) * 2 + 1] = l_run[r];
    }
  }
  __syncthreads();
  for (int e = tid; e < kRows * DH; e += kAttnThreads) {
    const int r = e / DH, d = e % DH, i = row0 + r;
    if (i >= N || d >= dw) continue;
    float value = 0.0f;  // padded rows, and rows without a kept key
    if (i < nv_q) {
      float m_all = -INFINITY;
      for (int w = 0; w < kAttnWarps; ++w) m_all = fmaxf(m_all, stats[(w * kRows + r) * 2]);
      if (m_all != -INFINITY) {
        float num = 0.0f, den = 0.0f;
        for (int w = 0; w < kAttnWarps; ++w) {
          const float m_w = stats[(w * kRows + r) * 2];
          if (m_w == -INFINITY) continue;
          const float f = expf(m_w - m_all);
          num += part[(w * kRows + r) * DH + d] * f;
          den += stats[(w * kRows + r) * 2 + 1] * f;
        }
        value = num / den;
      }
    }
    out[i * hd + h * dw + d] = value;
  }
}

// `heads` heads from those q, k, v, bias and out point at (H of them in
// the strides)
template <int DH, bool VEC16>
int launch_attention(const float* q, const float* k, const float* v, const float* bias,
                     const uint8_t* key_masks, const int32_t* nv_q, const int32_t* nv_k,
                     float* out, int N, int M, int H, int heads, int dh, float scale,
                     cudaStream_t stream) {
  const size_t shared =
      sizeof(float) * AttnLayout<DH>::kFloats + sizeof(uint32_t) * ((M + 31) / 32);
  if (shared > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(attention_kernel<DH, VEC16>), shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool bias16 =
      bias != nullptr && M % 4 == 0 && reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  const dim3 grid((N + kRows - 1) / kRows, heads);
  attention_kernel<DH, VEC16><<<grid, kAttnThreads, shared, stream>>>(
      q, k, v, bias, key_masks, nv_q, nv_k, out, N, M, H, dh, scale, bias16);
  return static_cast<int>(cudaGetLastError());
}

// dh > 64: attention_kernel's arithmetic (16 query rows and 8 warps a block,
// the warps splitting the keys into 16-key chunks with an online softmax
// each, q k^T and p v as 3xTF32 mma.sync m16n8k8, the merge in warp order)
// for one 64-column slice of the output a block (blockIdx.z). The q tile
// sits in shared memory zero-padded to a multiple of 8 columns (exact under
// the products); K, V and the bias are read in place through L1 by 4-byte
// loads, zeros past nv_k and dh: the rings of attention_kernel would not
// fit a block's shared memory at these widths. TWO_PASS
// (kernels/attention.py:attention_route, q_tile False): head widths whose q
// tile does not fit a block's shared memory either (dh past ~3,090; the JAX
// kernel holds (H, M, dh) K and V and takes such widths at small key
// counts) take q . k^T from a first pass, attention_scores_kernel, which
// computes each score once (with q read in place, the same products) where
// the slices would each recompute them over all of dh.
constexpr int kWideSlice = 64;

// q . k^T of a block's 16 query rows and keys [c0, c0 + 16) (two n8 tiles)
// as 3xTF32 mma.sync in k8 steps over dh (padded to dhp with zeros): q_at(r,
// d) and k_at(key, d) give the operands. Fragment e of tile nt: query row
// g + 8 (e / 2), key c0 + 8 nt + 2 t4 + e % 2.
template <typename QAt, typename KAt>
__device__ __forceinline__ void chunk_scores(QAt q_at, KAt k_at, int c0, int dhp, int g, int t4,
                                             float (&s_acc)[2][4]) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s_acc[nt][e] = 0.0f;
  }
  for (int s = 0; s < dhp / 8; ++s) {
    uint32_t a_big[4], a_small[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split_tf32(q_at(g + 8 * (e % 2), 8 * s + t4 + 4 * (e / 2)), a_big[e], a_small[e]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int key = c0 + 8 * nt + g;
      uint32_t b_big[2], b_small[2];
      split_tf32(k_at(key, 8 * s + t4), b_big[0], b_small[0]);
      split_tf32(k_at(key, 8 * s + t4 + 4), b_big[1], b_small[1]);
      mma_3xtf32(s_acc[nt], a_big, a_small, b_big, b_small);
    }
  }
}

// The two-pass route's first pass: scores[h, i, j] = q_i . k_j for the
// block's 16 query rows and every key below nv_k, the warps splitting the
// keys into 16-key chunks, q and K read in place through L1. Tiles of
// padded rows write nothing: the second pass zeros them without a read.
__global__ void __launch_bounds__(kAttnThreads) attention_scores_kernel(
    const float* __restrict__ q,            // (H, N, dh)
    const float* __restrict__ k,            // (H, M, dh)
    const int32_t* __restrict__ nv_q_ptr,   // or null: N
    const int32_t* __restrict__ nv_k_ptr,   // or null: M
    float* __restrict__ scores,             // (H, N, M)
    int N, int M, int dh) {
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int nv_q = nv_q_ptr != nullptr ? max(0, min(*nv_q_ptr, N)) : N;
  const int nv_k = nv_k_ptr != nullptr ? max(0, min(*nv_k_ptr, M)) : M;
  if (row0 >= nv_q) return;
  const float* kh = k + static_cast<size_t>(h) * M * dh;
  auto q_at = [&](int r, int d) {
    return row0 + r < N && d < dh ? __ldg(q + (static_cast<size_t>(h) * N + row0 + r) * dh + d)
                                  : 0.0f;
  };
  auto k_at = [&](int key, int d) {
    return key < nv_k && d < dh ? __ldg(kh + static_cast<size_t>(key) * dh + d) : 0.0f;
  };
  const int dhp = (dh + 7) / 8 * 8;
  const int chunks = (nv_k + kKeys - 1) / kKeys;
  for (int c = warp; c < chunks; c += kAttnWarps) {
    const int c0 = c * kKeys;
    float s_acc[2][4];
    chunk_scores(q_at, k_at, c0, dhp, g, t4, s_acc);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = row0 + g + 8 * (e / 2), key = c0 + 8 * nt + 2 * t4 + e % 2;
        if (i < N && key < nv_k) {
          scores[(static_cast<size_t>(h) * N + i) * M + key] = s_acc[nt][e];
        }
      }
    }
  }
}

template <bool TWO_PASS>
__global__ void __launch_bounds__(kAttnThreads, 1) attention_wide_kernel(
    const float* __restrict__ q,            // (H, N, dh)
    const float* __restrict__ k,            // (H, M, dh)
    const float* __restrict__ v,            // (H, M, dh)
    const float* __restrict__ bias,         // (N, H, M) or null
    const uint8_t* __restrict__ key_masks,  // (M,) or null
    const int32_t* __restrict__ nv_q_ptr,   // or null: N
    const int32_t* __restrict__ nv_k_ptr,   // or null: M
    const float* __restrict__ scores,       // (H, N, M) q . k^T where TWO_PASS, else null
    float* __restrict__ out,                // (N, H * dh)
    int N, int M, int H, int dh, float scale) {
  constexpr int kSlice = kWideSlice / 8;  // n8 tiles of p v in the slice
  extern __shared__ float4 shared4[];
  float* shared = reinterpret_cast<float*>(shared4);
  const int dhp = (dh + 7) / 8 * 8;
  const int qs = dhp + 4;                                  // q tile row stride
  float* part = shared;                                    // (warps, 16, 64)
  float* stats = part + kAttnWarps * kRows * kWideSlice;   // (warps, 16, 2): m, l
  float* q_s = stats + kAttnWarps * kRows * 2;             // (16, qs) but where TWO_PASS
  uint32_t* kept = reinterpret_cast<uint32_t*>(q_s + (TWO_PASS ? 0 : kRows * qs));

  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int d0 = blockIdx.z * kWideSlice;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int nv_q = nv_q_ptr != nullptr ? max(0, min(*nv_q_ptr, N)) : N;
  const int nv_k = nv_k_ptr != nullptr ? max(0, min(*nv_k_ptr, M)) : M;
  const size_t hd = static_cast<size_t>(H) * dh;
  const float* kh = k + static_cast<size_t>(h) * M * dh;
  const float* vh = v + static_cast<size_t>(h) * M * dh;

  if (row0 >= nv_q) {  // a tile of padded rows: zeros, nothing read
    for (int e = tid; e < kRows * kWideSlice; e += kAttnThreads) {
      const int i = row0 + e / kWideSlice, d = d0 + e % kWideSlice;
      if (i < N && d < dh) out[i * hd + h * dh + d] = 0.0f;
    }
    return;
  }
  if constexpr (!TWO_PASS) {
    for (int e = tid; e < kRows * dhp; e += kAttnThreads) {
      const int r = e / dhp, d = e % dhp;
      const bool ok = row0 + r < N && d < dh;
      q_s[r * qs + d] = ok ? q[(static_cast<size_t>(h) * N + row0 + r) * dh + d] : 0.0f;
    }
  }
  for (int w = warp; w * 32 < nv_k; w += kAttnWarps) {
    const int j = w * 32 + lane;
    const bool ok = j < nv_k && (key_masks == nullptr || key_masks[j] != 0);
    const uint32_t bits = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) kept[w] = bits;
  }
  __syncthreads();
  // K[key][d] and V[key][d] in place, zeros past nv_k and dh
  auto k_at = [&](int key, int d) {
    return key < nv_k && d < dh ? __ldg(kh + static_cast<size_t>(key) * dh + d) : 0.0f;
  };
  auto v_at = [&](int key, int d) {
    return key < nv_k && d < dh ? __ldg(vh + static_cast<size_t>(key) * dh + d) : 0.0f;
  };
  auto q_at = [&](int r, int d) { return q_s[r * qs + d]; };

  float o[kSlice][4];
#pragma unroll
  for (int s = 0; s < kSlice; ++s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[s][e] = 0.0f;
  }
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
  const int chunks = (nv_k + kKeys - 1) / kKeys;
  for (int c = warp; c < chunks; c += kAttnWarps) {
    const int c0 = c * kKeys;
    float s_acc[2][4];
    if constexpr (TWO_PASS) {  // the first pass's q . k^T, zeros past nv_k (masked below)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = row0 + g + 8 * (e / 2), key = c0 + 8 * nt + 2 * t4 + e % 2;
          s_acc[nt][e] = i < N && key < nv_k
                             ? __ldg(scores + (static_cast<size_t>(h) * N + i) * M + key)
                             : 0.0f;
        }
      }
    } else {
      chunk_scores(q_at, k_at, c0, dhp, g, t4, s_acc);
    }
    const uint32_t bits = kept[c0 / 32] >> (c0 % 32);
    float row_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = 8 * nt + 2 * t4 + e % 2;
        const int i = row0 + g + 8 * (e / 2);
        float x = s_acc[nt][e];
        if (bias != nullptr && i < N && c0 + jj < nv_k) {
          x += __ldg(bias + (static_cast<size_t>(i) * H + h) * M + c0 + jj);
        }
        x *= scale;
        s_acc[nt][e] = (bits >> jj) & 1u ? x : -INFINITY;
        row_max[e / 2] = fmaxf(row_max[e / 2], s_acc[nt][e]);
      }
    }
    float correction[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 1));
      row_max[r] = fmaxf(row_max[r], __shfl_xor_sync(0xffffffffu, row_max[r], 2));
      const float m_new = fmaxf(m_run[r], row_max[r]);
      correction[r] = m_run[r] == -INFINITY ? 0.0f : expf(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= correction[r];
    }
    uint32_t pa_big[2][4], pa_small[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s_acc[nt][e];
        const float p = x == -INFINITY ? 0.0f : expf(x - m_run[e / 2]);
        l_run[e / 2] += p;
        const int slot = (e % 2) * 2 + e / 2;
        split_tf32(p, pa_big[nt][slot], pa_small[nt][slot]);
      }
    }
#pragma unroll
    for (int s = 0; s < kSlice; ++s) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[s][e] *= correction[e / 2];
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        const int key = c0 + 8 * kt + 2 * t4;
        const int d = d0 + 8 * s + g;
        uint32_t b_big[2], b_small[2];
        split_tf32(v_at(key, d), b_big[0], b_small[0]);
        split_tf32(v_at(key + 1, d), b_big[1], b_small[1]);
        mma_3xtf32(o[s], pa_big[kt], pa_small[kt], b_big, b_small);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int s = 0; s < kSlice; ++s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e / 2);
      part[(warp * kRows + r) * kWideSlice + 8 * s + 2 * t4 + e % 2] = o[s][e];
    }
  }
  if (t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      stats[(warp * kRows + g + 8 * r) * 2] = m_run[r];
      stats[(warp * kRows + g + 8 * r) * 2 + 1] = l_run[r];
    }
  }
  __syncthreads();
  for (int e = tid; e < kRows * kWideSlice; e += kAttnThreads) {
    const int r = e / kWideSlice, d = e % kWideSlice, i = row0 + r;
    if (i >= N || d0 + d >= dh) continue;
    float value = 0.0f;  // padded rows, and rows without a kept key
    if (i < nv_q) {
      float m_all = -INFINITY;
      for (int w = 0; w < kAttnWarps; ++w) m_all = fmaxf(m_all, stats[(w * kRows + r) * 2]);
      if (m_all != -INFINITY) {
        float num = 0.0f, den = 0.0f;
        for (int w = 0; w < kAttnWarps; ++w) {
          const float m_w = stats[(w * kRows + r) * 2];
          if (m_w == -INFINITY) continue;
          const float f = expf(m_w - m_all);
          num += part[(w * kRows + r) * kWideSlice + d] * f;
          den += stats[(w * kRows + r) * 2 + 1] * f;
        }
        value = num / den;
      }
    }
    out[i * hd + h * dh + d0 + d] = value;
  }
}

// Shared memory of attention_wide_kernel: the warps' partial outputs and
// (m, l), the q tile where q_tile, the key bitmap.
size_t wide_shared(int M, int dh, bool q_tile) {
  const size_t dhp = (static_cast<size_t>(dh) + 7) / 8 * 8;
  const size_t floats = kAttnWarps * kRows * (kWideSlice + 2) + (q_tile ? kRows * (dhp + 4) : 0);
  return sizeof(float) * floats + sizeof(uint32_t) * ((static_cast<size_t>(M) + 31) / 32);
}

// q_tile: attention_wide_kernel with its q tile staged; else the two-pass
// route, q . k^T into `scores` (H of N x M: a workspace from the wrapper)
int launch_attention_wide(const float* q, const float* k, const float* v, const float* bias,
                          const uint8_t* key_masks, const int32_t* nv_q, const int32_t* nv_k,
                          float* scores, float* out, int N, int M, int H, int heads, int dh,
                          bool q_tile, float scale, cudaStream_t stream) {
  // the route: the q tile staged exactly where it fits
  if (q_tile != (wide_shared(M, dh, true) <= kMaxShared) || (!q_tile && scores == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shared = wide_shared(M, dh, q_tile);
  if (shared > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);  // the key bitmap
  const dim3 grid((N + kRows - 1) / kRows, heads, (dh + kWideSlice - 1) / kWideSlice);
  if (q_tile) {
    const cudaError_t err =
        allow_smem(reinterpret_cast<const void*>(attention_wide_kernel<false>), shared);
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_wide_kernel<false><<<grid, kAttnThreads, shared, stream>>>(
        q, k, v, bias, key_masks, nv_q, nv_k, nullptr, out, N, M, H, dh, scale);
    return static_cast<int>(cudaGetLastError());
  }
  attention_scores_kernel<<<dim3(grid.x, heads), kAttnThreads, 0, stream>>>(q, k, nv_q, nv_k,
                                                                           scores, N, M, dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(reinterpret_cast<const void*>(attention_wide_kernel<true>), shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_wide_kernel<true><<<grid, kAttnThreads, shared, stream>>>(
      q, k, v, bias, key_masks, nv_q, nv_k, scores, out, N, M, H, dh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// vec4: pair_scores_kernel (C a multiple of 4 up to 512, H <= 8, embed and
// qw 16-byte aligned), else pair_scores_any_kernel (kernels/attention.py:
// pair_scores_route picks it). embed_bf16: the embedding is bfloat16, else
// f32.
int rpe_pair_scores_launch(const void* embed, const float* qw, const int32_t* nv_q,
                           const int32_t* nv_k, float* out, int N, int M, int H, int C, int vec4,
                           int embed_bf16, void* stream) {
  if (H < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (vec4 && (H > kMaxHeads || C % 4 != 0 || C > 512 || N > kMaxGridY ||
               reinterpret_cast<uintptr_t>(embed) % 16 != 0 ||
               reinterpret_cast<uintptr_t>(qw) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0 || M == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (embed_bf16) {
    return pair_scores(static_cast<const __nv_bfloat16*>(embed), qw, nv_q, nv_k, out, N, M, H, C,
                       vec4, s);
  }
  return pair_scores(static_cast<const float*>(embed), qw, nv_q, nv_k, out, N, M, H, C, vec4, s);
}

// width, vec16: the instance (kernels/attention.py:attention_route picks
// it): attention_kernel<width> with 16-byte copies (vec16: DH == width, q,
// k and v 16-byte aligned) or 4-byte ones (DH <= width, the columns past DH
// zero), width 8, 16, 32 or 64; width 0: attention_wide_kernel, any DH,
// the q tile in shared memory where q_tile (where it fits), else the
// two-pass route through `scores`, an (H, N, M) workspace.
int fused_attention_launch(const float* q, const float* k, const float* v, const float* bias,
                           const uint8_t* key_masks, const int32_t* nv_q, const int32_t* nv_k,
                           float* scores, float* out, int N, int M, int H, int DH, int width,
                           int vec16, int q_tile, float scale, void* stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (H < 1 || DH < 1 || (width != 0 && DH > width) ||
      (vec16 && (DH != width || !aligned)) || (width != 0 && !q_tile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // heads in launches of at most 65,535 (the grid's y dimension; one launch
  // at every shipped shape): a launch's q, k, v, bias and out start at its
  // first head, the strides stay H's
  for (int h0 = 0; h0 < H; h0 += kMaxGridY) {
    const int heads = min(kMaxGridY, H - h0);
    const float* qh = q + static_cast<size_t>(h0) * N * DH;
    const float* kh = k + static_cast<size_t>(h0) * M * DH;
    const float* vh = v + static_cast<size_t>(h0) * M * DH;
    const float* bh = bias != nullptr ? bias + static_cast<size_t>(h0) * M : nullptr;
    float* oh = out + static_cast<size_t>(h0) * DH;
    float* sh = scores != nullptr ? scores + static_cast<size_t>(h0) * N * M : nullptr;
    auto narrow = [&](auto launch) {
      return launch(qh, kh, vh, bh, key_masks, nv_q, nv_k, oh, N, M, H, heads, DH, scale, s);
    };
    int err = 0;
    switch (width * 2 + (vec16 ? 1 : 0)) {
      case 0:
        err = launch_attention_wide(qh, kh, vh, bh, key_masks, nv_q, nv_k, sh, oh, N, M, H, heads,
                                    DH, q_tile != 0, scale, s);
        break;
      case 17: err = narrow(launch_attention<8, true>); break;
      case 33: err = narrow(launch_attention<16, true>); break;
      case 65: err = narrow(launch_attention<32, true>); break;
      case 129: err = narrow(launch_attention<64, true>); break;
      case 16: err = narrow(launch_attention<8, false>); break;
      case 32: err = narrow(launch_attention<16, false>); break;
      case 64: err = narrow(launch_attention<32, false>); break;
      case 128: err = narrow(launch_attention<64, false>); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != 0) return err;
  }
  return 0;
}

}  // extern "C"
