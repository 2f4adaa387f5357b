// The two attention kernels of the geometric transformer, for Hopper
// (sm_90a), f32 on the CUDA cores.
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
//
// attention_kernel replaces geotransformer_tpu/kernels/attention.py:
// fused_masked_attention (pallas_call at :355):
//   out[i, h * dh + d] = sum_j softmax_j((q[h, i] . k[h, j] + bias[i, h, j])
//                                        * scale) v[h, j, d]
// over the keys j < nv_k that the key mask keeps, zero for query rows
// i >= nv_q. What bounds it at these sizes (N, M <= ~640, dh <= 64, four
// heads): latency, not bytes or flops: the scores never reach device
// memory. A block takes one head and 16 query rows; 8 threads share a row,
// each with its own running max / sum (online softmax) over every 8th key
// of each 64-key chunk that the block stages in shared memory (rows padded
// to dh + 1 floats: the 8 threads of a row read 8 keys in 8 banks). The 8
// partial softmaxes of a row are merged with shuffles at the end. Chunks
// past nv_k are never read; blocks of padded rows write zeros only.
//
// No tensor cores (no TF32, no bf16): the first correct kernels. The JAX
// kernels read bf16 operands with f32 accumulation.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// ---- RPE pair scores -------------------------------------------------------

constexpr int kMaxHeads = 8;
constexpr int kPairThreads = 256;  // 8 warps
constexpr int kColsPerWarp = 4;
constexpr int kColsPerBlock = (kPairThreads / 32) * kColsPerWarp;  // 32

template <int CPL>  // float4 loads per lane and pair: C <= 128 * CPL
__global__ void __launch_bounds__(kPairThreads) pair_scores_kernel(
    const float* __restrict__ embed,     // (N, M, C)
    const float* __restrict__ qw,        // (N, H, C)
    const int32_t* __restrict__ nv_q_ptr,
    const int32_t* __restrict__ nv_k_ptr,
    float* __restrict__ out,             // (N, H, M)
    int N, int M, int H, int C) {
  extern __shared__ float4 qw_s[];  // (H, C / 4)
  const int i = blockIdx.y;
  const int j0 = blockIdx.x * kColsPerBlock;
  const int nv_q = min(*nv_q_ptr, N);
  const int nv_k = min(*nv_k_ptr, M);
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

  const float4* e_row = reinterpret_cast<const float4*>(embed + static_cast<size_t>(i) * M * C);
  const int jw = j0 + warp * kColsPerWarp;
  float4 ev[kColsPerWarp][CPL];
#pragma unroll
  for (int cc = 0; cc < kColsPerWarp; ++cc) {
    const int j = jw + cc;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c4 = lane + 32 * t;
      ev[cc][t] = (j < nv_k && c4 < c4s) ? e_row[static_cast<size_t>(j) * c4s + c4]
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

template <int CPL>
int launch_pair_scores(const float* embed, const float* qw, const int32_t* nv_q,
                       const int32_t* nv_k, float* out, int N, int M, int H, int C,
                       cudaStream_t stream) {
  const dim3 grid((M + kColsPerBlock - 1) / kColsPerBlock, N);
  const size_t shared = static_cast<size_t>(H) * C * sizeof(float);
  pair_scores_kernel<CPL><<<grid, kPairThreads, shared, stream>>>(
      embed, qw, nv_q, nv_k, out, N, M, H, C);
  return static_cast<int>(cudaGetLastError());
}

// ---- fused masked attention ------------------------------------------------

constexpr int kAttnThreads = 128;
constexpr int kGroup = 8;                                  // threads per query row
constexpr int kRowsPerBlock = kAttnThreads / kGroup;       // 16
constexpr int kKeyChunk = 64;                              // keys staged at a time
constexpr int kKeysPerThread = kKeyChunk / kGroup;         // 8

template <int DH>
__global__ void __launch_bounds__(kAttnThreads) attention_kernel(
    const float* __restrict__ q,            // (H, N, DH)
    const float* __restrict__ k,            // (H, M, DH)
    const float* __restrict__ v,            // (H, M, DH)
    const float* __restrict__ bias,         // (N, H, M) or null
    const uint8_t* __restrict__ key_masks,  // (M,) or null
    const int32_t* __restrict__ nv_q_ptr,
    const int32_t* __restrict__ nv_k_ptr,
    float* __restrict__ out,                // (N, H * DH)
    int N, int M, int H, float scale) {
  __shared__ float k_s[kKeyChunk][DH + 1];
  __shared__ float v_s[kKeyChunk][DH + 1];
  __shared__ bool ok_s[kKeyChunk];

  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int tid = threadIdx.x;
  const int g = tid % kGroup;
  const int i = row0 + tid / kGroup;
  const int nv_q = min(*nv_q_ptr, N);
  const int nv_k = min(*nv_k_ptr, M);
  const size_t hd = static_cast<size_t>(H) * DH;

  if (row0 >= nv_q) {
    for (int e = tid; e < kRowsPerBlock * DH; e += kAttnThreads) {
      const int ii = row0 + e / DH;
      if (ii < N) out[ii * hd + h * DH + e % DH] = 0.0f;
    }
    return;
  }

  // rows past N (the last tile's tail) read row N - 1 and write nothing
  const int ic = min(i, N - 1);
  float qr[DH];
  const float* q_row = q + (static_cast<size_t>(h) * N + ic) * DH;
#pragma unroll
  for (int d = 0; d < DH; ++d) qr[d] = q_row[d];
  const float* bias_row = bias != nullptr ? bias + (static_cast<size_t>(ic) * H + h) * M : nullptr;

  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.0f;
  float m_run = -INFINITY, l_run = 0.0f;

  for (int c0 = 0; c0 < nv_k; c0 += kKeyChunk) {
    __syncthreads();  // the previous chunk is consumed
    const int keys = min(kKeyChunk, nv_k - c0);
    for (int e = tid; e < kKeyChunk * DH; e += kAttnThreads) {
      const int jj = e / DH, d = e % DH;
      const size_t src = (static_cast<size_t>(h) * M + c0 + jj) * DH + d;
      k_s[jj][d] = jj < keys ? k[src] : 0.0f;
      v_s[jj][d] = jj < keys ? v[src] : 0.0f;
    }
    for (int jj = tid; jj < kKeyChunk; jj += kAttnThreads) {
      ok_s[jj] = jj < keys && (key_masks == nullptr || key_masks[c0 + jj] != 0);
    }
    __syncthreads();

    float s[kKeysPerThread];
    float chunk_max = -INFINITY;
#pragma unroll
    for (int t = 0; t < kKeysPerThread; ++t) {
      const int jj = g + kGroup * t;
      float dot = 0.0f;
#pragma unroll
      for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], k_s[jj][d], dot);
      if (bias_row != nullptr && jj < keys) dot += bias_row[c0 + jj];
      s[t] = ok_s[jj] ? dot * scale : -INFINITY;
      chunk_max = fmaxf(chunk_max, s[t]);
    }
    if (chunk_max == -INFINITY) continue;  // none of this thread's keys is valid
    const float m_new = fmaxf(m_run, chunk_max);
    const float correction = expf(m_run - m_new);  // 0 while m_run is -inf
    l_run *= correction;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= correction;
#pragma unroll
    for (int t = 0; t < kKeysPerThread; ++t) {
      const int jj = g + kGroup * t;
      const float p = s[t] == -INFINITY ? 0.0f : expf(s[t] - m_new);
      l_run += p;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, v_s[jj][d], acc[d]);
    }
    m_run = m_new;
  }

  // merge the row's kGroup partial softmaxes (its threads are adjacent lanes)
  float m_all = m_run;
#pragma unroll
  for (int off = 1; off < kGroup; off <<= 1) {
    m_all = fmaxf(m_all, __shfl_xor_sync(0xffffffffu, m_all, off));
  }
  const float w = m_run == -INFINITY ? 0.0f : expf(m_run - m_all);
  float l_all = l_run * w;
#pragma unroll
  for (int off = 1; off < kGroup; off <<= 1) l_all += __shfl_xor_sync(0xffffffffu, l_all, off);
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    float a = acc[d] * w;
#pragma unroll
    for (int off = 1; off < kGroup; off <<= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    acc[d] = a;
  }
  // padded rows, and rows without a valid key, write exact zeros
  const float inv = i < nv_q ? 1.0f / fmaxf(l_all, 1e-30f) : 0.0f;
  if (i < N) {
    float* out_row = out + i * hd + h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      if (d % kGroup == g) out_row[d] = acc[d] * inv;
    }
  }
}

template <int DH>
int launch_attention(const float* q, const float* k, const float* v, const float* bias,
                     const uint8_t* key_masks, const int32_t* nv_q, const int32_t* nv_k,
                     float* out, int N, int M, int H, float scale, cudaStream_t stream) {
  const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock, H);
  attention_kernel<DH><<<grid, kAttnThreads, 0, stream>>>(
      q, k, v, bias, key_masks, nv_q, nv_k, out, N, M, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rpe_pair_scores_launch(const float* embed, const float* qw, const int32_t* nv_q,
                           const int32_t* nv_k, float* out, int N, int M, int H, int C,
                           void* stream) {
  if (H < 1 || H > kMaxHeads || C < 4 || C % 4 != 0 || C > 512) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0 || M == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((C + 127) / 128) {
    case 1: return launch_pair_scores<1>(embed, qw, nv_q, nv_k, out, N, M, H, C, s);
    case 2: return launch_pair_scores<2>(embed, qw, nv_q, nv_k, out, N, M, H, C, s);
    case 3: return launch_pair_scores<3>(embed, qw, nv_q, nv_k, out, N, M, H, C, s);
    case 4: return launch_pair_scores<4>(embed, qw, nv_q, nv_k, out, N, M, H, C, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int fused_attention_launch(const float* q, const float* k, const float* v, const float* bias,
                           const uint8_t* key_masks, const int32_t* nv_q, const int32_t* nv_k,
                           float* out, int N, int M, int H, int DH, float scale, void* stream) {
  if (H < 1 || H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (DH) {
    case 8: return launch_attention<8>(q, k, v, bias, key_masks, nv_q, nv_k, out, N, M, H, scale, s);
    case 16: return launch_attention<16>(q, k, v, bias, key_masks, nv_q, nv_k, out, N, M, H, scale, s);
    case 32: return launch_attention<32>(q, k, v, bias, key_masks, nv_q, nv_k, out, N, M, H, scale, s);
    case 64: return launch_attention<64>(q, k, v, bias, key_masks, nv_q, nv_k, out, N, M, H, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
