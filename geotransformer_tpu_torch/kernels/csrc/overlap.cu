// Ground-truth patch overlaps for Hopper (sm_90a), f32 on the CUDA cores.
//
// Replaces geotransformer_tpu/kernels/overlap.py:patch_overlaps (pallas_call
// at :132, body _overlap_kernel :26). For each ref node m and each of its S
// candidate src nodes c = cand[m, s]:
//   covered_ref = #{i : rm[m, i], exists j: sm[c, j], |r[m, i] - s[c, j]|^2 < r^2}
//   covered_src = #{j : sm[c, j], exists i: rm[m, i], |r[m, i] - s[c, j]|^2 < r^2}
//   out[m, s]   = 0.5 (covered_ref / max(#rm, 1) + covered_src / max(#sm, 1))
// and 0 where the candidate's mask is off.
//
// Design. The TPU kernel was handed the (M, S, K, 3) gather of the candidate
// patches (25 MB at KITTI's M = 256, S = 64, K = 128) and evaluated the K x K
// distances as one HIGHEST-precision MXU dot per (node, candidate). Here the
// candidate patches are read through the candidate indices: a block serves one
// ref node and kWarps candidates, stages the ref patch and its mask in shared
// memory once, and gives each warp one candidate, whose patch the warp copies
// into its own shared slot. Each lane owns ref points i = lane, lane + 32, ...,
// sweeps all K src points once, keeps its ref cover flags in registers and sets
// the src cover flags in shared memory (a benign race: every writer stores 1);
// warp reductions then count both. The distance is taken directly as
// dx dx + dy dy + dz dz, each product and sum rounded on its own (no FMA
// contraction), exactly as the plain PyTorch version computes it, so the two
// agree bit for bit on the cover flags.
//
// What bounds it: K^2 = 16,384 distance evaluations a (node, candidate) pair,
// ~10 operations each: 2.7e9 operations for KITTI's 256 x 64 pairs, about
// 40 us at the f32 rate; the bytes read are ~0.4 MB of patches.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float sq_dist(float ax, float ay, float az, float bx, float by,
                                         float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads) patch_overlap_kernel(
    const float* __restrict__ ref_pts,     // (M, K, 3)
    const uint8_t* __restrict__ ref_mask,  // (M, K)
    const float* __restrict__ src_pts,     // (N, K, 3), already transformed
    const uint8_t* __restrict__ src_mask,  // (N, K)
    const int32_t* __restrict__ cand,      // (M, S) src node per candidate
    const uint8_t* __restrict__ cand_mask, // (M, S)
    float* __restrict__ out,               // (M, S)
    int M, int N, int S, int K, float r2) {
  extern __shared__ float smem[];
  float* rp = smem;                            // (K, 3) ref patch
  float* rm = rp + 3 * K;                      // (K,) ref mask as 0/1
  float* slots = rm + K;                       // kWarps x [sp (K, 3), sm (K,), cov (K,)]
  const int m = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < 3 * K; i += kThreads) {
    rp[i] = ref_pts[static_cast<size_t>(m) * K * 3 + i];
  }
  for (int i = threadIdx.x; i < K; i += kThreads) {
    rm[i] = ref_mask[static_cast<size_t>(m) * K + i] ? 1.0f : 0.0f;
  }
  __syncthreads();

  const int s = blockIdx.y * kWarps + warp;
  if (s >= S) return;
  const size_t o = static_cast<size_t>(m) * S + s;
  const int c = cand[o];
  if (!cand_mask[o] || c < 0 || c >= N) {
    if (lane == 0) out[o] = 0.0f;
    return;
  }
  float* sp = slots + static_cast<size_t>(warp) * 5 * K;
  float* sm = sp + 3 * K;
  float* cov = sm + K;
  for (int i = lane; i < 3 * K; i += 32) sp[i] = src_pts[static_cast<size_t>(c) * K * 3 + i];
  for (int j = lane; j < K; j += 32) {
    sm[j] = src_mask[static_cast<size_t>(c) * K + j] ? 1.0f : 0.0f;
    cov[j] = 0.0f;
  }
  __syncwarp();

  int ref_cover = 0;
  int ref_total = 0;
  for (int i = lane; i < K; i += 32) {
    if (rm[i] == 0.0f) continue;
    ++ref_total;
    const float x = rp[3 * i + 0];
    const float y = rp[3 * i + 1];
    const float z = rp[3 * i + 2];
    int hit = 0;
    for (int j = 0; j < K; ++j) {
      if (sm[j] != 0.0f && sq_dist(x, y, z, sp[3 * j + 0], sp[3 * j + 1], sp[3 * j + 2]) < r2) {
        hit = 1;
        cov[j] = 1.0f;
      }
    }
    ref_cover += hit;
  }
  __syncwarp();
  int src_cover = 0;
  int src_total = 0;
  for (int j = lane; j < K; j += 32) {
    src_cover += cov[j] != 0.0f;
    src_total += sm[j] != 0.0f;
  }
  ref_cover = warp_sum(ref_cover);
  ref_total = warp_sum(ref_total);
  src_cover = warp_sum(src_cover);
  src_total = warp_sum(src_total);
  if (lane == 0) {
    const float rt = ref_total > 0 ? static_cast<float>(ref_total) : 1.0f;
    const float st = src_total > 0 ? static_cast<float>(src_total) : 1.0f;
    out[o] = 0.5f * (static_cast<float>(ref_cover) / rt + static_cast<float>(src_cover) / st);
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int patch_overlaps_launch(const float* ref_pts, const uint8_t* ref_mask, const float* src_pts,
                          const uint8_t* src_mask, const int32_t* cand, const uint8_t* cand_mask,
                          float* out, int M, int N, int S, int K, float r2, void* stream) {
  if (K < 1 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const size_t smem = sizeof(float) * (4 * static_cast<size_t>(K) + kWarps * 5 * static_cast<size_t>(K));
  cudaError_t err = cudaFuncSetAttribute(
      patch_overlap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(M, (S + kWarps - 1) / kWarps);
  patch_overlap_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      ref_pts, ref_mask, src_pts, src_mask, cand, cand_mask, out, M, N, S, K, r2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
