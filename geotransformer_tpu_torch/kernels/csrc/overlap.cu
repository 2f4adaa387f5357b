// Ground-truth patch overlaps for Hopper (sm_90a), f32 on the CUDA cores.
//
// Replaces geotransformer_tpu/kernels/overlap.py:patch_overlaps (pallas_call
// at :132, body _overlap_kernel :26). For each ref node m and each of its S
// candidate src nodes c = cand[m, s]:
//   covered_ref = #{i : rm[m, i], exists j: sm[c, j], |r[m, i] - s[c, j]|^2 < r^2}
//   covered_src = #{j : sm[c, j], exists i: rm[m, i], |r[m, i] - s[c, j]|^2 < r^2}
//   out[m, s]   = 0.5 (covered_ref / max(#rm, 1) + covered_src / max(#sm, 1))
// and 0 where the candidate's mask is off or its index lies outside [0, N).
//
// What bounds it on an H100 (chip_smoke.py's cost_patch_overlaps): the
// bytes. It reads the masks, the candidate table, the ref patches and the
// candidate patches once each and writes the (M, S) overlaps (~0.5-2 MB at
// KITTI's caps: 0.0006 ms at 3.35 TB/s); the work is 9 operations a valid
// point pair of a valid candidate (17.9 M at KITTI's step, ~0.3 us at the
// CUDA cores' 67 TFLOP/s). So at these sizes one launch's latency and the
// chain of dependent loads set the time, not the arithmetic.
//
// Design: a block takes a ref node's candidates 8 at a time (the grid is
// M x S / 8), 8 warps. Every warp takes one __ballot_sync of the 8
// candidates' validity (mask on, index in range); warp 0 writes 0 for the
// invalid ones, and a block without a valid candidate is done there,
// before it stages anything (most blocks: a KITTI node has ~3 valid
// candidates of 64). Warp w takes the w-th valid candidate (the list the
// ballot compacts) and compacts that patch's valid points into its own
// shared slot, each lane starting the loads of 128 slots at once; a warp
// without a candidate compacts the ref patch's; one barrier. The warp then
// walks valid x valid pairs only: lane l holds ref points l, l + 32, ...
// (four at a time, their cover flags in registers), and for each src
// point one ballot over the lanes gives its cover flag, kept as a bit of a
// 32-bit mask word. The counts are popcounts. The distance is taken
// directly as dx dx + dy dy + dz dz, each product and sum rounded on its
// own (no FMA contraction), exactly as the plain PyTorch version computes
// it, so the two agree bit for bit on the cover flags and so on the
// overlaps. The candidate indices are read as they come (int64 from
// torch.topk, or int32), and a launch sets the kernel's shared-memory limit
// only when it grows.

#include <cuda_runtime.h>

#include <cstdint>

#include "launch_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRefTile = 4;  // ref points a lane holds at a time: 128 a warp
constexpr int kBatch = 4;    // chunks of 32 slots whose loads a lane starts together

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

// Compacts the valid points of one (K, 3) patch into pts_s as (x, y, z, 0)
// (in slot order) with one warp: each lane loads its slots of kBatch chunks
// of 32 at once (the loads of a batch in flight together, points whether
// valid or not, so that no load waits on the mask), then a ballot a chunk
// places them. Returns the count (in every lane).
__device__ __forceinline__ int compact_patch(const float* __restrict__ pts,
                                             const uint8_t* __restrict__ mask, int K,
                                             float4* pts_s, int lane) {
  int n = 0;
  for (int k0 = 0; k0 < K; k0 += 32 * kBatch) {
    bool on[kBatch];
    float x[kBatch], y[kBatch], z[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int k = k0 + 32 * b + lane;
      const bool in = k < K;
      on[b] = in && mask[k] != 0;
      x[b] = in ? pts[3 * k + 0] : 0.0f;
      y[b] = in ? pts[3 * k + 1] : 0.0f;
      z[b] = in ? pts[3 * k + 2] : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const uint32_t bits = __ballot_sync(0xffffffffu, on[b]);
      if (on[b]) pts_s[n + __popc(bits & ((1u << lane) - 1u))] = make_float4(x[b], y[b], z[b], 0.0f);
      n += __popc(bits);
    }
  }
  return n;
}

template <typename Index>
__global__ void __launch_bounds__(kThreads) patch_overlap_kernel(
    const float* __restrict__ ref_pts,     // (M, K, 3)
    const uint8_t* __restrict__ ref_mask,  // (M, K)
    const float* __restrict__ src_pts,     // (N, K, 3), already transformed
    const uint8_t* __restrict__ src_mask,  // (N, K)
    const Index* __restrict__ cand,        // (M, S) src node per candidate
    const uint8_t* __restrict__ cand_mask, // (M, S)
    float* __restrict__ out,               // (M, S)
    int N, int S, int K, float r2) {
  extern __shared__ float4 smem4[];
  const int words = (K + 31) / 32;
  float4* ref_s = smem4;                                  // (K,) the ref patch's valid points
  float4* slots = ref_s + K;                              // kWarps x (K,) a candidate's
  uint32_t* cov_all = reinterpret_cast<uint32_t*>(slots + kWarps * K);  // kWarps x (words,)
  __shared__ int n_ref_s;
  const int m = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t row = static_cast<size_t>(m) * S;

  // 1. the block's kWarps candidates: every warp takes the same ballot of
  // the valid ones (mask on, index in range); warp 0 writes 0 for the
  // rest; a block without a valid candidate is done before it stages
  // anything
  const int s0 = kWarps * blockIdx.y;
  bool on = false;
  if (lane < kWarps && s0 + lane < S) {
    const long long c = static_cast<long long>(cand[row + s0 + lane]);
    on = cand_mask[row + s0 + lane] != 0 && c >= 0 && c < N;
    if (warp == 0 && !on) out[row + s0 + lane] = 0.0f;
  }
  const uint32_t valid = __ballot_sync(0xffffffffu, on);
  const int total = __popc(valid);
  if (total == 0) return;

  // 2. warp w takes the w-th valid candidate (the list compacted by the
  // ballot) and compacts its patch; a warp without one (or the last)
  // compacts the ref patch; one barrier
  float4* src_s = slots + static_cast<size_t>(warp) * K;
  uint32_t* cov = cov_all + static_cast<size_t>(warp) * words;
  int s = -1;
  int n_src = 0;
  if (warp < total) {
    uint32_t rest = valid;
    for (int k = 0; k < warp; ++k) rest &= rest - 1u;  // drop the first `warp` set bits
    s = s0 + __ffs(rest) - 1;
    const long long c = static_cast<long long>(cand[row + s]);
    n_src = compact_patch(src_pts + c * K * 3, src_mask + c * K, K, src_s, lane);
  }
  if (warp == (total < kWarps ? total : kWarps - 1)) {
    const int n_ref = compact_patch(ref_pts + static_cast<size_t>(m) * K * 3,
                                    ref_mask + static_cast<size_t>(m) * K, K, ref_s, lane);
    if (lane == 0) n_ref_s = n_ref;
  }
  __syncthreads();
  if (warp >= total) return;
  const int n_ref = n_ref_s;

  // 3. valid x valid pairs: lane l holds ref points i0 + l + 32 t (t <
  // kRefTile) in registers, their cover flags too; one ballot a src point
  // gives its cover flag, 32 flags a mask word
  for (int w = lane; w < words; w += 32) cov[w] = 0u;
  __syncwarp();
  int ref_cover = 0;
  for (int i0 = 0; i0 < n_ref; i0 += 32 * kRefTile) {
    float x[kRefTile], y[kRefTile], z[kRefTile];
    bool live[kRefTile], hit[kRefTile];
#pragma unroll
    for (int t = 0; t < kRefTile; ++t) {
      const int i = i0 + lane + 32 * t;
      live[t] = i < n_ref;
      const float4 p = live[t] ? ref_s[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      x[t] = p.x;
      y[t] = p.y;
      z[t] = p.z;
      hit[t] = false;
    }
    const int tiles = min(kRefTile, (n_ref - i0 + 31) / 32);  // the tile's live rows
    for (int j0 = 0; j0 < n_src; j0 += 32) {
      uint32_t word = 0u;
      const int jn = min(32, n_src - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const float4 p = src_s[j0 + jj];
        bool any = false;
#pragma unroll
        for (int t = 0; t < kRefTile; ++t) {
          if (t < tiles) {
            const bool close = live[t] && sq_dist(x[t], y[t], z[t], p.x, p.y, p.z) < r2;
            hit[t] |= close;
            any |= close;
          }
        }
        word |= static_cast<uint32_t>(__ballot_sync(0xffffffffu, any) != 0u) << jj;
      }
      if (lane == 0) cov[j0 / 32] |= word;
    }
#pragma unroll
    for (int t = 0; t < kRefTile; ++t) ref_cover += hit[t];
  }
  __syncwarp();
  int src_cover = 0;
  for (int w = lane; w < words; w += 32) src_cover += __popc(cov[w]);
  ref_cover = warp_sum(ref_cover);
  src_cover = warp_sum(src_cover);
  if (lane == 0) {
    const float ref_total = n_ref > 0 ? static_cast<float>(n_ref) : 1.0f;
    const float src_total = n_src > 0 ? static_cast<float>(n_src) : 1.0f;
    out[row + s] = 0.5f * (static_cast<float>(ref_cover) / ref_total +
                           static_cast<float>(src_cover) / src_total);
  }
}

// The general route (kernels/overlap.py:overlap_route): patches too large
// for a block's shared memory to hold the ref patch and a patch a warp
// (past ~1,600 points; the JAX kernel takes thousands at small S). Nothing
// is staged: a block takes one candidate (the grid is M x S), and its warps
// split the 32-point chunks of each count: both patches' valid points, the
// ref points with a partner (lanes over the ref points, each walking the
// candidate's points through L1 until it is covered, the warp stopping once
// every lane is), then the candidate's points with one (the roles swapped);
// the warps' counts add in warp order. Every distance is sq_dist(ref point,
// src point), as the staged kernel and the plain version take it, so the
// counts and the overlaps are the same bits.
__device__ __forceinline__ int count_valid(const uint8_t* __restrict__ mask, int K) {
  int n = 0;
  for (int k = threadIdx.x; k < K; k += kThreads) n += mask[k] != 0;
  return warp_sum(n);
}

// This warp's share of the points of `mine` (valid by mine_mask) with a
// partner among the valid points of `other`: its 32-point chunks, lanes
// over `mine`; REF_MINE: `mine` is the ref patch.
template <bool REF_MINE>
__device__ int covered(const float* __restrict__ mine, const uint8_t* __restrict__ mine_mask,
                       const float* __restrict__ other, const uint8_t* __restrict__ other_mask,
                       int K, float r2, int warp, int lane) {
  int cover = 0;
  for (int i0 = 32 * warp; i0 < K; i0 += 32 * kWarps) {
    const int i = i0 + lane;
    const bool live = i < K && mine_mask[i] != 0;
    const float x = live ? mine[3 * i + 0] : 0.0f;
    const float y = live ? mine[3 * i + 1] : 0.0f;
    const float z = live ? mine[3 * i + 2] : 0.0f;
    bool hit = false;
    for (int j = 0; j < K && __any_sync(0xffffffffu, live && !hit); ++j) {
      if (other_mask[j] == 0) continue;  // the same j in every lane
      const float ox = other[3 * j + 0], oy = other[3 * j + 1], oz = other[3 * j + 2];
      const float d2 = REF_MINE ? sq_dist(x, y, z, ox, oy, oz) : sq_dist(ox, oy, oz, x, y, z);
      hit |= live && d2 < r2;
    }
    cover += hit;
  }
  return warp_sum(cover);
}

template <typename Index>
__global__ void __launch_bounds__(kThreads) patch_overlap_general_kernel(
    const float* __restrict__ ref_pts,     // (M, K, 3)
    const uint8_t* __restrict__ ref_mask,  // (M, K)
    const float* __restrict__ src_pts,     // (N, K, 3), already transformed
    const uint8_t* __restrict__ src_mask,  // (N, K)
    const Index* __restrict__ cand,        // (M, S) src node per candidate
    const uint8_t* __restrict__ cand_mask, // (M, S)
    float* __restrict__ out,               // (M, S)
    int N, int S, int K, float r2) {
  __shared__ int counts_s[kWarps][4];  // n_ref, n_src, ref cover, src cover
  const int m = blockIdx.x, s = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t at = static_cast<size_t>(m) * S + s;
  const long long c = static_cast<long long>(cand[at]);
  if (cand_mask[at] == 0 || c < 0 || c >= N) {
    if (threadIdx.x == 0) out[at] = 0.0f;
    return;
  }
  const float* rp = ref_pts + static_cast<size_t>(m) * K * 3;
  const uint8_t* rm = ref_mask + static_cast<size_t>(m) * K;
  const float* sp = src_pts + c * K * 3;
  const uint8_t* sm = src_mask + c * K;
  const int n_ref = count_valid(rm, K);
  const int n_src = count_valid(sm, K);
  const int ref_cover = covered<true>(rp, rm, sp, sm, K, r2, warp, lane);
  const int src_cover = covered<false>(sp, sm, rp, rm, K, r2, warp, lane);
  if (lane == 0) {
    counts_s[warp][0] = n_ref;
    counts_s[warp][1] = n_src;
    counts_s[warp][2] = ref_cover;
    counts_s[warp][3] = src_cover;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int total[4] = {0, 0, 0, 0};
    for (int w = 0; w < kWarps; ++w) {
      for (int t = 0; t < 4; ++t) total[t] += counts_s[w][t];
    }
    const float ref_total = total[0] > 0 ? static_cast<float>(total[0]) : 1.0f;
    const float src_total = total[1] > 0 ? static_cast<float>(total[1]) : 1.0f;
    out[at] = 0.5f * (static_cast<float>(total[2]) / ref_total +
                      static_cast<float>(total[3]) / src_total);
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// cand: (M, S) int64 (index_bytes 8) or int32 (4), read as it is. staged:
// the route (kernels/overlap.py:overlap_route), 1 where a block stages the
// ref patch and a patch a warp (every shipped configuration), 0 the general
// route.
int patch_overlaps_launch(const float* ref_pts, const uint8_t* ref_mask, const float* src_pts,
                          const uint8_t* src_mask, const void* cand, const uint8_t* cand_mask,
                          float* out, int M, int N, int S, int K, int index_bytes, int staged,
                          float r2, void* stream) {
  if (K < 1 || S < 1 || (index_bytes != 4 && index_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the ref patch and a patch a warp as float4, a warp's cover words
  const size_t words = (static_cast<size_t>(K) + 31) / 32;
  const size_t staged_smem = sizeof(float4) * (kWarps + 1) * static_cast<size_t>(K) +
                             sizeof(uint32_t) * kWarps * words;
  const size_t block_bytes = static_cast<size_t>(launch_util::device_limits().block_bytes);
  if ((staged != 0) != (staged_smem <= block_bytes)) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const size_t smem = staged ? staged_smem : 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel, auto index) {
    using Index = decltype(index);
    const cudaError_t err = launch_util::allow_smem(reinterpret_cast<const void*>(kernel), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    // the staged kernel: a block a node's 8 candidates; the general one: a
    // block a candidate
    const dim3 grid(M, staged ? (S + kWarps - 1) / kWarps : S);
    kernel<<<grid, kThreads, smem, st>>>(ref_pts, ref_mask, src_pts, src_mask,
                                      static_cast<const Index*>(cand), cand_mask, out, N, S, K,
                                      r2);
    return static_cast<int>(cudaGetLastError());
  };
  if (!staged) {
    if (index_bytes == 8) return run(patch_overlap_general_kernel<int64_t>, int64_t{0});
    return run(patch_overlap_general_kernel<int32_t>, int32_t{0});
  }
  if (index_bytes == 8) return run(patch_overlap_kernel<int64_t>, int64_t{0});
  return run(patch_overlap_kernel<int32_t>, int32_t{0});
}

}  // extern "C"
