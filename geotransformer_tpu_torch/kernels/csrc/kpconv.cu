// KPConv forward kernels for Hopper (sm_90a).
//
// kpconv_conv_launch replaces geotransformer_tpu/kernels/kpconv.py:
// kpconv_fused (pallas_call at :426/:467, body _kpconv_kernel_body :160,
// valid-tile skip _kpconv_kernel :90) and kpconv_split_fused (:1288), which
// on the TPU reaches the same pallas_call once for the head and once for the
// tail and combines them in XLA. Here a conv is two kernels of
// kpconv_common.cuh, whole table or split alike:
//   1. the edge pass: T[q, k, c] = sum_h infl[q, h, k] f[n(q, h), c] into an
//      (M, K * C) workspace, with the count divisor and the shortcut
//      max-pool and its tie counts; a split table is walked in the same pass
//      (each query's head columns, then its tail row through tail_rank), so
//      count = max(count_h + count_t, 1), pooled = max(pooled_h, pooled_t)
//      with a missing tail row as the zero shadow row, and ties counted
//      against the combined max, as the two passes and the combine did;
//   2. the contraction out = T W / count (W viewed as (K * C, D)) on the
//      tensor cores in 3xTF32 (f32 accuracy), W read once per 64-128 queries.
// What bounded the kernel it replaces (chip_smoke.py on an H100 80GB HBM3 at
// 700 W): a 4-32-query tile held T in shared memory and streamed all of W
// through L2 per block onto the CUDA cores (~2 GB of L2 reads for one
// stage-5 KITTI conv); a split conv paid that twice and a torch combine.
// Now the contraction runs at tensor-core rates and the edge pass, bound by
// its FMAs on the CUDA cores and the gathers from L2, sizes its tile by the
// thread count alone.
//
// The c_in == 1 input conv, t1[q, k] = sum_h infl(s_h - q, kp_k) feat_h and
// out = t1 W / max(count, 1), is two kernels that share one edge body
// (add_edge) and one epilogue (write_outputs):
//   kpconv_stream_kernel replaces kpconv_stream_fused (geotransformer_tpu/
//   kernels/kpconv.py:1679, body _kpconv_stream_kernel :1642): an edge's
//   offset, flag and feature come from five precomputed (M, H) planes;
//   kpconv_union_kernel replaces kpconv_union_input_fused (:1135, body
//   _kpconv_union_input_kernel :1057): they come from the tile's union of
//   support rows through union_sel. The TPU kernel scored every query
//   against all U union candidates through a membership matrix (Mosaic has
//   no per-lane gather), U / H (~38) times the geometry the edges need; here
//   each edge indexes the union staged in shared memory.
// What bounds them on an H100: row 2 reads 5 M H floats and writes M D
// (~35 MB a 3DMatch forward, ~92 MB a KITTI one); the edge body is ~11
// instructions a (slot, kernel point), ~10 on the FMA pipe and one MUFU
// square root, which at the full instruction rate takes about as long as the
// bytes; t1 W (2 M K D, ~66 MFLOP a 3DMatch forward, ~1 us at the CUDA
// cores' 67 TFLOP/s) would gain nothing on the tensor cores. So the design takes each
// edge's geometry once and keeps the loads off the critical path:
//   - a group of L lanes (the stream 8 or 16, the union 4) owns a query and
//     splits its H slots; each slot's values are read once from shared
//     memory into registers and all K influences are taken there, into K
//     register accumulators (the kernel points in registers), the count in
//     the same loop; the L partial sums merge by xor shuffles in a fixed
//     order, so every run gives the same bits. K = 15 (every shipped
//     configuration) has its own instances, any other K <= 16 a generic one;
//     a K > 16 walks the slots once a chunk of 16 kernel points (16
//     register accumulators, t1 rows of K padded to 16 in shared memory),
//     so any K computes, each kernel point's sum in the same order;
//   - a slot whose flag and feature are both 0 adds exactly 0: skipped;
//   - |off - kp_k| is sqrt.approx, 1 - d / sigma one fma with 1 / sigma
//     taken once, its clamp a saturate: local intrinsics, not a fast-math
//     flag (NVCC_FLAGS builds every library); tests/
//     test_torch_input_conv_order.py holds that arithmetic within
//     chip_smoke.py's tolerance of float64;
//   - stream: persistent blocks (two an SM) walk tiles of 256 / L queries;
//     a tile's five planes are five bulk copies (cp.async.bulk, one thread,
//     completion counted on an mbarrier) in a two-stage ring, the next tile
//     in flight while this one computes
//     (4-byte cp.async where M H % 4 != 0 leaves the planes unaligned).
//     Rows keep the planes' layout, unpadded, since a bulk copy is
//     contiguous: a warp's reads of its 32 / L queries conflict at most
//     2-way in the banks, beside ~170 instructions each slot's values feed.
//     L is 8 where two blocks fit an SM and the 32-query tiles cover the
//     SMs (3DMatch, KITTI), else 16 (ModelNet's ~1.5k queries); 4 lanes
//     (64-query tiles) ran no faster on 3DMatch;
//   - union: a block takes 64 queries of a union tile (L = 4): its sel rows
//     (at an odd stride) by cp.async while its threads gather the tile's
//     union as float4 (x, y, z, feat; the flag is feat > 0), a zero entry
//     at U for the sentinel; each lane reads its query point once;
//   - the epilogue: t1 and the count in shared memory, W staged once a
//     block, warps over query rows with lanes over D and their W columns in
//     registers, so that a warp stores whole rows; t1 and the count go out
//     only when asked, coalesced.
//
// For training the conv also writes the per-query count divisor and, with
// the pool, the number of columns tied at the max: the residuals of the
// inverse-table backward (kpconv_bwd.cu), which cannot recompute a
// query-side quantity from its support-side view. At c_in == 1 the workspace
// T is t1 = sum_h infl * feat (M, K), the input conv's weight-gradient
// residual. The stream conv writes its t1 and count, all its weight gradient
// needs.
//
// The bfloat16 point (PrecisionConfig.kpconv_mxu; the JAX kernels round
// t1 and W at geotransformer_tpu/kernels/kpconv.py:1123-1127 and
// :1667-1671, and at C_in > 1 the influences and features, :269-273):
// kpconv_conv_launch takes the edge pass's and the C_in = 1 product's
// rounding instances (kpconv_common.cuh); the input convs' edge body is
// unchanged (t1 stays f32, as the JAX t1 does), and the epilogue of their
// RB instances writes the unrounded t1 residual first, then rounds t1 in
// shared memory and each W value as it loads it, and sums the exact
// products in the same order. An instance of its own (a flag read at run
// time measured 2-4 % slower on the float32 point's 3DMatch calls).
//
// Geometry is exact f32 but for the input convs' sqrt.approx (above):
// offsets by direct subtraction, |off - kp_k| by a direct sqrt (the
// expanded |off|^2 - 2 off.kp + |kp|^2 form of the TPU kernel was a
// workaround for the MXU's single bf16 pass). A query whose
// mask is off sees only shadow neighbours: output 0, count 1, pool 0 —
// what the TPU kernel writes on skipped tiles. A tile of the contraction
// whose queries have no edge writes zeros and reads nothing (the valid-tile
// skip).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "kpconv_common.cuh"
#include "launch_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;         // kernel points in registers at a time
constexpr int kT1Stride = kChunk;  // t1 rows in shared memory: K padded to 16 (float4 reads)
constexpr int kUnionQueries = 64;  // queries a union block (L = 4)
constexpr float kFarAway = 1e18f;  // kernel points beyond K: influence 0, d^2 still finite

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A tile's planes by the Tensor Memory Accelerator: one thread asks for
// each plane's rows as one contiguous bulk copy, whose bytes complete a
// transaction count on an mbarrier in shared memory that the block waits on.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(shared_address(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   shared_address(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(shared_address(dst)),
      "l"(src), "r"(bytes), "r"(shared_address(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(shared_address(bar)),
      "r"(parity)
      : "memory");
}

// The kernel points in registers; those from K to KP (a generic instance)
// far away, so that their influence is 0.
template <int KP>
struct KernelPoints {
  float x[KP], y[KP], z[KP];

  __device__ __forceinline__ void load(const float* __restrict__ kp, int K) {
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      x[k] = k < K ? __ldg(kp + 3 * k + 0) : kFarAway;
      y[k] = k < K ? __ldg(kp + 3 * k + 1) : kFarAway;
      z[k] = k < K ? __ldg(kp + 3 * k + 2) : kFarAway;
    }
  }
};

// One edge of a query: offset o = s - q, flag (its count term) and feature.
// acc[k] += max(0, 1 - |o - kp_k| / sigma) * feat, cnt += flag; a slot whose
// flag and feature are both 0 adds exactly 0 and is skipped.
template <int KP>
__device__ __forceinline__ void add_edge(float ox, float oy, float oz, float flag, float feat,
                                         const KernelPoints<KP>& kp, float inv_sigma,
                                         float (&acc)[KP], float& cnt) {
  if (flag == 0.0f && feat == 0.0f) return;
  cnt += flag;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const float dx = ox - kp.x[k];
    const float dy = oy - kp.y[k];
    const float dz = oz - kp.z[k];
    const float d = sqrt_approx(fmaf(dz, dz, fmaf(dy, dy, dx * dx)));
    // 1 - d / sigma <= 1, so clamping to [0, 1] is max(0, .): one FFMA.SAT
    acc[k] = fmaf(__saturatef(fmaf(-d, inv_sigma, 1.0f)), feat, acc[k]);
  }
}

// The L lanes of a query's group (L consecutive lanes) add their partial
// sums by xor butterflies: every lane of the group ends with the same bits.
template <int KP, int L>
__device__ __forceinline__ void merge_lanes(float (&acc)[KP], float& cnt) {
#pragma unroll
  for (int offset = 1; offset < L; offset <<= 1) {
#pragma unroll
    for (int k = 0; k < KP; ++k) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], offset);
    cnt += __shfl_xor_sync(0xffffffffu, cnt, offset);
  }
}

// A group's first lane puts its query's t1 row (t1 rows `stride` floats
// apart) and divisor in shared memory.
template <int KP, int L>
__device__ __forceinline__ void keep_query(const float (&acc)[KP], float cnt, int ql, int rows,
                                           float* t1_s, float* cnt_s, int stride = kT1Stride) {
  if (threadIdx.x % L != 0 || ql >= rows) return;
#pragma unroll
  for (int k = 0; k < KP; ++k) t1_s[ql * stride + k] = acc[k];
  cnt_s[ql] = fmaxf(cnt, 1.0f);
}

// t1 rows in shared memory: K padded to 16, one chunk of 16 kernel points
// after another where K > 16
__host__ __device__ __forceinline__ int t1_stride(int K) {
  return K <= kChunk ? kT1Stride : (K + kChunk - 1) / kChunk * kChunk;
}

// t1 and the count of the tile's rows, coalesced, where asked.
__device__ __forceinline__ void write_residuals(const float* t1_s, const float* cnt_s,
                                                float* __restrict__ t1_out,
                                                float* __restrict__ count_out, int q0, int rows,
                                                int K, int stride) {
  if (t1_out != nullptr) {
    for (int i = threadIdx.x; i < rows * K; i += kThreads) {
      const int r = i / K;
      t1_out[static_cast<size_t>(q0) * K + i] = t1_s[r * stride + (i - r * K)];
    }
  }
  if (count_out != nullptr) {
    for (int i = threadIdx.x; i < rows; i += kThreads) count_out[q0 + i] = cnt_s[i];
  }
}

// The bfloat16 point's epilogue prologue (after a barrier): the unrounded
// t1 and the count out, then t1 rounded in shared memory for the product.
__device__ __forceinline__ void round_t1(float* t1_s, const float* cnt_s,
                                         float* __restrict__ t1_out,
                                         float* __restrict__ count_out, int q0, int rows, int K,
                                         int stride) {
  write_residuals(t1_s, cnt_s, t1_out, count_out, q0, rows, K, stride);
  __syncthreads();  // t1 read out before it is rounded
  for (int i = threadIdx.x; i < rows * stride; i += kThreads) t1_s[i] = round_bf16(t1_s[i]);
  __syncthreads();
}

template <bool RB>
__device__ __forceinline__ float maybe_round(float x) {
  if constexpr (RB) return round_bf16(x);
  return x;
}

// out[q0 + r, :] = t1[r, :] W * (1 / count[r]) for the tile's rows (after a
// barrier): each warp takes rows, its lanes columns d and d + 32 with their
// W columns in registers (one warp-wide store of whole rows at D = 64);
// then t1 and the count when asked, coalesced. RB: t1 and W rounded to
// bfloat16 first (round_t1; t1 and the count go out unrounded before it).
template <int KP, bool RB>
__device__ __forceinline__ void write_outputs(float* t1_s, const float* cnt_s,
                                              const float* w_s, float* __restrict__ out,
                                              float* __restrict__ t1_out,
                                              float* __restrict__ count_out, int q0, int rows,
                                              int K, int D) {
  if constexpr (RB) round_t1(t1_s, cnt_s, t1_out, count_out, q0, rows, K, kT1Stride);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int d0 = lane; d0 < D; d0 += 64) {
    const int d1 = d0 + 32;
    float w0[KP], w1[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      w0[k] = k < K ? maybe_round<RB>(w_s[k * D + d0]) : 0.0f;
      w1[k] = k < K && d1 < D ? maybe_round<RB>(w_s[k * D + d1]) : 0.0f;
    }
    for (int r = warp; r < rows; r += kWarps) {
      const float4* t4 = reinterpret_cast<const float4*>(t1_s + r * kT1Stride);
      float a0 = 0.0f;
      float a1 = 0.0f;
#pragma unroll
      for (int k4 = 0; k4 < (KP + 3) / 4; ++k4) {
        const float4 v = t4[k4];
        const float t[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (4 * k4 + j < KP) {
            a0 = fmaf(t[j], w0[4 * k4 + j], a0);
            a1 = fmaf(t[j], w1[4 * k4 + j], a1);
          }
        }
      }
      const float inv_count = 1.0f / cnt_s[r];
      float* row = out + static_cast<size_t>(q0 + r) * D;
      row[d0] = a0 * inv_count;
      if (d1 < D) row[d1] = a1 * inv_count;
    }
  }
  if constexpr (!RB) write_residuals(t1_s, cnt_s, t1_out, count_out, q0, rows, K, kT1Stride);
}

// write_outputs for K > 16 (t1 rows `stride` floats apart): the same sums
// over k in the same order, W read from shared memory at each k.
template <bool RB>
__device__ __forceinline__ void write_outputs_chunked(float* t1_s, const float* cnt_s,
                                                      const float* w_s, float* __restrict__ out,
                                                      float* __restrict__ t1_out,
                                                      float* __restrict__ count_out, int q0,
                                                      int rows, int K, int D, int stride) {
  if constexpr (RB) round_t1(t1_s, cnt_s, t1_out, count_out, q0, rows, K, stride);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int d0 = lane; d0 < D; d0 += 64) {
    const int d1 = d0 + 32;
    for (int r = warp; r < rows; r += kWarps) {
      const float* t = t1_s + r * stride;
      float a0 = 0.0f;
      float a1 = 0.0f;
      for (int k = 0; k < K; ++k) {
        a0 = fmaf(t[k], maybe_round<RB>(w_s[k * D + d0]), a0);
        if (d1 < D) a1 = fmaf(t[k], maybe_round<RB>(w_s[k * D + d1]), a1);
      }
      const float inv_count = 1.0f / cnt_s[r];
      float* row = out + static_cast<size_t>(q0 + r) * D;
      row[d0] = a0 * inv_count;
      if (d1 < D) row[d1] = a1 * inv_count;
    }
  }
  if constexpr (!RB) write_residuals(t1_s, cnt_s, t1_out, count_out, q0, rows, K, stride);
}

__device__ __forceinline__ void stage_weights(const float* __restrict__ w, float* w_s, int K,
                                              int D) {
  for (int i = threadIdx.x; i < K * D; i += kThreads) w_s[i] = __ldg(w + i);
}

// Copies rows [q0, q0 + rows) of `planes` (P planes of (M, H), contiguous)
// into dst (P, Q, hs) by 4-byte cp.async, one element a thread at a time.
template <int P, int Q, typename T>
__device__ __forceinline__ void copy_rows(const T* __restrict__ planes, T* dst, int M, int H,
                                          int hs, int q0, int rows) {
  static_assert(sizeof(T) == 4, "4-byte elements");
  const int n = rows * H;
  const int dq = kThreads / H;
  const int dh = kThreads - dq * H;
  int q = threadIdx.x / H;
  int h = threadIdx.x - q * H;
  for (int i = threadIdx.x; i < n; i += kThreads) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      cp_async4(reinterpret_cast<float*>(dst + (p * Q + q) * hs + h),
                reinterpret_cast<const float*>(planes + static_cast<size_t>(p) * M * H +
                                               static_cast<size_t>(q0) * H + i),
                true);
    }
    h += dh;
    q += dq;
    if (h >= H) {
      h -= H;
      ++q;
    }
  }
}

// floats of a stream block's shared memory: the two-stage ring of (5, Q, H)
// planes, W (K D, padded to 4), t1 (Q, 16) and the divisors (then the two
// stages' mbarriers)
inline size_t stream_smem_floats(int Q, int H, int K, int D) {
  return 2 * 5 * static_cast<size_t>(Q) * H + ((static_cast<size_t>(K) * D + 3) / 4 * 4) +
         static_cast<size_t>(Q) * t1_stride(K) + (Q + 3) / 4 * 4 + 4;
}

// Edge-stream input conv: persistent blocks walk tiles of Q = 256 / L
// queries; lanes [L ql, L ql + L) own query ql of a tile. `bulk`: the planes
// and their tiles start at multiples of 16 bytes (M H % 4 == 0), so a
// tile's plane is one bulk copy; else 4-byte cp.async, an element a thread.
// CHUNKED (K > 16, KP = 16): each tile walks its slots once a chunk of 16
// kernel points, their accumulators in registers, the next chunk's kernel
// points loaded in its turn; each kernel point's sum is the same as with
// all K in registers.
template <int KP, int L, bool CHUNKED, bool RB>
__global__ void __launch_bounds__(kThreads, 2) kpconv_stream_kernel(
    const float* __restrict__ stream,  // (5, M, H): off xyz, posflag, feat
    const float* __restrict__ kp,      // (K, 3)
    const float* __restrict__ w,       // (K, 1, D)
    float* __restrict__ out,           // (M, D)
    float* __restrict__ t1_out,        // (M, K) or null
    float* __restrict__ count_out,     // (M,) or null
    int M, int H, int K, int D, float sigma, bool bulk) {
  constexpr int Q = kThreads / L;
  const int stage = 5 * Q * H;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                     // (2, 5, Q, H)
  float* w_s = ring + 2 * stage;                          // (K, D)
  const int t1s = CHUNKED ? t1_stride(K) : kT1Stride;
  float* t1_s = w_s + (K * D + 3) / 4 * 4;                // (Q, t1s)
  float* cnt_s = t1_s + Q * t1s;                          // (Q,)
  uint64_t* bars = reinterpret_cast<uint64_t*>(cnt_s + (Q + 3) / 4 * 4);  // (2,)

  const int tiles = (M + Q - 1) / Q;
  // the copy of tile t's planes into stage s
  auto fetch = [&](int t, int s) {
    const int q0 = t * Q;
    const int rows = min(Q, M - q0);
    float* dst = ring + s * stage;
    if (!bulk) {
      copy_rows<5, Q>(stream, dst, M, H, H, q0, rows);
    } else if (threadIdx.x == 0) {
      const uint32_t bytes = static_cast<uint32_t>(rows * H) * sizeof(float);
      mbar_expect_bytes(bars + s, 5 * bytes);
      for (int p = 0; p < 5; ++p) {
        bulk_copy(dst + p * Q * H, stream + static_cast<size_t>(p) * M * H +
                                       static_cast<size_t>(q0) * H,
                  bytes, bars + s);
      }
    }
    cp_async_commit();
  };
  if (bulk && threadIdx.x == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int tile = blockIdx.x;
  fetch(tile, 0);
  stage_weights(w, w_s, K, D);
  KernelPoints<KP> kpr;
  if constexpr (!CHUNKED) kpr.load(kp, K);
  const float inv_sigma = 1.0f / sigma;
  const int ql = threadIdx.x / L;
  const int chunks = CHUNKED ? (K + kChunk - 1) / kChunk : 1;

  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < tiles) {
      fetch(next, (it + 1) & 1);
    } else {
      cp_async_commit();
    }
    if (bulk) {
      mbar_wait(bars + (it & 1), (it >> 1) & 1);
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();

    const int q0 = tile * Q;
    const int rows = min(Q, M - q0);
    const float* st = ring + (it & 1) * stage + ql * H;
    for (int c = 0; c < chunks; ++c) {
      if constexpr (CHUNKED) kpr.load(kp + 3 * kChunk * c, K - kChunk * c);
      float acc[KP];
#pragma unroll
      for (int k = 0; k < KP; ++k) acc[k] = 0.0f;
      float cnt = 0.0f;
      if (ql < rows) {
        for (int h = threadIdx.x % L; h < H; h += L) {
          add_edge(st[h], st[Q * H + h], st[2 * Q * H + h], st[3 * Q * H + h],
                   st[4 * Q * H + h], kpr, inv_sigma, acc, cnt);
        }
      }
      merge_lanes<KP, L>(acc, cnt);
      keep_query<KP, L>(acc, cnt, ql, rows, t1_s + kChunk * c, cnt_s, t1s);
    }
    __syncthreads();
    if constexpr (CHUNKED) {
      write_outputs_chunked<RB>(t1_s, cnt_s, w_s, out, t1_out, count_out, q0, rows, K, D, t1s);
    } else {
      write_outputs<KP, RB>(t1_s, cnt_s, w_s, out, t1_out, count_out, q0, rows, K, D);
    }
  }
  cp_async_wait<0>();
}

// floats of a union block's shared memory: the union as float4 (U + 1
// entries, the last the sentinel's zeros), the block's sel rows (Q, hs),
// W, t1 and the divisors
inline size_t union_smem_floats(int U, int hs, int K, int D) {
  return 4 * (static_cast<size_t>(U) + 1) + static_cast<size_t>(kUnionQueries) * hs +
         ((static_cast<size_t>(K) * D + 3) / 4 * 4) +
         static_cast<size_t>(kUnionQueries) * t1_stride(K) + kUnionQueries;
}

// Union-gather input conv: block b takes queries [q0, q0 + 64) of union
// tile b / sub (sub = ceil(tile / 64) blocks a tile); lanes [4 ql, 4 ql + 4)
// own query ql. CHUNKED: K > 16, as the stream kernel's.
template <int KP, bool CHUNKED, bool RB>
__global__ void __launch_bounds__(kThreads, 2) kpconv_union_kernel(
    const float* __restrict__ s_feats,    // (N,) the c_in == 1 features
    const float* __restrict__ s_points,   // (N, 3)
    const float* __restrict__ q_points,   // (M, 3)
    const int32_t* __restrict__ rows,     // (T, U), sentinel N
    const int32_t* __restrict__ sel,      // (M, H), sentinel U
    const float* __restrict__ kp,         // (K, 3)
    const float* __restrict__ w,          // (K, 1, D)
    float* __restrict__ out,              // (M, D)
    float* __restrict__ count_out,        // (M,) or null
    float* __restrict__ t1_out,           // (M, K) or null
    int M, int N, int U, int H, int K, int D, int tile, int sub, float sigma) {
  constexpr int L = kThreads / kUnionQueries;
  const int t = blockIdx.x / sub;
  const int q0 = t * tile + (blockIdx.x - t * sub) * kUnionQueries;
  const int rows_here = min(min(kUnionQueries, (t + 1) * tile - q0), M - q0);
  if (rows_here <= 0) return;
  const int hs = H | 1;
  extern __shared__ __align__(16) float smem[];
  // every part starts at a multiple of 4 floats: t1_s is read as float4
  float4* un = reinterpret_cast<float4*>(smem);                       // (U + 1,)
  int32_t* sel_s = reinterpret_cast<int32_t*>(smem + 4 * (U + 1));   // (Q, hs)
  float* w_s = smem + 4 * (U + 1) + kUnionQueries * hs;               // (K, D)
  const int t1s = CHUNKED ? t1_stride(K) : kT1Stride;
  float* t1_s = w_s + (K * D + 3) / 4 * 4;                            // (Q, t1s)
  float* cnt_s = t1_s + kUnionQueries * t1s;                          // (Q,)

  copy_rows<1, kUnionQueries>(sel, sel_s, M, H, hs, q0, rows_here);
  cp_async_commit();
  for (int u = threadIdx.x; u <= U; u += kThreads) {
    const int n = u < U ? __ldg(rows + static_cast<size_t>(t) * U + u) : N;
    float4 e = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (n >= 0 && n < N) {
      e.x = __ldg(s_points + 3 * static_cast<size_t>(n) + 0);
      e.y = __ldg(s_points + 3 * static_cast<size_t>(n) + 1);
      e.z = __ldg(s_points + 3 * static_cast<size_t>(n) + 2);
      e.w = __ldg(s_feats + n);
    }
    un[u] = e;
  }
  stage_weights(w, w_s, K, D);
  KernelPoints<KP> kpr;
  kpr.load(kp, K);  // (the first chunk of 16 where CHUNKED)
  const float inv_sigma = 1.0f / sigma;
  const int ql = threadIdx.x / L;
  cp_async_wait<0>();
  __syncthreads();

  const int chunks = CHUNKED ? (K + kChunk - 1) / kChunk : 1;
  for (int c = 0; c < chunks; ++c) {
    if constexpr (CHUNKED) {
      if (c > 0) kpr.load(kp + 3 * kChunk * c, K - kChunk * c);
    }
    float acc[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) acc[k] = 0.0f;
    float cnt = 0.0f;
    if (ql < rows_here) {
      const size_t q = static_cast<size_t>(q0 + ql);
      const float qx = __ldg(q_points + 3 * q + 0);
      const float qy = __ldg(q_points + 3 * q + 1);
      const float qz = __ldg(q_points + 3 * q + 2);
      for (int h = threadIdx.x % L; h < H; h += L) {
        int u = sel_s[ql * hs + h];
        u = (u >= 0 && u < U) ? u : U;
        const float4 e = un[u];
        // (s - q) - kp_k: the offset first, as every KPConv of the port
        add_edge(e.x - qx, e.y - qy, e.z - qz, e.w > 0.0f ? 1.0f : 0.0f, e.w, kpr, inv_sigma,
                 acc, cnt);
      }
    }
    merge_lanes<KP, L>(acc, cnt);
    keep_query<KP, L>(acc, cnt, ql, rows_here, t1_s + kChunk * c, cnt_s, t1s);
  }
  __syncthreads();
  if constexpr (CHUNKED) {
    write_outputs_chunked<RB>(t1_s, cnt_s, w_s, out, t1_out, count_out, q0, rows_here, K, D,
                              t1s);
  } else {
    write_outputs<KP, RB>(t1_s, cnt_s, w_s, out, t1_out, count_out, q0, rows_here, K, D);
  }
}

// The general route of both input convs (kernels/kpconv.py:stream_route,
// union_route): where a stream block's ring of (5, Q, H) planes and W, or a
// union block's staged union, sel rows and W, would not fit a block's
// shared memory (tables of hundreds of columns, unions of ~13,000 rows,
// K D past ~56,000: shapes no shipped configuration has, which the JAX
// kernels take), nothing is staged but t1 and the divisors: each slot's
// values are read from device memory through L1 as they are needed, W in
// the epilogue too. A block takes one tile of Q = 256 / L queries (the
// stream L = 16, the union 4, 64 queries of a union tile); the edge body,
// the lane split of the slots, the merge and the epilogue are the staged
// kernels', so each kernel point's sum runs over the same slots in the same
// order. Simple and correct, not tuned.
constexpr int kGlobalStreamLanes = 16;

inline size_t global_smem_floats(int Q, int K) {
  return static_cast<size_t>(Q) * t1_stride(K) + Q;
}

template <int KP, bool CHUNKED, bool RB>
__global__ void __launch_bounds__(kThreads) kpconv_stream_global_kernel(
    const float* __restrict__ stream,  // (5, M, H): off xyz, posflag, feat
    const float* __restrict__ kp,      // (K, 3)
    const float* __restrict__ w,       // (K, 1, D)
    float* __restrict__ out,           // (M, D)
    float* __restrict__ t1_out,        // (M, K) or null
    float* __restrict__ count_out,     // (M,) or null
    int M, int H, int K, int D, float sigma) {
  constexpr int L = kGlobalStreamLanes;
  constexpr int Q = kThreads / L;
  extern __shared__ __align__(16) float smem[];
  const int t1s = CHUNKED ? t1_stride(K) : kT1Stride;
  float* t1_s = smem;            // (Q, t1s)
  float* cnt_s = t1_s + Q * t1s;  // (Q,)
  const int q0 = blockIdx.x * Q;
  const int rows = min(Q, M - q0);
  const int ql = threadIdx.x / L;
  const size_t plane = static_cast<size_t>(M) * H;
  const float* st = stream + static_cast<size_t>(q0 + ql) * H;  // read where ql < rows
  KernelPoints<KP> kpr;
  if constexpr (!CHUNKED) kpr.load(kp, K);
  const float inv_sigma = 1.0f / sigma;
  const int chunks = CHUNKED ? (K + kChunk - 1) / kChunk : 1;
  for (int c = 0; c < chunks; ++c) {
    if constexpr (CHUNKED) kpr.load(kp + 3 * kChunk * c, K - kChunk * c);
    float acc[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) acc[k] = 0.0f;
    float cnt = 0.0f;
    if (ql < rows) {
      for (int h = threadIdx.x % L; h < H; h += L) {
        add_edge(__ldg(st + h), __ldg(st + plane + h), __ldg(st + 2 * plane + h),
                 __ldg(st + 3 * plane + h), __ldg(st + 4 * plane + h), kpr, inv_sigma, acc, cnt);
      }
    }
    merge_lanes<KP, L>(acc, cnt);
    keep_query<KP, L>(acc, cnt, ql, rows, t1_s + kChunk * c, cnt_s, t1s);
  }
  __syncthreads();
  if constexpr (CHUNKED) {
    write_outputs_chunked<RB>(t1_s, cnt_s, w, out, t1_out, count_out, q0, rows, K, D, t1s);
  } else {
    write_outputs<KP, RB>(t1_s, cnt_s, w, out, t1_out, count_out, q0, rows, K, D);
  }
}

template <int KP, bool CHUNKED, bool RB>
__global__ void __launch_bounds__(kThreads) kpconv_union_global_kernel(
    const float* __restrict__ s_feats,    // (N,) the c_in == 1 features
    const float* __restrict__ s_points,   // (N, 3)
    const float* __restrict__ q_points,   // (M, 3)
    const int32_t* __restrict__ rows,     // (T, U), sentinel N
    const int32_t* __restrict__ sel,      // (M, H), sentinel U
    const float* __restrict__ kp,         // (K, 3)
    const float* __restrict__ w,          // (K, 1, D)
    float* __restrict__ out,              // (M, D)
    float* __restrict__ count_out,        // (M,) or null
    float* __restrict__ t1_out,           // (M, K) or null
    int M, int N, int U, int H, int K, int D, int tile, int sub, float sigma) {
  constexpr int L = kThreads / kUnionQueries;
  const int t = blockIdx.x / sub;
  const int q0 = t * tile + (blockIdx.x - t * sub) * kUnionQueries;
  const int rows_here = min(min(kUnionQueries, (t + 1) * tile - q0), M - q0);
  if (rows_here <= 0) return;
  extern __shared__ __align__(16) float smem[];
  const int t1s = CHUNKED ? t1_stride(K) : kT1Stride;
  float* t1_s = smem;                         // (Q, t1s)
  float* cnt_s = t1_s + kUnionQueries * t1s;  // (Q,)
  const int32_t* union_row = rows + static_cast<size_t>(t) * U;
  KernelPoints<KP> kpr;
  kpr.load(kp, K);  // (the first chunk of 16 where CHUNKED)
  const float inv_sigma = 1.0f / sigma;
  const int ql = threadIdx.x / L;
  const int chunks = CHUNKED ? (K + kChunk - 1) / kChunk : 1;
  for (int c = 0; c < chunks; ++c) {
    if constexpr (CHUNKED) {
      if (c > 0) kpr.load(kp + 3 * kChunk * c, K - kChunk * c);
    }
    float acc[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) acc[k] = 0.0f;
    float cnt = 0.0f;
    if (ql < rows_here) {
      const size_t q = static_cast<size_t>(q0 + ql);
      const float qx = __ldg(q_points + 3 * q + 0);
      const float qy = __ldg(q_points + 3 * q + 1);
      const float qz = __ldg(q_points + 3 * q + 2);
      for (int h = threadIdx.x % L; h < H; h += L) {
        // the union entry sel names, as the staged kernel's un[u]: zeros
        // for the sentinel and for a row outside [0, N)
        const int u = __ldg(sel + q * H + h);
        const int n = (u >= 0 && u < U) ? __ldg(union_row + u) : N;
        float4 e = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (n >= 0 && n < N) {
          e.x = __ldg(s_points + 3 * static_cast<size_t>(n) + 0);
          e.y = __ldg(s_points + 3 * static_cast<size_t>(n) + 1);
          e.z = __ldg(s_points + 3 * static_cast<size_t>(n) + 2);
          e.w = __ldg(s_feats + n);
        }
        add_edge(e.x - qx, e.y - qy, e.z - qz, e.w > 0.0f ? 1.0f : 0.0f, e.w, kpr, inv_sigma,
                 acc, cnt);
      }
    }
    merge_lanes<KP, L>(acc, cnt);
    keep_query<KP, L>(acc, cnt, ql, rows_here, t1_s + kChunk * c, cnt_s, t1s);
  }
  __syncthreads();
  if constexpr (CHUNKED) {
    write_outputs_chunked<RB>(t1_s, cnt_s, w, out, t1_out, count_out, q0, rows_here, K, D,
                              t1s);
  } else {
    write_outputs<KP, RB>(t1_s, cnt_s, w, out, t1_out, count_out, q0, rows_here, K, D);
  }
}

using launch_util::Limits;
using launch_util::allow_smem;
using launch_util::device_limits;

// variant: the instance (kernels/kpconv.py:input_conv_variant): 0 K = 15,
// 1 another K <= 16, 2 K > 16 in chunks of 16 kernel points.
bool variant_takes(int variant, int K) {
  return (variant == 0 && K == 15) || (variant == 1 && K >= 1 && K <= kChunk) ||
         (variant == 2 && K > kChunk);
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Floats of the split-K workspace of a conv's contraction (M x K C) (K C x
// D) (0: none); the wrapper allocates it for kpconv_conv_launch.
long long kpconv_conv_workspace(int M, int K, int C, int D) {
  return kpconv::contraction_workspace(M, D, K * C, kpconv::tensor_core_widths(C, D));
}

// One KPConv: the edge pass into the workspaces t_ws (M, K * C) and div_ws
// (M,), then the contraction into out (through part_ws, the split-K
// partial sums, where kpconv_conv_workspace asks for them). head (M, H1)
// sentinel N; tail (M2, H2) and tail_rank (M,) (sentinel M2) or null for a
// whole table; pool_head and pool_tail the pooled columns of the head and
// of a tail row; pool_chunk: the pooled columns the pool phase stages at a
// time (kernels/kpconv.py:pool_route); mxu_bf16: the bfloat16 point (the
// edge pass's rounding instance at C > 1, the rounding t1 W at C = 1);
// edge_*: the edge pass's route (kernels/kpconv.py:edge_route(K, C)). Any K
// and C, any pool width.
int kpconv_conv_launch(const float* s_feats, const float* q_points, const float* s_points,
                       const int32_t* head, const int32_t* tail, const int32_t* tail_rank,
                       const float* posflag, const float* kp, const float* w,
                       const uint8_t* q_mask, const float* pool_feats, float* t_ws,
                       float* div_ws, float* part_ws, float* out, float* pooled,
                       float* count_out, float* ties_out, int M, int N, int H1, int H2, int M2,
                       int K, int C, int D, int P, int pool_head, int pool_tail, int pool_chunk,
                       int mxu_bf16, int edge_v, int edge_tpr, int edge_tr, int edge_kp_chunks,
                       int edge_passes, float sigma, void* stream) {
  if (D < 1 || H1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kpconv::EdgeArgs e{};
  e.feats = s_feats;
  e.self_pts = q_points;
  e.other_pts = s_points;
  e.head = head;
  e.tail = tail;
  e.rank = tail_rank;
  e.mask = q_mask;
  e.kp = kp;
  e.t_out = t_ws;
  e.R = M;
  e.n_other = N;
  e.C = C;
  e.K = K;
  e.h1 = H1;
  e.h2 = H2;
  e.r2 = M2;
  e.sigma = sigma;
  kpconv::FwdExtras x{};
  x.posflag = posflag;
  x.div_out = div_ws;
  x.count_out = count_out;
  x.pool_feats = pool_feats;
  x.pooled = pool_feats != nullptr ? pooled : nullptr;
  x.ties = pool_feats != nullptr ? ties_out : nullptr;
  x.P = P;
  x.pool_head = pool_head;
  x.pool_tail = pool_tail;
  const int pool_width = pool_feats == nullptr ? 0
                         : min(pool_head, H1) + (tail != nullptr ? min(pool_tail, H2) : 0);
  const kpconv::EdgeRoute route{edge_v, edge_tpr, edge_tr, edge_kp_chunks, edge_passes};
  int err = kpconv::launch_edges<false>(e, x, pool_width, pool_chunk, route, st,
                                        mxu_bf16 != 0 && C > 1);
  if (err != 0) return err;
  kpconv::GemmArgs g{};
  g.a = t_ws;
  g.lda = K * C;
  g.b = w;
  g.ldb = D;
  g.c = out;
  g.ldc = D;
  g.div = div_ws;
  g.M = M;
  g.N = D;
  g.Kdim = K * C;
  g.k_per_z = K * C;
  return kpconv::launch_contraction(g, kpconv::tensor_core_widths(C, D), part_ws, st,
                                    mxu_bf16 != 0 && C == 1);
}

// staged: the route (kernels/kpconv.py:stream_route): 1 where a block of
// 16 queries stages its ring and W (every shipped configuration), 0 the
// general route, nothing staged; mxu_bf16: t1 and W rounded to bfloat16
// before t1 W.
int kpconv_stream_launch(const float* stream_planes, const float* kp,
                         const float* w, float* out, float* t1_out,
                         float* count_out, int M, int H, int K, int D,
                         int variant, int staged, int mxu_bf16, float sigma, void* stream) {
  if (!variant_takes(variant, K) || H < 1 || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Limits& limits = device_limits();
  // 8 lanes a query (32-query tiles), or 16 (16-query tiles) where the
  // 32-query tiles do not cover the SMs or two such blocks do not fit an SM
  // (1 KB of an SM's shared memory is reserved a block)
  auto smem_of = [&](int L) { return sizeof(float) * stream_smem_floats(kThreads / L, H, K, D); };
  if ((staged != 0) != (smem_of(16) <= static_cast<size_t>(limits.block_bytes))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  if (!staged) {
    constexpr int Q = kThreads / kGlobalStreamLanes;
    const size_t smem = sizeof(float) * global_smem_floats(Q, K);
    auto run = [&](auto kernel) {
      const cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      kernel<<<(M + Q - 1) / Q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          stream_planes, kp, w, out, t1_out, count_out, M, H, K, D, sigma);
      return static_cast<int>(cudaGetLastError());
    };
    auto pick = [&](auto rb) {
      constexpr bool RB = decltype(rb)::value;
      if (variant == 2) return run(kpconv_stream_global_kernel<16, true, RB>);
      return variant == 0 ? run(kpconv_stream_global_kernel<15, false, RB>)
                          : run(kpconv_stream_global_kernel<16, false, RB>);
    };
    return mxu_bf16 ? pick(std::true_type{}) : pick(std::false_type{});
  }
  const bool wide = 2 * (smem_of(8) + 1024) <= static_cast<size_t>(limits.sm_bytes) &&
                    (M + kThreads / 8 - 1) / (kThreads / 8) >= limits.sms;
  const int L = wide ? 8 : 16;
  const size_t smem = smem_of(L);
  // persistent blocks, two an SM (__launch_bounds__(kThreads, 2))
  const int tiles = (M + kThreads / L - 1) / (kThreads / L);
  const int blocks = min(tiles, 2 * limits.sms);
  const bool bulk = reinterpret_cast<uintptr_t>(stream_planes) % 16 == 0 &&
                    static_cast<long long>(M) * H % 4 == 0;
  auto run = [&](auto kernel) {
    const cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        stream_planes, kp, w, out, t1_out, count_out, M, H, K, D, sigma, bulk);
    return static_cast<int>(cudaGetLastError());
  };
  // the instance: RB where mxu_bf16 (the bfloat16 point's epilogue)
  auto pick = [&](auto rb) {
    constexpr bool RB = decltype(rb)::value;
    if (variant == 2) {
      return wide ? run(kpconv_stream_kernel<16, 8, true, RB>)
                  : run(kpconv_stream_kernel<16, 16, true, RB>);
    }
    const bool k15 = variant == 0;  // every configuration's kernel size
    if (wide) {
      return k15 ? run(kpconv_stream_kernel<15, 8, false, RB>)
                 : run(kpconv_stream_kernel<16, 8, false, RB>);
    }
    return k15 ? run(kpconv_stream_kernel<15, 16, false, RB>)
               : run(kpconv_stream_kernel<16, 16, false, RB>);
  };
  return mxu_bf16 ? pick(std::true_type{}) : pick(std::false_type{});
}

// staged: the route (kernels/kpconv.py:union_route): 1 where a block stages
// the tile's union, its sel rows and W (every shipped configuration), 0
// the general route, nothing staged; mxu_bf16: t1 and W rounded to bfloat16
// before t1 W.
int kpconv_union_launch(const float* s_feats, const float* s_points, const float* q_points,
                        const int32_t* rows, const int32_t* sel, const float* kp,
                        const float* w, float* out, float* count_out, float* t1_out, int M,
                        int N, int U, int H, int K, int D, int tile, int variant, int staged,
                        int mxu_bf16, float sigma, void* stream) {
  if (!variant_takes(variant, K) || H < 1 || D < 1 || U < 1 || tile < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Limits& limits = device_limits();
  const size_t staged_smem = sizeof(float) * union_smem_floats(U, H | 1, K, D);
  if ((staged != 0) != (staged_smem <= static_cast<size_t>(limits.block_bytes))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  const size_t smem = staged ? staged_smem : sizeof(float) * global_smem_floats(kUnionQueries, K);
  const int sub = (tile + kUnionQueries - 1) / kUnionQueries;
  const long long blocks = static_cast<long long>((M + tile - 1) / tile) * sub;
  auto run = [&](auto kernel) {
    const cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<static_cast<unsigned>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        s_feats, s_points, q_points, rows, sel, kp, w, out, count_out, t1_out, M, N, U, H, K, D,
        tile, sub, sigma);
    return static_cast<int>(cudaGetLastError());
  };
  // the instance: RB where mxu_bf16 (the bfloat16 point's epilogue)
  auto pick = [&](auto rb) {
    constexpr bool RB = decltype(rb)::value;
    if (!staged) {
      if (variant == 2) return run(kpconv_union_global_kernel<16, true, RB>);
      return variant == 0 ? run(kpconv_union_global_kernel<15, false, RB>)
                          : run(kpconv_union_global_kernel<16, false, RB>);
    }
    if (variant == 2) return run(kpconv_union_kernel<16, true, RB>);
    return variant == 0 ? run(kpconv_union_kernel<15, false, RB>)
                        : run(kpconv_union_kernel<16, false, RB>);
  };
  return mxu_bf16 ? pick(std::true_type{}) : pick(std::false_type{});
}

}  // extern "C"
