// The on-device pyramid build's two hot loops for Hopper (sm_90a), f32 and
// int32 on the CUDA cores.
//
// Neither replaces a Pallas kernel: they replace the XLA loops of
// geotransformer_tpu/preprocess/device.py that its HONEST COST note
// (:29-36) names as the build's cost, the per-query candidate gathers and
// the exact (d^2, index) sorts of the radius search, and the segment mean
// of the voxel subsample. What surrounds them (the voxel keys and their
// sort, the cell sort, the CSR starts, the pair frame, the inverse tables)
// stays PyTorch operations in preprocess/device.py, as the JAX package
// leaves it to XLA.
//
// grid_radius_search (device.py:_radius_search_cloud_grid :180-335 and,
// with brute = 1, _radius_search_cloud :110-177). One warp a query row of B
// clouds at once. The warp's first nine lanes look up the query's nine
// x-runs of the cell-sorted support (dz outer, dy inner, as :270-290), a
// shuffle scan places them, and the warp walks the runs' first cand_cap
// slots (brute: the n_s valid support rows), 32 slots a step. Each lane
// takes d^2 = dx dx + dy dy + dz dz from the direct coordinate difference,
// each product and sum rounded on its own (__fmul_rn / __fadd_rn: nvcc
// would contract to FMA, and the host and the JAX grid path round term by
// term, device.py:313-316), and a slot within the radius goes, by ballot,
// into the warp's shared list as one 64-bit key: the bits of d^2 (>= 0, so
// ordered as an unsigned int) above the original index, which orders the
// list lexicographically by (d^2, index) as the host's pair sort does. A
// lane then ranks four keys at a time against the whole list (the keys are
// distinct: the indices are) and writes each key of rank < K to its slot;
// slots past the list take the sentinel Cs, and so does every slot of a
// query row at or past the cloud's valid count. Each query's 27-cell
// population (the runs' total before the cand_cap cut) goes to counts, from
// which the caller raises the candidate-overflow flag. Past the key list a
// block's shared memory holds (more than ~29,000 candidates a query; the
// JAX XLA search has no such limit), the general route
// (kernels/pyramid.py:search_route, CHUNKED) fills the list a chunk of
// kSearchChunk keys at a time and merges each full chunk into the query's
// K best so far (merge_best: in a workspace in device memory, two buffers
// of K keys a query row); once K are held, a slot whose key is not below
// the K-th best cannot enter and is dropped at once. The keys are distinct,
// so the K best are the same keys in the same order as with one list: the
// same table, bit for bit.
//
// voxel_segment_mean (device.py:_subsample_cloud :98-107). Over points
// already sorted by voxel key, the thread of a voxel's first row sums the
// voxel's rows in sorted order and divides by their count, so the result is
// the same from run to run (a float atomic add would not be); rows past the
// voxel count take PAD_COORD.
//
// What bounds them on an H100 (chip_smoke.py's cost_grid_radius_search and
// cost_voxel_segment_mean): the bytes. Each search reads the queries, the
// sorted support with its indices and the (G + 1)-entry CSR starts of each
// cloud (4 MB a cloud at G = 2^20), and writes the (Cq, K) table: ~10-20 MB
// at 3DMatch's stage 0, ~5 us at 3.35 TB/s; the work is ~8 operations a
// candidate slot (~10^7 slots, ~1.3 us at 67 TFLOP/s) plus the ranking. The
// kernel is the simple one: a warp a query and a quadratic ranking leave
// lanes idle where a query has few candidates, and it reads the starts by
// gathers.

#include <cuda_runtime.h>

#include <cstdint>

#include "launch_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRankTile = 4;  // keys a lane ranks at a time

__device__ __forceinline__ float sq_dist(float ax, float ay, float az, float bx, float by,
                                         float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// floor((p - origin) / edge) as int32, each step rounded as the plain version's
__device__ __forceinline__ int cell_of(float p, float origin, float edge) {
  return __float2int_rd(__fdiv_rn(__fsub_rn(p, origin), edge));
}

__device__ __forceinline__ int clip(int x, int lo, int hi) { return min(max(x, lo), hi); }

// int32 products and sums that wrap as the plain version's int32 tensors do
__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

constexpr int kSearchChunk = 1024;  // keys a warp's list holds on the general route

// The K smallest of the nb carried keys `best` (sorted) and the list's n
// keys, sorted into `next`; returns their count. The keys are distinct, so
// a key's rank is the number of keys below it: its carried rank (a binary
// search, or its position) plus the list's keys below it.
__device__ int merge_best(const unsigned long long* best, int nb, const unsigned long long* keys,
                          int n, unsigned long long* next, int K, int lane) {
  __syncwarp();  // the list is written
  for (int i = lane; i < n; i += 32) {
    const unsigned long long key = keys[i];
    int lo = 0, hi = nb;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (best[mid] < key) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int rank = lo;
    for (int j = 0; j < n && rank < K; ++j) rank += keys[j] < key;
    if (rank < K) next[rank] = key;
  }
  for (int i = lane; i < nb; i += 32) {
    const unsigned long long key = best[i];
    int rank = i;
    for (int j = 0; j < n && rank < K; ++j) rank += keys[j] < key;
    if (rank < K) next[rank] = key;
  }
  __syncwarp();  // next is written and the list read
  return min(K, nb + n);
}

template <bool CHUNKED>
__global__ void grid_search_kernel(
    const float* __restrict__ queries,   // (B, Cq, 3)
    const int* __restrict__ q_lengths,   // (B,)
    const float4* __restrict__ support,  // (B, Cs): x, y, z, original index (exact as f32)
    const int* __restrict__ s_lengths,   // (B,)
    const int* __restrict__ starts,      // (B, G + 1) CSR starts of the cell-sorted support
    const float* __restrict__ origin,    // (B, 3)
    const int* __restrict__ dims,        // (B, 3)
    int* __restrict__ out,               // (B, Cq, K)
    int* __restrict__ counts,            // (B, Cq)
    unsigned long long* __restrict__ best,  // (B Cq, 2, K) where CHUNKED, else null
    int B, int Cq, int Cs, int G, int K, int cand_cap, int buf, float edge, float r2,
    int brute) {
  extern __shared__ unsigned long long keys_all[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * warps + warp;
  if (row >= static_cast<long long>(B) * Cq) return;
  const int b = static_cast<int>(row / Cq);
  const int qi = static_cast<int>(row % Cq);
  unsigned long long* keys = keys_all + static_cast<size_t>(warp) * buf;
  int* orow = out + row * K;
  const float qx = queries[3 * row + 0];
  const float qy = queries[3 * row + 1];
  const float qz = queries[3 * row + 2];

  // 1. the runs: lane j < 9 holds run j (brute: lane 0 the n_s valid rows)
  int lo = 0, len = 0;
  if (brute) {
    if (lane == 0) len = clip(s_lengths[b], 0, Cs);
  } else if (lane < 9) {
    const int dy = lane % 3 - 1, dz = lane / 3 - 1;
    const int nx = dims[3 * b + 0], ny = dims[3 * b + 1], nz = dims[3 * b + 2];
    const int cqx = cell_of(qx, origin[3 * b + 0], edge);
    const int cy = cell_of(qy, origin[3 * b + 1], edge) + dy;
    const int cz = cell_of(qz, origin[3 * b + 2], edge) + dz;
    const bool row_ok = cy >= 0 && cy < ny && cz >= 0 && cz < nz;
    const int x0 = clip(cqx - 1, 0, nx);
    const int x1 = clip(cqx + 2, x0, nx);
    const int base = wrap_mul(nx, wrap_add(row_ok ? cy : 0, wrap_mul(ny, row_ok ? cz : 0)));
    const int a = clip(row_ok ? wrap_add(base, x0) : 0, 0, G);
    const int e = clip(row_ok ? wrap_add(base, x1) : 0, a, G);
    const int* sb = starts + static_cast<size_t>(b) * (G + 1);
    lo = sb[a];
    len = sb[e] - lo;
  }
  int incl = len;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  const int off = incl - len;
  const int total = __shfl_sync(kFull, incl, 31);
  if (lane == 0) counts[row] = total;
  const int sentinel = Cs;
  if (qi >= q_lengths[b]) {  // a padding query row
    for (int r = lane; r < K; r += 32) orow[r] = sentinel;
    return;
  }

  // 2. the slots within the radius, as (d^2, index) keys into the warp's list
  const int limit = brute ? total : min(total, cand_cap);
  const float4* sup = support + static_cast<size_t>(b) * Cs;
  int n = 0;
  // CHUNKED: the K best so far, nb of them in best_q[cur]; keys not below
  // the K-th best (`worst`, once K are held) are dropped
  unsigned long long* best_q = CHUNKED ? best + row * 2 * K : nullptr;
  int cur = 0, nb = 0;
  unsigned long long worst = ~0ull;
  for (int j = 0; j < (brute ? 1 : 9); ++j) {
    const int lo_j = __shfl_sync(kFull, lo, j);
    const int len_j = __shfl_sync(kFull, len, j);
    const int off_j = __shfl_sync(kFull, off, j);
    const int end = min(len_j, limit - off_j);
    for (int t0 = 0; t0 < end; t0 += 32) {
      const int t = t0 + lane;
      bool keep = false;
      unsigned long long key = 0ull;
      if (t < end) {
        const float4 c = sup[clip(lo_j + t, 0, Cs - 1)];
        const float d2 = sq_dist(c.x, c.y, c.z, qx, qy, qz);
        if (d2 <= r2) {
          key = (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) |
                static_cast<unsigned>(static_cast<int>(c.w));
          keep = !CHUNKED || key < worst;
        }
      }
      const unsigned ballot = __ballot_sync(kFull, keep);
      if constexpr (CHUNKED) {
        if (n + __popc(ballot) > buf) {  // a full list: into the K best
          nb = merge_best(best_q + cur * K, nb, keys, n, best_q + (1 - cur) * K, K, lane);
          cur = 1 - cur;
          n = 0;
          worst = nb == K ? best_q[cur * K + K - 1] : ~0ull;
        }
      }
      if (keep) keys[n + __popc(ballot & ((1u << lane) - 1u))] = key;
      n += __popc(ballot);
    }
  }
  __syncwarp();
  if constexpr (CHUNKED) {
    if (n > 0) {
      nb = merge_best(best_q + cur * K, nb, keys, n, best_q + (1 - cur) * K, K, lane);
      cur = 1 - cur;
    }
    for (int r = lane; r < K; r += 32) {
      orow[r] = r < nb ? static_cast<int>(best_q[cur * K + r] & 0xffffffffull) : sentinel;
    }
    return;
  }

  // 3. each key's rank in the list; ranks below K name the row's slots
  for (int i0 = 0; i0 < n; i0 += 32 * kRankTile) {
    unsigned long long mine[kRankTile];
    int rank[kRankTile];
#pragma unroll
    for (int t = 0; t < kRankTile; ++t) {
      const int i = i0 + lane + 32 * t;
      mine[t] = i < n ? keys[i] : ~0ull;
      rank[t] = 0;
    }
    for (int j = 0; j < n; ++j) {
      const unsigned long long kj = keys[j];
#pragma unroll
      for (int t = 0; t < kRankTile; ++t) rank[t] += kj < mine[t];
    }
#pragma unroll
    for (int t = 0; t < kRankTile; ++t) {
      const int i = i0 + lane + 32 * t;
      if (i < n && rank[t] < K) orow[rank[t]] = static_cast<int>(mine[t] & 0xffffffffull);
    }
  }
  for (int r = n + lane; r < K; r += 32) orow[r] = sentinel;
}

__global__ void segment_mean_kernel(
    const float* __restrict__ points,  // (B, C, 3) sorted by voxel key
    const int* __restrict__ seg,       // (B, C) voxel of each row, -1 on padding rows
    const int* __restrict__ voxels,    // (B,) voxel count
    float* __restrict__ out,           // (B, cap_out, 3)
    int* __restrict__ counts,          // (B, cap_out)
    int B, int C, int cap_out, float pad) {
  const int rows = max(C, cap_out);
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(B) * rows) return;
  const int b = static_cast<int>(t / rows);
  const int i = static_cast<int>(t % rows);
  if (i < cap_out && i >= voxels[b]) {  // past the voxel count
    float* o = out + (static_cast<size_t>(b) * cap_out + i) * 3;
    o[0] = pad;
    o[1] = pad;
    o[2] = pad;
    counts[static_cast<size_t>(b) * cap_out + i] = 0;
  }
  if (i >= C) return;
  const int* sb = seg + static_cast<size_t>(b) * C;
  const int s = sb[i];
  if (s < 0 || s >= cap_out || (i > 0 && sb[i - 1] == s)) return;  // not a voxel's first row
  const float* p = points + static_cast<size_t>(b) * C * 3;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  int c = 0;
  for (int j = i; j < C && sb[j] == s; ++j, ++c) {
    sx = __fadd_rn(sx, p[3 * j + 0]);
    sy = __fadd_rn(sy, p[3 * j + 1]);
    sz = __fadd_rn(sz, p[3 * j + 2]);
  }
  const float fc = static_cast<float>(c);
  float* o = out + (static_cast<size_t>(b) * cap_out + s) * 3;
  o[0] = __fdiv_rn(sx, fc);
  o[1] = __fdiv_rn(sy, fc);
  o[2] = __fdiv_rn(sz, fc);
  counts[static_cast<size_t>(b) * cap_out + s] = c;
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// brute = 1: every valid support row is a candidate (starts, origin and dims
// unused, may be null); the warp's key list then holds Cs keys, else
// cand_cap. warps, chunk: the route (kernels/pyramid.py:search_route): chunk
// 0 where `warps` warps' whole lists fit a block (every shipped bucket),
// else kSearchChunk keys a warp's list and `best`, a workspace of
// B Cq 2 K keys.
int grid_radius_search_launch(const float* queries, const int* q_lengths, const float* support,
                              const int* s_lengths, const int* starts, const float* origin,
                              const int* dims, int* out, int* counts, void* best, int B, int Cq,
                              int Cs, int G, int K, int cand_cap, int brute, int warps, int chunk,
                              float edge, float r2, void* stream) {
  if (B < 0 || Cq < 0 || Cs < 1 || K < 1 || (!brute && (cand_cap < 1 || G < 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int list = brute ? Cs : cand_cap;
  const size_t block_bytes = static_cast<size_t>(launch_util::device_limits().block_bytes);
  int want_warps = 4;
  while (want_warps > 1 && sizeof(unsigned long long) * list * want_warps > block_bytes) {
    --want_warps;
  }
  const bool staged = sizeof(unsigned long long) * list * want_warps <= block_bytes;
  if (warps != (staged ? want_warps : 4) || chunk != (staged ? 0 : kSearchChunk) ||
      (!staged && best == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || Cq == 0) return 0;
  const int buf = staged ? list : kSearchChunk;
  const size_t smem = sizeof(unsigned long long) * static_cast<size_t>(buf) * warps;
  const long long rows = static_cast<long long>(B) * Cq;
  const unsigned grid = static_cast<unsigned>((rows + warps - 1) / warps);
  auto run = [&](auto kernel) {
    const cudaError_t err = launch_util::allow_smem(reinterpret_cast<const void*>(kernel), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
        queries, q_lengths, reinterpret_cast<const float4*>(support), s_lengths, starts, origin,
        dims, out, counts, static_cast<unsigned long long*>(best), B, Cq, Cs, G, K, cand_cap, buf,
        edge, r2, brute);
    return static_cast<int>(cudaGetLastError());
  };
  return staged ? run(grid_search_kernel<false>) : run(grid_search_kernel<true>);
}

int voxel_segment_mean_launch(const float* points, const int* seg, const int* voxels, float* out,
                              int* counts, int B, int C, int cap_out, float pad, void* stream) {
  if (B < 0 || C < 0 || cap_out < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(B) * (C > cap_out ? C : cap_out);
  if (threads == 0) return 0;
  constexpr int kThreads = 256;
  segment_mean_kernel<<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(points, seg, voxels, out, counts, B,
                                                             C, cap_out, pad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
