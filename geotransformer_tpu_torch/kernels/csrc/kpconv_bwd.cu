// KPConv backward over the inverse neighbour table, for Hopper (sm_90a).
//
// Replaces geotransformer_tpu/kernels/kpconv.py:kpconv_bwd_fused (pallas_call
// at :884, body _kpconv_bwd_kernel :651). The forward gathered support rows
// per query; its gradient would scatter per edge. The inverse table turns the
// scatter into a gather: row n lists the queries q_j whose neighbour lists
// hold n (sentinel M), so for each support row
//   infl[n, j, k] = max(0, 1 - |s_n - q_j - kp_k| / sigma)   (support - query,
//                   the forward's offset; the disposition is not symmetric)
//   u[n, k, d]    = sum_j infl[n, j, k] gdiv[q_j, d]         gdiv = dout / count
//   d_s[n, c]     = sum_{k, d} u[n, k, d] W[k, c, d]
//   d_pool[n, p]  = sum_j [pool[n, p] == pooled[q_j, p]] dpool[q_j, p] / ties[q_j, p]
// and dW[k, c, d] = sum_n s[n, c] u[n, k, d] is a reduction over all rows.
//
// Three passes, all of kpconv_common.cuh:
//   1. the u pass: the edge pass in its backward mode (gathered rows gdiv,
//      offsets s_n - q_j), with the pool's gradient; a split inverse table
//      (head (N, J1), tail (N2, J2), rank (N,)) in the same pass: row n walks
//      its head edges, then its tail row rank[n] if it has one;
//   2. d_s = u (N, K D) Wt (K D, C), the forward's contraction (3xTF32
//      tensor cores; Wt the weights pre-transposed to (K, D, C));
//   3. dW[k] = s^T (C x N) u[:, k, :] (N x D): the same tensor-core tiles
//      with s read transposed, each block one (c, d) tile of one kernel
//      point over one slice of the rows, the slices' partial sums added in a
//      fixed order (reduce_slices_kernel). No float atomics: the result is
//      the same on every run.
// What bounded the kernel it replaces (chip_smoke.py on an H100 80GB HBM3 at
// 700 W): 22.2 ms of a KITTI step against a 1.35 ms bound. With KITTI's
// J = 136 inverse columns its (TN, J, K) influence tile left 4 support rows
// a block, each block streamed all of Wt through L2 for the d_s contraction
// on the CUDA cores, dW ran on the CUDA cores too, and a split table took two
// launches and two rank gathers. Now both contractions run on the tensor
// cores and the u pass stages influences a chunk of edges at a time.
//
// Sentinel edges (value M) contribute zero. Ties in the pooled max share the
// gradient evenly (the forward's tie count, as XLA's reduce-max VJP does),
// shadow columns' shares are dropped; equality is exact because the pooled
// values are f32 copies of the pool features.
//
// The bfloat16 points, as instances (kpconv_common.cuh's kRound* bits).
// kpconv_mxu, the JAX kernel's MXU_DTYPE (geotransformer_tpu/kernels/
// kpconv.py:699-725): the influences and gdiv rounded before u, u rounded
// before both weight products (d_s = round(u) Wt with Wt f32: a bfloat16
// value is a TF32 value, so only Wt is split, two products a k8 step; dW =
// round(s)^T round(u): one TF32 pass of exact products). The JAX backward
// runs a split inverse table as two calls, each rounding its own u
// (:760-766, :778-802), so the u pass rounds the head's sums and the
// tail's sums apart and adds them; that sum is no bfloat16 value, and the
// split route's d_s takes the three products of the float32 point and its
// dW two. kpconv_table (:842-845): a row's own pool features rounded for
// the tie equality, as the forward pooled the rounded table values.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "kpconv_common.cuh"

namespace {

using kpconv::kThreads;

// dW tile (c x d): 64 where the width reaches it, else 32
int dw_tile(int width) { return width >= 64 ? 64 : 32; }

// Row slices of the dW pass: enough blocks for two waves of the card, at
// least 128 rows a slice, each slice a multiple of 32 rows.
int dw_rows_per_slice(int N, int K, int C, int D) {
  const bool tc = kpconv::tensor_core_widths(C, D);
  const long long tiles = tc ? static_cast<long long>((C + dw_tile(C) - 1) / dw_tile(C)) *
                                   ((D + dw_tile(D) - 1) / dw_tile(D))
                             : (static_cast<long long>(C) * D + kThreads - 1) / kThreads;
  long long slices = (2 * kpconv::kSMs + tiles * K - 1) / (tiles * K);
  const long long most = (N + 127) / 128;
  slices = slices > most ? most : slices;
  slices = slices < 1 ? 1 : slices;
  const int rows = static_cast<int>((N + slices - 1) / slices);
  return (rows + 31) & ~31;
}

template <int EXACT>
int launch_dw_tc(const kpconv::GemmArgs& p, int K, int slices, cudaStream_t s) {
  using kpconv::launch_gemm_tc;
  const int bm = dw_tile(p.M), bn = dw_tile(p.N);
  if (bm == 64 && bn == 64) return launch_gemm_tc<64, 64, 2, 4, true, EXACT>(p, K, slices, s);
  if (bm == 64) return launch_gemm_tc<64, 32, 4, 2, true, EXACT>(p, K, slices, s);
  if (bn == 64) return launch_gemm_tc<32, 64, 2, 4, true, EXACT>(p, K, slices, s);
  return launch_gemm_tc<32, 32, 2, 4, true, EXACT>(p, K, slices, s);
}

// exact: 0 at the float32 point; at the bfloat16 point s rounded as read,
// 2 where u is bfloat16-valued (a whole inverse table), else 1 (a split
// one's u is the sum of two rounded parts)
int launch_dw(const kpconv::GemmArgs& p, int K, int slices, int exact, cudaStream_t s) {
  if (!kpconv::tensor_core_widths(p.M, p.N)) {
    return kpconv::launch_gemm_f32(p, 1, K, slices, s, exact != 0 ? 1 : 0);
  }
  if (exact == 2) return launch_dw_tc<2>(p, K, slices, s);
  if (exact == 1) return launch_dw_tc<1>(p, K, slices, s);
  return launch_dw_tc<0>(p, K, slices, s);
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Number of row slices the dW pass uses for these sizes; the wrapper sizes
// the partial buffer (slices, K, C, D) with it (unused at 1).
int kpconv_dw_slices(int N, int K, int C, int D) {
  if (N == 0) return 1;
  const int rows = dw_rows_per_slice(N, K, C, D);
  return (N + rows - 1) / rows;
}

// Floats of the split-K workspace of d_s = u (N x K D) Wt (K D x C) (0:
// none); the wrapper allocates it for kpconv_bwd_launch.
long long kpconv_ds_workspace(int N, int K, int C, int D) {
  return kpconv::contraction_workspace(N, C, K * D, kpconv::tensor_core_widths(C, D));
}

// The backward of one conv. head (N, J1) sentinel M; tail (N2, J2) and rank
// (N,) (sentinel N2) or null for a whole inverse table. Writes u (N, K, D),
// d_s (N, C) (through part_ds, kpconv_ds_workspace floats), dw (K, C, D)
// (through part (slices, K, C, D) when there is more than one slice) and,
// with the pool, d_pool (N, P), the inverse table's columns pool_chunk at a
// time (kernels/kpconv.py:pool_route); edge_*: the u pass's route
// (kernels/kpconv.py:edge_route(K, D)). Any K, C and D, any table width.
// mxu_bf16: the influences, gdiv and u rounded to bfloat16 (u a part of the
// table at a time), s rounded for dW (kpconv_mxu); table_bf16: the rows' own
// pool features rounded for the tie equality (kpconv_table).
int kpconv_bwd_launch(const float* s_feats, const float* s_points, const float* q_points,
                      const float* gdiv, const int32_t* head, const int32_t* tail,
                      const int32_t* rank, const float* kp, const float* wt,
                      const float* pool_feats, const float* pooled, const float* dpt, float* u,
                      float* part_ds, float* part, float* d_s, float* dw, float* d_pool,
                      int N, int M, int J1, int J2, int N2, int K, int C, int D, int P,
                      int pool_chunk, int mxu_bf16, int table_bf16, int edge_v, int edge_tpr,
                      int edge_tr, int edge_kp_chunks, int edge_passes, float sigma,
                      void* stream) {
  if (K < 1 || J1 < 1 || C < 1 || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N == 0) {
    return static_cast<int>(cudaMemsetAsync(dw, 0, sizeof(float) * K * C * D, st));
  }

  kpconv::EdgeArgs e{};
  e.feats = gdiv;
  e.self_pts = s_points;
  e.other_pts = q_points;
  e.head = head;
  e.tail = tail;
  e.rank = rank;
  e.kp = kp;
  e.t_out = u;
  e.R = N;
  e.n_other = M;
  e.C = D;
  e.K = K;
  e.h1 = J1;
  e.h2 = J2;
  e.r2 = N2;
  e.sigma = sigma;
  kpconv::BwdExtras x{};
  x.pool_feats = pool_feats;
  x.pooled = pooled;
  x.dpt = dpt;
  x.d_pool = pool_feats != nullptr ? d_pool : nullptr;
  x.P = P;
  const int pool_width = pool_feats == nullptr ? 0 : J1 + (tail != nullptr ? J2 : 0);
  const kpconv::EdgeRoute route{edge_v, edge_tpr, edge_tr, edge_kp_chunks, edge_passes};
  const int round_mode =
      (mxu_bf16 != 0 ? kpconv::kRoundInfl | kpconv::kRoundFeats | kpconv::kRoundSums : 0) |
      (table_bf16 != 0 && pool_feats != nullptr ? kpconv::kRoundPool : 0);
  int err = kpconv::launch_edges<true>(e, x, pool_width, pool_chunk, route, st, round_mode);
  if (err != 0) return err;

  // d_s = u (N, K D) Wt (K D, C); at the bfloat16 point a whole table's u
  // is bfloat16-valued: two products a k8 step (Wt stays f32)
  kpconv::GemmArgs g{};
  g.a = u;
  g.lda = K * D;
  g.b = wt;
  g.ldb = C;
  g.c = d_s;
  g.ldc = C;
  g.M = N;
  g.N = C;
  g.Kdim = K * D;
  g.k_per_z = K * D;
  err = kpconv::launch_contraction(g, kpconv::tensor_core_widths(C, D), part_ds, st, false,
                                   mxu_bf16 != 0 && tail == nullptr);
  if (err != 0) return err;

  // dW[k] = s^T u[:, k, :], one slice of the rows a block (grid y: k, z: slice)
  const int rows = dw_rows_per_slice(N, K, C, D);
  const int slices = (N + rows - 1) / rows;
  kpconv::GemmArgs w{};
  w.a = s_feats;  // k-major: a[n * C + c]
  w.lda = C;
  w.b = u;
  w.ldb = K * D;
  w.b_step_y = D;
  w.c = slices == 1 ? dw : part;
  w.ldc = D;
  w.c_step_y = static_cast<long long>(C) * D;
  w.c_step_z = static_cast<long long>(K) * C * D;
  w.M = C;
  w.N = D;
  w.Kdim = N;
  w.k_per_z = rows;
  err = launch_dw(w, K, slices, mxu_bf16 == 0 ? 0 : tail == nullptr ? 2 : 1, st);
  if (err != 0 || slices == 1) return err;
  // dW[e] = sum_s part[s, e], slices added in order
  kpconv::reduce_slices_kernel<<<(K * C * D + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      part, dw, nullptr, slices, K * C, D);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
