// Native host preprocessing kernels of the PyTorch port.
//
// A dependency-free C ABI consumed via ctypes
// (geotransformer_tpu_torch/native/__init__.py), the same code below this
// header as geotransformer_tpu/native/geolib.cpp, so both libraries give
// the same bits:
//   * grid_subsample:   per-cloud voxel hashing, emits the mean of each
//     occupied voxel ordered by flat voxel id (the order of the numpy path
//     in preprocess/voxel.py, which sorts by the same id).
//   * radius_neighbors: fixed-K nearest-within-radius search over a uniform
//     grid hash (cell = radius), sorted by (distance, index) so results are
//     fully deterministic; sentinel index = total support count.
//
// Single-threaded per call by design: the input pipeline parallelizes over
// pairs with worker processes.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

struct VoxelAccum {
  double x = 0.0, y = 0.0, z = 0.0;
  int64_t count = 0;
};

}  // namespace

extern "C" {

// Subsample one stacked batch of clouds. Returns the total number of output
// points, or -1 if out_capacity would be exceeded (caller retries bigger).
int64_t gt_grid_subsample(const float* points, const int64_t* lengths,
                          int64_t batch, double voxel_size, float* out_points,
                          int64_t out_capacity, int64_t* out_lengths) {
  int64_t start = 0;
  int64_t total_out = 0;
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t n = lengths[b];
    const float* cloud = points + 3 * start;

    double min_c[3] = {1e30, 1e30, 1e30};
    double max_c[3] = {-1e30, -1e30, -1e30};
    for (int64_t i = 0; i < n; ++i) {
      for (int d = 0; d < 3; ++d) {
        const double v = cloud[3 * i + d];
        min_c[d] = std::min(min_c[d], v);
        max_c[d] = std::max(max_c[d], v);
      }
    }
    double origin[3];
    for (int d = 0; d < 3; ++d) {
      origin[d] = std::floor(min_c[d] / voxel_size) * voxel_size;
    }
    const int64_t nx =
        static_cast<int64_t>(std::floor((max_c[0] - origin[0]) / voxel_size)) + 1;
    const int64_t ny =
        static_cast<int64_t>(std::floor((max_c[1] - origin[1]) / voxel_size)) + 1;

    std::unordered_map<int64_t, VoxelAccum> voxels;
    voxels.reserve(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) {
      const double x = cloud[3 * i + 0];
      const double y = cloud[3 * i + 1];
      const double z = cloud[3 * i + 2];
      const int64_t ix = static_cast<int64_t>(std::floor((x - origin[0]) / voxel_size));
      const int64_t iy = static_cast<int64_t>(std::floor((y - origin[1]) / voxel_size));
      const int64_t iz = static_cast<int64_t>(std::floor((z - origin[2]) / voxel_size));
      VoxelAccum& acc = voxels[ix + nx * iy + nx * ny * iz];
      acc.x += x;
      acc.y += y;
      acc.z += z;
      acc.count += 1;
    }

    std::vector<std::pair<int64_t, const VoxelAccum*>> ordered;
    ordered.reserve(voxels.size());
    for (const auto& kv : voxels) ordered.emplace_back(kv.first, &kv.second);
    std::sort(ordered.begin(), ordered.end(),
              [](const auto& a, const auto& b) { return a.first < b.first; });

    if (total_out + static_cast<int64_t>(ordered.size()) > out_capacity) return -1;
    for (const auto& kv : ordered) {
      const VoxelAccum& acc = *kv.second;
      out_points[3 * total_out + 0] = static_cast<float>(acc.x / acc.count);
      out_points[3 * total_out + 1] = static_cast<float>(acc.y / acc.count);
      out_points[3 * total_out + 2] = static_cast<float>(acc.z / acc.count);
      ++total_out;
    }
    out_lengths[b] = static_cast<int64_t>(ordered.size());
    start += n;
  }
  return total_out;
}

// Fixed-K radius search in stack mode; out_indices is (total_q, limit),
// sentinel = total_s for missing slots.
void gt_radius_neighbors(const float* q_points, const float* s_points,
                         const int64_t* q_lengths, const int64_t* s_lengths,
                         int64_t batch, double radius, int64_t limit,
                         int64_t* out_indices) {
  int64_t total_s = 0;
  for (int64_t b = 0; b < batch; ++b) total_s += s_lengths[b];

  const float r2 = static_cast<float>(radius * radius);
  int64_t q_start = 0;
  int64_t s_start = 0;
  std::vector<std::pair<float, int64_t>> cand;
  cand.reserve(8192);
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t nq = q_lengths[b];
    const int64_t ns = s_lengths[b];
    const float* q = q_points + 3 * q_start;
    const float* s = s_points + 3 * s_start;

    // Uniform grid over the support cloud, cell edge = radius, stored CSR
    // over a DENSE cell array (hash lookups — 27 per query — dominated the
    // sparse version). Cells hold packed (x, y, z, original index) runs so
    // each query scans sequential memory.
    float min_c[3] = {1e30f, 1e30f, 1e30f};
    float max_c[3] = {-1e30f, -1e30f, -1e30f};
    for (int64_t i = 0; i < ns; ++i) {
      for (int d = 0; d < 3; ++d) {
        min_c[d] = std::min(min_c[d], s[3 * i + d]);
        max_c[d] = std::max(max_c[d], s[3 * i + d]);
      }
    }
    const float inv_r = static_cast<float>(1.0 / radius);
    int64_t dims[3];
    for (int d = 0; d < 3; ++d) {
      dims[d] = static_cast<int64_t>(
                    std::floor((max_c[d] - min_c[d]) * inv_r)) + 1;
    }
    // Degenerate extents (huge sparse scenes) could blow the dense array;
    // coarsen the grid instead — cells just hold more candidates.
    float cell_edge = static_cast<float>(radius);
    float inv_cell = inv_r;
    while (dims[0] * dims[1] * dims[2] > 8 * ns + 1024) {
      cell_edge *= 2.0f;
      inv_cell = 1.0f / cell_edge;
      for (int d = 0; d < 3; ++d) {
        dims[d] = static_cast<int64_t>(
                      std::floor((max_c[d] - min_c[d]) * inv_cell)) + 1;
      }
    }
    const int64_t reach =
        static_cast<int64_t>(std::ceil(radius / cell_edge));  // 1 unless coarsened
    const int64_t n_cells = dims[0] * dims[1] * dims[2];

    auto cell_of = [&](const float* p, int64_t c[3]) {
      for (int d = 0; d < 3; ++d) {
        int64_t v = static_cast<int64_t>(std::floor((p[d] - min_c[d]) * inv_cell));
        c[d] = std::min(std::max(v, int64_t{0}), dims[d] - 1);
      }
    };

    std::vector<int32_t> pt_cell(ns);
    std::vector<int32_t> cell_start(n_cells + 1, 0);
    for (int64_t i = 0; i < ns; ++i) {
      int64_t c[3];
      cell_of(s + 3 * i, c);
      const int32_t id = static_cast<int32_t>(c[0] + dims[0] * (c[1] + dims[1] * c[2]));
      pt_cell[i] = id;
      ++cell_start[id + 1];
    }
    for (int64_t c = 0; c < n_cells; ++c) cell_start[c + 1] += cell_start[c];
    std::vector<float> px(ns), py(ns), pz(ns);
    std::vector<int32_t> pidx(ns);
    {
      std::vector<int32_t> cursor(cell_start.begin(), cell_start.end() - 1);
      for (int64_t i = 0; i < ns; ++i) {
        const int32_t at = cursor[pt_cell[i]]++;
        px[at] = s[3 * i + 0];
        py[at] = s[3 * i + 1];
        pz[at] = s[3 * i + 2];
        pidx[at] = static_cast<int32_t>(i);
      }
    }

    for (int64_t i = 0; i < nq; ++i) {
      const float* qp = q + 3 * i;
      const float qx = qp[0], qy = qp[1], qz = qp[2];
      int64_t c[3];
      cell_of(qp, c);
      cand.clear();
      const int64_t x0 = std::max(c[0] - reach, int64_t{0});
      const int64_t x1 = std::min(c[0] + reach, dims[0] - 1);
      const int64_t y0 = std::max(c[1] - reach, int64_t{0});
      const int64_t y1 = std::min(c[1] + reach, dims[1] - 1);
      const int64_t z0 = std::max(c[2] - reach, int64_t{0});
      const int64_t z1 = std::min(c[2] + reach, dims[2] - 1);
      cand.clear();
      for (int64_t cz = z0; cz <= z1; ++cz) {
        for (int64_t cy = y0; cy <= y1; ++cy) {
          // cells along x are contiguous: one run per (y, z) row
          const int64_t row0 = x0 + dims[0] * (cy + dims[1] * cz);
          const int32_t lo = cell_start[row0];
          const int32_t hi = cell_start[row0 + (x1 - x0) + 1];
          for (int32_t j = lo; j < hi; ++j) {
            const float ddx = qx - px[j];
            const float ddy = qy - py[j];
            const float ddz = qz - pz[j];
            const float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
            if (d2 <= r2) cand.emplace_back(d2, pidx[j]);
          }
        }
      }
      const int64_t k = std::min<int64_t>(limit, cand.size());
      if (static_cast<int64_t>(cand.size()) > k) {
        // nth_element is O(n); partial_sort over thousands of in-radius
        // candidates (the 2x-radius upsampling searches) dominated before.
        std::nth_element(cand.begin(), cand.begin() + k, cand.end());
      }
      std::sort(cand.begin(), cand.begin() + k);
      int64_t* row = out_indices + (q_start + i) * limit;
      for (int64_t j = 0; j < k; ++j) row[j] = cand[j].second + s_start;
      for (int64_t j = k; j < limit; ++j) row[j] = total_s;
    }
    q_start += nq;
    s_start += ns;
  }
}

}  // extern "C"
