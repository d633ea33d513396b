// Weighted sample elimination (Poisson-disk thinning), host C++.
//
// The port's copy of cm_sample_elimination in claymore_tpu/native/src/
// runtime.cpp (the cySampleElim algorithm of the reference's
// SampleGenerator, re-implemented with a hash grid and a lazy max-heap), so
// that io/sampler.py:poisson_disk_sample keeps the same indices without
// importing the JAX package.  Built by g++ at first use
// (ops/_build.py:host_library), loaded with ctypes.
//
// Candidates pts[n*3] (shifted to start at 0, extents given) -> the indices
// of the target m samples kept, ascending, in out_idx (size >= m).  Weights
// w_i = sum_j (1 - d_ij / (2 r_max))^8 over neighbours within 2 r_max;
// repeatedly eliminate the sample of largest weight (ties: the larger
// index) and take its terms off its neighbours' weights.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <queue>
#include <utility>
#include <vector>

extern "C" int cm_sample_elimination(const float* pts, int64_t n, int64_t target,
                                     float extent_x, float extent_y, float extent_z,
                                     int32_t* out_idx) {
  if (target >= n) {
    for (int64_t i = 0; i < n; ++i) out_idx[i] = int32_t(i);
    return int(n);
  }
  const double volume = double(extent_x) * extent_y * extent_z;
  const double r_max = std::cbrt(volume / (4.0 * std::sqrt(2.0) * double(target)));
  const double r2max = 2.0 * r_max;

  // hash grid with cell size 2 r_max
  const double cell = r2max;
  int gx = std::max(1, int(extent_x / cell));
  int gy = std::max(1, int(extent_y / cell));
  int gz = std::max(1, int(extent_z / cell));
  auto cell_of = [&](const float* p) {
    int cx = std::min(gx - 1, std::max(0, int(p[0] / extent_x * gx)));
    int cy = std::min(gy - 1, std::max(0, int(p[1] / extent_y * gy)));
    int cz = std::min(gz - 1, std::max(0, int(p[2] / extent_z * gz)));
    return (cx * gy + cy) * gz + cz;
  };
  std::vector<std::vector<int32_t>> grid(size_t(gx) * gy * gz);
  for (int64_t i = 0; i < n; ++i) grid[cell_of(pts + i * 3)].push_back(int32_t(i));

  auto for_neighbors = [&](int64_t i, auto&& fn) {
    const float* p = pts + i * 3;
    int cx = std::min(gx - 1, std::max(0, int(p[0] / extent_x * gx)));
    int cy = std::min(gy - 1, std::max(0, int(p[1] / extent_y * gy)));
    int cz = std::min(gz - 1, std::max(0, int(p[2] / extent_z * gz)));
    for (int dx = -1; dx <= 1; ++dx)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dz = -1; dz <= 1; ++dz) {
          int x = cx + dx, y = cy + dy, z = cz + dz;
          if (x < 0 || y < 0 || z < 0 || x >= gx || y >= gy || z >= gz) continue;
          for (int32_t j : grid[size_t(x * gy + y) * gz + z]) {
            if (j == i) continue;
            double ddx = pts[j * 3 + 0] - p[0];
            double ddy = pts[j * 3 + 1] - p[1];
            double ddz = pts[j * 3 + 2] - p[2];
            double d = std::sqrt(ddx * ddx + ddy * ddy + ddz * ddz);
            if (d < r2max) fn(j, d);
          }
        }
  };

  std::vector<double> weight(n, 0.0);
  for (int64_t i = 0; i < n; ++i)
    for_neighbors(i, [&](int32_t, double d) {
      double t = 1.0 - d / r2max;
      weight[i] += t * t * t * t * t * t * t * t;
    });

  // lazy max-heap of (weight, index)
  std::vector<char> alive(n, 1);
  std::priority_queue<std::pair<double, int32_t>> heap;
  for (int64_t i = 0; i < n; ++i) heap.push({weight[i], int32_t(i)});

  int64_t remaining = n;
  while (remaining > target && !heap.empty()) {
    auto [w, i] = heap.top();
    heap.pop();
    if (!alive[i] || w != weight[i]) continue;  // stale entry
    alive[i] = 0;
    --remaining;
    for_neighbors(i, [&](int32_t j, double d) {
      if (!alive[j]) return;
      double t = 1.0 - d / r2max;
      weight[j] -= t * t * t * t * t * t * t * t;
      heap.push({weight[j], j});
    });
  }

  int64_t k = 0;
  for (int64_t i = 0; i < n && k < target; ++i)
    if (alive[i]) out_idx[k++] = int32_t(i);
  return int(k);
}
