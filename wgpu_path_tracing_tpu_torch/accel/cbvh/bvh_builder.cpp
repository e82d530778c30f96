// Native SAH BVH build: the C++ twin of accel/bvh.py (which mirrors the
// reference's bvh.ts:53-229). Its output is bit-identical to the NumPy
// build's (tests/test_torch_native.py): the same double-precision box
// and cost math, the same LIFO work queue, the same strict-greater
// max-extent axis rule (aabb.ts:52-66), a stable sort on float32 centroid
// keys (bvh.ts:95-102: each centroid is computed in double and rounded to
// float, as accel/bvh.py does, so centroids that tie in float32 but differ
// in double keep their input order), count-ratio SAH candidates
// (bvh.ts:173-202) with costs TRAVERSAL=1 / INTERSECTION=2 (bvh.ts:206-209).
// accel/native.py compiles it with -ffp-contract=off: NumPy rounds every
// multiply and add of the surface areas and costs separately.
//
// A plain C ABI for ctypes; accel/native.py builds and binds it.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

inline double surface_area(const Vec3& mn, const Vec3& mx) {
  const double dx = mx.x - mn.x, dy = mx.y - mn.y, dz = mx.z - mn.z;
  return 2.0 * (dx * dy + dy * dz + dz * dx);
}

struct Key3 {
  float x, y, z;
};

struct Task {
  int node, start, end;
};

}  // namespace

extern "C" {

// v0/v1/v2: (num_tris, 3) float32. Outputs (caller-allocated):
//   aabb_min/aabb_max: (2*num_tris + 1, 3) float32
//   meta:              (2*num_tris + 1, 4) int32 [left, right, offset, count]
//   order:             (num_tris,) int64 permutation
// Returns the node count (>= 1), or -1 on invalid input.
int64_t wpt_build_bvh(const float* v0, const float* v1, const float* v2,
                      int64_t num_tris, int32_t max_leaf_size,
                      int32_t num_bins, float* aabb_min, float* aabb_max,
                      int32_t* meta, int64_t* order) {
  if (num_tris <= 0 || max_leaf_size < 1 || num_bins < 2) return -1;
  const int64_t t = num_tris;

  std::vector<Vec3> tri_min(t), tri_max(t);
  std::vector<Key3> centroid(t);
  for (int64_t i = 0; i < t; ++i) {
    const Vec3 a{(double)v0[3 * i], (double)v0[3 * i + 1], (double)v0[3 * i + 2]};
    const Vec3 b{(double)v1[3 * i], (double)v1[3 * i + 1], (double)v1[3 * i + 2]};
    const Vec3 c{(double)v2[3 * i], (double)v2[3 * i + 1], (double)v2[3 * i + 2]};
    tri_min[i] = vmin(vmin(a, b), c);
    tri_max[i] = vmax(vmax(a, b), c);
    centroid[i] = {(float)((a.x + b.x + c.x) / 3.0),
                   (float)((a.y + b.y + c.y) / 3.0),
                   (float)((a.z + b.z + c.z) / 3.0)};
  }

  for (int64_t i = 0; i < t; ++i) order[i] = i;

  struct Node {
    Vec3 mn, mx;
    int32_t left, right, offset, count;
  };
  std::vector<Node> nodes;
  nodes.reserve(2 * t);

  Vec3 root_mn = tri_min[0], root_mx = tri_max[0];
  for (int64_t i = 1; i < t; ++i) {
    root_mn = vmin(root_mn, tri_min[i]);
    root_mx = vmax(root_mx, tri_max[i]);
  }
  nodes.push_back({root_mn, root_mx, -1, -1, 0, (int32_t)t});

  std::vector<Task> queue;
  queue.push_back({0, 0, (int)t});

  std::vector<Vec3> pre_mn, pre_mx, suf_mn, suf_mx;

  while (!queue.empty()) {
    const Task task = queue.back();
    queue.pop_back();
    const int n = task.end - task.start;

    if (n <= max_leaf_size) {
      Node& nd = nodes[task.node];
      nd.left = nd.right = -1;
      nd.offset = task.start;
      nd.count = n;
      continue;
    }

    int64_t* idx = order + task.start;

    Vec3 sub_mn = tri_min[idx[0]], sub_mx = tri_max[idx[0]];
    for (int i = 1; i < n; ++i) {
      sub_mn = vmin(sub_mn, tri_min[idx[i]]);
      sub_mx = vmax(sub_mx, tri_max[idx[i]]);
    }
    const double ex = sub_mx.x - sub_mn.x, ey = sub_mx.y - sub_mn.y,
                 ez = sub_mx.z - sub_mn.z;
    int axis;
    if (ex > ey && ex > ez)
      axis = 0;
    else if (ey > ex && ey > ez)
      axis = 1;
    else
      axis = 2;

    std::stable_sort(idx, idx + n, [&](int64_t a, int64_t b) {
      const float ca = axis == 0   ? centroid[a].x
                        : axis == 1 ? centroid[a].y
                                    : centroid[a].z;
      const float cb = axis == 0   ? centroid[b].x
                        : axis == 1 ? centroid[b].y
                                    : centroid[b].z;
      return ca < cb;
    });

    pre_mn.resize(n);
    pre_mx.resize(n);
    suf_mn.resize(n);
    suf_mx.resize(n);
    pre_mn[0] = tri_min[idx[0]];
    pre_mx[0] = tri_max[idx[0]];
    for (int i = 1; i < n; ++i) {
      pre_mn[i] = vmin(pre_mn[i - 1], tri_min[idx[i]]);
      pre_mx[i] = vmax(pre_mx[i - 1], tri_max[idx[i]]);
    }
    suf_mn[n - 1] = tri_min[idx[n - 1]];
    suf_mx[n - 1] = tri_max[idx[n - 1]];
    for (int i = n - 2; i >= 0; --i) {
      suf_mn[i] = vmin(suf_mn[i + 1], tri_min[idx[i]]);
      suf_mx[i] = vmax(suf_mx[i + 1], tri_max[idx[i]]);
    }

    double best_cost = std::numeric_limits<double>::infinity();
    int best_s = 0;
    for (int i = 1; i < num_bins; ++i) {
      const int s = (int)((int64_t)n * i / num_bins);
      if (s == 0 || s == n) continue;
      const double cost =
          1.0 + (surface_area(pre_mn[s - 1], pre_mx[s - 1]) * s +
                 surface_area(suf_mn[s], suf_mx[s]) * (n - s)) *
                    2.0;
      if (cost < best_cost) {
        best_cost = cost;
        best_s = s;
      }
    }
    if (best_s == 0) best_s = n / 2;  // guard, as accel/bvh.py
    const int split = task.start + best_s;

    const int left_idx = (int)nodes.size();
    const int right_idx = left_idx + 1;
    nodes.push_back({pre_mn[best_s - 1], pre_mx[best_s - 1], -1, -1,
                     (int32_t)task.start, (int32_t)best_s});
    nodes.push_back({suf_mn[best_s], suf_mx[best_s], -1, -1, (int32_t)split,
                     (int32_t)(n - best_s)});

    Node& nd = nodes[task.node];
    nd.left = left_idx;
    nd.right = right_idx;
    nd.offset = 0;
    nd.count = 0;

    queue.push_back({left_idx, task.start, split});
    queue.push_back({right_idx, split, task.end});
  }

  for (size_t i = 0; i < nodes.size(); ++i) {
    aabb_min[3 * i] = (float)nodes[i].mn.x;
    aabb_min[3 * i + 1] = (float)nodes[i].mn.y;
    aabb_min[3 * i + 2] = (float)nodes[i].mn.z;
    aabb_max[3 * i] = (float)nodes[i].mx.x;
    aabb_max[3 * i + 1] = (float)nodes[i].mx.y;
    aabb_max[3 * i + 2] = (float)nodes[i].mx.z;
    meta[4 * i] = nodes[i].left;
    meta[4 * i + 1] = nodes[i].right;
    meta[4 * i + 2] = nodes[i].offset;
    meta[4 * i + 3] = nodes[i].count;
  }
  return (int64_t)nodes.size();
}

}  // extern "C"
