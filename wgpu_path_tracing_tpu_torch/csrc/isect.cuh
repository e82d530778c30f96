// Device functions the intersection kernels share: dense_hit.cu (K1),
// walk.cu (K3), pairs.cu (K4), phased.cu (K5), cluster.cu (K6) and blocks.cu
// (phase 1 of K4 and K6).
//
// Each follows its plain PyTorch counterpart term for term (ops/walk.py
// slab_entry, ops/blocks.py slab_entry_div, ops/intersect.py
// moller_trumbore), and the library is compiled with -fmad=false and without
// --use_fast_math, so every product, sum, IEEE division and reciprocal
// rounds as PyTorch's separate elementwise kernels round them.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace wpt {

// torch.minimum / torch.maximum: NaN if either operand is NaN (CUDA's fminf
// and fmaxf drop it).
__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

// torch.minimum / torch.maximum in one instruction each: PTX's .NaN min
// and max return NaN if either operand is NaN, as nan_min does. They
// may pick another zero sign than nan_min for (+0, -0), which no comparison
// tells apart: use them where the result is only compared, or where a
// stored zero's sign is allowed to differ (phase 1's entry table, which is
// only compared and sorted).
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz;  // 1/d with a zero component replaced by 1e-30
};

// Ray i of SoA (3, n) origins and directions.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ ro,
                                        const float* __restrict__ rd, int n,
                                        int i) {
  const float kTiny = static_cast<float>(1e-30);
  Ray r;
  r.ox = ro[i];
  r.oy = ro[n + i];
  r.oz = ro[2 * n + i];
  r.dx = rd[i];
  r.dy = rd[n + i];
  r.dz = rd[2 * n + i];
  r.ix = 1.0f / (r.dx == 0.0f ? kTiny : r.dx);
  r.iy = 1.0f / (r.dy == 0.0f ? kTiny : r.dy);
  r.iz = 1.0f / (r.dz == 0.0f ? kTiny : r.dz);
  return r;
}

// A tail lane of the last ray block (ops/blocks.py pad_blocks): origin 0,
// direction 1. With its limit of -inf it enters no box.
__device__ __forceinline__ Ray pad_ray() {
  return Ray{0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f, 1.0f};
}

// The slab test from the six plane distances: the entry distance tn in
// *tn_out, and whether the ray enters the box at or below `lim`. tn's zero
// sign may differ from the plain version's (min_nan, max_nan); every caller
// only compares it, but phase 1 also stores it.
__device__ __forceinline__ bool slab_enter(float t1x, float t2x, float t1y,
                                           float t2y, float t1z, float t2z,
                                           float lim, float* tn_out) {
  const float tn = max_nan(max_nan(min_nan(t1x, t2x), min_nan(t1y, t2y)),
                           min_nan(t1z, t2z));
  const float tf = min_nan(min_nan(max_nan(t1x, t2x), max_nan(t1y, t2y)),
                           max_nan(t1z, t2z));
  *tn_out = tn;
  return (tf >= tn) && (tf >= 0.0f) && (tn <= lim);
}

// Slab entry test of one box [min3 | max3] at box[0..5], multiplying by the
// safe reciprocal (K3, K5).
__device__ __forceinline__ bool slab_entry(const float* __restrict__ box,
                                           const Ray& r, float lim,
                                           float* tn_out) {
  return slab_enter((box[0] - r.ox) * r.ix, (box[3] - r.ox) * r.ix,
                    (box[1] - r.oy) * r.iy, (box[4] - r.oy) * r.iy,
                    (box[2] - r.oz) * r.iz, (box[5] - r.oz) * r.iz, lim,
                    tn_out);
}

// The same test dividing by the direction (K4, K6 and their phase 1), on a
// box [min3, max3] held as six floats: a zero component gives +-inf or NaN,
// and a NaN box rejects every lane.
__device__ __forceinline__ bool slab_entry_div(float x0, float y0, float z0,
                                               float x1, float y1, float z1,
                                               const Ray& r, float lim,
                                               float* tn_out) {
  return slab_enter((x0 - r.ox) / r.dx, (x1 - r.ox) / r.dx,
                    (y0 - r.oy) / r.dy, (y1 - r.oy) / r.dy,
                    (z0 - r.oz) / r.dz, (z1 - r.oz) / r.dz, lim, tn_out);
}

// Möller-Trumbore with EPSILON = 1e-6 (pt.wgsl:123-157) against one triangle
// [v0, e1, e2]; returns whether the hit is valid, its distance in *t_out.
__device__ __forceinline__ bool moller_trumbore(
    const Ray& r, float v0x, float v0y, float v0z, float e1x, float e1y,
    float e1z, float e2x, float e2y, float e2z, float* t_out) {
  const float kEpsilon = static_cast<float>(1e-6);
  const float hx = r.dy * e2z - r.dz * e2y;
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const float f = 1.0f / a;
  const float sx = r.ox - v0x;
  const float sy = r.oy - v0y;
  const float sz = r.oz - v0z;
  const float u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  const float t = f * (e2x * qx + e2y * qy + e2z * qz);
  *t_out = t;
  return (fabsf(a) >= kEpsilon) && (u >= 0.0f) && (u <= 1.0f) &&
         (v >= 0.0f) && (u + v <= 1.0f) && (t > kEpsilon);
}

// moller_trumbore with early exits, for a triangle read as three 16-byte
// rows a = [v0, e1.x], b = [e1.y, e1.z, e2.x, e2.y], e = [e2.z, ...] (K1's
// shared tile, K3's leaf records): the same terms in the same order, so the
// same t on a valid hit, but a triangle stops at the first test it fails
// (|a| < EPSILON, then u outside [0, 1], then v), each of which the full
// test's `valid` also rejects; a NaN fails its compare in both. Returns t
// on a valid hit and NaN otherwise, so that the caller's `t < best` is its
// whole test (a bool carried out of the exits cost byte moves on every
// pair: PERF.md).
__device__ __forceinline__ float mt_early(const Ray& r, const float4& a,
                                          const float4& b, const float4& e) {
  const float kEpsilon = static_cast<float>(1e-6);
  const float v0x = a.x, v0y = a.y, v0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = e.x;
  const float hx = r.dy * e2z - r.dz * e2y;
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * hx + e1y * hy + e1z * hz;
  if (!(fabsf(det) >= kEpsilon)) return CUDART_NAN_F;
  const float f = 1.0f / det;
  const float sx = r.ox - v0x;
  const float sy = r.oy - v0y;
  const float sz = r.oz - v0z;
  const float u = f * (sx * hx + sy * hy + sz * hz);
  if (!((u >= 0.0f) && (u <= 1.0f))) return CUDART_NAN_F;
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  if (!((v >= 0.0f) && (u + v <= 1.0f))) return CUDART_NAN_F;
  const float t = f * (e2x * qx + e2y * qy + e2z * qz);
  return t > kEpsilon ? t : CUDART_NAN_F;
}

// The leaf table of accel/bvh8.py: groups of kGroupRows rows of kLanes
// floats; rows 0..8 hold [v0, e1, e2] by slot, row 9 the global triangle
// index (-1 on a padding slot), rows kSubRow.. the sub-cluster boxes.
constexpr int kLanes = 128;      // accel/bvh8.py LEAF_SLOTS
constexpr int kSub = 16;         // accel/bvh8.py SUB
constexpr int kSubW = kLanes / kSub;
constexpr int kGroupRows = 32;   // accel/bvh8.py group_rows(SUB)
constexpr int kSubRow = 16;      // first sub-cluster box row of a group

// Möller-Trumbore over the kSubW slots of sub-cluster c of a leaf group: the
// least t, ties to the lowest triangle index. Leaves (inf, INT_MAX) when no
// slot is hit.
__device__ __forceinline__ void mt_subcluster(const float* __restrict__ group,
                                              int c, const Ray& r,
                                              float* t_out, int* idx_out) {
  float sub_t = CUDART_INF_F;
  int sub_i = 0x7fffffff;
  for (int k = c * kSubW; k < (c + 1) * kSubW; ++k) {
    const float gidx = group[9 * kLanes + k];
    float t;
    const bool valid =
        moller_trumbore(r, group[0 * kLanes + k], group[1 * kLanes + k],
                        group[2 * kLanes + k], group[3 * kLanes + k],
                        group[4 * kLanes + k], group[5 * kLanes + k],
                        group[6 * kLanes + k], group[7 * kLanes + k],
                        group[8 * kLanes + k], &t) &&
        (gidx >= 0.0f);
    const int gi = static_cast<int>(gidx);
    if (valid && (t < sub_t || (t == sub_t && gi < sub_i))) {
      sub_t = t;
      sub_i = gi;
    }
  }
  *t_out = sub_t;
  *idx_out = sub_i;
}

// cp.async of 16 bytes from global to shared memory (K4, K6), its commit
// group, and the wait for every group this thread committed.
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The epilogue every intersector shares (ops/blocks.py finish).
__device__ __forceinline__ void store_hit(float* __restrict__ t_out,
                                          int* __restrict__ idx_out, int i,
                                          float best_t, int best_i,
                                          int num_tris, bool live) {
  if (num_tris >= 0 && best_i >= num_tris) best_i = -1;
  if (!isfinite(best_t)) best_i = -1;
  if (!live) {
    best_t = CUDART_INF_F;
    best_i = -1;
  }
  t_out[i] = best_t;
  idx_out[i] = best_i;
}

}  // namespace wpt
