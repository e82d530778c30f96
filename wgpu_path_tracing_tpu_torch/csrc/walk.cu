// K3: closest or any hit through the 8-wide BVH (accel/bvh8.py tables).
//
// Replaces the TPU kernel wgpu_path_tracing_tpu/ops/walk.py::_walk_kernel
// (entered through closest_hit_walk). That kernel walks one DFS stack per
// block of 2048 rays in the block's majority octant, with the stack in
// SMEM, the tables resident in VMEM (or a paged DMA ring), two pops per
// iteration and 16-bit quantised stack keys, all to fit a vector unit that
// has no per-lane control flow. Here one thread owns one ray and walks the
// tree on its own stack in local memory, the shape of the reference's
// traverseBVH (pt.wgsl:248-296): no block union, no quantisation, no
// residency gates. The only scene-size limit is the card's memory.
//
// Bound on the H100: latency of dependent table loads. Each visit reads one
// 8-row box slab (256 B) or one leaf group's sub-box rows and 8-slot
// columns (a group is 16 KB) through L1/L2, then does about 60 flops per
// box test and 55 per triangle. Neighbouring threads hold neighbouring
// camera rays, so their paths and loads largely coincide; bounce rays
// diverge. This first version keeps the walk simple and right: the stack
// entry is 8 bytes (node, entry distance), the tables are read directly.
//
// Per-ray semantics (ops/walk.py, where the plain version follows the same
// steps term for term, so the two agree bit for bit on the card):
// - limit = t_max (or inf) on an active lane, -inf on an inactive one;
// - 1/d with a zero component replaced by 1e-30;
// - the octant is the ray's own direction sign bits; slots 0..7 of
//   walk_order[n, oct*8 + k] are pushed in order (slot 7, the nearest,
//   pops first); empty slots (meta 0, NaN boxes) are skipped;
// - a child is entered when tf >= tn && tf >= 0 && tn <= limit, with min
//   and max that propagate NaN as torch.minimum / torch.maximum do (CUDA's
//   fminf / fmaxf drop it);
// - a popped entry whose entry distance is above the live limit is dropped;
// - a leaf group's 16 sub-cluster boxes are gated against the limit at the
//   visit's start; each entered sub-cluster runs Möller-Trumbore over its
//   8 slots (least t, ties to the lowest index; padding slots have index
//   -1), and merges into the best hit with a strict <;
// - after a leaf visit the limit becomes min(best t, limit), or, with
//   any_hit, the lane stops once its best t is below its limit;
// - the output clears idx >= num_tris, non-finite t and inactive lanes.
//
// The library is compiled with -fmad=false and without --use_fast_math, so
// every product, sum and IEEE division rounds as PyTorch's separate
// elementwise kernels round them.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWidth = 8;        // accel/bvh8.py WIDTH
constexpr int kOctants = 8;      // accel/bvh8.py OCTANTS
constexpr int kLanes = 128;      // accel/bvh8.py LEAF_SLOTS
constexpr int kSub = 16;         // accel/bvh8.py SUB
constexpr int kSubW = kLanes / kSub;
constexpr int kGroupRows = 32;   // accel/bvh8.py group_rows(SUB)
constexpr int kSubRow = 16;      // first sub-cluster box row of a group
constexpr int kMaxStack = 256;   // ops/walk.py STACK_MAX; the wrapper checks
                                 // the tree's need against it

// torch.minimum / torch.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b > a ? b : a;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Slab entry test of one box row [min3 | max3] at box[0..5].
__device__ __forceinline__ bool slab_entry(const float* __restrict__ box,
                                           const Ray& r, float lim,
                                           float* tn_out) {
  const float t1x = (box[0] - r.ox) * r.ix;
  const float t2x = (box[3] - r.ox) * r.ix;
  const float t1y = (box[1] - r.oy) * r.iy;
  const float t2y = (box[4] - r.oy) * r.iy;
  const float t1z = (box[2] - r.oz) * r.iz;
  const float t2z = (box[5] - r.oz) * r.iz;
  const float tn = nan_max(nan_max(nan_min(t1x, t2x), nan_min(t1y, t2y)),
                           nan_min(t1z, t2z));
  const float tf = nan_min(nan_min(nan_max(t1x, t2x), nan_max(t1y, t2y)),
                           nan_max(t1z, t2z));
  *tn_out = tn;
  return (tf >= tn) && (tf >= 0.0f) && (tn <= lim);
}

struct Entry {
  int node;  // >= 0 interior wide node, < 0 leaf group -(g + 1)
  float tn;  // entry distance at push time
};

__global__ void walk_kernel(const int* __restrict__ order,
                            const float* __restrict__ boxes,
                            const float* __restrict__ tris,
                            const float* __restrict__ ro,
                            const float* __restrict__ rd,
                            const bool* __restrict__ active,
                            const float* __restrict__ t_max,
                            float* __restrict__ t_out,
                            int* __restrict__ idx_out, int n, int num_tris,
                            int any_hit) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float kEpsilon = static_cast<float>(1e-6);
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
  const bool live = active == nullptr || active[i];
  const float lim0 =
      live ? (t_max == nullptr ? CUDART_INF_F : t_max[i]) : -CUDART_INF_F;
  const int oct = (r.dx < 0.0f ? 1 : 0) + (r.dy < 0.0f ? 2 : 0) +
                  (r.dz < 0.0f ? 4 : 0);

  float best_t = CUDART_INF_F;
  int best_i = -1;
  float lim = lim0;
  Entry stack[kMaxStack];
  int sp = 1;
  stack[0] = Entry{0, 0.0f};  // the root

  while (sp > 0) {
    const Entry e = stack[--sp];
    if (e.tn > lim) continue;  // pop-time culling
    if (e.node >= 0) {
      const int* metas = order + static_cast<size_t>(e.node) * kOctants *
                                     kWidth + oct * kWidth;
      const float* slab =
          boxes + (static_cast<size_t>(e.node) * kOctants + oct) * kWidth * 8;
      for (int k = 0; k < kWidth; ++k) {
        const int m = metas[k];
        if (m == 0) continue;  // empty slot: NaN box
        float tn;
        if (!slab_entry(slab + k * 8, r, lim, &tn)) continue;
        if (sp < kMaxStack) stack[sp++] = Entry{m, tn};
      }
      continue;
    }
    const float* group =
        tris + static_cast<size_t>(-e.node - 1) * kGroupRows * kLanes;
    const float gate_lim = lim;
    for (int c = 0; c < kSub; ++c) {
      float tn;
      if (!slab_entry(group + (kSubRow + c) * kLanes, r, gate_lim, &tn))
        continue;
      float sub_t = CUDART_INF_F;
      int sub_i = 0x7fffffff;
      for (int k = c * kSubW; k < (c + 1) * kSubW; ++k) {
        const float gidx = group[9 * kLanes + k];
        const float v0x = group[0 * kLanes + k];
        const float v0y = group[1 * kLanes + k];
        const float v0z = group[2 * kLanes + k];
        const float e1x = group[3 * kLanes + k];
        const float e1y = group[4 * kLanes + k];
        const float e1z = group[5 * kLanes + k];
        const float e2x = group[6 * kLanes + k];
        const float e2y = group[7 * kLanes + k];
        const float e2z = group[8 * kLanes + k];
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
        const bool valid = (fabsf(a) >= kEpsilon) && (u >= 0.0f) &&
                           (u <= 1.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
                           (t > kEpsilon) && (gidx >= 0.0f);
        const int gi = static_cast<int>(gidx);
        if (valid && (t < sub_t || (t == sub_t && gi < sub_i))) {
          sub_t = t;
          sub_i = gi;
        }
      }
      if (sub_t < best_t) {
        best_t = sub_t;
        best_i = sub_i;
      }
    }
    if (any_hit) {
      if (best_t < lim0) break;
    } else {
      lim = nan_min(best_t, lim0);
    }
  }

  if (num_tris >= 0 && best_i >= num_tris) best_i = -1;
  if (!isfinite(best_t)) best_i = -1;
  if (!live) {
    best_t = CUDART_INF_F;
    best_i = -1;
  }
  t_out[i] = best_t;
  idx_out[i] = best_i;
}

}  // namespace

extern "C" int wpt_walk(const void* order, const void* boxes,
                        const void* tris, const void* ro, const void* rd,
                        const void* active, const void* t_max, void* t_out,
                        void* idx_out, int n, int num_tris, int any_hit,
                        void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  walk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(order), static_cast<const float*>(boxes),
      static_cast<const float*>(tris), static_cast<const float*>(ro),
      static_cast<const float*>(rd), static_cast<const bool*>(active),
      static_cast<const float*>(t_max), static_cast<float*>(t_out),
      static_cast<int*>(idx_out), n, num_tris, any_hit);
  return static_cast<int>(cudaGetLastError());
}
