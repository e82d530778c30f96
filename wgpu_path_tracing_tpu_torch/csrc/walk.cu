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

#include "isect.cuh"

namespace {

using namespace wpt;  // the slab test, Möller-Trumbore and the leaf layout

constexpr int kThreads = 256;
constexpr int kWidth = 8;        // accel/bvh8.py WIDTH
constexpr int kOctants = 8;      // accel/bvh8.py OCTANTS
constexpr int kMaxStack = 256;   // ops/walk.py STACK_MAX; the wrapper checks
                                 // the tree's need against it

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
  const Ray r = load_ray(ro, rd, n, i);
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
      float sub_t;
      int sub_i;
      mt_subcluster(group, c, r, &sub_t, &sub_i);
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

  store_hit(t_out, idx_out, i, best_t, best_i, num_tris, live);
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
