// K3: closest or any hit through the wide BVH (accel/bvh8.py tables), at
// width 8 (wpt_walk) and 16 (wpt_walk16, the tables of
// build_wide_bvh(width=16)): the fan-out W is a template parameter.
//
// Replaces the TPU kernel wgpu_path_tracing_tpu/ops/walk.py::_walk_kernel
// (entered through closest_hit_walk, which infers its width from the order
// table, walk.py:684, as ops/walk.py does here). That kernel walks one DFS stack per
// block of 2048 rays in the block's majority octant, with the stack in
// SMEM, the tables resident in VMEM (or a paged DMA ring), two pops per
// iteration and 16-bit quantised stack keys, all to fit a vector unit that
// has no per-lane control flow. Here one thread owns one ray and walks the
// tree on its own, the shape of the reference's traverseBVH
// (pt.wgsl:248-296): no block union, no quantisation, no residency gates.
// The only scene-size limit is the card's memory.
//
// Bound on the H100 by instruction issue, then by the divergent lanes of a
// warp and the serial walk of the slowest rays; 9-26x its operation bound
// (PERF.md). The design:
// - Records shaped for 16-byte loads (ops/walk.py::leaf_records): a leaf
//   group is 16 sub-box records of 32 B, [min3, max3, 0, 0], then 128
//   triangle records of 48 B, [v0, e1, e2, index, 0, 0], so a sub-box is two
//   float4 loads and a triangle three; an interior node's W metas are W/4
//   int4 (two at width 8, four at 16) and each child box (a 32-B row of
//   walk_boxes) two float4.
// - A stack of one entry a tree level (Ylitie, Karras and Laine, HPG 2017),
//   in shared memory: an interior visit makes one entry, node << W | the
//   W-bit mask of the children it entered, in 32 bits (so at most 2^24
//   nodes at width 8 and 65,536 at width 16, which the wrapper checks); the
//   node being walked stays in registers and the entries of its ancestors
//   that still hold children go to shared memory, fewer than the tree's
//   depth (the wrapper sizes it from the tree's own depth). No local
//   memory.
// - The slab test's 12 NaN-propagating min and max are one PTX instruction
//   each (isect.cuh's slab_enter, which K4, K5, K6 and their phase 1
//   share); the 16 sub-box gates of a leaf visit are unrolled, and so are a
//   sub-cluster's 8 Möller-Trumbore tests, each of which stops at the first
//   condition it fails.
// - The wrapper sorts bounce rays into direction-octant x origin buckets
//   (ops/intersect.py::with_ray_order), so a warp holds rays with similar
//   paths.
//
// Per-ray semantics (ops/walk.py, where the plain version follows the same
// steps term for term, so the two agree bit for bit on the card):
// - limit = t_max (or inf) on an active lane, -inf on an inactive one;
// - 1/d with a zero component replaced by 1e-30;
// - the octant is the ray's own direction sign bits; slots 0..W-1 of
//   walk_order[n, oct*W + k] are taken nearest first, slot W-1 first, as a
//   LIFO stack that pushed them in order pops them; empty slots (meta 0,
//   NaN boxes) are skipped;
// - a child is entered when tf >= tn && tf >= 0 && tn <= limit, with min
//   and max that propagate NaN as torch.minimum / torch.maximum do (CUDA's
//   fminf / fmaxf drop it);
// - a child taken from its parent's mask whose entry distance is above the
//   live limit is dropped; the distance is computed again from the same box
//   by the same slab test, so it has the bits the plain version stored;
// - a leaf group's 16 sub-cluster boxes are gated against the limit at the
//   visit's start; each entered sub-cluster runs Möller-Trumbore over its
//   8 slots (least t, ties to the lowest index; padding slots have index
//   -1 and come last in a group), and merges into the best hit with a
//   strict <;
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

using namespace wpt;  // the slab test, Möller-Trumbore, the leaf layout

constexpr int kThreads = 256;
constexpr int kWidth = 8;        // accel/bvh8.py WIDTH
constexpr int kWideWidth = 16;   // accel/bvh8.py WIDTHS[1]
constexpr int kOctants = 8;      // accel/bvh8.py OCTANTS
constexpr int kBoxFloats = 8;    // a child box or sub-box record
constexpr int kTriFloats = 12;   // a triangle record
constexpr int kLeafFloats = kSub * kBoxFloats + kLanes * kTriFloats;
constexpr int kDefaultShared = 48 * 1024;  // dynamic shared memory without
                                           // the opt-in attribute

// Slab test of the box record at p ([min3, max3, 0, 0], two float4): the
// terms of isect.cuh's slab_entry in the same order, and its slab_enter.
__device__ __forceinline__ bool box_entry(const float4* __restrict__ p,
                                          const Ray& r, float lim,
                                          float* tn_out) {
  const float4 a = p[0];
  const float4 b = p[1];
  return slab_enter((a.x - r.ox) * r.ix, (a.w - r.ox) * r.ix,
                    (a.y - r.oy) * r.iy, (b.x - r.oy) * r.iy,
                    (a.z - r.oz) * r.iz, (b.y - r.oz) * r.iz, lim, tn_out);
}

// The children of interior node `node` that the ray enters: bit k for slot
// k of the octant's order.
template <int W>
__device__ __forceinline__ unsigned interior_mask(
    const int* __restrict__ order, const float4* __restrict__ boxes,
    int node, int oct, const Ray& r, float lim) {
  const int4* m4 = reinterpret_cast<const int4*>(
      order + (static_cast<size_t>(node) * kOctants + oct) * W);
  int metas[W];
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const int4 v = m4[q];
    metas[4 * q] = v.x;
    metas[4 * q + 1] = v.y;
    metas[4 * q + 2] = v.z;
    metas[4 * q + 3] = v.w;
  }
  const float4* slab =
      boxes + (static_cast<size_t>(node) * kOctants + oct) * W * 2;
  unsigned mask = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    float tn;
    if (metas[k] != 0 && box_entry(slab + 2 * k, r, lim, &tn))
      mask |= 1u << k;
  }
  return mask;
}

// Möller-Trumbore over sub-cluster c of a leaf group's records: the least
// t, ties to the lowest triangle index. Leaves (inf, INT_MAX) when no slot
// is hit. Unrolled, so the 24 loads issue together; a padding slot (index
// -1) is no hit.
__device__ __forceinline__ void mt_records(const float4* __restrict__ tris,
                                           int c, const Ray& r, float* t_out,
                                           int* idx_out) {
  float sub_t = CUDART_INF_F;
  int sub_i = 0x7fffffff;
  const float4* p = tris + c * kSubW * 3;
#pragma unroll
  for (int k = 0; k < kSubW; ++k) {
    const float4 a = p[3 * k];
    const float4 b = p[3 * k + 1];
    const float4 e = p[3 * k + 2];
    const float gidx = e.y;
    if (gidx >= 0.0f) {
      const float t = mt_early(r, a, b, e);  // NaN where there is no hit
      const int gi = static_cast<int>(gidx);
      if (t < sub_t || (t == sub_t && gi < sub_i)) {
        sub_t = t;
        sub_i = gi;
      }
    }
  }
  *t_out = sub_t;
  *idx_out = sub_i;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    walk_kernel(const int* __restrict__ order,
                const float4* __restrict__ boxes,
                const float4* __restrict__ leaves,
                const float* __restrict__ ro, const float* __restrict__ rd,
                const bool* __restrict__ active,
                const float* __restrict__ t_max, float* __restrict__ t_out,
                int* __restrict__ idx_out, int n, int num_tris, int any_hit) {
  // Entry j of this thread's stack at stack[j * kThreads + threadIdx.x]:
  // node << W | the mask of its children still to take.
  constexpr unsigned kMask = (1u << W) - 1u;
  extern __shared__ unsigned stack[];
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
  int sp = 0;
  int node = 0;  // the root, entered at distance 0
  unsigned mask =
      0.0f > lim ? 0u : interior_mask<W>(order, boxes, 0, oct, r, lim);

  while (true) {
    if (mask == 0) {
      if (sp == 0) break;
      const unsigned e = stack[--sp * kThreads + threadIdx.x];
      node = static_cast<int>(e >> W);
      mask = e & kMask;
    }
    const int k = 31 - __clz(mask);
    mask &= ~(1u << k);
    const size_t row = (static_cast<size_t>(node) * kOctants + oct) * W;
    const int m = order[row + k];
    float tn;
    box_entry(boxes + (row + k) * 2, r, lim, &tn);
    if (tn > lim) continue;  // culled on the live limit
    if (m > 0) {
      const unsigned inner = interior_mask<W>(order, boxes, m, oct, r, lim);
      if (inner != 0) {
        if (mask != 0)
          stack[sp++ * kThreads + threadIdx.x] =
              (static_cast<unsigned>(node) << W) | mask;
        node = m;
        mask = inner;
      }
      continue;
    }
    const float4* leaf =
        leaves + static_cast<size_t>(-m - 1) * (kLeafFloats / 4);
    unsigned gate = 0;
#pragma unroll
    for (int c = 0; c < kSub; ++c) {
      float sub_tn;
      if (box_entry(leaf + 2 * c, r, lim, &sub_tn)) gate |= 1u << c;
    }
    const float4* tris = leaf + kSub * kBoxFloats / 4;
    while (gate != 0) {
      const int c = __ffs(gate) - 1;
      gate &= gate - 1;
      float sub_t;
      int sub_i;
      mt_records(tris, c, r, &sub_t, &sub_i);
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

// levels: stack entries a thread (ops/walk.py::WalkTables.levels).
template <int W>
int launch_walk(const void* order, const void* boxes, const void* leaves,
                const void* ro, const void* rd, const void* active,
                const void* t_max, void* t_out, void* idx_out, int n,
                int num_tris, int any_hit, int levels, void* stream) {
  const size_t shared = static_cast<size_t>(levels) * kThreads *
                        sizeof(unsigned);
  if (shared > kDefaultShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        walk_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  walk_kernel<W><<<blocks, kThreads, shared,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(order), static_cast<const float4*>(boxes),
      static_cast<const float4*>(leaves), static_cast<const float*>(ro),
      static_cast<const float*>(rd), static_cast<const bool*>(active),
      static_cast<const float*>(t_max), static_cast<float*>(t_out),
      static_cast<int*>(idx_out), n, num_tris, any_hit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int wpt_walk(const void* order, const void* boxes,
                        const void* leaves, const void* ro, const void* rd,
                        const void* active, const void* t_max, void* t_out,
                        void* idx_out, int n, int num_tris, int any_hit,
                        int levels, void* stream) {
  return launch_walk<kWidth>(order, boxes, leaves, ro, rd, active, t_max,
                             t_out, idx_out, n, num_tris, any_hit, levels,
                             stream);
}

extern "C" int wpt_walk16(const void* order, const void* boxes,
                          const void* leaves, const void* ro, const void* rd,
                          const void* active, const void* t_max, void* t_out,
                          void* idx_out, int n, int num_tris, int any_hit,
                          int levels, void* stream) {
  return launch_walk<kWideWidth>(order, boxes, leaves, ro, rd, active, t_max,
                                 t_out, idx_out, n, num_tris, any_hit, levels,
                                 stream);
}
