// K3: closest or any hit through the wide BVH (accel/bvh8.py tables), at
// width 8 (wpt_walk, walk_kernel: a ray a thread, the design below) and 16
// (wpt_walk16 on the tables of build_wide_bvh(width=16), team_walk_kernel:
// a team of lanes a ray, described where it is defined).
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
//   nodes at width 8, which the wrapper checks); the
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

// ---------------------------------------------------------------------------
// K3-w16: the width-16 walk, a team of kTeam lanes a ray.
//
// A 16-wide node is a half-warp's worth of children, and a leaf group holds
// 16 sub-boxes: so kTeam lanes walk one ray together, lane j owning child
// slots j, j + kTeam, ... (kSlots of them) of the node being walked and
// sub-box j, j + kTeam, ... of a leaf. Every decision (the mask, the
// stack, the limit, the best hit) is the same on all the team's lanes, so
// the team's control flow is uniform and each *_sync names its lanes only;
// the two or four teams of a warp follow their own rays.
// - Interior visit: one coalesced team read of the node's metas (64 B) and
//   boxes (512 B); each lane runs box_entry on its slots, and a ballot of
//   the team gives interior_mask<16>'s bits. Each lane keeps its slots'
//   meta and entry distance in registers, so the pop-time cull and the
//   child's id are shuffles from the slot's lane, not a reload.
// - Pops keep walk_kernel's order: k = 31 - clz(mask), highest slot first,
//   a LIFO stack, the cull tn > lim against the live limit.
// - The stack is one a team in shared memory, an entry a tree level below
//   the root: each lane's slots' metas (0 for a slot no longer pending, so
//   that a ballot gives the entry's mask back) and entry distances.
// - Leaf visit: lane j gates sub-box j (and j + kTeam), a ballot gives the
//   gate; the entered sub-clusters go kPair at a time, one to each group of
//   kSubW lanes, one triangle slot a lane, through mt_early term for term;
//   each group's (t, index) is reduced by shuffles with mt_records' rule
//   (least t, ties to the lowest index, padding -1 and NaN no hit), and the
//   groups merge into the best hit in ascending sub-cluster with a strict
//   <, as walk_kernel's serial loop does; a pass in which no lane's t is
//   below the best hit skips the reduction (it could change nothing).
// Bound on the H100 by instruction issue and by the latency of each step's
// dependent loads (PERF.md); the per-ray semantics are walk_kernel's above.
constexpr int kTeam = 16;                    // lanes a ray
constexpr int kSlots = kWideWidth / kTeam;   // child slots a lane
constexpr int kTeams = kThreads / kTeam;     // rays a block
constexpr int kGates = kSub / kTeam;         // sub-boxes a lane gates
constexpr int kPair = kTeam / kSubW;         // sub-clusters tested at once
static_assert(kTeam == 8 || kTeam == 16, "a team is 8 or 16 lanes");

// The team's bits of a ballot over the warp, in its lanes' order.
__device__ __forceinline__ unsigned team_ballot(unsigned tmask, int base,
                                                bool pred) {
  return (__ballot_sync(tmask, pred) >> base) & ((1u << kTeam) - 1u);
}

// The children of interior node `node` that the ray enters, as
// interior_mask<16> gives them: bit k for slot k. Lane j's slots' metas and
// entry distances go to meta[] and tn[].
__device__ __forceinline__ unsigned team_interior(
    const int* __restrict__ order, const float4* __restrict__ boxes,
    int node, int oct, const Ray& r, float lim, int lane, unsigned tmask,
    int base, int (&meta)[kSlots], float (&tn)[kSlots]) {
  const size_t row = (static_cast<size_t>(node) * kOctants + oct) *
                     kWideWidth;
  unsigned mask = 0;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int k = s * kTeam + lane;
    meta[s] = order[row + k];
    const bool enter = box_entry(boxes + (row + k) * 2, r, lim, &tn[s]);
    mask |= team_ballot(tmask, base, meta[s] != 0 && enter) << (s * kTeam);
  }
  return mask;
}

// mt_records' (t, index) rule as a total order: a strictly below b.
__device__ __forceinline__ bool hit_below(float ta, int ia, float tb,
                                          int ib) {
  return ta < tb || (ta == tb && ia < ib);
}

__global__ void __launch_bounds__(kThreads)
    team_walk_kernel(const int* __restrict__ order,
                     const float4* __restrict__ boxes,
                     const float4* __restrict__ leaves,
                     const float* __restrict__ ro,
                     const float* __restrict__ rd,
                     const bool* __restrict__ active,
                     const float* __restrict__ t_max,
                     float* __restrict__ t_out, int* __restrict__ idx_out,
                     int n, int num_tris, int any_hit, int levels) {
  // Entry e of team t's stack, slot k: [(e * kTeams + t) * 16 + k] of the
  // metas, then of the entry distances.
  extern __shared__ int stack_meta[];
  float* stack_tn =
      reinterpret_cast<float*>(stack_meta + levels * kTeams * kWideWidth);
  const int lane = threadIdx.x & (kTeam - 1);
  const int team = threadIdx.x / kTeam;
  const int base = threadIdx.x & 31 & ~(kTeam - 1);
  const unsigned tmask = ((1u << kTeam) - 1u) << base;
  const int i = blockIdx.x * kTeams + team;
  if (i >= n) return;  // the whole team: it shares i
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
  int meta[kSlots];
  float tn[kSlots];
  unsigned mask = 0;  // the root, entered at distance 0
  if (!(0.0f > lim))
    mask = team_interior(order, boxes, 0, oct, r, lim, lane, tmask, base,
                         meta, tn);

  while (true) {
    if (mask == 0) {
      if (sp == 0) break;
      --sp;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int at = (sp * kTeams + team) * kWideWidth + s * kTeam + lane;
        meta[s] = stack_meta[at];
        tn[s] = stack_tn[at];
        mask |= team_ballot(tmask, base, meta[s] != 0) << (s * kTeam);
      }
    }
    const int k = 31 - __clz(mask);
    mask &= ~(1u << k);
    int mk = meta[0];
    float tk = tn[0];
#pragma unroll
    for (int s = 1; s < kSlots; ++s) {
      if (k / kTeam == s) {
        mk = meta[s];
        tk = tn[s];
      }
    }
    const int m = __shfl_sync(tmask, mk, k & (kTeam - 1), kTeam);
    if (__shfl_sync(tmask, tk, k & (kTeam - 1), kTeam) > lim)
      continue;  // culled on the live limit
    if (m > 0) {
      int cmeta[kSlots];
      float ctn[kSlots];
      const unsigned inner = team_interior(order, boxes, m, oct, r, lim,
                                           lane, tmask, base, cmeta, ctn);
      if (inner != 0) {
        if (mask != 0) {
#pragma unroll
          for (int s = 0; s < kSlots; ++s) {
            const int slot = s * kTeam + lane;
            const int at = (sp * kTeams + team) * kWideWidth + slot;
            stack_meta[at] = (mask >> slot) & 1u ? meta[s] : 0;
            stack_tn[at] = tn[s];
          }
          ++sp;
        }
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          meta[s] = cmeta[s];
          tn[s] = ctn[s];
        }
        mask = inner;
      }
      continue;
    }
    const float4* leaf =
        leaves + static_cast<size_t>(-m - 1) * (kLeafFloats / 4);
    unsigned gate = 0;
#pragma unroll
    for (int s = 0; s < kGates; ++s) {
      float sub_tn;
      const bool enter = box_entry(leaf + 2 * (s * kTeam + lane), r, lim,
                                   &sub_tn);
      gate |= team_ballot(tmask, base, enter) << (s * kTeam);
    }
    const float4* tris = leaf + kSub * kBoxFloats / 4;
    const int group = lane / kSubW;  // which of the kPair sub-clusters
    while (gate != 0) {
      // The next kPair entered sub-clusters in ascending order; -1 where
      // the gate runs out.
      int c = -1;
#pragma unroll
      for (int q = 0; q < kPair; ++q) {
        const int cq = gate != 0 ? __ffs(gate) - 1 : -1;
        gate &= gate - 1;
        if (group == q) c = cq;
      }
      float t = CUDART_INF_F;
      int gi = 0x7fffffff;
      if (c >= 0) {
        const float4* p = tris + (c * kSubW + (lane & (kSubW - 1))) * 3;
        const float4 a = p[0];
        const float4 b = p[1];
        const float4 e = p[2];
        if (e.y >= 0.0f) {
          const float tt = mt_early(r, a, b, e);  // NaN where no hit
          if (tt == tt) {
            t = tt;
            gi = static_cast<int>(e.y);
          }
        }
      }
      // Only a t below the best hit can change it (the merge's strict <):
      // most passes hold none, and skip the reduction.
      if (__ballot_sync(tmask, t < best_t) == 0) continue;
#pragma unroll
      for (int off = kSubW / 2; off > 0; off /= 2) {
        const float to = __shfl_xor_sync(tmask, t, off);
        const int io = __shfl_xor_sync(tmask, gi, off);
        if (hit_below(to, io, t, gi)) {
          t = to;
          gi = io;
        }
      }
#pragma unroll
      for (int q = 0; q < kPair; ++q) {
        const float tq = __shfl_sync(tmask, t, q * kSubW, kTeam);
        const int iq = __shfl_sync(tmask, gi, q * kSubW, kTeam);
        if (tq < best_t) {
          best_t = tq;
          best_i = iq;
        }
      }
    }
    if (any_hit) {
      if (best_t < lim0) break;
    } else {
      lim = nan_min(best_t, lim0);
    }
  }

  if (lane == 0) store_hit(t_out, idx_out, i, best_t, best_i, num_tris, live);
}

int launch_team_walk(const void* order, const void* boxes,
                     const void* leaves, const void* ro, const void* rd,
                     const void* active, const void* t_max, void* t_out,
                     void* idx_out, int n, int num_tris, int any_hit,
                     int levels, void* stream) {
  const size_t shared = static_cast<size_t>(levels) * kTeams * kWideWidth *
                        (sizeof(int) + sizeof(float));
  if (shared > kDefaultShared) {
    const cudaError_t err = cudaFuncSetAttribute(
        team_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n + kTeams - 1) / kTeams;
  team_walk_kernel<<<blocks, kThreads, shared,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(order), static_cast<const float4*>(boxes),
      static_cast<const float4*>(leaves), static_cast<const float*>(ro),
      static_cast<const float*>(rd), static_cast<const bool*>(active),
      static_cast<const float*>(t_max), static_cast<float*>(t_out),
      static_cast<int*>(idx_out), n, num_tris, any_hit, levels);
  return static_cast<int>(cudaGetLastError());
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
  return launch_team_walk(order, boxes, leaves, ro, rd, active, t_max, t_out,
                          idx_out, n, num_tris, any_hit, levels, stream);
}
