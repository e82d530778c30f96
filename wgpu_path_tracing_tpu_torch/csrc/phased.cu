// K5: the phased flat group dispatch, closest hit over every leaf
// sub-cluster that any ray of the block enters.
//
// Replaces the TPU kernel wgpu_path_tracing_tpu/ops/phased.py::_phased_kernel
// (entered through closest_hit_phased). That kernel is one Pallas grid step
// per block of 2048 rays: phase 1 packs 32 "any lane enters" gate bits into
// each SMEM word over unrolled chunks of the sub-box table, phase 2 is a
// group loop unrolled 8 times that reads the bits back. The packing, the
// unrolling and the padded group count they need are not carried over.
//
// The function (ops/phased.py closest_hit_phased_plain): a sub-cluster is
// gated for a block of bn consecutive rays when any lane of the block enters
// its box under the lane's call-entry limit (t_max or inf on an active lane,
// -inf on an inactive one; the tail lanes of the last block enter nothing).
// Every lane of the block then tests every gated sub-cluster, groups in
// ascending order, a group's sub-clusters in ascending order: inside a
// sub-cluster the least t wins, ties to the lowest triangle index, and it
// replaces the lane's best on a strict <. The gate by ray block is part of
// the function (a lane that does not enter a box itself can still score in
// it through rounding), and nothing tightens the limits along the way.
//
// Bound on the H100 by instruction issue: incoherent rays gate most of the
// scene and each live lane tests it, 55 operations a filled slot, against
// a leaf table read once (PERF.md). The design, two kernels with the gate
// bytes between them:
//
// - gate_kernel: a warp a leaf group and a CTA sixteen groups of one ray
//   block, whose rays are staged once in shared memory (origin, safe
//   reciprocal, limit). An empty sub-cluster's box holds NaN and is entered
//   by no ray: it is never tested. Sweep 1 tests the group's union box
//   against the block's rays, 64 a step, and stops at the first step in
//   which one may enter; a group that no ray may enter skips its sixteen
//   sub-boxes. Sweep 2 tests the group's remaining sub-boxes against 32
//   rays a step, skipping a step in which no ray may enter the union, until
//   each sub-box is entered or the rays run out. The union box (least and
//   greatest corner over the filled sub-boxes) is made in registers,
//   exactly. The pre-test is exact: the slab test's terms (x - o) * (1/d)
//   are monotone in the plane x, so a ray that enters a sub-box has union
//   terms at least as far apart and enters the union too; the one
//   exception is a NaN term (0 x inf, with the origin on a union plane and
//   a subnormal d), which the pre-test counts as a pass. Each lane writes
//   its own gate byte, 0 or 1: no clearing and no atomics.
// - phased_kernel: one thread a ray, a CTA lying inside one ray block, so
//   the CTA shares the block's gates. It compacts the gate bytes of a window
//   of 1,024 sub-clusters into an ascending list in shared memory, then
//   stages the listed sub-clusters' triangle records (16-byte aligned,
//   ops/walk.py leaf_records; three float4 a triangle) sixteen at a time
//   with cp.async into a double buffer: one barrier a batch. Each thread
//   runs isect.cuh's mt_early on the rows, which stops a triangle at the
//   first test it fails and returns t or NaN. 64 registers a thread, four
//   CTAs an SM: at 32 registers it spilled and took 7-16% longer (H100).
// - The tie rule: where every sub-cluster holds its triangles in ascending
//   index order by slot and every padding slot has zero edges (checked once
//   a scene, ops/phased.py slots_ascending), one strict < over the slots in
//   order is exactly the two-level rule; the kOrdered instantiation does
//   that. The other compares indices as the plain version does.
// - Dead lanes idle: an inactive lane's output is (inf, -1) whatever it
//   tests. A CTA packs its live lanes onto its first warps; where they fill
//   fewer warps than it has, the idle warps take copies of them, each copy
//   testing every reps-th staged sub-cluster, and the copies merge (least
//   t, ties to the lowest sub-cluster). A CTA with no live lane only writes
//   its outputs. Dead lanes still vote in the gate, as the function says.
//
// Levers measured and not kept are in PERF.md (section 6, K5).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "isect.cuh"

namespace {

using namespace wpt;

constexpr int kBoxFloats = 8;   // ops/walk.py BOX_FLOATS: [min3, max3, 0, 0]
constexpr int kTriFloats = 12;  // ops/walk.py TRI_FLOATS: [v0, e1, e2, i, 0, 0]
constexpr int kLeaf4 = (kSub * kBoxFloats + kLanes * kTriFloats) / 4;
constexpr int kBoxes4 = kSub * kBoxFloats / 4;  // a record's sub-box float4
constexpr int kSub4 = kSubW * kTriFloats / 4;   // a sub-cluster's triangles

constexpr int kGateWarps = 16;  // leaf groups a gate CTA, one a warp
constexpr int kGateThreads = 32 * kGateWarps;
constexpr int kRayChunk = 2048;  // rays staged at a time: ops/phased.py BN

constexpr int kMaxThreads = 256;  // the test kernel's CTA (at most)
constexpr int kTestBlocks = 4;    // its CTAs an SM: 64 registers a thread
constexpr int kWindow = 1024;     // sub-clusters compacted at a time
constexpr int kBatch = 16;        // sub-clusters staged at a time
constexpr unsigned kFull = 0xffffffffu;

// The gate's rays in (dynamic) shared memory: origin, safe reciprocal of
// the direction, call-entry limit.
struct RayChunk {
  float ox[kRayChunk], oy[kRayChunk], oz[kRayChunk];
  float ix[kRayChunk], iy[kRayChunk], iz[kRayChunk];
  float lim[kRayChunk];
};

struct SlabRay {
  float ox, oy, oz, ix, iy, iz, lim;
};

// Rays [first, first + m) of the call into shared memory (a tail lane past
// n: pad_ray, limit -inf).
__device__ __forceinline__ void stage_rays(RayChunk& s,
                                           const float* __restrict__ ro,
                                           const float* __restrict__ rd,
                                           const float* __restrict__ lim0,
                                           int n, int first, int m) {
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const int i = first + j;
    const bool real = i < n;
    const Ray r = real ? load_ray(ro, rd, n, i) : pad_ray();
    s.ox[j] = r.ox;
    s.oy[j] = r.oy;
    s.oz[j] = r.oz;
    s.ix[j] = r.ix;
    s.iy[j] = r.iy;
    s.iz[j] = r.iz;
    s.lim[j] = real ? lim0[i] : -CUDART_INF_F;
  }
}

__device__ __forceinline__ SlabRay ray_at(const RayChunk& s, int j) {
  return SlabRay{s.ox[j], s.oy[j], s.oz[j], s.ix[j], s.iy[j], s.iz[j],
                 s.lim[j]};
}

// The slab test of box [lo, hi] against a staged ray: isect.cuh's
// slab_entry, term for term. With kMay, the union pre-test: it fails only
// on a comparison that fails for certain, so a NaN term passes.
template <bool kMay>
__device__ __forceinline__ bool box_test(float lx, float ly, float lz,
                                         float hx, float hy, float hz,
                                         const SlabRay& r) {
  const float t1x = (lx - r.ox) * r.ix, t2x = (hx - r.ox) * r.ix;
  const float t1y = (ly - r.oy) * r.iy, t2y = (hy - r.oy) * r.iy;
  const float t1z = (lz - r.oz) * r.iz, t2z = (hz - r.oz) * r.iz;
  if (!kMay) {
    float tn;
    return slab_enter(t1x, t2x, t1y, t2y, t1z, t2z, r.lim, &tn);
  }
  const float tn = max_nan(max_nan(min_nan(t1x, t2x), min_nan(t1y, t2y)),
                           min_nan(t1z, t2z));
  const float tf = min_nan(min_nan(max_nan(t1x, t2x), max_nan(t1y, t2y)),
                           max_nan(t1z, t2z));
  return !(tf < tn) && !(tf < 0.0f) && !(tn > r.lim);
}

// The exact minimum (maximum) over the sixteen sub-boxes of a group, which
// lanes c and c + 16 of its warp both hold.
__device__ __forceinline__ float group_min(float v) {
  for (int off = kSub / 2; off > 0; off >>= 1) {
    v = fminf(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

__device__ __forceinline__ float group_max(float v) {
  for (int off = kSub / 2; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  }
  return v;
}

__global__ void __launch_bounds__(kGateThreads)
gate_kernel(const float4* __restrict__ leaves, const float* __restrict__ ro,
            const float* __restrict__ rd, const float* __restrict__ lim0,
            unsigned char* __restrict__ gates, int n, int bn, int ng) {
  extern __shared__ __align__(16) unsigned char dynamic_smem[];
  RayChunk& s = *reinterpret_cast<RayChunk*>(dynamic_smem);
  __shared__ float4 box_smem[kGateWarps][kSub][2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int g = blockIdx.y * kGateWarps + warp;
  const int c = lane % kSub;
  const bool have = g < ng;  // the same for the whole warp
  float4(&box)[kSub][2] = box_smem[warp];
  // The group's 16 sub-box records [min3, max3, 0, 0], two float4 each.
  reinterpret_cast<float4*>(box)[lane] =
      have ? leaves[static_cast<size_t>(g) * kLeaf4 + lane]
           : make_float4(CUDART_NAN_F, 0.0f, 0.0f, 0.0f);
  __syncwarp();
  const float lx = box[c][0].x, ly = box[c][0].y, lz = box[c][0].z;
  const float hx = box[c][0].w, hy = box[c][1].x, hz = box[c][1].y;
  // A NaN bound (an empty sub-cluster) makes every slab test fail.
  const bool filled = have && !(isnan(lx) || isnan(ly) || isnan(lz) ||
                                isnan(hx) || isnan(hy) || isnan(hz));
  const unsigned filled_mask = __ballot_sync(kFull, filled) & 0xffffu;
  const float ulx = group_min(filled ? fminf(lx, hx) : CUDART_INF_F);
  const float uly = group_min(filled ? fminf(ly, hy) : CUDART_INF_F);
  const float ulz = group_min(filled ? fminf(lz, hz) : CUDART_INF_F);
  const float uhx = group_max(filled ? fmaxf(lx, hx) : -CUDART_INF_F);
  const float uhy = group_max(filled ? fmaxf(ly, hy) : -CUDART_INF_F);
  const float uhz = group_max(filled ? fmaxf(lz, hz) : -CUDART_INF_F);
  const int lane0 = b * bn;

  // Sweep 1: may any ray of the block enter the group's union box? Every
  // condition below is the same across a warp. Two rays a lane a step; a
  // lane past the chunk repeats its last ray, which changes no vote.
  bool pending = filled_mask != 0u;
  bool entered = false;
  for (int base = 0; base < bn; base += kRayChunk) {
    if (!__syncthreads_or(pending)) break;  // also: the chunk is free
    const int m = min(kRayChunk, bn - base);
    stage_rays(s, ro, rd, lim0, n, lane0 + base, m);
    __syncthreads();
    for (int j0 = 0; pending && j0 < m; j0 += 64) {
      const SlabRay r1 = ray_at(s, min(j0 + lane, m - 1));
      const SlabRay r2 = ray_at(s, min(j0 + 32 + lane, m - 1));
      const bool may =
          box_test<true>(ulx, uly, ulz, uhx, uhy, uhz, r1) |
          box_test<true>(ulx, uly, ulz, uhx, uhy, uhz, r2);
      if (__any_sync(kFull, may)) {
        entered = true;
        pending = false;
      }
    }
  }

  // Sweep 2: the filled sub-boxes of an entered group, 32 rays a step
  // against each sub-box not yet entered; a step whose rays all fail the
  // union pre-test enters none of them and is skipped.
  unsigned todo = entered ? filled_mask : 0u;
  unsigned gated = 0u;
  for (int base = 0; base < bn; base += kRayChunk) {
    if (!__syncthreads_or(todo != 0u)) break;
    const int m = min(kRayChunk, bn - base);
    if (bn > kRayChunk) {  // else sweep 1's chunk is still in place
      stage_rays(s, ro, rd, lim0, n, lane0 + base, m);
      __syncthreads();
    }
    for (int j0 = 0; todo != 0u && j0 < m; j0 += 32) {
      const SlabRay r = ray_at(s, min(j0 + lane, m - 1));
      if (!__any_sync(kFull,
                      box_test<true>(ulx, uly, ulz, uhx, uhy, uhz, r))) {
        continue;
      }
      unsigned hit = 0u;
#pragma unroll
      for (int k = 0; k < kSub; ++k) {
        if ((todo >> k) & 1u) {
          const float4 p = box[k][0];
          const float4 q = box[k][1];
          if (box_test<false>(p.x, p.y, p.z, p.w, q.x, q.y, r)) hit |= 1u << k;
        }
      }
      hit = __reduce_or_sync(kFull, hit);
      gated |= hit;
      todo &= ~hit;
    }
  }
  if (have && lane < kSub) {
    gates[(static_cast<size_t>(b) * ng + g) * kSub + lane] =
        (gated >> lane) & 1u;
  }
}

// The exclusive prefix sum of v over the CTA and its total (every thread
// calls it; `scratch` holds a value a warp).
__device__ __forceinline__ int cta_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  __syncthreads();  // scratch is no longer read
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
  const int warps = blockDim.x >> 5;
  for (int w = 0; w < warps; ++w) {
    if (w < warp) before += scratch[w];
    all += scratch[w];
  }
  *total = all;
  return before + x - v;
}

// Sub-clusters list[p .. p + count) of the window into dst with cp.async,
// as one commit group (an empty one when count <= 0).
__device__ __forceinline__ void fetch(float4* dst,
                                      const float4* __restrict__ leaves,
                                      const int* list, int count) {
  for (int q = threadIdx.x; q < count * kSub4; q += blockDim.x) {
    const int sub = list[q / kSub4];
    const float4* src = leaves + static_cast<size_t>(sub / kSub) * kLeaf4 +
                        kBoxes4 + (sub % kSub) * kSub4 + q % kSub4;
    copy_async16(dst + q, src);
  }
  copy_async_commit();
}

template <bool kOrdered>
__global__ void __launch_bounds__(kMaxThreads, kTestBlocks)
phased_kernel(const float4* __restrict__ leaves,
              const unsigned char* __restrict__ gates,
              const float* __restrict__ ro, const float* __restrict__ rd,
              const bool* __restrict__ active, float* __restrict__ t_out,
              int* __restrict__ idx_out, int n, int bn, int ng,
              int num_tris) {
  __shared__ float4 tile[2][kBatch * kSub4];
  __shared__ int list[kWindow];
  __shared__ int lanes[kMaxThreads];
  __shared__ int scratch[kMaxThreads / 32];
  const int first = blockIdx.x * blockDim.x;  // bn % blockDim.x == 0
  const int own = first + threadIdx.x;
  const bool real = own < n;
  const bool live = real && (active == nullptr || active[own]);
  if (real && !live) store_hit(t_out, idx_out, own, 0.0f, -1, num_tris, false);
  // The CTA's live lanes, in order, onto its first threads.
  int alive;
  const int slot = cta_scan(live ? 1 : 0, scratch, &alive);
  if (live) lanes[slot] = own;
  if (alive == 0) return;  // the same for every thread
  __syncthreads();
  // Replicas: where the live lanes fill fewer warps than the CTA has, the
  // idle warps take copies of them, and copy `rep` of `reps` tests every
  // reps-th staged sub-cluster; the copies merge at the end.
  const int span = (alive + 31) & ~31;
  const int reps = blockDim.x / span;
  const int rep = threadIdx.x / span;
  const int q = threadIdx.x - rep * span;
  const bool mine = rep < reps && q < alive;
  const int i = mine ? lanes[q] : 0;
  const Ray r = mine ? load_ray(ro, rd, n, i) : pad_ray();
  float best_t = CUDART_INF_F;
  int best_i = -1;
  int best_s = 0x7fffffff;  // the best's sub-cluster, for the merge

  const int subs = ng * kSub;
  const unsigned* words = reinterpret_cast<const unsigned*>(
      gates + static_cast<size_t>(first / bn) * subs);
  const int per = kWindow / 4 / blockDim.x;  // gate words a thread
  for (int w0 = 0; w0 < subs; w0 += kWindow) {
    // The window's gated sub-clusters, ascending. A gate byte is 0 or 1, so
    // a word's population count is its gated sub-clusters.
    const int q0 = w0 / 4 + threadIdx.x * per;
    const int q1 = min(q0 + per, subs / 4);
    int mine_n = 0;
    for (int q = q0; q < q1; ++q) mine_n += __popc(words[q]);
    int total;
    int pos = cta_scan(mine_n, scratch, &total);
    for (int q = q0; q < q1; ++q) {
      const unsigned w = words[q];
      for (int k = 0; k < 4; ++k) {
        if ((w >> (8 * k)) & 0xffu) list[pos++] = 4 * q + k;
      }
    }
    __syncthreads();
    fetch(tile[0], leaves, list, min(kBatch, total));
    for (int p = 0; p < total; p += kBatch) {
      copy_async_wait();
      // Batch p is in place for every thread, and no thread reads the
      // batch before it any more.
      __syncthreads();
      fetch(tile[((p / kBatch) + 1) & 1], leaves, list + p + kBatch,
            min(kBatch, total - p - kBatch));
      if (mine) {
        const float4* cur = tile[(p / kBatch) & 1];
        const int count = min(kBatch, total - p);
        for (int u = rep; u < count; u += reps) {
          const float4* rows = cur + u * kSub4;
          if (kOrdered) {
#pragma unroll
            for (int k = 0; k < kSubW; ++k) {
              const float4 e = rows[3 * k + 2];
              const float t = mt_early(r, rows[3 * k], rows[3 * k + 1], e);
              if (t < best_t) {  // NaN: no hit
                best_t = t;
                best_i = static_cast<int>(e.y);
                best_s = list[p + u];
              }
            }
          } else {
            float sub_t = CUDART_INF_F;
            int sub_i = 0x7fffffff;
#pragma unroll
            for (int k = 0; k < kSubW; ++k) {
              const float4 e = rows[3 * k + 2];
              if (e.y >= 0.0f) {
                const float t = mt_early(r, rows[3 * k], rows[3 * k + 1], e);
                const int gi = static_cast<int>(e.y);
                if (t < sub_t || (t == sub_t && gi < sub_i)) {
                  sub_t = t;
                  sub_i = gi;
                }
              }
            }
            if (sub_t < best_t) {
              best_t = sub_t;
              best_i = sub_i;
              best_s = list[p + u];
            }
          }
        }
      }
    }
    copy_async_wait();
    __syncthreads();  // the list and the tiles are free for the next window
  }
  if (reps > 1) {
    // Each copy holds the first least t of its sub-clusters; the least t
    // over the copies, ties to the lowest sub-cluster, is the first least
    // t over them all. The tiles are free.
    float* merge_t = reinterpret_cast<float*>(tile);
    int* merge_i = reinterpret_cast<int*>(merge_t + kMaxThreads);
    int* merge_s = merge_i + kMaxThreads;
    if (mine && rep > 0) {
      merge_t[threadIdx.x] = best_t;
      merge_i[threadIdx.x] = best_i;
      merge_s[threadIdx.x] = best_s;
    }
    __syncthreads();
    if (mine && rep == 0) {
      for (int k = 1; k < reps; ++k) {
        const float t = merge_t[k * span + q];
        const int sub = merge_s[k * span + q];
        if (t < best_t || (t == best_t && sub < best_s)) {
          best_t = t;
          best_i = merge_i[k * span + q];
          best_s = sub;
        }
      }
    }
  }
  if (mine && rep == 0) {
    store_hit(t_out, idx_out, i, best_t, best_i, num_tris, true);
  }
}

// Threads of the test kernel's CTA: the most, up to kMaxThreads, that
// divide bn (a multiple of 32), so a CTA lies inside one ray block.
int test_threads(int bn) {
  int t = kMaxThreads;
  while (bn % t) t >>= 1;
  return t;
}

}  // namespace

extern "C" int wpt_phased(const void* leaves, const void* ro, const void* rd,
                          const void* lim0, const void* active, void* gates,
                          void* t_out, void* idx_out, int n, int bn, int ng,
                          int num_tris, int ordered, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ng > 0) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        sizeof(RayChunk));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 gate_grid((n + bn - 1) / bn,
                         (ng + kGateWarps - 1) / kGateWarps);
    gate_kernel<<<gate_grid, kGateThreads, sizeof(RayChunk), s>>>(
        static_cast<const float4*>(leaves), static_cast<const float*>(ro),
        static_cast<const float*>(rd), static_cast<const float*>(lim0),
        static_cast<unsigned char*>(gates), n, bn, ng);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = test_threads(bn);
  const int blocks = (n + threads - 1) / threads;
  auto kernel = ordered ? phased_kernel<true> : phased_kernel<false>;
  kernel<<<blocks, threads, 0, s>>>(
      static_cast<const float4*>(leaves),
      static_cast<const unsigned char*>(gates), static_cast<const float*>(ro),
      static_cast<const float*>(rd), static_cast<const bool*>(active),
      static_cast<float*>(t_out), static_cast<int*>(idx_out), n, bn, ng,
      num_tris);
  return static_cast<int>(cudaGetLastError());
}
