// K5: the phased flat group dispatch, closest hit over every leaf
// sub-cluster that any ray of the block enters.
//
// Replaces the TPU kernel wgpu_path_tracing_tpu/ops/phased.py::_phased_kernel
// (entered through closest_hit_phased). That kernel is one Pallas grid step
// per block of 2048 rays: phase 1 packs 32 "any lane enters" gate bits into
// each SMEM word over unrolled chunks of the sub-box table, phase 2 is a
// group loop unrolled 8 times that reads the bits back. The packing, the
// unrolling and the padded group count they need are not carried over. Here
// the two phases are two kernels with the gates in a byte table between:
//
// - gate_kernel: one thread a ray (tail lanes of the last block included, as
//   lanes that enter nothing) against a slice of the sub-cluster boxes, read
//   in place from the walk's leaf table. The entry test is the walk's (the
//   safe reciprocal, NaN-propagating min and max) against the call-entry
//   limit. A warp lies inside one ray block (bn is a multiple of 32), votes
//   with __any_sync, and its first lane sets the block's gate byte; every
//   writer stores the same 1, so no atomics are needed.
// - phased_kernel: one thread a ray through the groups in ascending order
//   and each group's sub-clusters in ascending order; a gated sub-cluster
//   runs Möller-Trumbore over its 8 slots (least t, ties to the lowest
//   triangle index) and replaces the best on a strict <. A group's 16 gate
//   bytes are one 16-byte load, the same address across the warp.
//
// The gate by ray block is part of the function: a lane that does not enter
// a box itself can still score in it through rounding.
//
// Bound on the H100: operations. Nothing tightens the limits along the way,
// so incoherent rays gate most of the scene and every lane tests it: about
// 55 operations a filled slot a lane, against a leaf table read once.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "isect.cuh"

namespace {

using namespace wpt;

constexpr int kThreads = 256;
constexpr int kGateGroups = 8;  // leaf groups a gate thread sweeps

__global__ void gate_kernel(const float* __restrict__ tris,
                            const float* __restrict__ ro,
                            const float* __restrict__ rd,
                            const float* __restrict__ lim0_in,
                            unsigned char* __restrict__ gates, int n,
                            int n_pad, int bn, int ng) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool lane = i < n_pad;  // a whole warp or none of it (bn % 32 == 0)
  const bool real = i < n;
  const Ray r = real ? load_ray(ro, rd, n, i) : pad_ray();
  const float lim0 = real ? lim0_in[i] : -CUDART_INF_F;
  unsigned char* mine =
      gates + static_cast<size_t>(lane ? i / bn : 0) * ng * kSub;
  const int g0 = blockIdx.y * kGateGroups;
  const int g1 = min(g0 + kGateGroups, ng);
  for (int g = g0; g < g1; ++g) {
    const float* group = tris + static_cast<size_t>(g) * kGroupRows * kLanes;
    for (int c = 0; c < kSub; ++c) {
      float tn;
      const bool enter =
          lane && slab_entry(group + (kSubRow + c) * kLanes, r, lim0, &tn);
      if (__any_sync(0xffffffffu, enter) && (threadIdx.x & 31) == 0) {
        mine[g * kSub + c] = 1;
      }
    }
  }
}

__global__ void phased_kernel(const float* __restrict__ tris,
                              const unsigned char* __restrict__ gates,
                              const float* __restrict__ ro,
                              const float* __restrict__ rd,
                              const bool* __restrict__ active,
                              float* __restrict__ t_out,
                              int* __restrict__ idx_out, int n, int bn,
                              int ng, int num_tris) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(ro, rd, n, i);
  // ng * kSub bytes a ray block: each group's gates are 16-byte aligned.
  const uint4* mine = reinterpret_cast<const uint4*>(
      gates + static_cast<size_t>(i / bn) * ng * kSub);
  float best_t = CUDART_INF_F;
  int best_i = -1;
  for (int g = 0; g < ng; ++g) {
    const uint4 w = mine[g];
    if ((w.x | w.y | w.z | w.w) == 0u) continue;
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
    const float* group = tris + static_cast<size_t>(g) * kGroupRows * kLanes;
#pragma unroll
    for (int c = 0; c < kSub; ++c) {
      if (((words[c >> 2] >> (8 * (c & 3))) & 0xffu) == 0u) continue;
      float sub_t;
      int sub_i;
      mt_subcluster(group, c, r, &sub_t, &sub_i);
      if (sub_t < best_t) {
        best_t = sub_t;
        best_i = sub_i;
      }
    }
  }
  store_hit(t_out, idx_out, i, best_t, best_i, num_tris,
            active == nullptr || active[i]);
}

}  // namespace

extern "C" int wpt_phased(const void* tris, const void* ro, const void* rd,
                          const void* lim0, const void* active, void* gates,
                          void* t_out, void* idx_out, int n, int bn, int ng,
                          int num_tris, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pad = (n + bn - 1) / bn * bn;
  const dim3 gate_grid((n_pad + kThreads - 1) / kThreads,
                       (ng + kGateGroups - 1) / kGateGroups);
  gate_kernel<<<gate_grid, kThreads, 0, s>>>(
      static_cast<const float*>(tris), static_cast<const float*>(ro),
      static_cast<const float*>(rd), static_cast<const float*>(lim0),
      static_cast<unsigned char*>(gates), n, n_pad, bn, ng);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  phased_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(tris),
      static_cast<const unsigned char*>(gates), static_cast<const float*>(ro),
      static_cast<const float*>(rd), static_cast<const bool*>(active),
      static_cast<float*>(t_out), static_cast<int*>(idx_out), n, bn, ng,
      num_tris);
  return static_cast<int>(cudaGetLastError());
}
