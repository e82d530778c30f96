// Phase 1 of K4 and K6: each ray block's least entry distance into each box.
//
// Replaces the XLA scans that feed the TPU's dispatch kernels: the chunked
// sweep of every ray block against every super box ahead of _pair_kernel
// (wgpu_path_tracing_tpu/ops/pairs.py:307, p1_step) and the same sweep
// against every cluster box ahead of _round_kernel (ops/cluster.py:239).
// Its plain version is ops/blocks.py::block_entry, which cuts the sweep into
// chunks to bound its (lanes, boxes) temporaries; here nothing is made but
// the (nb, C) table.
//
// One thread block a ray block of bn lanes (K4 and K6: 1024), one lane a
// thread (a loop over lanes when bn is larger), the lane's ray in
// registers. The boxes go through shared memory in chunks of kChunk, two
// float4 a box, and every lane reads the same box (a broadcast). A box's
// test is isect.cuh's slab_entry_div against the lane's call-entry limit:
// true division and NaN-propagating min and max. The least entry over the
// lanes that enter is an integer min: the entry distance as a key that
// orders like the float (a lane that does not enter gives the key of inf),
// reduced over the warp in one instruction (__reduce_min_sync) and over the
// block by one shared atomicMin a warp. An entry that no lane makes stays
// inf. The minimum may come out as -0 where the plain version gives +0 (the
// key orders -0 below +0, and min.NaN may pick either sign of a zero); the
// table is only compared and sorted, where -0 == +0.
//
// Bound on the H100: operations, 25 a lane and a box, against the rays and
// the boxes read once and the table written once. The six true divisions
// of a slab test are an instruction sequence each in an exact build.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "isect.cuh"

namespace {

using namespace wpt;

constexpr int kThreads = 1024;
constexpr int kChunk = 1024;  // boxes staged at a time

// A key whose unsigned order is the float order (-0 below +0; no NaN ever
// reaches it: a NaN entry enters nothing).
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__global__ void __launch_bounds__(kThreads)
block_entry_kernel(const float* __restrict__ aabb,
                   const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ oz, const float* __restrict__ dx,
                   const float* __restrict__ dy, const float* __restrict__ dz,
                   const float* __restrict__ lim, float* __restrict__ out,
                   int bn, int c) {
  __shared__ float4 boxes[2 * kChunk];
  __shared__ unsigned least[kChunk];
  const unsigned kNone = order_key(CUDART_INF_F);
  const size_t base = static_cast<size_t>(blockIdx.x) * bn;
  for (int c0 = 0; c0 < c; c0 += kChunk) {
    const int cc = min(kChunk, c - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int q = threadIdx.x; q < cc; q += blockDim.x) {
      const float* box = aabb + static_cast<size_t>(c0 + q) * 6;
      boxes[2 * q] = make_float4(box[0], box[1], box[2], box[3]);
      boxes[2 * q + 1] = make_float4(box[4], box[5], 0.0f, 0.0f);
      least[q] = kNone;
    }
    __syncthreads();
    // Every thread of a warp runs every step (the loop bounds are the
    // block's), so the warp's reduction sees all its lanes.
    for (int l0 = 0; l0 < bn; l0 += blockDim.x) {
      const int l = l0 + threadIdx.x;
      const bool lane = l < bn;
      Ray r = pad_ray();
      float lm = -CUDART_INF_F;
      if (lane) {
        r.ox = ox[base + l];
        r.oy = oy[base + l];
        r.oz = oz[base + l];
        r.dx = dx[base + l];
        r.dy = dy[base + l];
        r.dz = dz[base + l];
        lm = lim[base + l];
      }
      for (int q = 0; q < cc; ++q) {
        const float4 lo = boxes[2 * q];
        const float4 hi = boxes[2 * q + 1];
        float tn;
        const bool enter = slab_entry_div(lo.x, lo.y, lo.z, lo.w, hi.x, hi.y,
                                          r, lm, &tn) && lane;
        const unsigned key =
            __reduce_min_sync(0xffffffffu, enter ? order_key(tn) : kNone);
        if ((threadIdx.x & 31) == 0 && key != kNone) atomicMin(&least[q], key);
      }
    }
    __syncthreads();
    for (int q = threadIdx.x; q < cc; q += blockDim.x) {
      out[static_cast<size_t>(blockIdx.x) * c + c0 + q] = key_value(least[q]);
    }
  }
}

}  // namespace

// o*, d*, lim: (nb, bn) float32 rows; aabb: (c, 6); out: (nb, c).
extern "C" int wpt_block_entry(const void* aabb, const void* ox,
                               const void* oy, const void* oz, const void* dx,
                               const void* dy, const void* dz, const void* lim,
                               void* out, int nb, int bn, int c,
                               void* stream) {
  const int threads = bn < kThreads ? ((bn + 31) / 32) * 32 : kThreads;
  block_entry_kernel<<<nb, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(aabb), static_cast<const float*>(ox),
      static_cast<const float*>(oy), static_cast<const float*>(oz),
      static_cast<const float*>(dx), static_cast<const float*>(dy),
      static_cast<const float*>(dz), static_cast<const float*>(lim),
      static_cast<float*>(out), bn, c);
  return static_cast<int>(cudaGetLastError());
}
