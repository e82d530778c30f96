// K1: dense closest hit, every ray against every triangle.
//
// Replaces the TPU kernel wgpu_path_tracing_tpu/ops/pallas_kernels.py::
// _brute_kernel (entered through closest_hit_brute_pallas_soa). That kernel
// evaluates (256 triangles x 1024 rays) broadcasts per grid step and reduces
// with a first-index min trick; here each thread owns one ray and walks the
// triangles in ascending index, keeping the ray's best hit with a strict
// `<`, which is the same lowest-index tie rule with no atomics and no
// cross-block pass.
//
// Bound on the H100 by instruction issue. The rays are read once (24 B) and
// (t, idx) written once (8 B), and the table's bound counts 55 operations a
// ray-triangle pair, but an exact build (-fmad=false) fuses none of them and
// the IEEE reciprocal is a short sequence, so the full test issues about 75
// instructions a pair. The design issues fewer (PERF.md):
// - each triangle goes through the shared tile as three 16-byte rows
//   [v0, e1.x | e1.y, e1.z, e2.x, e2.y | e2.z, 0, 0, 0], three LDS.128
//   broadcasts in place of nine scalar loads;
// - the test stops at the first condition it fails (isect.cuh::mt_early):
//   |a| < EPSILON, then u outside [0, 1], then v, and returns t or NaN, so
//   the update is one compare. Camera and shadow rays in the main path's
//   tile lane order are coherent, so whole warps take the same exit; bounce
//   rays diverge more and gain less;
// - one ray a thread at 32 registers (__launch_bounds__), so that 16 blocks
//   of 128 threads, the SM's 2,048 threads, are resident: 262,144 rays are
//   one wave of 2,048 blocks. Two and four rays a thread, which share each
//   triangle's loads, measured no faster: the loads were not what held it;
// - the grid is at most one wave of resident blocks, which loop over groups
//   of kThreads rays, so a larger call never leaves a last wave mostly
//   empty; the tile is staged once a block when the scene fits it.
// Origins and directions are two SoA (3, n) row blocks, so the neighbouring
// threads of a warp read neighbouring addresses, and the caller's rows of a
// larger buffer go in without a copy. The ragged edge is masked.
//
// The arithmetic is the plain version's (ops/intersect.py::moller_trumbore)
// term for term. The library is compiled with -fmad=false and without
// --use_fast_math, so every product, sum and the IEEE 1/a round as
// PyTorch's separate elementwise kernels round them, and an exit skips only
// a pair that the plain version's `valid` rejects: the results equal the
// plain version bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "isect.cuh"

namespace {

using wpt::Ray;

constexpr int kThreads = 128;  // threads a block, one ray each
constexpr int kBlocksPerSm = 16;  // 2,048 threads: at most 32 registers
constexpr int kTile = 256;     // triangles a staged tile

// Rows [base, base + count) of the (T, 9) table into the tile, three
// float4 a triangle; the last three floats of each triangle stay unread.
__device__ __forceinline__ void stage(float* tile, const float* __restrict__ tris,
                                      int base, int count) {
  for (int k = threadIdx.x; k < count * 9; k += blockDim.x) {
    const int row = k / 9;
    tile[row * 12 + (k - row * 9)] = tris[base * 9 + k];
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    dense_hit_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                     const float* __restrict__ tris, float* __restrict__ t_out,
                     int* __restrict__ idx_out, int n, int num_tris) {
  __shared__ float4 tile[kTile * 3];
  float* tile_f = reinterpret_cast<float*>(tile);
  const bool one_tile = num_tris <= kTile;
  if (one_tile) {
    stage(tile_f, tris, 0, num_tris);
    __syncthreads();
  }
  const int groups = (n + kThreads - 1) / kThreads;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int i = g * kThreads + threadIdx.x;
    Ray r{};
    if (i < n) {
      r.ox = ro[i];
      r.oy = ro[n + i];
      r.oz = ro[2 * n + i];
      r.dx = rd[i];
      r.dy = rd[n + i];
      r.dz = rd[2 * n + i];
    }
    float best_t = CUDART_INF_F;
    int best_i = -1;
    for (int base = 0; base < num_tris; base += kTile) {
      const int count = min(kTile, num_tris - base);
      if (!one_tile) {
        __syncthreads();
        stage(tile_f, tris, base, count);
        __syncthreads();
      }
      for (int j = 0; j < count; ++j) {
        const float t = wpt::mt_early(r, tile[3 * j], tile[3 * j + 1],
                                      tile[3 * j + 2]);  // NaN: no hit
        if (t < best_t) {
          best_t = t;
          best_i = base + j;
        }
      }
    }
    if (i < n) {
      t_out[i] = best_t;
      idx_out[i] = best_i;
    }
  }
}

}  // namespace

// ro, rd: (3, n) float32 rows; tris: (num_tris, 9) float32.
extern "C" int wpt_dense_hit(const void* ro, const void* rd, const void* tris,
                             void* t_out, void* idx_out, int n, int num_tris,
                             void* stream) {
  static int slots = 0;  // resident blocks on the whole card
  if (slots == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dense_hit_kernel,
                                                  kThreads, 0);
    slots = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int groups = (n + kThreads - 1) / kThreads;
  const int blocks = groups < slots ? groups : slots;
  dense_hit_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ro), static_cast<const float*>(rd),
      static_cast<const float*>(tris), static_cast<float*>(t_out),
      static_cast<int*>(idx_out), n, num_tris);
  return static_cast<int>(cudaGetLastError());
}
