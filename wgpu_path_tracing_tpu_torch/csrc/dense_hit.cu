// K1: dense closest hit, every ray against every triangle.
//
// Replaces the TPU kernel wgpu_path_tracing_tpu/ops/pallas_kernels.py::
// _brute_kernel (entered through closest_hit_brute_pallas_soa). That kernel
// evaluates (256 triangles x 1024 rays) broadcasts per grid step and reduces
// with a first-index min trick; here one thread owns one ray and walks the
// triangles in ascending index, keeping the best hit with a strict `<`, which
// is the same lowest-index tie rule with no atomics and no cross-block pass.
//
// Bound on the H100: FP32 issue, about 55 flops per ray-triangle pair; the
// rays are read once (24 B) and (t, idx) written once (8 B). The design
// stages the triangle table through shared memory in tiles of 256 rows, so
// each triangle is read from device memory once per block and then
// broadcast from shared memory to the block's 256 rays. Rays are SoA
// (6, N), so neighbouring threads read neighbouring addresses. The ragged
// edge is masked; nothing is padded. At the flagship size (262,144 rays x 36
// triangles) launch latency rather than arithmetic is expected to dominate.
//
// The arithmetic is the plain version's (ops/intersect.py::moller_trumbore)
// term for term. The library is compiled with -fmad=false and without
// --use_fast_math, so every product, sum and the IEEE 1/a round as
// PyTorch's separate elementwise kernels round them: the results equal the
// plain version bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;
constexpr float kEpsilon = 1e-6f;

__global__ void dense_hit_kernel(const float* __restrict__ rays,
                                 const float* __restrict__ tris,
                                 float* __restrict__ t_out,
                                 int* __restrict__ idx_out, int n,
                                 int num_tris) {
  __shared__ float tile[kTile * 9];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (live) {
    ox = rays[i];
    oy = rays[n + i];
    oz = rays[2 * n + i];
    dx = rays[3 * n + i];
    dy = rays[4 * n + i];
    dz = rays[5 * n + i];
  }
  float best_t = CUDART_INF_F;
  int best_idx = -1;

  for (int base = 0; base < num_tris; base += kTile) {
    const int count = min(kTile, num_tris - base);
    __syncthreads();
    for (int k = threadIdx.x; k < count * 9; k += blockDim.x) {
      tile[k] = tris[base * 9 + k];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < count; ++j) {
      const float* tri = tile + j * 9;
      const float v0x = tri[0], v0y = tri[1], v0z = tri[2];
      const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
      const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
      const float hx = dy * e2z - dz * e2y;
      const float hy = dz * e2x - dx * e2z;
      const float hz = dx * e2y - dy * e2x;
      const float a = e1x * hx + e1y * hy + e1z * hz;
      const float f = 1.0f / a;
      const float sx = ox - v0x;
      const float sy = oy - v0y;
      const float sz = oz - v0z;
      const float u = f * (sx * hx + sy * hy + sz * hz);
      const float qx = sy * e1z - sz * e1y;
      const float qy = sz * e1x - sx * e1z;
      const float qz = sx * e1y - sy * e1x;
      const float v = f * (dx * qx + dy * qy + dz * qz);
      const float t = f * (e2x * qx + e2y * qy + e2z * qz);
      const bool valid = (fabsf(a) >= kEpsilon) && (u >= 0.0f) &&
                         (u <= 1.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
                         (t > kEpsilon);
      if (valid && t < best_t) {
        best_t = t;
        best_idx = base + j;
      }
    }
  }
  if (live) {
    t_out[i] = best_t;
    idx_out[i] = best_idx;
  }
}

}  // namespace

extern "C" int wpt_dense_hit(const void* rays, const void* tris, void* t_out,
                             void* idx_out, int n, int num_tris,
                             void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  dense_hit_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays), static_cast<const float*>(tris),
      static_cast<float*>(t_out), static_cast<int*>(idx_out), n, num_tris);
  return static_cast<int>(cudaGetLastError());
}
