// K9: one level of the edge-avoiding à-trous filter, one thread a pixel.
//
// Replaces one pass of the level loop of
// wgpu_path_tracing_tpu/ops/denoise.py::atrous_filter (lines 217-263), which
// the JAX package leaves to XLA: 25 dilated B3 taps of about 30 elementwise
// operations each, a few hundred launches a level in eager PyTorch. Here a
// thread reads its pixel's centre values once and its 25 taps at spacing
// `step` in (ty, tx) order, each at the edge-replicated (clamped)
// coordinate that the plain version's padded slices reach, and writes the
// level's colour and its propagated variance.
//
// The arithmetic is the plain version's (ops/denoise.py atrous_level_plain)
// term for term: the luminance as ((0.2126 r + 0.7152 g) + 0.0722 b), the
// normal dot product as a left-associated sum, max(., 0) ** sigma_normal
// through powf as PyTorch's pow by a scalar exponent calls it,
// exp(-dz * dz) and exp(-dl / sig_l) through expf, the weight as
// ((h * w_seg) * w_edge) * w_l, the sums in tap order, and max() carrying
// NaN as torch.maximum does. The library is built with -fmad=false and
// without fast math, so each product, sum, IEEE division and square root
// rounds as PyTorch's separate elementwise kernels round them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? b : a;
}

__device__ __forceinline__ float luminance(const float* c) {
  return 0.2126f * c[0] + 0.7152f * c[1] + 0.0722f * c[2];
}

__global__ void __launch_bounds__(kThreads)
    atrous_level_kernel(const float* __restrict__ color,
                        const float* __restrict__ normal,
                        const float* __restrict__ depth,
                        const unsigned char* __restrict__ found,
                        const float* __restrict__ var,
                        float* __restrict__ out_color,
                        float* __restrict__ out_var, int h, int w, int step,
                        float sigma_normal, float sigma_depth,
                        float sigma_lum) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= h * w) return;
  const int y = p / w;
  const int x = p - y * w;
  // The 1D B3 spline (1, 4, 6, 4, 1) / 16; its outer product is exact.
  const float b3[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f,
                       4.0f / 16.0f, 1.0f / 16.0f};
  const float* c = color + 3 * p;
  const float* nrm = normal + 3 * p;
  const float z = depth[p];
  const bool f = found[p] != 0;
  const float lum_c = luminance(c);
  const float sig_l = sigma_lum * sqrtf(var[p]) + 1e-4f;
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc_v = 0.0f, wsum = 0.0f;
#pragma unroll
  for (int ty = 0; ty < 5; ++ty) {
    const int qy = min(max(y + (ty - 2) * step, 0), h - 1);
#pragma unroll
    for (int tx = 0; tx < 5; ++tx) {
      const int qx = min(max(x + (tx - 2) * step, 0), w - 1);
      const int q = qy * w + qx;
      const float* cq = color + 3 * q;
      const float* nq = normal + 3 * q;
      const float zq = depth[q];
      const bool fq = found[q] != 0;
      const float ndot =
          nan_max(nrm[0] * nq[0] + nrm[1] * nq[1] + nrm[2] * nq[2], 0.0f);
      const float w_n = powf(ndot, sigma_normal);
      const float zmax = nan_max(nan_max(z, zq), 1e-4f);
      const float dz = (z - zq) / (sigma_depth * zmax);
      const float w_z = expf(-dz * dz);
      const float dl = fabsf(lum_c - luminance(cq));
      const float w_l = expf(-dl / sig_l);
      const float w_seg = f == fq ? 1.0f : 0.0f;
      const float w_edge = (!f && !fq) ? 1.0f : w_n * w_z;
      const float wt = b3[ty] * b3[tx] * w_seg * w_edge * w_l;
      acc0 = acc0 + wt * cq[0];
      acc1 = acc1 + wt * cq[1];
      acc2 = acc2 + wt * cq[2];
      acc_v = acc_v + wt * wt * var[q];
      wsum = wsum + wt;
    }
  }
  const float den = nan_max(wsum, 1e-8f);
  out_color[3 * p] = acc0 / den;
  out_color[3 * p + 1] = acc1 / den;
  out_color[3 * p + 2] = acc2 / den;
  out_var[p] = acc_v / nan_max(wsum * wsum, 1e-12f);
}

}  // namespace

// color, normal (h, w, 3) f32; depth, var (h, w) f32; found (h, w) bool;
// out_color (h, w, 3), out_var (h, w) f32.
extern "C" int wpt_atrous_level(const void* color, const void* normal,
                                const void* depth, const void* found,
                                const void* var, void* out_color,
                                void* out_var, int h, int w, int step,
                                float sigma_normal, float sigma_depth,
                                float sigma_lum, void* stream) {
  const int blocks = (h * w + kThreads - 1) / kThreads;
  atrous_level_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(color), static_cast<const float*>(normal),
      static_cast<const float*>(depth),
      static_cast<const unsigned char*>(found),
      static_cast<const float*>(var), static_cast<float*>(out_color),
      static_cast<float*>(out_var), h, w, step, sigma_normal, sigma_depth,
      sigma_lum);
  return static_cast<int>(cudaGetLastError());
}
