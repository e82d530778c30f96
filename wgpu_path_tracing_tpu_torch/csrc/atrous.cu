// K9: one level of the edge-avoiding à-trous filter, a tile of the
// decimated grid a block.
//
// Replaces one pass of the level loop of
// wgpu_path_tracing_tpu/ops/denoise.py::atrous_filter (lines 217-263), which
// the JAX package leaves to XLA: 25 dilated B3 taps of about 30 elementwise
// operations each, a few hundred launches a level in eager PyTorch.
//
// The pixels that share one residue (y mod step, x mod step) form a grid of
// their own, on which the dilated 5x5 stencil is a dense 5x5. A block owns
// a kTile x kTile tile of one such grid: it stages the tile's (kTile + 4)^2
// halo in shared memory once (colour, its luminance, normal, depth, found,
// variance), each halo slot holding the edge-replicated (clamped) pixel that
// the plain version's padded slices reach there, which need not share the
// residue; then each thread filters its pixel from the halo. So each input
// is read about 1.6 times a level instead of 25, and each luminance is
// computed once instead of 25 times. Bound on the H100 by the taps' powf
// and two expf (PERF.md), which the exactness keeps.
//
// The arithmetic is the plain version's (ops/denoise.py atrous_level_plain)
// term for term: the luminance as ((0.2126 r + 0.7152 g) + 0.0722 b), the
// normal dot product as a left-associated sum, max(., 0) ** sigma_normal
// through powf as PyTorch's pow by a scalar exponent calls it,
// exp(-dz * dz) and exp(-dl / sig_l) through expf, the weight as
// ((h * w_seg) * w_edge) * w_l, the sums in tap order (ty, tx), and max()
// carrying NaN as torch.maximum does. The library is built with -fmad=false
// and without fast math, so each product, sum, IEEE division and square
// root rounds as PyTorch's separate elementwise kernels round them.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;               // a block's tile, kTile^2 pixels
constexpr int kHalo = kTile + 4;        // its halo's side
constexpr int kSlots = kHalo * kHalo;   // halo slots
constexpr int kThreads = kTile * kTile;

__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? b : a;
}

__device__ __forceinline__ float luminance(float r, float g, float b) {
  return 0.2126f * r + 0.7152f * g + 0.0722f * b;
}

__global__ void __launch_bounds__(kThreads)
    atrous_level_kernel(const float* __restrict__ color,
                        const float* __restrict__ normal,
                        const float* __restrict__ depth,
                        const unsigned char* __restrict__ found,
                        const float* __restrict__ var,
                        float* __restrict__ out_color,
                        float* __restrict__ out_var, int h, int w, int step,
                        int tiles_y, int tiles_x, float sigma_normal,
                        float sigma_depth, float sigma_lum) {
  __shared__ float s_c[3][kSlots];
  __shared__ float s_n[3][kSlots];
  __shared__ float s_l[kSlots];
  __shared__ float s_z[kSlots];
  __shared__ float s_v[kSlots];
  __shared__ unsigned char s_f[kSlots];
  // Block -> (residue ry, rx; tile ty, tx); residues past the image's size
  // hold no pixel and are not launched.
  const int rw = min(step, w);
  int b = blockIdx.x;
  const int tile_x = b % tiles_x;
  b /= tiles_x;
  const int tile_y = b % tiles_y;
  b /= tiles_y;
  const int rx = b % rw;
  const int ry = b / rw;
  const int sy0 = tile_y * kTile - 2;  // the halo's first sub-grid row
  const int sx0 = tile_x * kTile - 2;
  for (int k = threadIdx.x; k < kSlots; k += kThreads) {
    const int hy = k / kHalo;
    const int hx = k - hy * kHalo;
    const int y = min(max(ry + (sy0 + hy) * step, 0), h - 1);
    const int x = min(max(rx + (sx0 + hx) * step, 0), w - 1);
    const int q = y * w + x;
    const float c0 = color[3 * q];
    const float c1 = color[3 * q + 1];
    const float c2 = color[3 * q + 2];
    s_c[0][k] = c0;
    s_c[1][k] = c1;
    s_c[2][k] = c2;
    s_l[k] = luminance(c0, c1, c2);
    s_n[0][k] = normal[3 * q];
    s_n[1][k] = normal[3 * q + 1];
    s_n[2][k] = normal[3 * q + 2];
    s_z[k] = depth[q];
    s_v[k] = var[q];
    s_f[k] = found[q];
  }
  __syncthreads();
  const int py = threadIdx.x / kTile;
  const int px = threadIdx.x - py * kTile;
  const int y = ry + (tile_y * kTile + py) * step;
  const int x = rx + (tile_x * kTile + px) * step;
  if (y >= h || x >= w) return;
  // The 1D B3 spline (1, 4, 6, 4, 1) / 16; its outer product is exact.
  const float b3[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f,
                       4.0f / 16.0f, 1.0f / 16.0f};
  const int c = (py + 2) * kHalo + px + 2;  // the pixel's own slot
  const float n0 = s_n[0][c], n1 = s_n[1][c], n2 = s_n[2][c];
  const float z = s_z[c];
  const bool f = s_f[c] != 0;
  const float lum_c = s_l[c];
  const float sig_l = sigma_lum * sqrtf(s_v[c]) + 1e-4f;
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc_v = 0.0f, wsum = 0.0f;
#pragma unroll
  for (int ty = 0; ty < 5; ++ty) {
#pragma unroll
    for (int tx = 0; tx < 5; ++tx) {
      const int q = (py + ty) * kHalo + px + tx;
      const float zq = s_z[q];
      const bool fq = s_f[q] != 0;
      const float ndot =
          nan_max(n0 * s_n[0][q] + n1 * s_n[1][q] + n2 * s_n[2][q], 0.0f);
      const float w_n = powf(ndot, sigma_normal);
      const float zmax = nan_max(nan_max(z, zq), 1e-4f);
      const float dz = (z - zq) / (sigma_depth * zmax);
      const float w_z = expf(-dz * dz);
      const float dl = fabsf(lum_c - s_l[q]);
      const float w_l = expf(-dl / sig_l);
      const float w_seg = f == fq ? 1.0f : 0.0f;
      const float w_edge = (!f && !fq) ? 1.0f : w_n * w_z;
      const float wt = b3[ty] * b3[tx] * w_seg * w_edge * w_l;
      acc0 = acc0 + wt * s_c[0][q];
      acc1 = acc1 + wt * s_c[1][q];
      acc2 = acc2 + wt * s_c[2][q];
      acc_v = acc_v + wt * wt * s_v[q];
      wsum = wsum + wt;
    }
  }
  const int p = y * w + x;
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
  // The residue-0 grid is the largest: ceil(h / step) x ceil(w / step).
  const int tiles_y = ((h + step - 1) / step + kTile - 1) / kTile;
  const int tiles_x = ((w + step - 1) / step + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(step < h ? step : h) *
                           (step < w ? step : w) * tiles_y * tiles_x;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  atrous_level_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(color), static_cast<const float*>(normal),
      static_cast<const float*>(depth),
      static_cast<const unsigned char*>(found),
      static_cast<const float*>(var), static_cast<float*>(out_color),
      static_cast<float*>(out_var), h, w, step, tiles_y, tiles_x,
      sigma_normal, sigma_depth, sigma_lum);
  return static_cast<int>(cudaGetLastError());
}
