// K4: the pair dispatch, closest hit over (ray block, super tile) pairs in
// entry order.
//
// Replaces the TPU kernel wgpu_path_tracing_tpu/ops/pairs.py::_pair_kernel
// with its window loop (_dispatch_window, closest_hit_pairs). That kernel is
// one Pallas grid step per pair of a window of the flat pair list, with the
// block's running (t, idx) held in VMEM across its run of pairs, seeding
// flags at window edges and scalar-prefetched pair indices. Here a thread
// block owns a block of 1024 consecutive rays, one ray a thread, and loops
// over its own list: the running best stays in registers, and there are no
// windows. Phase 1 and the sort that make the list stay PyTorch calls
// (ops/pairs.py pair_list), as they are XLA calls there.
//
// Per pair the super tile (8 member clusters x 64 rows x 16 floats, 32 KB)
// is staged in shared memory; each member's box is tested against the live
// limit min(best t, limit) with true division, and when any lane of the
// block enters (__syncthreads_or) every lane runs Möller-Trumbore over the
// member's 64 rows. The vote over the whole block is part of the function:
// a lane that does not enter a box can still score in it through rounding.
// In a member the winner is the least t, ties to the lowest row; it
// replaces the best on a strict <.
//
// Bound on the H100: operations. A visited member costs 64 tests x 55
// operations a lane against 32 KB staged a pair, and the tile reads hit L2
// (the table is a few MB). Rows are read from shared memory at one address
// a warp (a broadcast), so the loop is limited by its float32 math.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "isect.cuh"

namespace {

using namespace wpt;

constexpr int kBlock = 1024;  // ops/pairs.py BN
constexpr int kK = 64;        // ops/pairs.py PAIRS_K
constexpr int kGroup = 8;     // ops/pairs.py PAIRS_GROUP
constexpr int kCols = 16;     // ops/pairs.py PAIRS_COLS
constexpr int kTile = kGroup * kK * kCols;  // floats in a super tile

__global__ void __launch_bounds__(kBlock)
pairs_kernel(const float* __restrict__ tris,
             const long long* __restrict__ cids,
             const long long* __restrict__ counts,
             const float* __restrict__ ro, const float* __restrict__ rd,
             const float* __restrict__ lim0_in,
             const bool* __restrict__ active, float* __restrict__ t_out,
             int* __restrict__ idx_out, int n, int cs, int num_tris) {
  __shared__ __align__(16) float tile[kTile];
  const int b = blockIdx.x;
  const int i = b * kBlock + threadIdx.x;
  const bool real = i < n;
  const Ray r = real ? load_ray(ro, rd, n, i) : pad_ray();
  const float lim0 = real ? lim0_in[i] : -CUDART_INF_F;

  float best_t = CUDART_INF_F;
  int best_i = -1;
  const int count = static_cast<int>(counts[b]);
  for (int p = 0; p < count; ++p) {
    const long long cid = cids[static_cast<size_t>(b) * cs + p];
    const float4* src = reinterpret_cast<const float4*>(tris + cid * kTile);
    float4* dst = reinterpret_cast<float4*>(tile);
    __syncthreads();  // the previous tile is no longer read
    for (int q = threadIdx.x; q < kTile / 4; q += kBlock) dst[q] = src[q];
    __syncthreads();
    for (int s = 0; s < kGroup; ++s) {
      const float* member = tile + s * kK * kCols;
      float tn;
      const bool enter =
          slab_entry_div(member + 9, r, nan_min(best_t, lim0), &tn);
      if (!__syncthreads_or(enter)) continue;
      float min_t;
      int min_row;
      closest_row(member, kK, kCols, r, &min_t, &min_row);
      if (min_t < best_t) {
        best_t = min_t;
        best_i = static_cast<int>(member[15]) + min_row;
      }
    }
  }
  if (real) {
    store_hit(t_out, idx_out, i, best_t, best_i, num_tris,
              active == nullptr || active[i]);
  }
}

}  // namespace

extern "C" int wpt_pairs(const void* tris, const void* cids,
                         const void* counts, const void* ro, const void* rd,
                         const void* lim0, const void* active, void* t_out,
                         void* idx_out, int n, int cs, int num_tris,
                         void* stream) {
  const int blocks = (n + kBlock - 1) / kBlock;
  pairs_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tris), static_cast<const long long*>(cids),
      static_cast<const long long*>(counts), static_cast<const float*>(ro),
      static_cast<const float*>(rd), static_cast<const float*>(lim0),
      static_cast<const bool*>(active), static_cast<float*>(t_out),
      static_cast<int*>(idx_out), n, cs, num_tris);
  return static_cast<int>(cudaGetLastError());
}
