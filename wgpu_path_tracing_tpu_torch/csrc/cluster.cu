// K6: the round dispatch, closest hit over a ray block's nearest clusters,
// eight a round.
//
// Replaces the TPU kernel wgpu_path_tracing_tpu/ops/cluster.py::_round_kernel
// with its round loop (_dispatch_round, closest_hit_cluster). There a round
// is one Pallas call over a (blocks, 8) grid of scalar-prefetched cluster
// ids, and the picks, the culling and the loop are XLA around it. Here a
// thread block owns a block of 1024 consecutive rays, one ray a thread, and
// goes through all its rounds itself: the running best stays in registers.
// Phase 1 and the sort that order the candidates stay PyTorch calls
// (ops/cluster.py candidates).
//
// At the start of a round the block takes its largest live limit
// min(best t, limit) over its lanes (NaN-propagating, as jnp.max is); the
// candidates above it are dropped for good, which in an ascending list ends
// the block. Each of up to 8 candidates that remain is staged in shared
// memory (k <= 128 rows x 9 floats) and every lane runs Möller-Trumbore over
// all its rows, with no gate: the least t, ties to the lowest row, replaces
// the best on a strict <.
//
// Bound on the H100: operations (k x 55 a lane and a cluster against 4.5 KB
// staged); rows are read from shared memory as broadcasts.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "isect.cuh"

namespace {

using namespace wpt;

constexpr int kBlock = 1024;  // ops/cluster.py BN
constexpr int kMaxK = 128;    // ops/cluster.py CLUSTER_K; the wrapper checks
constexpr int kRound = 8;     // ops/cluster.py ROUND
constexpr int kCols = 9;
constexpr int kWarps = kBlock / 32;

// The NaN-propagating maximum of v over the thread block.
__device__ float block_nan_max(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  __syncthreads();  // scratch is no longer read
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = scratch[0];
  for (int w = 1; w < kWarps; ++w) m = nan_max(m, scratch[w]);
  return m;
}

__global__ void __launch_bounds__(kBlock)
cluster_kernel(const float* __restrict__ tris,
               const float* __restrict__ entry,
               const long long* __restrict__ cids,
               const float* __restrict__ ro, const float* __restrict__ rd,
               const float* __restrict__ lim0_in,
               const bool* __restrict__ active, float* __restrict__ t_out,
               int* __restrict__ idx_out, int n, int c, int k, int max_rounds,
               int num_tris) {
  __shared__ float tile[kMaxK * kCols];
  __shared__ float scratch[kWarps];
  const int b = blockIdx.x;
  const int i = b * kBlock + threadIdx.x;
  const bool real = i < n;
  const Ray r = real ? load_ray(ro, rd, n, i) : pad_ray();
  const float lim0 = real ? lim0_in[i] : -CUDART_INF_F;
  const float* my_entry = entry + static_cast<size_t>(b) * c;
  const long long* my_cids = cids + static_cast<size_t>(b) * c;

  float best_t = CUDART_INF_F;
  int best_i = -1;
  bool done = false;
  for (int round = 0; !done && (max_rounds == 0 || round < max_rounds);
       ++round) {
    const float block_limit = block_nan_max(nan_min(best_t, lim0), scratch);
    for (int j = 0; j < kRound; ++j) {
      const int p = round * kRound + j;
      // Every thread reads the same entry, so the block leaves together.
      if (p >= c || !(my_entry[p] <= block_limit) ||
          !(my_entry[p] < CUDART_INF_F)) {
        done = true;
        break;
      }
      const int cid = static_cast<int>(my_cids[p]);
      const float* src = tris + static_cast<size_t>(cid) * k * kCols;
      __syncthreads();  // the previous tile is no longer read
      for (int q = threadIdx.x; q < k * kCols; q += kBlock) tile[q] = src[q];
      __syncthreads();
      float min_t;
      int min_row;
      closest_row(tile, k, kCols, r, &min_t, &min_row);
      if (min_t < best_t) {
        best_t = min_t;
        best_i = cid * k + min_row;
      }
    }
  }
  if (real) {
    store_hit(t_out, idx_out, i, best_t, best_i, num_tris,
              active == nullptr || active[i]);
  }
}

}  // namespace

extern "C" int wpt_cluster(const void* tris, const void* entry,
                           const void* cids, const void* ro, const void* rd,
                           const void* lim0, const void* active, void* t_out,
                           void* idx_out, int n, int c, int k, int max_rounds,
                           int num_tris, void* stream) {
  const int blocks = (n + kBlock - 1) / kBlock;
  cluster_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tris), static_cast<const float*>(entry),
      static_cast<const long long*>(cids), static_cast<const float*>(ro),
      static_cast<const float*>(rd), static_cast<const float*>(lim0),
      static_cast<const bool*>(active), static_cast<float*>(t_out),
      static_cast<int*>(idx_out), n, c, k, max_rounds, num_tris);
  return static_cast<int>(cudaGetLastError());
}
