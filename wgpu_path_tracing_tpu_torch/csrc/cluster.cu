// K6: the round dispatch, closest hit over a ray block's nearest clusters,
// eight a round.
//
// Replaces the TPU kernel wgpu_path_tracing_tpu/ops/cluster.py::_round_kernel
// with its round loop (_dispatch_round, closest_hit_cluster). There a round
// is one Pallas call over a (blocks, 8) grid of scalar-prefetched cluster
// ids, and the picks, the culling and the loop are XLA around it. Here a
// thread block owns a block of 1024 consecutive rays, one ray a thread, and
// goes through all its rounds itself: the running best stays in registers.
// Phase 1 is csrc/blocks.cu and the sort that orders the candidates a
// PyTorch call (ops/cluster.py candidates).
//
// The function (ops/cluster.py closest_hit_cluster_plain): at the start of
// a round the block takes its largest live limit min(best t, limit) over
// its lanes (NaN-propagating, as jnp.max is); the candidates above it are
// dropped for good, which in an ascending list ends the block. Each of up
// to 8 candidates that remain is tested by every lane over all its rows,
// with no gate: the least t, ties to the lowest row, replaces the best on a
// strict <.
//
// Bound on the H100 by instruction issue (k x 55 operations a lane and a
// cluster; PERF.md). The design:
// - the rows are a port-only copy of cluster_tris with three float4 a
//   triangle, [v0, e1.x], [e1.y, e1.z, e2.x, e2.y], [e2.z, 0, 0, 0]
//   (ops/cluster.py cluster_rows, made once a scene), the rows that
//   isect.cuh::mt_early reads: the test stops at the first condition it
//   fails and returns t or NaN, and the running best takes each row's t on a
//   strict < (the least t, the lowest row);
// - the block's order is known ahead, so the next candidate's rows are
//   copied into the other half of a double buffer in shared memory with
//   cp.async while this one is tested: one barrier a candidate, and no
//   thread waits on a load it could have issued earlier;
// - the round's NaN-propagating block maximum and the slab tests use PTX's
//   max.NaN / min.NaN, one instruction each;
// - lanes whose output is thrown away (inactive, or past the last ray) test
//   no triangle: their limit is -inf whatever their best, so the block's
//   maximum does not change.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "isect.cuh"

namespace {

using namespace wpt;

constexpr int kBlock = 1024;  // ops/cluster.py BN
constexpr int kMaxK = 128;    // ops/cluster.py CLUSTER_K; the wrapper checks
constexpr int kRound = 8;     // ops/cluster.py ROUND
constexpr int kRow4 = 3;      // float4 a triangle row (ops/cluster.py)
constexpr int kWarps = kBlock / 32;

// Candidate p's rows into dst with cp.async, as one commit group (an empty
// one when p is no candidate).
__device__ __forceinline__ void fetch(float4* dst,
                                      const float4* __restrict__ rows,
                                      const float* my_entry,
                                      const long long* my_cids, int p, int c,
                                      int rows4) {
  if (p < c && my_entry[p] < CUDART_INF_F) {
    const float4* src = rows + static_cast<size_t>(my_cids[p]) * rows4;
    for (int q = threadIdx.x; q < rows4; q += kBlock) {
      copy_async16(dst + q, src + q);
    }
  }
  copy_async_commit();
}

// The NaN-propagating maximum of v over the thread block.
__device__ float block_nan_max(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  __syncthreads();  // scratch is no longer read
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = scratch[0];
  for (int w = 1; w < kWarps; ++w) m = max_nan(m, scratch[w]);
  return m;
}

__global__ void __launch_bounds__(kBlock)
cluster_kernel(const float4* __restrict__ rows,
               const float* __restrict__ entry,
               const long long* __restrict__ cids,
               const float* __restrict__ ro, const float* __restrict__ rd,
               const float* __restrict__ lim0_in,
               const bool* __restrict__ active, float* __restrict__ t_out,
               int* __restrict__ idx_out, int n, int c, int k, int max_rounds,
               int num_tris) {
  __shared__ float4 tile[2][kMaxK * kRow4];
  __shared__ float scratch[kWarps];
  const int b = blockIdx.x;
  const int i = b * kBlock + threadIdx.x;
  const bool real = i < n;
  const bool live = real && (active == nullptr || active[i]);
  const Ray r = real ? load_ray(ro, rd, n, i) : pad_ray();
  const float lim0 = real ? lim0_in[i] : -CUDART_INF_F;
  const float* my_entry = entry + static_cast<size_t>(b) * c;
  const long long* my_cids = cids + static_cast<size_t>(b) * c;
  const int rows4 = k * kRow4;

  float best_t = CUDART_INF_F;
  int best_i = -1;
  bool done = false;
  fetch(tile[0], rows, my_entry, my_cids, 0, c, rows4);
  for (int round = 0; !done && (max_rounds == 0 || round < max_rounds);
       ++round) {
    const float block_limit = block_nan_max(min_nan(best_t, lim0), scratch);
    for (int j = 0; j < kRound; ++j) {
      const int p = round * kRound + j;
      // Every thread reads the same entry, so the block leaves together.
      if (p >= c || !(my_entry[p] <= block_limit) ||
          !(my_entry[p] < CUDART_INF_F)) {
        done = true;
        break;
      }
      copy_async_wait();
      // Candidate p's rows are in place for every thread, and no thread
      // reads candidate p - 1's half any more.
      __syncthreads();
      fetch(tile[(p + 1) & 1], rows, my_entry, my_cids, p + 1, c, rows4);
      if (live) {
        const float4* cand = tile[p & 1];
        const int base = static_cast<int>(my_cids[p]) * k;
#pragma unroll 4
        for (int row = 0; row < k; ++row) {
          const float t = mt_early(r, cand[3 * row], cand[3 * row + 1],
                                   cand[3 * row + 2]);  // NaN: miss
          if (t < best_t) {
            best_t = t;
            best_i = base + row;
          }
        }
      }
    }
  }
  copy_async_wait();  // no copy in flight at exit
  if (real) {
    store_hit(t_out, idx_out, i, best_t, best_i, num_tris, live);
  }
}

}  // namespace

extern "C" int wpt_cluster(const void* rows, const void* entry,
                           const void* cids, const void* ro, const void* rd,
                           const void* lim0, const void* active, void* t_out,
                           void* idx_out, int n, int c, int k, int max_rounds,
                           int num_tris, void* stream) {
  const int blocks = (n + kBlock - 1) / kBlock;
  cluster_kernel<<<blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rows), static_cast<const float*>(entry),
      static_cast<const long long*>(cids), static_cast<const float*>(ro),
      static_cast<const float*>(rd), static_cast<const float*>(lim0),
      static_cast<const bool*>(active), static_cast<float*>(t_out),
      static_cast<int*>(idx_out), n, c, k, max_rounds, num_tris);
  return static_cast<int>(cudaGetLastError());
}
