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
// windows. Phase 1 is csrc/blocks.cu and the sort that makes the list a
// PyTorch call (ops/pairs.py pair_list), as they are XLA calls there.
//
// The function (ops/pairs.py _dispatch_plain): for each pair in list order,
// each of the super tile's 8 member clusters in order, the member's box is
// tested against every lane's live limit min(best t, limit) with true
// division; when any lane of the block enters, every lane runs
// Möller-Trumbore over the member's 64 rows, the least t winning, ties to
// the lowest row, and replacing the best on a strict <. The vote over the
// whole block is part of the function: a lane that does not enter a box can
// still score in it through rounding.
//
// Bound on the H100 by instruction issue, as K1 and K3 are (PERF.md); the
// design issues less:
// - one vote a pair for all 8 members: each lane tests the 8 boxes, a warp
//   ORs the 8-bit masks (__reduce_or_sync) and one shared atomicOr a warp
//   gathers the block's mask behind one barrier. The limits only fall, so
//   the mask holds every member that will be entered; a member outside it
//   costs nothing. The first member of the mask is entered at the limits
//   of the vote itself; each later one takes its exact vote
//   (__syncthreads_or) at the limits that the members before it left;
// - the next pair's super tile is staged while this one is tested: a row
//   is 16 floats [v0, e1, e2 | box | base], and its first three float4 are
//   the rows that isect.cuh::mt_early reads, so those (24 KB a tile, or the
//   CTA's share of the rows under a split) are copied into the other half of
//   a double buffer in shared memory with cp.async, behind the barrier of
//   the pair's vote; rows are then read as LDS.128 broadcasts. Reading them
//   straight from the table through L1 instead took 6-12% longer on every
//   ray set (PERF.md). The test stops at the first condition it fails and
//   returns t or NaN, so the update is one compare, and the running best
//   takes each row's t on a strict < (the least t, the lowest row);
// - the slab test's NaN-propagating min and max are one PTX instruction
//   each (isect.cuh::slab_enter);
// - lanes whose output is thrown away (inactive, or past the last ray) test
//   no triangle: their limit is -inf whatever their best, so their votes
//   do not change;
// - 32 registers a thread (__launch_bounds__(1024, 2), with a few hundred
//   bytes of spills), so two blocks fit an SM and a 262,144-ray call is one
//   wave; one block an SM at 48 registers was faster on camera rays and
//   slower on bounce-1 rays (PERF.md);
// - a call of fewer ray blocks than the card holds (the compacted tiers of
//   ops/intersect.py::with_tail_compaction: n/8 is 32 blocks at 262,144
//   rays) splits each member's rows over a thread block cluster of `split`
//   CTAs (2, 4 or 8) on as many SMs, every CTA holding all 1,024 lanes.
//   Each CTA tests its share of the rows (least t, lowest row), writes the
//   lane's candidate to its shared memory, and after one cluster barrier
//   every CTA merges the candidates of all ranks in rank order (strict <)
//   into its best, read through distributed shared memory. The merge gives
//   the same (t, row) as one CTA's pass over all rows, so every CTA holds
//   the same bests and takes the same votes, locally.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "isect.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace wpt;

constexpr int kBlock = 1024;  // ops/pairs.py BN
constexpr int kK = 64;        // ops/pairs.py PAIRS_K
constexpr int kGroup = 8;     // ops/pairs.py PAIRS_GROUP
constexpr int kCols = 16;     // ops/pairs.py PAIRS_COLS
constexpr int kRow4 = kCols / 4;          // float4 a row
constexpr int kMember4 = kK * kRow4;      // float4 a member cluster
constexpr int kTile4 = kGroup * kMember4;  // float4 a super tile
constexpr int kBlocksPerSm = 2;
constexpr int kMaxSplit = 8;  // CTAs a ray block at most (a portable cluster)

// The first three float4 of rows [row0, row0 + kRows) of each member of a
// super tile into dst, as one cp.async commit group.
template <int kRows>
__device__ __forceinline__ void stage_tile(float4* dst,
                                           const float4* __restrict__ tile,
                                           int row0) {
  for (int q = threadIdx.x; q < kGroup * kRows * 3; q += kBlock) {
    const int sj = q / 3;
    const int s = sj / kRows;
    copy_async16(dst + q,
                 tile + s * kMember4 + (row0 + sj - s * kRows) * kRow4 +
                     (q - sj * 3));
  }
  copy_async_commit();
}

// Whether the ray enters the box of the member at `member` (its first row's
// float4 2 and 3: [e2.z, min3], [max3, base]) at or below `lim`.
__device__ __forceinline__ bool member_entry(const float4* __restrict__ member,
                                             const Ray& r, float lim) {
  const float4 lo = member[2];
  const float4 hi = member[3];
  float tn;
  return slab_entry_div(lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, r, lim, &tn);
}

// kSplit: the CTAs of a ray block (1, or a cluster of 2, 4 or 8).
template <int kSplit>
__global__ void __launch_bounds__(kBlock, kBlocksPerSm)
pairs_kernel(const float4* __restrict__ tris,
             const long long* __restrict__ cids,
             const long long* __restrict__ counts,
             const float* __restrict__ ro, const float* __restrict__ rd,
             const float* __restrict__ lim0_in,
             const bool* __restrict__ active, float* __restrict__ t_out,
             int* __restrict__ idx_out, int n, int cs, int num_tris) {
  // The block's member mask of pair p in votes[p % 3]: a word is cleared
  // two pairs ahead of its use, behind a barrier that every thread passes
  // after its last read and before its next write.
  __shared__ unsigned votes[3];
  // With kSplit > 1: each lane's candidate of this CTA's rows, double
  // buffered by member (a buffer is written again only after the next
  // cluster barrier, which every CTA reaches after its reads of it).
  __shared__ float cand_t[kSplit > 1 ? 2 : 1][kBlock];
  __shared__ unsigned char cand_row[kSplit > 1 ? 2 : 1][kBlock];
  // Two staged tiles: the CTA's kRows rows of each member, three float4 a
  // row.
  extern __shared__ float4 staged[];
  constexpr int kRows = kK / kSplit;
  constexpr int kPart4 = kGroup * kRows * 3;
  const int b = blockIdx.x / kSplit;
  const int part = blockIdx.x % kSplit;  // the CTA's rank in its cluster
  const int row0 = part * kRows;
  const int i = b * kBlock + threadIdx.x;
  const bool real = i < n;
  const bool live = real && (active == nullptr || active[i]);
  const Ray r = real ? load_ray(ro, rd, n, i) : pad_ray();
  const float lim0 = real ? lim0_in[i] : -CUDART_INF_F;
  if (threadIdx.x < 3) votes[threadIdx.x] = 0;
  __syncthreads();

  float best_t = CUDART_INF_F;
  int best_i = -1;
  int buf = 0;
  const int count = static_cast<int>(counts[b]);
  const long long* my_cids = cids + static_cast<size_t>(b) * cs;
  if (count > 0) {
    stage_tile<kRows>(staged, tris + static_cast<size_t>(my_cids[0]) * kTile4,
                      row0);
  }
  for (int p = 0; p < count; ++p) {
    const float4* tile = tris + static_cast<size_t>(my_cids[p]) * kTile4;
    const float lim = min_nan(best_t, lim0);
    unsigned mine = 0;
#pragma unroll
    for (int s = 0; s < kGroup; ++s) {
      if (member_entry(tile + s * kMember4, r, lim)) mine |= 1u << s;
    }
    mine = __reduce_or_sync(0xffffffffu, mine);
    if ((threadIdx.x & 31) == 0 && mine != 0) atomicOr(&votes[p % 3], mine);
    copy_async_wait();
    // Pair p's rows are staged for every thread, and no thread reads pair
    // p - 1's buffer any more.
    __syncthreads();
    unsigned mask = votes[p % 3];
    if (threadIdx.x == 0) votes[(p + 2) % 3] = 0;
    if (p + 1 < count) {
      stage_tile<kRows>(staged + ((p + 1) & 1) * kPart4,
                        tris + static_cast<size_t>(my_cids[p + 1]) * kTile4,
                        row0);
    }
    const float4* staged_rows = staged + (p & 1) * kPart4;  // pair p
    bool first = true;
    while (mask != 0) {
      const int s = __ffs(mask) - 1;
      mask &= mask - 1;
      const float4* member = tile + s * kMember4;
      if (!first &&
          !__syncthreads_or(member_entry(member, r, min_nan(best_t, lim0)))) {
        continue;
      }
      first = false;
      const int base = static_cast<int>(member[3].w);
      if constexpr (kSplit == 1) {
        if (live) {
#pragma unroll 4
          for (int k = 0; k < kK; ++k) {
            const float4* row = staged_rows + (s * kRows + k) * 3;
            const float t = mt_early(r, row[0], row[1], row[2]);  // NaN: miss
            if (t < best_t) {
              best_t = t;
              best_i = base + k;
            }
          }
        }
      } else {
        float ct = CUDART_INF_F;
        int crow = 0;
        if (live) {
#pragma unroll 4
          for (int k = row0; k < row0 + kK / kSplit; ++k) {
            const float4* row = staged_rows + (s * kRows + k - row0) * 3;
            const float t = mt_early(r, row[0], row[1], row[2]);
            if (t < ct) {
              ct = t;
              crow = k;
            }
          }
        }
        cand_t[buf][threadIdx.x] = ct;
        cand_row[buf][threadIdx.x] = static_cast<unsigned char>(crow);
        cg::this_cluster().sync();
        for (int g = 0; g < kSplit; ++g) {
          const float t = *cg::this_cluster().map_shared_rank(
              &cand_t[buf][threadIdx.x], g);
          if (t < best_t) {
            best_t = t;
            best_i = base + *cg::this_cluster().map_shared_rank(
                                &cand_row[buf][threadIdx.x], g);
          }
        }
        buf ^= 1;
      }
    }
  }
  if constexpr (kSplit > 1) {
    cg::this_cluster().sync();  // no CTA leaves while its buffers are read
  }
  if (real && part == 0) {
    store_hit(t_out, idx_out, i, best_t, best_i, num_tris, live);
  }
}

template <int kSplit>
cudaError_t launch(cudaStream_t stream, int blocks, const void* tris,
                   const void* cids, const void* counts, const void* ro,
                   const void* rd, const void* lim0, const void* active,
                   void* t_out, void* idx_out, int n, int cs, int num_tris) {
  cudaLaunchConfig_t config = {};
  const int bytes = 2 * kGroup * (kK / kSplit) * 3 * sizeof(float4);
  static bool opted = false;
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        pairs_kernel<kSplit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  config.gridDim = dim3(blocks * kSplit);
  config.blockDim = dim3(kBlock);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kSplit;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(
      &config, pairs_kernel<kSplit>, static_cast<const float4*>(tris),
      static_cast<const long long*>(cids),
      static_cast<const long long*>(counts), static_cast<const float*>(ro),
      static_cast<const float*>(rd), static_cast<const float*>(lim0),
      static_cast<const bool*>(active), static_cast<float*>(t_out),
      static_cast<int*>(idx_out), n, cs, num_tris);
}

}  // namespace

extern "C" int wpt_pairs(const void* tris, const void* cids,
                         const void* counts, const void* ro, const void* rd,
                         const void* lim0, const void* active, void* t_out,
                         void* idx_out, int n, int cs, int num_tris,
                         void* stream) {
  static int slots = 0;  // resident CTAs on the whole card
  if (slots == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const int bytes = 2 * kGroup * kK * 3 * sizeof(float4);
    cudaFuncSetAttribute(pairs_kernel<1>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pairs_kernel<1>,
                                                  kBlock, bytes);
    slots = sms * (per_sm > 0 ? per_sm : 1);
  }
  // The widest split (at most kMaxSplit) whose CTAs all fit the card at
  // once.
  const int blocks = (n + kBlock - 1) / kBlock;
  int split = 1;
  while (split < kMaxSplit && blocks * split * 2 <= slots) split *= 2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (split) {
    case 1:
      err = launch<1>(s, blocks, tris, cids, counts, ro, rd, lim0, active,
                      t_out, idx_out, n, cs, num_tris);
      break;
    case 2:
      err = launch<2>(s, blocks, tris, cids, counts, ro, rd, lim0, active,
                      t_out, idx_out, n, cs, num_tris);
      break;
    case 4:
      err = launch<4>(s, blocks, tris, cids, counts, ro, rd, lim0, active,
                      t_out, idx_out, n, cs, num_tris);
      break;
    default:
      err = launch<kMaxSplit>(s, blocks, tris, cids, counts, ro, rd, lim0,
                              active, t_out, idx_out, n, cs, num_tris);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
