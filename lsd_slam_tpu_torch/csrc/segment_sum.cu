// Order-fixed scatter-sum on Hopper: buf[idx[i]] += vals[i], each target
// summing its sources one after another in source order, on top of its
// initial value: a left fold, the CPU `index_add_`'s bits, every run.
//
// Port-only: it has no Pallas counterpart. It replaces XLA's scatter-add
// (`x.at[idx].add(v)`) where the JAX package sums floats into rows chosen
// by an index: propagate's pass 2 (lsd_slam_tpu/depth/regularize.py:239-244),
// the pose-graph assembly (lsd_slam_tpu/mapping/pose_graph.py:57-63), the
// sparse PGO's matvec, rhs and diagonal blocks
// (lsd_slam_tpu/mapping/sparse_pgo.py:69-93) and the appearance
// descriptor's histograms and tile sums
// (lsd_slam_tpu/mapping/appearance.py:93-105). PyTorch's `index_add_` on
// the card adds with atomics, whose order changes from run to run.
//
// Two steps, each one C entry.
//
// 1. The order (`lsd_segment_order`): from `idx` (M,) int64 in source
//    order and T, the CSR form of the stable sort of `idx`: `offsets`
//    (T+1,) int32 and `perm` (M,) int32, the source ids of each target,
//    ascending within the target. It is exactly torch.sort(idx,
//    stable=True)'s permutation, computed with no host pull. A key outside
//    [0, T) fails a device-side assert in the count kernel (the next call
//    that synchronises raises). The host picks one of two paths from T:
//    - few targets (T <= 4,096: the PGO's vertices, the appearance tiles
//      and bins), a stable counting sort with no atomics in device memory:
//        count  a block per chunk of sources counts each target's sources
//               in shared memory and writes its column of a (T, chunks)
//               count matrix;
//        scan   the exclusive prefix of that matrix, target-major: each
//               (target, chunk) gets the first slot of its sources;
//        place  each block counts again per warp, takes each warp's first
//               slot per target, and walks its sources in order: a source
//               goes to its warp's next slot for its key plus its rank
//               among its round's lanes of that key (__match_any_sync).
//               Placed in source order, so no sort. Chunk 0 writes
//               `offsets`.
//    - many targets (propagate: 307,200 pixels, about one source each):
//        count  an integer atomicAdd per key (exact, any order), a block
//               per 4,096 sources;
//        scan   as above, over the T counts;
//        place  slot offsets[key] + atomicSub of the key's count (any
//               order within the segment);
//        sort   a segment of at most 16 ids is sorted by one thread in
//               registers by a Batcher network on 4 or 16 registers (5 or
//               63 comparators); a longer one is queued and sorted by a block
//               by merges of sorted runs (each id's place is its rank in
//               its run plus a binary search in the other), in shared
//               memory up to 4,096 ids, beyond that in device memory.
//               Ids are distinct, so the result does not depend on the
//               order in which the atomics placed them.
//    The scan takes a block per tile of 4,096 counts. The count kernel
//    also adds up each tile's total (in shared memory, then one atomic per
//    block and tile), so a block's prefix is one parallel load of the
//    earlier tiles' totals: no block waits for another.
//
// 2. The fold (`lsd_segment_sum`): target-major, each walk bounded by
//    offsets[t] and offsets[t+1]; no thread exists for a source and no
//    key is read back. The host picks the regime from the shapes alone
//    (M against 16 T, scatter.py), and both add the same terms in the
//    same order:
//      short   one thread per target and row (C = 4) or per target and
//              column, walking its segment with the perm entries and
//              values of the next four steps loaded before their
//              dependent adds (propagate: about one source per target;
//              the PGO: a vertex's edges);
//      long    one warp per (target, block of 32 columns): the lanes load
//              up to 1,024 gathered values at a time into shared memory
//              (the next step's perm entries loaded meanwhile), then one
//              lane per column folds them 32 loads ahead of its adds (the
//              appearance tile sums, ~1,200 sources per target, and its
//              histograms, ~300).
//    The sums are plain f32 adds (-fmad=false changes nothing here).
//
// Bounds, with int32 indices and C columns:
//   bytes   the fold reads (4 perm + 4C vals) B per source and (4 offsets
//           + 4C) B per target and writes 4C B per target; the order step
//           reads 8 B (int64 key) per source and writes 4 B of perm per
//           source and 4 B of offsets per target. At 3.35 TB/s.
//   chain   a target's adds are dependent by contract: the longest
//           segment times the FADD latency (4 cycles) at the SM clock.
//           The long regime exists for this bound: its loads go out many
//           at a time, so the fold runs near the add chain, not at a load
//           round trip per step (~180 ns a step on the H100 in a walk that
//           loads each step's key, perm entry and value in turn).
// chip_smoke.py's [scatter] phase computes both from the run's inputs.

#undef NDEBUG
#include <cassert>
#include <climits>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kScanItems = 16;
constexpr int kScanTile = kThreads * kScanItems;  // counts per scan block
constexpr int kShort = 16;      // longest segment sorted by one thread
constexpr int kSortCap = 4096;  // longest segment sorted in shared memory
constexpr int kSortBlocks = 132 * 2;
constexpr int64_t kFewTargets = 4096;     // the stable counting path's T
constexpr int64_t kFewMatrix = 1 << 18;   // its most (target, chunk) counts
constexpr int kFoldWarps = 4;   // warps per block of the long fold
constexpr int kChunk = 1024;    // values per warp per step of the long fold

constexpr int64_t kTileCap = 8192;  // most tile totals kept in shared memory

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// ---- the scan ----

__host__ __device__ int64_t n_scan_tiles(int64_t n) {
  return n / kScanTile + 1;  // a block also covers out[n]
}

// out[i] = in[0] + ... + in[i-1] for i in [0, n], a block per tile of
// kScanTile counts; tile_sums[j] is the total of tile j, added up by the
// kernel that wrote `in`, so a block's prefix is one parallel load of the
// earlier tiles' totals: no look-back and no wait on another block. The
// tile goes through shared memory (one pad word per 32) so that loads and
// stores are coalesced and each thread scans 16 consecutive counts.
__global__ void scan_kernel(const int* __restrict__ in, int64_t n,
                            int* __restrict__ out,
                            const int* __restrict__ tile_sums) {
  __shared__ int s_tile[kScanTile + kScanTile / 32];
  __shared__ int s_warp[kWarps], s_pre[kWarps];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const auto padded = [](int e) { return e + e / 32; };
  const int64_t tile0 = static_cast<int64_t>(tile) * kScanTile;
  int pre = 0;
  for (int j = threadIdx.x; j < tile; j += kThreads) pre += tile_sums[j];
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const int e = k * kThreads + threadIdx.x;
    s_tile[padded(e)] = tile0 + e < n ? in[tile0 + e] : 0;
  }
  __syncthreads();
  const int e0 = threadIdx.x * kScanItems;
  int v[kScanItems];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    v[k] = s_tile[padded(e0 + k)];
    sum += v[k];
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAll, incl, d);
    if (lane >= d) incl += y;
    pre += __shfl_xor_sync(kAll, pre, d);
  }
  if (lane == 31) s_warp[warp] = incl;
  if (lane == 0) s_pre[warp] = pre;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? s_warp[lane] : 0;
    int wi = w, total = lane < kWarps ? s_pre[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kAll, wi, d);
      if (lane >= d) wi += y;
      total += __shfl_xor_sync(kAll, total, d);
    }
    if (lane < kWarps) s_warp[lane] = total + wi - w;
  }
  __syncthreads();
  int run = s_warp[warp] + incl - sum;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    s_tile[padded(e0 + k)] = run;
    run += v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const int e = k * kThreads + threadIdx.x;
    if (tile0 + e <= n) out[tile0 + e] = s_tile[padded(e)];
  }
}

// ---- few targets: a stable counting sort ----

// The keys of this block's warp's sources, kRounds rounds of 32 lanes at a
// time (loaded together, each checked against [0, n_targets)); calls
// fn(i, key, live) for each round in order.
template <typename Fn>
__device__ __forceinline__ void walk_warp_sources(
    const int64_t* __restrict__ idx, int64_t m, int64_t n_targets,
    int64_t chunk, Fn fn) {
  constexpr int kRounds = 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t sub = chunk / kWarps;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * chunk +
                        warp * sub;
  const int64_t end = begin + sub < m ? begin + sub : m;
  for (int64_t i0 = begin; i0 < end; i0 += 32 * kRounds) {
    int64_t keys[kRounds];
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int64_t i = i0 + 32 * u + lane;
      keys[u] = i < end ? idx[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int64_t i = i0 + 32 * u + lane;
      const bool live = i < end;
      assert((!live || (keys[u] >= 0 && keys[u] < n_targets)) &&
             "ordered_index_add: target out of range");
      fn(i, live ? static_cast<int>(keys[u]) : -1, live);
      __syncwarp();  // this round's shared-memory updates, before the next's
    }
  }
}

// counts[key * chunks + blockIdx.x] = sources of the block's chunk at key;
// tile_sums gets the block's share of each scan tile's total
__global__ void few_count_kernel(const int64_t* __restrict__ idx, int64_t m,
                                 int64_t n_targets, int64_t chunk,
                                 int64_t chunks, int* __restrict__ counts,
                                 int* __restrict__ tile_sums) {
  extern __shared__ int hist[];  // n_targets, then the scan tiles' totals
  const int64_t n_tiles = n_scan_tiles(n_targets * chunks);
  int* tiles = hist + n_targets;
  for (int64_t k = threadIdx.x; k < n_targets + n_tiles; k += blockDim.x)
    hist[k] = 0;
  __syncthreads();
  walk_warp_sources(idx, m, n_targets, chunk, [&](int64_t, int key,
                                                  bool live) {
    if (live) atomicAdd(&hist[key], 1);
  });
  __syncthreads();
  for (int64_t k = threadIdx.x; k < n_targets; k += blockDim.x) {
    const int64_t e = k * chunks + blockIdx.x;
    counts[e] = hist[k];
    if (hist[k]) atomicAdd(&tiles[e / kScanTile], hist[k]);
  }
  __syncthreads();
  for (int64_t j = threadIdx.x; j < n_tiles; j += blockDim.x)
    if (tiles[j]) atomicAdd(&tile_sums[j], tiles[j]);
}

// `first` is the exclusive scan of the count matrix: the first slot of
// (key, chunk). Places the chunk's sources in source order: each warp's
// first slot per key, then a source's rank among the earlier sources of
// its warp with its key.
__global__ void few_place_kernel(const int64_t* __restrict__ idx, int64_t m,
                                 int64_t n_targets, int64_t chunk,
                                 int64_t chunks,
                                 const int* __restrict__ first,
                                 int* __restrict__ perm,
                                 int* __restrict__ offsets) {
  extern __shared__ int slot[];  // kWarps x n_targets
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t k = threadIdx.x; k < kWarps * n_targets; k += blockDim.x)
    slot[k] = 0;
  __syncthreads();
  int* mine = slot + warp * n_targets;
  walk_warp_sources(idx, m, n_targets, chunk, [&](int64_t, int key,
                                                  bool live) {
    if (live) atomicAdd(&mine[key], 1);
  });
  __syncthreads();
  for (int64_t k = threadIdx.x; k < n_targets; k += blockDim.x) {
    int run = first[k * chunks + blockIdx.x];
    for (int w = 0; w < kWarps; ++w) {
      const int c = slot[w * n_targets + k];
      slot[w * n_targets + k] = run;
      run += c;
    }
    if (blockIdx.x == 0) offsets[k] = first[k * chunks];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    offsets[n_targets] = first[n_targets * chunks];
  __syncthreads();
  walk_warp_sources(idx, m, n_targets, chunk, [&](int64_t i, int key,
                                                  bool live) {
    const unsigned group = __match_any_sync(kAll, key);  // dead lanes: -1
    const int at = live ? mine[key] + __popc(group & lanes_below(lane)) : 0;
    __syncwarp();
    if (live && (group & lanes_below(lane)) == 0) mine[key] += __popc(group);
    if (live) perm[at] = static_cast<int>(i);
  });
}

// chunks of a multiple of kThreads sources, at most kFewMatrix counts
void few_chunks(int64_t m, int64_t n_targets, int64_t* chunks,
                int64_t* chunk) {
  const int64_t by_m = (m + kThreads - 1) / kThreads;
  const int64_t by_t = kFewMatrix / (n_targets > 0 ? n_targets : 1);
  int64_t n = by_m < by_t ? by_m : by_t;
  if (n < 1) n = 1;
  int64_t s = (m + n - 1) / n;
  s = (s + kThreads - 1) / kThreads * kThreads;
  if (s < kThreads) s = kThreads;
  *chunk = s;
  *chunks = m > 0 ? (m + s - 1) / s : 1;
}

// ---- many targets: atomics, then a sort of each segment ----

// a block per kScanTile sources: counts[key] += 1 for each, and each scan
// tile's total (in shared memory while there are at most kTileCap tiles,
// one add per group of a warp's lanes in one tile)
__global__ void count_kernel(const int64_t* __restrict__ idx, int64_t m,
                             int64_t n_targets, int* __restrict__ counts,
                             int* __restrict__ tile_sums) {
  extern __shared__ int s_tiles[];
  const int64_t n_tiles = n_scan_tiles(n_targets);
  const bool local = n_tiles <= kTileCap;
  const int lane = threadIdx.x & 31;
  if (local) {
    for (int64_t j = threadIdx.x; j < n_tiles; j += kThreads) s_tiles[j] = 0;
    __syncthreads();
  }
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kScanTile +
                     threadIdx.x;
  int64_t keys[kScanItems];
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const int64_t i = i0 + k * kThreads;
    keys[k] = i < m ? idx[i] : -1;
  }
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    const bool live = i0 + k * kThreads < m;
    assert((!live || (keys[k] >= 0 && keys[k] < n_targets)) &&
           "ordered_index_add: target out of range");
    const int tile = live ? static_cast<int>(keys[k] / kScanTile) : -1;
    const unsigned group = __match_any_sync(kAll, tile);
    if (live) {
      atomicAdd(&counts[keys[k]], 1);
      if ((group & lanes_below(lane)) == 0)
        atomicAdd(local ? &s_tiles[tile] : &tile_sums[tile], __popc(group));
    }
  }
  if (local) {
    __syncthreads();
    for (int64_t j = threadIdx.x; j < n_tiles; j += kThreads)
      if (s_tiles[j]) atomicAdd(&tile_sums[j], s_tiles[j]);
  }
}

__global__ void place_kernel(const int64_t* __restrict__ idx, int64_t m,
                             const int* __restrict__ offsets,
                             int* __restrict__ cursor,
                             int* __restrict__ perm) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= m) return;
  const int key = static_cast<int>(idx[i]);
  const int r = atomicSub(&cursor[key], 1) - 1;
  perm[offsets[key] + r] = static_cast<int>(i);
}

// Batcher's odd-even merge sort networks on 4 and 16 registers (5 and 63
// comparators), written out so that every index is a constant
__device__ __forceinline__ void cas(int& x, int& y) {
  const int lo = min(x, y), hi = max(x, y);
  x = lo;
  y = hi;
}

__device__ __forceinline__ void sort_network(int (&v)[4]) {
  cas(v[0], v[1]); cas(v[2], v[3]); cas(v[0], v[2]); cas(v[1], v[3]);
  cas(v[1], v[2]);
}

__device__ __forceinline__ void sort_network(int (&v)[16]) {
  cas(v[0], v[1]); cas(v[2], v[3]); cas(v[4], v[5]); cas(v[6], v[7]);
  cas(v[8], v[9]); cas(v[10], v[11]); cas(v[12], v[13]); cas(v[14], v[15]);
  cas(v[0], v[2]); cas(v[1], v[3]); cas(v[4], v[6]); cas(v[5], v[7]);
  cas(v[8], v[10]); cas(v[9], v[11]); cas(v[12], v[14]); cas(v[13], v[15]);
  cas(v[1], v[2]); cas(v[5], v[6]); cas(v[9], v[10]); cas(v[13], v[14]);
  cas(v[0], v[4]); cas(v[1], v[5]); cas(v[2], v[6]); cas(v[3], v[7]);
  cas(v[8], v[12]); cas(v[9], v[13]); cas(v[10], v[14]); cas(v[11], v[15]);
  cas(v[2], v[4]); cas(v[3], v[5]); cas(v[10], v[12]); cas(v[11], v[13]);
  cas(v[1], v[2]); cas(v[3], v[4]); cas(v[5], v[6]); cas(v[9], v[10]);
  cas(v[11], v[12]); cas(v[13], v[14]); cas(v[0], v[8]); cas(v[1], v[9]);
  cas(v[2], v[10]); cas(v[3], v[11]); cas(v[4], v[12]); cas(v[5], v[13]);
  cas(v[6], v[14]); cas(v[7], v[15]); cas(v[4], v[8]); cas(v[5], v[9]);
  cas(v[6], v[10]); cas(v[7], v[11]); cas(v[2], v[4]); cas(v[3], v[5]);
  cas(v[6], v[8]); cas(v[7], v[9]); cas(v[10], v[12]); cas(v[11], v[13]);
  cas(v[1], v[2]); cas(v[3], v[4]); cas(v[5], v[6]); cas(v[7], v[8]);
  cas(v[9], v[10]); cas(v[11], v[12]); cas(v[13], v[14]);
}

// One thread per target: a segment of at most kShort ids is sorted in
// registers; a longer one goes on the list of `sort_long_kernel`.
__global__ void sort_short_kernel(const int* __restrict__ offsets,
                                  int64_t n_targets, int* __restrict__ perm,
                                  int* __restrict__ long_list,
                                  int* __restrict__ n_long) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= n_targets) return;
  const int a = offsets[t];
  const int len = offsets[t + 1] - a;
  if (len <= 1) return;
  if (len > kShort) {
    long_list[atomicAdd(n_long, 1)] = static_cast<int>(t);
    return;
  }
  if (len <= 4) {  // nearly every segment of propagate
    int v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = k < len ? perm[a + k] : INT_MAX;
    sort_network(v);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < len) perm[a + k] = v[k];
    return;
  }
  int v[kShort];
#pragma unroll
  for (int k = 0; k < kShort; ++k) v[k] = k < len ? perm[a + k] : INT_MAX;
  sort_network(v);
#pragma unroll
  for (int k = 0; k < kShort; ++k)
    if (k < len) perm[a + k] = v[k];
}

// One pass of the block's merge sort over `len` ids: runs of `w` sorted
// ids are merged in pairs into runs of 2w, from `src` into `dst`.
__device__ void merge_pass(const int* src, int* dst, int len, int w) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int run = i / w;
    const int x = src[i];
    const int lo0 = (run ^ 1) * w;
    int below = 0;  // ids of the partner run below x
    if (lo0 < len) {
      int lo = lo0, hi = min(lo0 + w, len);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (src[mid] < x) lo = mid + 1; else hi = mid;
      }
      below = lo - lo0;
    }
    dst[(run & ~1) * w + (i - run * w) + below] = x;
  }
}

__global__ void __launch_bounds__(kThreads)
sort_long_kernel(const int* __restrict__ offsets,
                 const int* __restrict__ long_list,
                 const int* __restrict__ n_long, int* perm, int* scratch) {
  __shared__ int sa[kSortCap], sb[kSortCap];
  const int count = *n_long;
  for (int s = blockIdx.x; s < count; s += gridDim.x) {
    const int t = long_list[s];
    const int a = offsets[t];
    const int len = offsets[t + 1] - a;
    const bool fits = len <= kSortCap;
    int* src = fits ? sa : perm + a;
    int* dst = fits ? sb : scratch + a;
    if (fits) {
      for (int i = threadIdx.x; i < len; i += blockDim.x) sa[i] = perm[a + i];
      __syncthreads();
    }
    for (int w = 1; w < len; w <<= 1) {
      merge_pass(src, dst, len, w);
      __syncthreads();
      int* tmp = src; src = dst; dst = tmp;
    }
    if (src != perm + a) {
      for (int i = threadIdx.x; i < len; i += blockDim.x) perm[a + i] = src[i];
    }
    __syncthreads();  // the shared buffers are reused by the next segment
  }
}

// ---- the fold ----

// short regime: one thread per (target, CPT columns); C % CPT == 0
template <int CPT>
__global__ void fold_short_kernel(const int* __restrict__ offsets,
                                  const int* __restrict__ perm,
                                  const float* __restrict__ vals,
                                  float* __restrict__ buf, int64_t n_targets,
                                  int c) {
  const int groups = c / CPT;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (g >= n_targets * groups) return;
  const int64_t t = g / groups;
  const int c0 = static_cast<int>(g - t * groups) * CPT;
  float* out = buf + t * c + c0;
  const int a = offsets[t], b = offsets[t + 1];
  if (a == b) return;
  float acc[CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) acc[q] = out[q];
  const float* col = vals + c0;
  int j = a;
  for (; j + 4 <= b; j += 4) {
    int p[4];
    float v[4][CPT];
#pragma unroll
    for (int u = 0; u < 4; ++u) p[u] = perm[j + u];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int q = 0; q < CPT; ++q)
        v[u][q] = col[static_cast<int64_t>(p[u]) * c + q];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int q = 0; q < CPT; ++q) acc[q] += v[u][q];
  }
  for (; j < b; ++j) {
    const float* row = col + static_cast<int64_t>(perm[j]) * c;
#pragma unroll
    for (int q = 0; q < CPT; ++q) acc[q] += row[q];
  }
#pragma unroll
  for (int q = 0; q < CPT; ++q) out[q] = acc[q];
}

// long regime: one warp per (target, block of 32 columns); K sources per
// step, K * min(C, 32) <= kChunk. Each lane copies the rows of its own
// sources (perm entries in its registers) into shared memory with cp.async,
// each column contiguous; step i+1's copies are in flight while step i
// folds, and a column is read 16 bytes at a time, 8 loads ahead of its
// 32 adds.
template <int K>
__global__ void __launch_bounds__(kFoldWarps * 32)
fold_long_kernel(const int* __restrict__ offsets,
                 const int* __restrict__ perm,
                 const float* __restrict__ vals, float* __restrict__ buf,
                 int64_t n_targets, int c) {
  __shared__ __align__(16) float s_vals[kFoldWarps][2][kChunk];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int n_cb = (c + 31) / 32;
  const int64_t gw = static_cast<int64_t>(blockIdx.x) * kFoldWarps + wid;
  if (gw >= n_targets * n_cb) return;  // the whole warp
  const int64_t t = gw / n_cb;
  const int c0 = static_cast<int>(gw - t * n_cb) * 32;
  const int ncol = min(32, c - c0);
  const int a = offsets[t], b = offsets[t + 1];
  if (a == b) return;
  float* out = buf + t * c + c0;
  float acc = lane < ncol ? out[lane] : 0.0f;
  const float* cols = vals + c0;
  int p[K / 32];
  const auto load_perm = [&](int j0) {
#pragma unroll
    for (int r = 0; r < K / 32; ++r) {
      const int k = lane + 32 * r;
      if (j0 + k < b) p[r] = perm[j0 + k];
    }
  };
  const auto copy_step = [&](int j0, float* sv) {
#pragma unroll
    for (int r = 0; r < K / 32; ++r) {
      const int k = lane + 32 * r;
      if (j0 + k < b) {
        const float* row = cols + static_cast<int64_t>(p[r]) * c;
        for (int q = 0; q < ncol; ++q)
          __pipeline_memcpy_async(sv + q * K + k, row + q, sizeof(float));
      }
    }
    __pipeline_commit();
  };
  load_perm(a);
  copy_step(a, s_vals[wid][0]);
  load_perm(a + K);
  for (int j0 = a, step = 0; j0 < b; j0 += K, ++step) {
    const bool more = j0 + K < b;
    if (more) {
      copy_step(j0 + K, s_vals[wid][(step + 1) & 1]);
      load_perm(j0 + 2 * K);
      __pipeline_wait_prior(1);  // this step's copies have landed
    } else {
      __pipeline_wait_prior(0);
    }
    __syncwarp();
    if (lane < ncol) {
      const float* col = s_vals[wid][step & 1] + lane * K;
      const float4* col4 = reinterpret_cast<const float4*>(col);
      const int n = min(K, b - j0);
      int k4 = 0;
      for (; 4 * (k4 + 8) <= n; k4 += 8) {
        float4 x[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) x[u] = col4[k4 + u];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          acc += x[u].x;
          acc += x[u].y;
          acc += x[u].z;
          acc += x[u].w;
        }
      }
      for (int k = 4 * k4; k < n; ++k) acc += col[k];
    }
    __syncwarp();  // the buffer is refilled two steps on
  }
  if (lane < ncol) out[lane] = acc;
}

template <int CPT>
cudaError_t launch_short(const int* offsets, const int* perm,
                         const float* vals, float* buf, int64_t n_targets,
                         int c, cudaStream_t stream) {
  const int64_t threads = n_targets * (c / CPT);
  fold_short_kernel<CPT><<<static_cast<unsigned>(
                               (threads + kThreads - 1) / kThreads),
                           kThreads, 0, stream>>>(offsets, perm, vals, buf,
                                                  n_targets, c);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_long(const int* offsets, const int* perm,
                        const float* vals, float* buf, int64_t n_targets,
                        int c, cudaStream_t stream) {
  const int64_t warps = n_targets * ((c + 31) / 32);
  const int64_t blocks = (warps + kFoldWarps - 1) / kFoldWarps;
  fold_long_kernel<K><<<static_cast<unsigned>(blocks), kFoldWarps * 32, 0,
                        stream>>>(offsets, perm, vals, buf, n_targets, c);
  return cudaGetLastError();
}


}  // namespace

// The int32 scratch of one order step: `zeroed` ints the caller zeroes and
// `spare` ints it need not. Few targets: zeroed = the scan tiles' totals;
// spare = the count matrix and its scan. Many targets: zeroed = counts
// (then the long-segment list), the scan tiles' totals and the list's
// length; spare = the merge buffer of segments longer than kSortCap.
extern "C" void lsd_segment_order_scratch(int64_t m, int64_t n_targets,
                                          int64_t* zeroed, int64_t* spare) {
  if (n_targets <= kFewTargets) {
    int64_t chunks, chunk;
    few_chunks(m, n_targets, &chunks, &chunk);
    const int64_t n = n_targets * chunks;
    *zeroed = n_scan_tiles(n);
    *spare = 2 * n + 1;
    return;
  }
  *zeroed = n_targets + n_scan_tiles(n_targets) + 1;
  *spare = m > kSortCap ? m : 0;
}

// `*launched` gets the number of kernels launched (0 to 5); a memset is not
// counted.
extern "C" int lsd_segment_order(const int64_t* idx, int64_t m,
                                 int64_t n_targets, int* offsets, int* perm,
                                 int* zeroed, int* spare, void* stream_,
                                 int* launched) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  *launched = 0;
  // after each launch: its error, if any, and the count
  const auto launch_error = [launched]() {
    const cudaError_t e = cudaGetLastError();
    if (e == cudaSuccess) ++*launched;
    return e;
  };
  const auto blocks = [](int64_t n, int64_t per) {
    return static_cast<unsigned>((n + per - 1) / per);
  };
  cudaError_t err;
  if (n_targets <= kFewTargets) {
    if (m == 0)
      return static_cast<int>(cudaMemsetAsync(
          offsets, 0, sizeof(int) * (n_targets + 1), stream));
    int64_t chunks, chunk;
    few_chunks(m, n_targets, &chunks, &chunk);
    const int64_t n = n_targets * chunks;
    int* counts = spare;
    int* first = spare + n;
    few_count_kernel<<<static_cast<unsigned>(chunks), kThreads,
                       sizeof(int) * (n_targets + n_scan_tiles(n)),
                       stream>>>(idx, m, n_targets, chunk, chunks, counts,
                                 zeroed);
    if ((err = launch_error()) != cudaSuccess) return err;
    scan_kernel<<<static_cast<unsigned>(n_scan_tiles(n)), kThreads, 0,
                  stream>>>(counts, n, first, zeroed);
    if ((err = launch_error()) != cudaSuccess) return err;
    const size_t smem = sizeof(int) * kWarps * n_targets;
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(
             few_place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             static_cast<int>(smem))) != cudaSuccess)
      return err;
    few_place_kernel<<<static_cast<unsigned>(chunks), kThreads, smem,
                       stream>>>(idx, m, n_targets, chunk, chunks, first,
                                 perm, offsets);
    return static_cast<int>(launch_error());
  }
  const int64_t n_tiles = n_scan_tiles(n_targets);
  int* counts = zeroed;  // then the list of long segments
  int* tile_sums = zeroed + n_targets;
  int* n_long = tile_sums + n_tiles;
  if (m > 0) {
    count_kernel<<<blocks(m, kScanTile), kThreads,
                   n_tiles <= kTileCap ? sizeof(int) * n_tiles : 0,
                   stream>>>(idx, m, n_targets, counts, tile_sums);
    if ((err = launch_error()) != cudaSuccess) return err;
  }
  scan_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, stream>>>(
      counts, n_targets, offsets, tile_sums);
  if ((err = launch_error()) != cudaSuccess) return err;
  if (m == 0) return 0;
  place_kernel<<<blocks(m, kThreads), kThreads, 0, stream>>>(
      idx, m, offsets, counts, perm);
  if ((err = launch_error()) != cudaSuccess) return err;
  if (m < 2) return 0;
  sort_short_kernel<<<blocks(n_targets, kThreads), kThreads, 0, stream>>>(
      offsets, n_targets, perm, counts, n_long);
  if ((err = launch_error()) != cudaSuccess) return err;
  if (m <= kShort) return 0;
  int64_t grid = m / (kShort + 1);
  if (grid > kSortBlocks) grid = kSortBlocks;
  sort_long_kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      offsets, counts, n_long, perm, spare);
  return static_cast<int>(launch_error());
}

// regime 0: short segments, 1: long segments (the same bits); `*launched`
// gets the number of kernels launched (0 or 1)
extern "C" int lsd_segment_sum(const int* offsets, const int* perm,
                               const float* vals, float* buf,
                               int64_t n_targets, int c, int regime,
                               void* stream_, int* launched) {
  *launched = 0;
  if (n_targets <= 0 || c <= 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaError_t err;
  if (regime == 0)  // a whole row per thread for propagate's (M, 4)
    err = c == 4 ? launch_short<4>(offsets, perm, vals, buf, n_targets, c,
                                   stream)
                 : launch_short<1>(offsets, perm, vals, buf, n_targets, c,
                                   stream);
  // sources per step: the appearance histograms (C = 1) and tile sums
  // (C = 2) take 1,024 values a step, other widths 32 sources
  else if (c == 1)
    err = launch_long<1024>(offsets, perm, vals, buf, n_targets, c, stream);
  else if (c == 2)
    err = launch_long<512>(offsets, perm, vals, buf, n_targets, c, stream);
  else
    err = launch_long<32>(offsets, perm, vals, buf, n_targets, c, stream);
  if (err == cudaSuccess) *launched = 1;
  return static_cast<int>(err);
}
