// Order-fixed scatter-sum on Hopper: buf[key[k]] += vals[perm[k]] over the
// sources sorted by target, each target summing its contributions one after
// another in source order, on top of its initial value.
//
// Port-only: it has no Pallas counterpart. It replaces XLA's scatter-add
// (`x.at[idx].add(v)`) at the places where the JAX package sums floats into
// rows chosen by an index: propagate's pass 2
// (lsd_slam_tpu/depth/regularize.py:169), the pose-graph assembly
// (lsd_slam_tpu/mapping/pose_graph.py:57-63), the sparse PGO's rhs,
// diagonal blocks and matvec (mapping/sparse_pgo.py:63-99) and the
// appearance descriptor's histograms (mapping/appearance.py:92-105).
// PyTorch's `index_add_` on the card adds with atomics, whose order changes
// from run to run; this kernel gives the CPU's sequential `index_add_`
// bits on the card, every run.
//
// Inputs: `keys` (M,) int64 targets sorted stably (torch.sort(stable=True)),
// `perm` (M,) int64 the source index of each sorted position, `vals` (M, C)
// f32 rows, `buf` (T, C) f32 updated in place. One thread per (sorted
// position, column); the thread at the head of a segment (the first
// position of its key) walks the segment in order and writes the target
// once, every other thread returns. A key outside [0, T) is a caller's bug:
// it fails a device-side assert, as PyTorch's own `index_add_` kernel does,
// and the next call that synchronises raises. The sums are plain f32 adds
// (-fmad=false changes nothing here: there is no product).
//
// Bound: memory. Each source reads its key, its perm entry and C floats,
// each target reads and writes C floats: (16 + 4C) B per source plus 8C B
// per touched target. The walk of a segment is sequential by design (the
// order is the contract), so a target with many sources is latency-bound:
// one dependent load chain per segment. Propagate's segments are short
// (it sends its dropped pixels to their own pixel with +0.0 instead of one
// dump slot) and the PGO's are a vertex's edges; the appearance
// descriptor's are long (at 640x480, level 2: about 1,200 sources into
// each of 16 tile sums per roll, about 300 into each histogram bin), and
// chip_smoke.py's [scatter] phase times that shape.

#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void segment_sum_kernel(const int64_t* __restrict__ keys,
                                   const int64_t* __restrict__ perm,
                                   const float* __restrict__ vals,
                                   float* __restrict__ buf, int64_t m, int c,
                                   int64_t n_targets) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= m * c) return;
  const int64_t k = t / c;
  const int col = static_cast<int>(t - k * c);
  const int64_t key = keys[k];
  assert(key >= 0 && key < n_targets &&
         "ordered_index_add: target out of range");
  if (k > 0 && keys[k - 1] == key) return;  // not the head of its segment
  float acc = buf[key * c + col];
  for (int64_t j = k; j < m && keys[j] == key; ++j) {
    acc += vals[perm[j] * c + col];
  }
  buf[key * c + col] = acc;
}

}  // namespace

extern "C" int lsd_segment_sum(const int64_t* keys, const int64_t* perm,
                               const float* vals, float* buf, int64_t m,
                               int c, int64_t n_targets, void* stream) {
  if (m <= 0 || c <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (m * c + threads - 1) / threads;
  segment_sum_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      keys, perm, vals, buf, m, c, n_targets);
  return static_cast<int>(cudaGetLastError());
}
