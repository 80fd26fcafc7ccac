// The grid of a one-launch kernel over a model's leaves (robust_agg.cu,
// secagg_mask.cu): which blocks take which leaf, and within a leaf which
// thread takes which elements.  The kernels' wrappers pass each leaf's
// pointers and element count; every decision about the grid is made here,
// on the host side of the entry points and in the kernels.
//
// Thread t < D / 4 of a leaf owns elements 4t..4t+3.  When D % 4 != 0 the
// last D % 4 elements go to one thread in a warp of its own (tail_thread, as
// in shard_finalize.cu), so no warp runs both the float4 and the scalar
// branch.  A leaf takes blocks_of(D) consecutive blocks of the grid from
// its block0 on, and a block finds its leaf by a scan of the table's
// block0s (uniform across the block), so no block straddles two leaves.  A
// launch holds up to kMaxLeaves leaves; a longer table takes more launches.
//
// The host part builds with a host C++ compiler as well:
// tests/test_torch_fused_agg.py checks the block map with one.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define LEAF_TABLE_HD __host__ __device__ __forceinline__
#else
#define LEAF_TABLE_HD inline
#endif

namespace leaf_table {

constexpr int kThreads = 256;     // threads of a block
constexpr int kPerThread = 4;     // elements of a thread: one float4
constexpr int kMaxLeaves = 64;    // leaves of one launch's table

// The thread that takes the last D % 4 elements when there are n_vec whole
// float4 groups: the first thread of the next warp.
LEAF_TABLE_HD int64_t tail_thread(int64_t n_vec) {
  return (n_vec + 31) / 32 * 32;
}

// Blocks over a leaf of d elements: a thread per float4 and the tail
// thread, if d % 4.
LEAF_TABLE_HD int64_t vec_blocks(int64_t d) {
  const int64_t n_vec = d / kPerThread;
  const int64_t threads =
      d % kPerThread == 0 ? n_vec : tail_thread(n_vec) + 1;
  return (threads + kThreads - 1) / kThreads;
}

// The first element and the count (4, or the d % 4 tail) of thread i of a
// leaf of d elements; false if it owns none.
LEAF_TABLE_HD bool owned(int64_t i, int64_t d, int64_t* d0, int* cnt) {
  const int64_t n_vec = d / kPerThread;
  if (i < n_vec) {
    *d0 = i * kPerThread;
    *cnt = kPerThread;
    return true;
  }
  if (d % kPerThread && i == tail_thread(n_vec)) {
    *d0 = n_vec * kPerThread;
    *cnt = static_cast<int>(d - *d0);
    return true;
  }
  return false;
}

// The leaf of block b: the last of the n leaves whose block0 <= b.
template <class Leaf>
LEAF_TABLE_HD int find_leaf(const Leaf* leaf, int n, int b) {
  int l = 0;
  while (l + 1 < n && leaf[l + 1].block0 <= b) ++l;
  return l;
}

// Gives leaves [0, n) of a launch their first blocks, blocks_of(leaf.d)
// each, in order; returns the launch's blocks.
template <class Leaf, class Blocks>
inline int64_t assign_blocks(Leaf* leaf, int n, Blocks blocks_of) {
  int64_t total = 0;
  for (int l = 0; l < n; ++l) {
    leaf[l].block0 = static_cast<int32_t>(total);
    total += blocks_of(leaf[l].d);
  }
  return total;
}

#ifdef __CUDACC__

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// cnt (1..4) consecutive floats from p: one 16-byte load where p is
// aligned and cnt == 4, else scalar loads (zeros past cnt).
__device__ __forceinline__ void load4(const float* p, int cnt,
                                      float v[kPerThread]) {
  if (cnt == kPerThread && aligned16(p)) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) v[k] = k < cnt ? p[k] : 0.0f;
  }
}

#endif  // __CUDACC__

}  // namespace leaf_table
