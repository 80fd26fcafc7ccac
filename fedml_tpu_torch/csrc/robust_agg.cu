// Fused robust aggregation over every float leaf of a model in one launch:
// norm-diff clip, weak-DP Gaussian noise and the sample-weighted mean in one
// pass over the cohort; and the clip-norm pass before it, in one launch.
//
// Replaces the TPU kernel fedml_tpu/core/pallas_agg.py::_agg_kernel
// (launched per leaf by _agg_leaf's pallas_call, built by
// make_fused_robust_aggregate) and the XLA reduction of its phase 1
// (_clip_scales).  For a leaf flattened to D elements:
//
//     out[d] = sum_i r_i * (g[d] + s_i * (x[i, d] - g[d]) + sigma * n_i[d])
//     s_i    = min(1, bound / max(||x_i - g||, 1e-12))   (over weight leaves)
//
// x is [N, D] row-major f32, g is [D] f32, s (clip scales) and r
// (normalised weights) are f32 [N] on the device.  n_i[d] is the JAX
// package's counter PRG: a murmur3 finaliser over the element index d and a
// per-client salt, then Box-Muller.  Its uniforms are bit-equal to the JAX
// package's; the Gaussian is computed on the special-function units
// (murmur.cuh's gaussian_fast), within a few 1e-6 of the precise functions.
// The Pallas kernel's element index is the row-major index within the
// padded leaf, which equals d here because this kernel needs no padding.
//
// The leaf table.  The wrapper (core/fused_agg.py) lays the model's float
// leaves out once per tree structure, each at an offset of one flat f32
// output (padded to a multiple of 4 floats, so that every leaf's output
// starts on a 16-byte boundary).  Each call passes a row per leaf with this
// round's pointers and seed words; the entry points below give each leaf
// its blocks of the grid (leaf_table.cuh) and pass the table by value as a
// __grid_constant__ parameter.  A block first puts each client's clip
// scale, weight and noise salt in shared memory (N <= 512).  Within a leaf,
// thread t < D / 4 owns elements 4t..4t+3 and loops over the N clients in
// registers; a row of x that starts on a 16-byte boundary is read as
// float4, another (a row of a leaf whose D is not a multiple of 4, or an
// unaligned view) as four scalars, which neighbouring threads still read
// from neighbouring addresses.  The last D % 4 elements go to one thread
// in a warp of its own.
//
// The clip-norm pass: a grid of chunks of 4096 elements of the weight
// leaves; each block keeps g's chunk in registers and, for every client i,
// sums (x[i, d] - g[d])^2 over the chunk in a fixed order into one partial.
// The last block to finish (an integer ticket; no float atomics) adds each
// client's partials in block order and writes s_i, so two launches on the
// same inputs give the same bits.  A NaN in a client's update makes its
// s_i NaN, as in the plain version.  Two launches a round (norm, aggregate)
// rather than one cooperative launch: x (67.6 MB for the FEMNIST CNN at
// N = 10) is larger than the 50 MB L2, so a grid barrier would not save the
// second read from memory, and it would tie the grid's size to what fits on
// the SMs at once.
//
// What bounds it: memory at sigma = 0.  The aggregate reads x once (4*N*D
// bytes) and g once (4*D) and writes out once (4*D): 81.1 MB for the CNN,
// 24.2 us at the H100 SXM's 3.35 TB/s (data sheet); the norm pass reads x
// and g again (74.4 MB, 22.2 us).  The noise adds per (client, element) two
// murmur finalisers (~20 integer operations), two int-to-float conversions
// and three special-function operations (lg2, rsqrt, cos); at the H100's
// 64 integer and 16 special-function lanes per SM a clock those come close
// to the memory time (chip_smoke.py's bound counts each term).
//
// Floating point: built with -fmad=false, so no multiply-add is contracted
// and every operation of the aggregate rounds where the step-by-step
// PyTorch version (fused_agg.py::robust_agg_plain) rounds.  The norm pass
// adds its squares in another order than PyTorch's sum, so s_i may differ
// from the plain version's by a few ulps.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "leaf_table.cuh"
#include "murmur.cuh"

namespace {

using leaf_table::aligned16;
using leaf_table::find_leaf;
using leaf_table::kMaxLeaves;
using leaf_table::kPerThread;
using leaf_table::kThreads;
using leaf_table::load4;
using leaf_table::owned;
using murmur::fmix;
using murmur::gaussian_fast;
using murmur::index_hash;
using murmur::uniforms;

constexpr int kNormChunk = 4096;    // elements of a leaf per norm block
constexpr int kMaxClients = 512;    // the cohort (fused_agg.MAX_CLIENTS)

// One leaf of a launch.  block0 is the leaf's first block in the launch's
// grid (leaf_table::assign_blocks).  The aggregate's table holds every float leaf; the norm pass's the
// weight leaves only (its out is unused).
struct Leaf {
  const float* x;     // [n, d]
  const float* g;     // [d]
  float* out;         // [d]
  int64_t d;
  uint32_t s0, s1;    // the leaf's noise salts, from its seed words
  int32_t clipped;    // 1: a weight leaf (s_i applies); 0: s_i = 1
  int32_t block0;
};

struct LeafTable {
  int32_t n_leaves;
  Leaf leaf[kMaxLeaves];
};

// The table row the wrapper passes for each leaf, as int64 words.
enum Col { kX, kG, kOut, kD, kSeed0, kSeed1, kClipped, kCols };

// Blocks of the norm pass over a leaf of d elements.
int64_t norm_blocks(int64_t d) { return (d + kNormChunk - 1) / kNormChunk; }

__device__ __forceinline__ uint32_t client_salt(uint32_t s0, uint32_t s1,
                                                uint32_t i) {
  return fmix(s0 ^ (s1 + i * 0x85EBCA6Bu));
}

template <bool kNoise>
__global__ void __launch_bounds__(kThreads)
robust_agg_kernel(const __grid_constant__ LeafTable t,
                  const float* __restrict__ scales,
                  const float* __restrict__ ratios, int n, float sigma) {
  // each client's scale, weight and noise salt for this leaf, once a block
  __shared__ float c_scale[kMaxClients], c_ratio[kMaxClients];
  __shared__ uint32_t c_salt[kMaxClients];
  const Leaf& leaf = t.leaf[find_leaf(t.leaf, t.n_leaves, blockIdx.x)];
  const bool clipped = leaf.clipped && scales != nullptr;
  for (int c = threadIdx.x; c < n; c += kThreads) {
    c_scale[c] = clipped ? scales[c] : 1.0f;
    c_ratio[c] = ratios[c];
    if (kNoise)
      c_salt[c] = client_salt(leaf.s0, leaf.s1, static_cast<uint32_t>(c));
  }
  __syncthreads();

  const int64_t d_total = leaf.d;
  int64_t d0;
  int cnt;
  if (!owned(static_cast<int64_t>(blockIdx.x - leaf.block0) * kThreads
                 + threadIdx.x, d_total, &d0, &cnt))
    return;

  float gv[kPerThread], acc[kPerThread];
  uint32_t idx_h[kPerThread];
  load4(leaf.g + d0, cnt, gv);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    acc[k] = 0.0f;
    if (kNoise) idx_h[k] = index_hash(static_cast<uint32_t>(d0 + k));
  }
  const float* row = leaf.x + d0;
  for (int c = 0; c < n; ++c, row += d_total) {
    const float s = c_scale[c];
    const float r = c_ratio[c];
    float xv[kPerThread];
    load4(row, cnt, xv);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      float term = __fadd_rn(gv[k], __fmul_rn(s, __fsub_rn(xv[k], gv[k])));
      if (kNoise) {
        const float noise = gaussian_fast(idx_h[k], c_salt[c]);
        term = __fadd_rn(term, __fmul_rn(sigma, noise));
      }
      acc[k] = __fadd_rn(acc[k], __fmul_rn(r, term));
    }
  }

  float* o = leaf.out + d0;
  if (cnt == kPerThread && aligned16(o)) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2],
                                                acc[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      if (k < cnt) o[k] = acc[k];
  }
}

// Sum of v over the block, in a fixed order (a shuffle tree in each warp,
// then the warps' sums in warp order); the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sum[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xFFFFFFFFu, v, off));
  __syncthreads();   // warp_sum may still be read by an earlier call
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s = __fadd_rn(s, warp_sum[w]);
  return s;
}

// Block b of the norm pass takes a chunk of kNormChunk elements of one
// weight leaf and, for each client i, sums (x[i, d] - g[d])^2 over it,
// into partial[i * total_blocks + b].  g's chunk stays in registers across
// the clients; each warp reduces its sums by a shuffle tree into shared
// memory, with no barrier between clients, and the warps' sums are added in
// warp order at the end.  The last block of all launches of the pass (done
// counts them) adds each client's partials in block order and writes its
// clip scale.
__global__ void __launch_bounds__(kThreads)
clip_norm_kernel(const __grid_constant__ LeafTable t,
                 float* __restrict__ partial, float* __restrict__ scales,
                 unsigned* __restrict__ done, int block_base,
                 int total_blocks, int n, float bound) {
  extern __shared__ float warp_part[];   // [n][kThreads / 32]
  constexpr int kWarps = kThreads / 32;
  constexpr int kVecs = kNormChunk / (kPerThread * kThreads);
  const Leaf& leaf = t.leaf[find_leaf(t.leaf, t.n_leaves, blockIdx.x)];
  const int64_t e0 =
      static_cast<int64_t>(blockIdx.x - leaf.block0) * kNormChunk;
  const int64_t e1 = leaf.d < e0 + kNormChunk ? leaf.d : e0 + kNormChunk;
  // every row starts on a 16-byte boundary, and so does g
  const bool vec = leaf.d % kPerThread == 0 && aligned16(leaf.x) &&
                   aligned16(leaf.g);
  float4 gv[kVecs];
#pragma unroll
  for (int v = 0; v < kVecs; ++v) {
    const int64_t e = e0 + kPerThread * (threadIdx.x + v * kThreads);
    gv[v] = vec && e < e1 ? *reinterpret_cast<const float4*>(leaf.g + e)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int c = 0; c < n; ++c) {
    const float* row = leaf.x + static_cast<int64_t>(c) * leaf.d;
    float acc = 0.0f;
    if (vec) {
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        const int64_t e = e0 + kPerThread * (threadIdx.x + v * kThreads);
        if (e < e1) {
          const float4 a = *reinterpret_cast<const float4*>(row + e);
          const float d0 = __fsub_rn(a.x, gv[v].x);
          const float d1 = __fsub_rn(a.y, gv[v].y);
          const float d2 = __fsub_rn(a.z, gv[v].z);
          const float d3 = __fsub_rn(a.w, gv[v].w);
          acc = __fadd_rn(acc,
                          __fadd_rn(__fadd_rn(__fmul_rn(d0, d0),
                                              __fmul_rn(d1, d1)),
                                    __fadd_rn(__fmul_rn(d2, d2),
                                              __fmul_rn(d3, d3))));
        }
      }
    } else {
      for (int64_t e = e0 + threadIdx.x; e < e1; e += kThreads) {
        const float df = __fsub_rn(row[e], leaf.g[e]);
        acc = __fadd_rn(acc, __fmul_rn(df, df));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_down_sync(0xFFFFFFFFu, acc, off));
    if ((threadIdx.x & 31) == 0)
      warp_part[c * kWarps + threadIdx.x / 32] = acc;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n; c += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w)
      s = __fadd_rn(s, warp_part[c * kWarps + w]);
    partial[static_cast<int64_t>(c) * total_blocks + block_base + blockIdx.x] =
        s;
  }

  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned ticket = atomicAdd(done, 1u);
    last = ticket == static_cast<unsigned>(total_blocks) - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int cc = 0; cc < n; ++cc) {
    float a = 0.0f;
    for (int b = threadIdx.x; b < total_blocks; b += kThreads)
      a = __fadd_rn(a, __ldcg(partial + static_cast<int64_t>(cc) * total_blocks
                              + b));
    const float norm = sqrtf(block_sum(a));
    // fmaxf would turn a NaN norm into 1e-12 and the scale into 1
    if (threadIdx.x == 0)
      scales[cc] = isnan(norm)
                       ? norm
                       : fminf(1.0f, __fdiv_rn(bound, fmaxf(norm, 1e-12f)));
  }
}

// The uniforms (and the Gaussians the aggregate adds) of client `client` at
// every element index, from the same device functions the aggregate uses:
// lets a caller hold the stream against another implementation.  Not part
// of the aggregation path.
__global__ void noise_probe_kernel(float* __restrict__ u1,
                                   float* __restrict__ u2,
                                   float* __restrict__ gauss, int64_t d_total,
                                   uint32_t s0, uint32_t s1,
                                   uint32_t client) {
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (d >= d_total) return;
  const uint32_t idx_h = index_hash(static_cast<uint32_t>(d));
  const uint32_t salt = client_salt(s0, s1, client);
  if (u1 != nullptr) uniforms(idx_h, salt, u1 + d, u2 + d);
  if (gauss != nullptr) gauss[d] = gaussian_fast(idx_h, salt);
}

// The table of rows [first, last) of the wrapper's rows, each leaf's
// blocks given by blocks_of; *blocks is the launch's grid.
template <class Blocks>
LeafTable make_table(const long long* rows, int first, int last,
                     Blocks blocks_of, int64_t* blocks) {
  LeafTable t{};
  t.n_leaves = last - first;
  for (int l = first; l < last; ++l) {
    const long long* r = rows + l * kCols;
    Leaf& leaf = t.leaf[l - first];
    leaf.x = reinterpret_cast<const float*>(r[kX]);
    leaf.g = reinterpret_cast<const float*>(r[kG]);
    leaf.out = reinterpret_cast<float*>(r[kOut]);
    leaf.d = r[kD];
    leaf.s0 = murmur::salt0(static_cast<int>(r[kSeed0]));
    leaf.s1 = murmur::salt1(static_cast<int>(r[kSeed1]));
    leaf.clipped = static_cast<int32_t>(r[kClipped]);
  }
  *blocks = leaf_table::assign_blocks(t.leaf, t.n_leaves, blocks_of);
  return t;
}

int launch_agg(const long long* rows, int n_leaves, const float* scales,
               const float* ratios, int n, float sigma, cudaStream_t st,
               int* launches) {
  *launches = 0;
  if (n > kMaxClients) return static_cast<int>(cudaErrorInvalidValue);
  for (int first = 0; first < n_leaves; first += kMaxLeaves) {
    int64_t blocks;
    const LeafTable t = make_table(rows, first,
                                   std::min(n_leaves, first + kMaxLeaves),
                                   leaf_table::vec_blocks, &blocks);
    if (blocks == 0) continue;
    if (sigma != 0.0f)
      robust_agg_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0,
                                st>>>(t, scales, ratios, n, sigma);
    else
      robust_agg_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 st>>>(t, scales, ratios, n, sigma);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
}

}  // namespace

// Every float leaf of a tree: rows is int64 [n_leaves, kCols] (x, g, out
// pointers, D, the two seed words and the clipped flag, in the order of
// core/fused_agg.py::LeafLayout).  scales may be null (no clip).  Launches
// once per 64 leaves and sets *launches to the launches made.  Returns the
// first CUDA error (0 on success).
extern "C" int robust_agg_table_f32(const long long* rows, int n_leaves,
                                    const float* scales, const float* ratios,
                                    long long n, float sigma, void* stream,
                                    int* launches) {
  return launch_agg(rows, n_leaves, scales, ratios, static_cast<int>(n),
                    sigma, static_cast<cudaStream_t>(stream), launches);
}

// The norm pass's blocks over the weight leaves in rows: the partials it
// writes for each client.
extern "C" long long clip_norm_blocks(const long long* rows, int n_leaves) {
  long long total = 0;
  for (int l = 0; l < n_leaves; ++l) total += norm_blocks(rows[l * kCols + kD]);
  return total;
}

// The clip scales of n clients over the weight leaves in rows (int64
// [n_leaves, kCols]; out and the seed words unused; at least one element in
// all); partial is f32 [n * clip_norm_blocks(rows)], done a zeroed uint32
// (the blocks' ticket).  Launches once per 64 leaves and sets *launches.
extern "C" int clip_norm_f32(const long long* rows, int n_leaves,
                             float* partial, float* scales, unsigned* done,
                             long long n, float bound, void* stream,
                             int* launches) {
  *launches = 0;
  auto st = static_cast<cudaStream_t>(stream);
  const long long total = clip_norm_blocks(rows, n_leaves);
  if (total == 0 || n > kMaxClients)
    return static_cast<int>(cudaErrorInvalidValue);
  long long base = 0;
  for (int first = 0; first < n_leaves; first += kMaxLeaves) {
    int64_t blocks;
    const LeafTable t = make_table(rows, first,
                                   std::min(n_leaves, first + kMaxLeaves),
                                   norm_blocks, &blocks);
    if (blocks == 0) continue;
    const size_t smem = static_cast<size_t>(n) * (kThreads / 32) *
                        sizeof(float);
    clip_norm_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
        t, partial, scales, done, static_cast<int>(base),
        static_cast<int>(total), static_cast<int>(n), bound);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
    base += blocks;
  }
  return 0;
}

// One leaf: a one-leaf table of the same kernel, every client clipped by
// scales.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int robust_agg_f32(const float* x, const float* g,
                              const float* scales, const float* ratios,
                              float* out, long long n, long long d,
                              int seed0, int seed1, float sigma,
                              void* stream) {
  const long long row[kCols] = {
      static_cast<long long>(reinterpret_cast<uintptr_t>(x)),
      static_cast<long long>(reinterpret_cast<uintptr_t>(g)),
      static_cast<long long>(reinterpret_cast<uintptr_t>(out)),
      d, seed0, seed1, 1};
  int launches;
  return launch_agg(row, 1, scales, ratios, static_cast<int>(n), sigma,
                    static_cast<cudaStream_t>(stream), &launches);
}
// Probes of the noise stream of one client: its uniforms (u1, u2) and the
// Gaussians the aggregate adds (gauss); a null pointer skips its output.
extern "C" int noise_probe_f32(float* u1, float* u2, float* gauss,
                               long long d, int seed0, int seed1, int client,
                               void* stream) {
  if (d <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((d + kThreads - 1) / kThreads);
  noise_probe_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      u1, u2, gauss, d, murmur::salt0(seed0), murmur::salt1(seed1),
      static_cast<uint32_t>(client));
  return static_cast<int>(cudaGetLastError());
}
