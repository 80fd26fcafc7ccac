// Fused quantize + pairwise mask for secure aggregation: every float leaf of
// a group's model, every client row of the group, in one launch, with the
// pair keys derived in the launch.
//
// Replaces the TPU kernel fedml_tpu/secure/pallas_mask.py::_mask_kernel
// (launched per leaf and per client by _masked_flat's pallas_call, wrapped
// by fused_quantize_mask, vmapped over the group's clients by
// secure/secagg.py::aggregate_stacked) and the XLA derivation of its seeds
// (derive_pair_seeds).  For a leaf flattened to D elements, row r is client
// i = first_client + r of an n_clients group, and in the uint32 ring
// (wrapping arithmetic):
//
//     out[r, d] = (uint32)(int32) rint(clamp(x[r, d] * w[r], -clip, clip)
//                                      * scale)
//               + sum_{j > i} fmix(h_d ^ salt_ij) - sum_{j < i} fmix(h_d ^ salt_ij)
//
// with h_d = fmix(d * 0x9E3779B9 + 1) and salt_ij = fmix(s0_ij) ^
// fmix(s1_ij ^ 0x5BD1E995), where (s0_ij, s1_ij) are the words of the pair
// key fold_in(fold_in(round_key, min(i, j)), max(i, j)) (threefry2x32, 20
// rounds, as core/prng.py and jax.random), each plus leaf_id * 31337 with
// int32 wraparound.  The pair keys are symmetric, so client j's -mask
// cancels client i's +mask bit for bit in the ring sum over the group.  The
// TPU kernel pads each leaf to 256x128 blocks and indexes elements
// row-major in the padded leaf, which is d here: no padding is needed.  The
// result is stored as int32 carrying the uint32 bits (two's complement).
//
// The leaf table.  As in robust_agg.cu: the wrapper (secure/fused_mask.py)
// lays the leaves out once per tree structure, each at a column offset of
// one int32 buffer [R, C] (offsets and C multiples of 4, so every row of
// every leaf starts on a 16-byte boundary); the entry points give each leaf
// its blocks of the grid (leaf_table.cuh) and pass the table by value as a
// __grid_constant__ parameter.  Thread t < D / 4 of a leaf owns elements
// 4t..4t+3, the last D % 4 go to a thread in a warp of its own; a row of x
// that starts on a 16-byte boundary is read as float4, another as four
// scalars.
//
// Each pair once.  When the launch holds every row of the group (rows =
// n_clients <= 16, first_client = 0, as aggregate_stacked calls it), a
// thread owns its elements across all R rows: it hashes each index once,
// keeps the R x 4 ring values in registers, and computes each pair's mask
// once, adding it to row i and subtracting it from row j.  That is N(N-1)/2
// finalisers per element in place of N(N-1), and one index hash in place of
// N; wrapping addition is associative, so the bits are those of the per-row
// sum.  Other launches (one client's rows, as mask_update, or groups over
// 16) take the per-row walk: a grid of (blocks, rows), each thread one row's
// 4 elements and the N - 1 partners.  Each block derives the pair keys it
// needs (R(R-1)/2, or N - 1 for a row) into shared memory: at most 120
// threefry pairs for the pairs form, computed in parallel by the block's
// threads, which is small beside the block's 4 x 1024 x R elements.
//
// Rounding: rint half to even, as jnp.round; __float2int_rn rounds the
// scaled value to the nearest int32, ties to even, in one step (exact for
// |value| < 2^31, which the aggregator's ring budget guarantees).  Built
// with -fmad=false and explicit __fmul_rn, so the two float multiplies round
// where the plain version's do; a NaN passes the clamp as in jnp.clip.
//
// What bounds it: memory at the slice's group of 5.  It reads x (4*R*D
// bytes) and writes out (4*R*D): 67.6 MB at the FEMNIST CNN's D =
// 1,690,046 and R = N = 5, 20.2 us at the H100 SXM's 3.35 TB/s (data
// sheet).  Per element it does ~10 integer operations for the index hash,
// per row a quantize (4 float operations and a conversion) and per pair ~11
// integer operations: at N = 5, 120 integer operations an element, 12.1 us
// at 64 integer lanes per SM a clock (chip_smoke.py's bound counts each
// term); the pair term grows as N^2 and passes the memory time near N = 8.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "leaf_table.cuh"

namespace {

using leaf_table::aligned16;
using leaf_table::find_leaf;
using leaf_table::kMaxLeaves;
using leaf_table::kPerThread;
using leaf_table::kThreads;
using leaf_table::load4;
using leaf_table::owned;

constexpr int kMaxPairRows = 16;   // the pairs form's largest group

struct Leaf {
  const float* x;     // [rows, d]
  int64_t d;
  int64_t col;        // the leaf's first column of out
  uint32_t shift;     // leaf_id * 31337, added to both key words
  int32_t block0;     // the leaf's first block in the launch's grid
                      // (leaf_table::assign_blocks)
};

struct LeafTable {
  int32_t n_leaves;
  Leaf leaf[kMaxLeaves];
};

// The table row the wrapper passes for each leaf, as int64 words.
enum Col { kX, kD, kCol, kLeafId, kCols };

// Where the pair salts come from: the round key's two words (derived in the
// launch), or a table of pair seeds from the caller (int32 [rows,
// n_clients, 2], already offset by the leaf, as the per-leaf entry takes
// them).
struct KeySource {
  uint32_t k0, k1;
  const int32_t* seeds;
  int n_clients;
  int first_client;
};

__device__ __forceinline__ uint32_t fmix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 (20 rounds) keyed by (k0, k1) over the counter (0, d):
// jax.random.fold_in(key, d).
__device__ __forceinline__ void fold_in(uint32_t k0, uint32_t k1, uint32_t d,
                                        uint32_t* y0, uint32_t* y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = ks[0], x1 = d + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][k]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  *y0 = x0;
  *y1 = x1;
}

__device__ __forceinline__ uint32_t salt_of(uint32_t s0, uint32_t s1) {
  return fmix(s0) ^ fmix(s1 ^ 0x5BD1E995u);
}

// The salt of the pair (i, j) of clients for a leaf.  From seeds, row is
// the caller's row of client i.
__device__ __forceinline__ uint32_t pair_salt(const KeySource& ks, int i,
                                              int j, int row,
                                              uint32_t shift) {
  if (ks.seeds != nullptr) {
    const int32_t* s = ks.seeds + (static_cast<int64_t>(row) * ks.n_clients
                                   + j) * 2;
    return salt_of(static_cast<uint32_t>(s[0]), static_cast<uint32_t>(s[1]));
  }
  uint32_t a0, a1, s0, s1;
  fold_in(ks.k0, ks.k1, static_cast<uint32_t>(min(i, j)), &a0, &a1);
  fold_in(a0, a1, static_cast<uint32_t>(max(i, j)), &s0, &s1);
  return salt_of(s0 + shift, s1 + shift);
}

// rint(clamp(v, -clip, clip) * scale) as int32; NaN passes through the
// clamp, as in jnp.clip.
__device__ __forceinline__ uint32_t quantize(float x, float w, float scale,
                                             float clip) {
  float v = __fmul_rn(x, w);
  v = v < -clip ? -clip : (v > clip ? clip : v);
  return static_cast<uint32_t>(__float2int_rn(__fmul_rn(v, scale)));
}

__device__ __forceinline__ void store4(int32_t* p, int cnt,
                                       const uint32_t v[4]) {
  if (cnt == kPerThread && aligned16(p)) {
    *reinterpret_cast<int4*>(p) =
        make_int4(static_cast<int32_t>(v[0]), static_cast<int32_t>(v[1]),
                  static_cast<int32_t>(v[2]), static_cast<int32_t>(v[3]));
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      if (k < cnt) p[k] = static_cast<int32_t>(v[k]);
  }
}

// Every row of an R-client group: each pair's mask once.
template <int R>
__global__ void __launch_bounds__(kThreads)
secagg_pairs_kernel(const __grid_constant__ LeafTable t,
                    const float* __restrict__ w, int32_t* __restrict__ out,
                    int64_t out_cols, const __grid_constant__ KeySource ks,
                    float scale, float clip) {
  __shared__ uint32_t salt[R * R];
  const Leaf& leaf = t.leaf[find_leaf(t.leaf, t.n_leaves, blockIdx.x)];
  for (int p = threadIdx.x; p < R * R; p += kThreads) {
    const int i = p / R, j = p % R;
    if (i < j) salt[p] = pair_salt(ks, i, j, i, leaf.shift);
  }
  __syncthreads();

  int64_t d0;
  int cnt;
  if (!owned(static_cast<int64_t>(blockIdx.x - leaf.block0) * kThreads
                 + threadIdx.x, leaf.d, &d0, &cnt))
    return;
  uint32_t acc[R][kPerThread], idx_h[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k)
    idx_h[k] = fmix(static_cast<uint32_t>(d0 + k) * 0x9E3779B9u + 1u);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float xv[kPerThread];
    load4(leaf.x + r * leaf.d + d0, cnt, xv);
    const float wr = w[r];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      acc[r][k] = quantize(xv[k], wr, scale, clip);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = i + 1; j < R; ++j) {
      const uint32_t s = salt[i * R + j];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const uint32_t m = fmix(idx_h[k] ^ s);
        acc[i][k] += m;
        acc[j][k] -= m;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    store4(out + r * out_cols + leaf.col + d0, cnt, acc[r]);
}

// One row per blockIdx.y: client first_client + row, its N - 1 partners.
__global__ void __launch_bounds__(kThreads)
secagg_rows_kernel(const __grid_constant__ LeafTable t,
                   const float* __restrict__ w, int32_t* __restrict__ out,
                   int64_t out_cols, const __grid_constant__ KeySource ks,
                   float scale, float clip) {
  extern __shared__ uint32_t row_salt[];
  const Leaf& leaf = t.leaf[find_leaf(t.leaf, t.n_leaves, blockIdx.x)];
  const int row = blockIdx.y;
  const int i = ks.first_client + row;
  for (int j = threadIdx.x; j < ks.n_clients; j += kThreads)
    if (j != i) row_salt[j] = pair_salt(ks, i, j, row, leaf.shift);
  __syncthreads();

  int64_t d0;
  int cnt;
  if (!owned(static_cast<int64_t>(blockIdx.x - leaf.block0) * kThreads
                 + threadIdx.x, leaf.d, &d0, &cnt))
    return;
  float xv[kPerThread];
  load4(leaf.x + row * leaf.d + d0, cnt, xv);
  const float wr = w[row];
  uint32_t acc[kPerThread], idx_h[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    acc[k] = quantize(xv[k], wr, scale, clip);
    idx_h[k] = fmix(static_cast<uint32_t>(d0 + k) * 0x9E3779B9u + 1u);
  }
  for (int j = 0; j < ks.n_clients; ++j) {
    if (j == i) continue;
    const uint32_t s = row_salt[j];
    if (j > i) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) acc[k] += fmix(idx_h[k] ^ s);
    } else {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) acc[k] -= fmix(idx_h[k] ^ s);
    }
  }
  store4(out + row * out_cols + leaf.col + d0, cnt, acc);
}

// salts[i * n + j] for every pair of an n-client group and one leaf, from
// the same device functions the launches use (the diagonal is 0): a probe
// to hold the in-launch keys against another derivation.
__global__ void secagg_salts_kernel(int32_t* __restrict__ salts, int n,
                                    const __grid_constant__ KeySource ks,
                                    uint32_t shift) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n * n) return;
  const int i = p / n, j = p % n;
  salts[p] = i == j ? 0 : static_cast<int32_t>(pair_salt(ks, i, j, i, shift));
}

// The table of rows [first, last) of the wrapper's rows; *blocks is the
// launch's grid (its first dimension).
LeafTable make_table(const long long* rows, int first, int last,
                     int64_t* blocks) {
  LeafTable t{};
  t.n_leaves = last - first;
  for (int l = first; l < last; ++l) {
    const long long* r = rows + l * kCols;
    Leaf& leaf = t.leaf[l - first];
    leaf.x = reinterpret_cast<const float*>(r[kX]);
    leaf.d = r[kD];
    leaf.col = r[kCol];
    leaf.shift = static_cast<uint32_t>(r[kLeafId]) * 31337u;
  }
  *blocks = leaf_table::assign_blocks(t.leaf, t.n_leaves,
                                      leaf_table::vec_blocks);
  return t;
}

template <int R>
void launch_pairs(const LeafTable& t, unsigned blocks, const float* w,
                  int32_t* out, int64_t out_cols, const KeySource& ks,
                  float scale, float clip, cudaStream_t st) {
  secagg_pairs_kernel<R><<<blocks, kThreads, 0, st>>>(t, w, out, out_cols,
                                                      ks, scale, clip);
}

int launch_table(const long long* rows, int n_leaves, const float* w,
                 int32_t* out, long long out_cols, long long n_rows,
                 const KeySource& ks, float scale, float clip,
                 cudaStream_t st, int* launches) {
  *launches = 0;
  if (n_rows <= 0) return 0;
  const bool pairs = ks.first_client == 0 && n_rows == ks.n_clients &&
                     n_rows >= 2 && n_rows <= kMaxPairRows;
  for (int first = 0; first < n_leaves; first += kMaxLeaves) {
    int64_t blocks;
    const LeafTable t = make_table(
        rows, first, std::min(n_leaves, first + kMaxLeaves), &blocks);
    if (blocks == 0) continue;
    if (pairs) {
      const unsigned b = static_cast<unsigned>(blocks);
      switch (n_rows) {
#define PAIRS_CASE(R) \
  case R: launch_pairs<R>(t, b, w, out, out_cols, ks, scale, clip, st); break;
        PAIRS_CASE(2) PAIRS_CASE(3) PAIRS_CASE(4) PAIRS_CASE(5)
        PAIRS_CASE(6) PAIRS_CASE(7) PAIRS_CASE(8) PAIRS_CASE(9)
        PAIRS_CASE(10) PAIRS_CASE(11) PAIRS_CASE(12) PAIRS_CASE(13)
        PAIRS_CASE(14) PAIRS_CASE(15) PAIRS_CASE(16)
#undef PAIRS_CASE
      }
    } else {
      const dim3 grid(static_cast<unsigned>(blocks),
                      static_cast<unsigned>(n_rows));
      const size_t smem = static_cast<size_t>(ks.n_clients) * sizeof(uint32_t);
      secagg_rows_kernel<<<grid, kThreads, smem, st>>>(t, w, out, out_cols,
                                                       ks, scale, clip);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
}

}  // namespace

// Every float leaf of a group's tree: rows is int64 [n_leaves, kCols] (x
// pointer, D, column offset in out and leaf id; the order of
// secure/fused_mask.py::mask_table); w f32 [n_rows]; out int32 [n_rows,
// out_cols]; the pair keys come from the round key (k0, k1).  n_rows <=
// 65535 and n_clients <= 8192 (the per-row walk's salts in shared memory),
// both checked by the caller.  Launches once per 64 leaves and sets
// *launches to the launches made; returns the first CUDA error (0 on
// success).
extern "C" int secagg_mask_table_i32(const long long* rows, int n_leaves,
                                     const float* w, int* out,
                                     long long out_cols, long long n_rows,
                                     int n_clients, int first_client,
                                     unsigned k0, unsigned k1, float scale,
                                     float clip, void* stream,
                                     int* launches) {
  const KeySource ks{k0, k1, nullptr, n_clients, first_client};
  return launch_table(rows, n_leaves, w, out, out_cols, n_rows, ks, scale,
                      clip, static_cast<cudaStream_t>(stream), launches);
}

// One leaf, the pair seeds given: x f32 [rows, d], w f32 [rows], seeds
// int32 [rows, n_clients, 2], out int32 [rows, d], all on the device and
// contiguous: a one-leaf table of the same kernels.  Returns the CUDA
// error after the launch (0 on success).
extern "C" int secagg_mask_i32(const float* x, const float* w,
                               const int* seeds, int* out, long long rows,
                               int n_clients, int first_client, long long d,
                               float scale, float clip, void* stream) {
  const long long row[kCols] = {
      static_cast<long long>(reinterpret_cast<uintptr_t>(x)), d, 0, 0};
  const KeySource ks{0u, 0u, seeds, n_clients, first_client};
  int launches;
  return launch_table(row, 1, w, out, d, rows, ks, scale, clip,
                      static_cast<cudaStream_t>(stream), &launches);
}

// salts int32 [n, n]: the salt of every pair of an n-client group for leaf
// leaf_id, derived from the round key (k0, k1) as the launches derive it.
extern "C" int secagg_salts_i32(int* salts, int n, unsigned k0, unsigned k1,
                                int leaf_id, void* stream) {
  if (n <= 0) return 0;
  const KeySource ks{k0, k1, nullptr, n, 0};
  const unsigned blocks = static_cast<unsigned>((n * n + kThreads - 1)
                                                / kThreads);
  secagg_salts_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      salts, n, ks, static_cast<uint32_t>(leaf_id) * 31337u);
  return static_cast<int>(cudaGetLastError());
}
