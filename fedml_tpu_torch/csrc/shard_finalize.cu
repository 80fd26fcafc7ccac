// Fused finalize of one shard of the sharded streaming fold: the weighted
// mean's division and the weak-DP noise in one pass over the shard's fold
// accumulator.
//
// Replaces the TPU kernel fedml_tpu/core/pallas_agg.py::_finalize_kernel
// (launched once per shard by make_fused_shard_finalize's pallas_call).  The
// shard's float pieces, concatenated in slice-key order, arrive as one
// contiguous f32 buffer acc[D]; for every element index d:
//
//     out[d] = acc[d] / wsum  (+ sigma * n[d])
//
// n[d] is the JAX package's counter PRG, bit for bit (murmur.cuh), keyed by
// d and the salt fmix(fmix(seed_word) ^ fmix(step ^ 0x5BD1E995)), where
// seed_word already mixes the shard id into the run seed.  The Pallas
// kernel's element index is the row-major index within the buffer padded to
// [rows, 128]; the padding sits only at the end, so that index equals d
// here and this kernel needs no padding.
//
// What bounds it: memory.  The kernel reads acc once and writes out once,
// 8 bytes per element: for the FEMNIST CNN's largest shard at S = 4
// (D = 422,944) that is 3.4 MB, 1.0 us at the H100 SXM's 3.35 TB/s (data
// sheet).  The noise adds two murmur finalisers and a precise log, sqrt and
// cos per element, which makes it bound by instruction issue at sigma > 0
// (PERF.md has the measured times beside the bound).  The design streams
// with 16-byte loads: each of the first D / 4 threads owns 4 consecutive
// elements and loads and stores them as one float4; the last D % 4
// elements go to one thread in a warp of its own, with scalar loads and
// stores.  Both branches compute an element the same way, keyed by its own
// index, so the size of the tail changes no bit of the result.  A pointer
// that is not 16-byte aligned (a contiguous view at an odd offset can reach
// the wrapper) takes a scalar kernel instead, one element a thread,
// neighbouring threads on neighbouring elements.  Nothing carries between
// blocks, so the grid simply covers D.  One launch per shard per round, as
// on the TPU; one launch over all shards, and an accumulator kept flat so
// that the caller's concatenation disappears, are left for later.
//
// Floating point: built with -fmad=false; the division is IEEE
// round-to-nearest (__fdiv_rn) and the noise's multiply and add round
// separately, where the step-by-step PyTorch version
// (fused_agg.py::shard_finalize_plain) rounds.

#include <cstdint>
#include <cuda_runtime.h>

#include "murmur.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

__host__ __device__ __forceinline__ uint32_t shard_salt(int seed_word,
                                                        int step) {
  return murmur::fmix(murmur::salt0(seed_word) ^ murmur::salt1(step));
}

// out[d] for one element d
template <bool kNoise>
__device__ __forceinline__ float finalize_one(float a, int64_t d, float wsum,
                                              uint32_t salt, float sigma) {
  float o = __fdiv_rn(a, wsum);
  if (kNoise) {
    const uint32_t idx_h = murmur::index_hash(static_cast<uint32_t>(d));
    o = __fadd_rn(o, __fmul_rn(sigma, murmur::gaussian(idx_h, salt)));
  }
  return o;
}

// The thread that takes the last D % 4 elements when there are n_vec whole
// float4 groups: the first thread of the next warp, so that no warp runs
// both branches one after the other (a tail inside a float4 warp made the
// whole launch ~0.2 us slower).
__host__ __device__ __forceinline__ int64_t tail_thread(int64_t n_vec) {
  return (n_vec + 31) / 32 * 32;
}

// kVec: thread i < D / 4 takes elements 4i..4i+3 as one float4, and
// tail_thread takes the rest; else (a pointer not 16-byte aligned) thread i
// takes element i.
template <bool kVec, bool kNoise>
__global__ void __launch_bounds__(kThreads)
shard_finalize_kernel(const float* __restrict__ acc, float* __restrict__ out,
                      int64_t d_total, float wsum, uint32_t salt,
                      float sigma) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (!kVec) {
    if (i < d_total)
      out[i] = finalize_one<kNoise>(acc[i], i, wsum, salt, sigma);
    return;
  }
  const int64_t n_vec = d_total / kPerThread;
  if (i < n_vec) {
    const int64_t d0 = i * kPerThread;
    const float4 t = *reinterpret_cast<const float4*>(acc + d0);
    *reinterpret_cast<float4*>(out + d0) = make_float4(
        finalize_one<kNoise>(t.x, d0, wsum, salt, sigma),
        finalize_one<kNoise>(t.y, d0 + 1, wsum, salt, sigma),
        finalize_one<kNoise>(t.z, d0 + 2, wsum, salt, sigma),
        finalize_one<kNoise>(t.w, d0 + 3, wsum, salt, sigma));
  } else if (i == tail_thread(n_vec)) {
    // every load issued before the first use: one wait for memory
    const int64_t d0 = n_vec * kPerThread;
    float a[kPerThread - 1];
#pragma unroll
    for (int k = 0; k < kPerThread - 1; ++k)
      a[k] = (d0 + k < d_total) ? acc[d0 + k] : 0.0f;
#pragma unroll
    for (int k = 0; k < kPerThread - 1; ++k)
      if (d0 + k < d_total)
        out[d0 + k] = finalize_one<kNoise>(a[k], d0 + k, wsum, salt, sigma);
  }
}

// The uniforms of the shard's noise stream at every element index, from the
// same device functions the finalize uses: lets a caller hold the stream's
// bits against another implementation.  Not part of the finalize path.
__global__ void shard_uniforms_kernel(float* __restrict__ u1,
                                      float* __restrict__ u2, int64_t d_total,
                                      uint32_t salt) {
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (d >= d_total) return;
  murmur::uniforms(murmur::index_hash(static_cast<uint32_t>(d)), salt, u1 + d,
                   u2 + d);
}

template <bool kVec>
void launch(const float* acc, float* out, int64_t d, float wsum,
            uint32_t salt, float sigma, cudaStream_t stream) {
  const int64_t n_vec = d / kPerThread;
  const int64_t threads = !kVec                 ? d
                          : d % kPerThread == 0 ? n_vec
                                                : tail_thread(n_vec) + 1;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  if (sigma != 0.0f)
    shard_finalize_kernel<kVec, true><<<blocks, kThreads, 0, stream>>>(
        acc, out, d, wsum, salt, sigma);
  else
    shard_finalize_kernel<kVec, false><<<blocks, kThreads, 0, stream>>>(
        acc, out, d, wsum, salt, sigma);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int shard_finalize_f32(const float* acc, float* out, long long d,
                                  float wsum, int seed_word, int step,
                                  float sigma, void* stream) {
  if (d <= 0) return 0;
  const uint32_t salt = shard_salt(seed_word, step);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = (reinterpret_cast<uintptr_t>(acc) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (vec)
    launch<true>(acc, out, d, wsum, salt, sigma, st);
  else
    launch<false>(acc, out, d, wsum, salt, sigma, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int shard_uniforms_f32(float* u1, float* u2, long long d,
                                  int seed_word, int step, void* stream) {
  if (d <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((d + kThreads - 1) / kThreads);
  shard_uniforms_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      u1, u2, d, shard_salt(seed_word, step));
  return static_cast<int>(cudaGetLastError());
}
