// Fused robust aggregation for one parameter leaf: norm-diff clip, weak-DP
// Gaussian noise and the sample-weighted mean in one pass over the cohort.
//
// Replaces the TPU kernel fedml_tpu/core/pallas_agg.py::_agg_kernel
// (launched per leaf by _agg_leaf's pallas_call, built by
// make_fused_robust_aggregate).  For a leaf flattened to D elements:
//
//     out[d] = sum_i r_i * (g[d] + s_i * (x[i, d] - g[d]) + sigma * n_i[d])
//
// x is [N, D] row-major f32, g is [D] f32, s (clip scales) and r
// (normalised weights) are f32 [N] on the device.  n_i[d] is the JAX
// package's counter PRG, bit for bit: a murmur3 finaliser over the element
// index d and a per-client salt, then Box-Muller.  The Pallas kernel's
// element index is the row-major index within the padded leaf, which
// equals d here because this kernel needs no padding.
//
// What bounds it: memory.  The kernel reads x once (4*N*D bytes) and g once
// (4*D) and writes out once (4*D); at sigma = 0 it does ~5 flops per (i, d),
// far below the ~20 flops per byte where an H100's fp32 rate would take
// over.  For the FEMNIST CNN (8 leaves, D summing to 1,690,046) and N = 10
// that is 81.1 MB per round in 8 launches: 24.2 us at the H100 SXM's
// 3.35 TB/s (data sheet).  The noise adds two murmur finalisers and a
// precise log, sqrt and cos per (i, d); counted as one operation each they
// stay under the memory line, but their instruction counts do not, so at
// sigma > 0 the kernel is bound by instruction issue (PERF.md has the
// measured times beside the bound).  The design streams x with 16-byte
// loads: each thread owns 4 consecutive elements (float4 when D % 4 == 0
// and the pointers are 16-byte aligned), loops over the N clients in
// registers with neighbouring threads on neighbouring addresses of each
// row x[i, :], and writes its 4 outputs once.  Nothing carries between
// blocks, so the grid simply covers D.  Fusing the clip-norm pre-pass
// (which re-reads the same N*D) and covering all leaves in one launch are
// left for later.
//
// Floating point: built with -fmad=false, so no multiply-add is contracted
// and every operation rounds where the step-by-step PyTorch version
// (fused_agg.py::robust_agg_plain) rounds.  The noise stream's device
// functions live in murmur.cuh, shared with shard_finalize.cu.

#include <cstdint>
#include <cuda_runtime.h>

#include "murmur.cuh"

namespace {

using murmur::fmix;
using murmur::gaussian;
using murmur::index_hash;
using murmur::uniforms;

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

__device__ __forceinline__ uint32_t client_salt(uint32_t s0, uint32_t s1,
                                                uint32_t i) {
  return fmix(s0 ^ (s1 + i * 0x85EBCA6Bu));
}

template <bool kVec, bool kNoise>
__global__ void __launch_bounds__(kThreads)
robust_agg_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  const float* __restrict__ scales,
                  const float* __restrict__ ratios, float* __restrict__ out,
                  int64_t n, int64_t d_total, uint32_t s0, uint32_t s1,
                  float sigma) {
  const int64_t d0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kPerThread;
  if (d0 >= d_total) return;

  float gv[kPerThread], acc[kPerThread];
  uint32_t idx_h[kPerThread];
  if (kVec) {
    const float4 t = *reinterpret_cast<const float4*>(g + d0);
    gv[0] = t.x; gv[1] = t.y; gv[2] = t.z; gv[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      gv[k] = (d0 + k < d_total) ? g[d0 + k] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    acc[k] = 0.0f;
    if (kNoise) idx_h[k] = index_hash(static_cast<uint32_t>(d0 + k));
  }

  for (int64_t i = 0; i < n; ++i) {
    const float s = scales[i];
    const float r = ratios[i];
    const float* row = x + i * d_total;
    float xv[kPerThread];
    if (kVec) {
      const float4 t = *reinterpret_cast<const float4*>(row + d0);
      xv[0] = t.x; xv[1] = t.y; xv[2] = t.z; xv[3] = t.w;
    } else {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k)
        xv[k] = (d0 + k < d_total) ? row[d0 + k] : 0.0f;
    }
    uint32_t salt = 0;
    if (kNoise) salt = client_salt(s0, s1, static_cast<uint32_t>(i));
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      float term = __fadd_rn(gv[k], __fmul_rn(s, __fsub_rn(xv[k], gv[k])));
      if (kNoise)
        term = __fadd_rn(term, __fmul_rn(sigma, gaussian(idx_h[k], salt)));
      acc[k] = __fadd_rn(acc[k], __fmul_rn(r, term));
    }
  }

  if (kVec) {
    *reinterpret_cast<float4*>(out + d0) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      if (d0 + k < d_total) out[d0 + k] = acc[k];
  }
}

// The uniforms of client `client` at every element index, from the same
// device functions the aggregate uses: lets a caller hold the stream's bits
// against another implementation.  Not part of the aggregation path.
__global__ void noise_uniforms_kernel(float* __restrict__ u1,
                                      float* __restrict__ u2, int64_t d_total,
                                      uint32_t s0, uint32_t s1,
                                      uint32_t client) {
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (d >= d_total) return;
  uniforms(index_hash(static_cast<uint32_t>(d)), client_salt(s0, s1, client),
           u1 + d, u2 + d);
}

template <bool kVec>
void launch(const float* x, const float* g, const float* scales,
            const float* ratios, float* out, int64_t n, int64_t d,
            uint32_t s0, uint32_t s1, float sigma, cudaStream_t stream) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * kPerThread;
  const unsigned blocks = static_cast<unsigned>((d + per_block - 1) / per_block);
  if (sigma != 0.0f)
    robust_agg_kernel<kVec, true><<<blocks, kThreads, 0, stream>>>(
        x, g, scales, ratios, out, n, d, s0, s1, sigma);
  else
    robust_agg_kernel<kVec, false><<<blocks, kThreads, 0, stream>>>(
        x, g, scales, ratios, out, n, d, s0, s1, sigma);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int robust_agg_f32(const float* x, const float* g,
                              const float* scales, const float* ratios,
                              float* out, long long n, long long d,
                              int seed0, int seed1, float sigma,
                              void* stream) {
  if (d <= 0) return 0;
  const uint32_t s0 = murmur::salt0(seed0);
  const uint32_t s1 = murmur::salt1(seed1);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = (d % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(g) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (vec)
    launch<true>(x, g, scales, ratios, out, n, d, s0, s1, sigma, st);
  else
    launch<false>(x, g, scales, ratios, out, n, d, s0, s1, sigma, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int noise_uniforms_f32(float* u1, float* u2, long long d,
                                  int seed0, int seed1, int client,
                                  void* stream) {
  if (d <= 0) return 0;
  const unsigned blocks = static_cast<unsigned>((d + kThreads - 1) / kThreads);
  noise_uniforms_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      u1, u2, d, murmur::salt0(seed0), murmur::salt1(seed1),
      static_cast<uint32_t>(client));
  return static_cast<int>(cudaGetLastError());
}
