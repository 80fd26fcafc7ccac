// Fused quantize + pairwise mask for secure aggregation: one parameter leaf,
// every client row of a group in one launch.
//
// Replaces the TPU kernel fedml_tpu/secure/pallas_mask.py::_mask_kernel
// (launched per leaf and per client by _masked_flat's pallas_call, wrapped
// by fused_quantize_mask, vmapped over the group's clients by
// secure/secagg.py::aggregate_stacked).  For a leaf flattened to D elements,
// row r is client i = first_client + r of an n_clients group, and in the
// uint32 ring (wrapping arithmetic):
//
//     out[r, d] = (uint32)(int32) rint(clamp(x[r, d] * w[r], -clip, clip)
//                                      * scale)
//               + sum_{j > i} fmix(h_d ^ salt_ij) - sum_{j < i} fmix(h_d ^ salt_ij)
//
// with h_d = fmix(d * 0x9E3779B9 + 1) and salt_ij = fmix(s0_ij) ^
// fmix(s1_ij ^ 0x5BD1E995), where (s0_ij, s1_ij) are the pair's int32 seed
// words (already offset by leaf_id * 31337 by the caller).  The pair seeds
// are symmetric, so client j's -mask cancels client i's +mask bit for bit in
// the ring sum over the group.  The TPU kernel pads each leaf to 256x128
// blocks and indexes elements row-major in the padded leaf, which is d here:
// this kernel needs no padding.  The result is stored as int32 carrying the
// uint32 bits (two's complement).
//
// Rounding: rint half to even, as jnp.round; __float2int_rn rounds the
// scaled value to the nearest int32, ties to even, in one step (exact for
// |value| < 2^31, which the aggregator's ring budget guarantees).  Built
// with -fmad=false and explicit __fmul_rn, so the two float multiplies round
// where the plain version's do.
//
// What bounds it: memory.  It reads x (4*R*D bytes) and writes out (4*R*D);
// per (row, element) it does about 15 integer and float operations for the
// quantize and the index hash, and 10 (one murmur finaliser, an xor, an add)
// for each of the N-1 partners.  At the FEMNIST CNN's D = 1,690,046 and a
// group of N = 5 that is 67.6 MB (20.2 us at the H100 SXM's 3.35 TB/s, data
// sheet) against 0.47 G operations (7.1 us at 67 T/s, the data sheet's
// non-tensor 32-bit rate); it stays memory-bound up to N of about 14.  The
// design: one launch per leaf over a grid of (element blocks, client rows);
// each thread owns 4 consecutive elements of one row (16-byte loads and
// stores when D % 4 == 0 and the pointers are aligned), keeps their quantized
// values and index hashes in registers and loops over the partners j.  The
// pair salts depend only on (i, j), so each block hashes its row's N salts
// once into shared memory instead of once per element.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

__device__ __forceinline__ uint32_t fmix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// rint(clamp(v, -clip, clip) * scale) as int32; NaN passes through the
// clamp, as in jnp.clip.
__device__ __forceinline__ uint32_t quantize(float x, float w, float scale,
                                             float clip) {
  float v = __fmul_rn(x, w);
  v = v < -clip ? -clip : (v > clip ? clip : v);
  return static_cast<uint32_t>(__float2int_rn(__fmul_rn(v, scale)));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
secagg_mask_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const int32_t* __restrict__ seeds,
                   int32_t* __restrict__ out, int n_clients, int first_client,
                   int64_t d_total, float scale, float clip) {
  extern __shared__ uint32_t salt[];
  const int64_t row = blockIdx.y;
  const int i = first_client + static_cast<int>(row);
  const int32_t* row_seeds = seeds + row * n_clients * 2;
  for (int j = threadIdx.x; j < n_clients; j += kThreads)
    salt[j] = fmix(static_cast<uint32_t>(row_seeds[2 * j])) ^
              fmix(static_cast<uint32_t>(row_seeds[2 * j + 1]) ^ 0x5BD1E995u);
  __syncthreads();

  const int64_t d0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kPerThread;
  if (d0 >= d_total) return;
  const float wr = w[row];
  const float* xr = x + row * d_total;
  float xv[kPerThread];
  if (kVec) {
    const float4 t = *reinterpret_cast<const float4*>(xr + d0);
    xv[0] = t.x; xv[1] = t.y; xv[2] = t.z; xv[3] = t.w;
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      xv[k] = (d0 + k < d_total) ? xr[d0 + k] : 0.0f;
  }
  uint32_t acc[kPerThread], idx_h[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    acc[k] = quantize(xv[k], wr, scale, clip);
    idx_h[k] = fmix(static_cast<uint32_t>(d0 + k) * 0x9E3779B9u + 1u);
  }

  for (int j = 0; j < n_clients; ++j) {
    if (j == i) continue;
    const uint32_t s = salt[j];
    if (j > i) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) acc[k] += fmix(idx_h[k] ^ s);
    } else {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) acc[k] -= fmix(idx_h[k] ^ s);
    }
  }

  int32_t* orow = out + row * d_total;
  if (kVec) {
    *reinterpret_cast<int4*>(orow + d0) =
        make_int4(static_cast<int32_t>(acc[0]), static_cast<int32_t>(acc[1]),
                  static_cast<int32_t>(acc[2]), static_cast<int32_t>(acc[3]));
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      if (d0 + k < d_total) orow[d0 + k] = static_cast<int32_t>(acc[k]);
  }
}

}  // namespace

// x f32 [rows, d], w f32 [rows], seeds int32 [rows, n_clients, 2], out
// int32 [rows, d], all on the device and contiguous; rows <= 65535 and
// n_clients <= 8192 (the salts' shared memory), both checked by the caller.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int secagg_mask_i32(const float* x, const float* w,
                               const int* seeds, int* out, long long rows,
                               int n_clients, int first_client, long long d,
                               float scale, float clip, void* stream) {
  if (d <= 0 || rows <= 0) return 0;
  const int64_t per_block = static_cast<int64_t>(kThreads) * kPerThread;
  const dim3 grid(static_cast<unsigned>((d + per_block - 1) / per_block),
                  static_cast<unsigned>(rows));
  const size_t smem = static_cast<size_t>(n_clients) * sizeof(uint32_t);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = (d % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (vec)
    secagg_mask_kernel<true><<<grid, kThreads, smem, st>>>(
        x, w, seeds, out, n_clients, first_client, d, scale, clip);
  else
    secagg_mask_kernel<false><<<grid, kThreads, smem, st>>>(
        x, w, seeds, out, n_clients, first_client, d, scale, clip);
  return static_cast<int>(cudaGetLastError());
}
