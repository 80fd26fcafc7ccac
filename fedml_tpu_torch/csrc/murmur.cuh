// The JAX package's murmur3 counter PRG + Box-Muller noise, as device
// functions shared by the kernels that reproduce its weak-DP streams bit for
// bit: robust_agg.cu (fedml_tpu/core/pallas_agg.py::_agg_kernel) and
// shard_finalize.cu (::_finalize_kernel).
//
// An element's stream is keyed by its index d and a 32-bit salt:
//     idx_h = fmix(d * 0x9E3779B9 + 1)
//     b1 = fmix(idx_h ^ salt), b2 = fmix(b1 ^ 0x27D4EB2F)
//     u1 = (b1 >> 8) * 2^-24 + 2^-25  in (0, 1),  u2 = (b2 >> 8) * 2^-24
//     n = sqrt(-2 log u1) * cos(2 pi u2)
// Seed words arrive as int32 carrying uint32 bits and hash to the salts
// s0 = fmix(seed0), s1 = fmix(seed1 ^ 0x5BD1E995).
//
// Floating point: compile with -fmad=false.  The uniforms use explicit
// round-to-nearest intrinsics, bit-equal to the JAX package's.  gaussian
// uses the precise logf, cosf and sqrtf (no --use_fast_math), so every step
// rounds where the plain PyTorch versions round (shard_finalize.cu);
// gaussian_fast (robust_agg.cu) takes the special-function units' lg2,
// rsqrt and cos instead, within a few 1e-6 of gaussian.

#pragma once

#include <cstdint>

namespace murmur {

__host__ __device__ __forceinline__ uint32_t fmix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__host__ __device__ __forceinline__ uint32_t salt0(int seed0) {
  return fmix(static_cast<uint32_t>(seed0));
}

__host__ __device__ __forceinline__ uint32_t salt1(int seed1) {
  return fmix(static_cast<uint32_t>(seed1) ^ 0x5BD1E995u);
}

__device__ __forceinline__ uint32_t index_hash(uint32_t d) {
  return fmix(d * 0x9E3779B9u + 1u);
}

// (bits >> 8) < 2^24, so the int -> float conversion is exact.
__device__ __forceinline__ void uniforms(uint32_t idx_h, uint32_t salt,
                                         float* u1, float* u2) {
  const uint32_t b1 = fmix(idx_h ^ salt);
  const uint32_t b2 = fmix(b1 ^ 0x27D4EB2Fu);
  *u1 = __fadd_rn(__fmul_rn(static_cast<float>(static_cast<int>(b1 >> 8)),
                            5.9604644775390625e-08f),   // 2^-24
                  2.98023223876953125e-08f);            // 2^-25
  *u2 = __fmul_rn(static_cast<float>(static_cast<int>(b2 >> 8)),
                  5.9604644775390625e-08f);
}

__device__ __forceinline__ float gaussian(uint32_t idx_h, uint32_t salt) {
  float u1, u2;
  uniforms(idx_h, salt, &u1, &u2);
  return sqrtf(-2.0f * logf(u1)) * cosf(6.28318548202514648f * u2);
}

// The special-function units' approximations, without the denormal
// handling the library wraps around them (.ftz): gaussian_fast never feeds
// them a denormal (u1 >= 2^-25, x = 0 or >= 2^-24, a = 0 or |a| >= 2^-23).
__device__ __forceinline__ float lg2_sfu(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rsqrt_sfu(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float cos_sfu(float x) {
  float y;
  asm("cos.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The same Gaussian from the special-function units, about a third of
// gaussian's instructions.  -ln(u1): lg2 where u1 < 1 - 2^-8; nearer 1,
// where lg2's absolute error (~2^-22) would swamp the small result, the
// series t + t^2/2 in t = 1 - u1 (exact there, Sterbenz; the rest is under
// t^2/3 <= 2^-17.6 relative, 2.3e-7 at most in the Gaussian).  sqrt(x) as
// x * rsqrt(x), with x = 0 (u1 rounds to 1 once in 2^24 draws) kept at 0.
// cos(2 pi u2) as -cos(2 pi u2 - pi), whose argument lies in [-pi, pi),
// where the SFU's absolute error is at most 2^-21.4.
__device__ __forceinline__ float gaussian_fast(uint32_t idx_h, uint32_t salt) {
  float u1, u2;
  uniforms(idx_h, salt, &u1, &u2);
  const float t = 1.0f - u1;
  const float series = t * (1.0f + 0.5f * t);
  const float neg_ln = t < 0.00390625f ? series
                                      : lg2_sfu(u1) * -0.693147182f;
  const float x = 2.0f * neg_ln;
  const float r = x * rsqrt_sfu(fmaxf(x, 1e-30f));
  const float a = 6.28318548202514648f * u2 - 3.14159274101257324f;
  return -(r * cos_sfu(a));
}

}  // namespace murmur
