// Causal flash attention, forward and backward, in f32 (K4).
//
// Replaces the three TPU kernels of JAX's Pallas library flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py), which
// fedml_tpu/models/transformer.py::_pallas_flash calls with causal=True and
// sm_scale = 1/sqrt(d):
//
//   flash_fwd_f32     <- _flash_attention_kernel (forward, via
//                        _flash_attention_impl): O = softmax(mask(Q K^T *
//                        scale)) V, plus the row max m and the normaliser
//                        l = sum exp(s - m) for the backward;
//   flash_bwd_dkv_f32 <- _flash_attention_dkv_kernel (_flash_attention_bwd_dkv):
//                        dK and dV from Q, K, V, dO, m, l and di = sum(O*dO);
//   flash_bwd_dq_f32  <- _flash_attention_dq_kernel (_flash_attention_bwd_dq):
//                        dQ from the same inputs.
//
// Layout: q, k, v, o, dO, dq, dk, dv are [BH, T, D] contiguous f32 (B and H
// folded; the wrapper transposes the model's [B, T, H, D]); m, l, di are
// [BH, T].  T is a multiple of 128 (the library's block, checked by the
// wrapper) and D is 16, 32 or 64 (the wrapper refuses other head sizes on
// the card).  Key c is visible to query r when c <= r.  The split of the
// backward into a dK/dV pass and a dQ pass is the library's: each output
// element is owned by one thread, so the gradients need no atomics and are
// deterministic.
//
// What bounds it: f32 operations.  Counting the causal half only, a (b, h)
// pair costs 4 T^2 D / 2 operations forward, 8 T^2 D / 2 for dK/dV and
// 6 T^2 D / 2 for dQ; at T = 2048, D = 32 that is 268 M, 537 M and 403 M
// against 0.5-1 MB of traffic, so the bound is the H100 SXM's 67 TFLOP/s
// outside the tensor cores (data sheet), not its 3.35 TB/s.
//
// The simple design (SIMT FMAs, no tensor cores): one block of 64 threads
// per (bh, 64-row tile); each thread owns one row of the tile it writes and
// keeps that row's operands and accumulators in registers.  The other
// operand's 64-row tiles are staged in shared memory and read by all
// threads of a warp at one address (a broadcast, 16 bytes a load), so each
// shared load feeds four FMAs.  Tiles strictly above the diagonal are never
// visited; on the diagonal tile the masked pairs are skipped.
//
//   forward: thread = query row; walks key tiles 0..diagonal; scores 16
//            keys at a time into registers, then one online-softmax
//            rescale per 16 keys; O = acc / l at the end.
//   dK/dV:   thread = key row; walks query tiles diagonal..end; recomputes
//            p = exp(s - m) * (1/l) per pair; dV += p dO, dK += ds Q with
//            ds = p (dO.v - di) scale.
//   dQ:      thread = query row; walks key tiles 0..diagonal; dQ += ds K.
//
// Floating point: the shared build flags carry -fmad=false (K1 and K2 need
// it for their bit-equality); this file writes its FMAs as fmaf, which is
// fused whatever that flag says.  exp is __expf (ex2.approx): at most a
// few ulps where the probabilities matter.  The results are held to the
// plain PyTorch versions (models/flash_attention.py) within a tolerance,
// not bit for bit.  wgmma/TMA tiles are work for a later change.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;    // rows of every tile; threads per block
constexpr int kChunk = 16;   // keys the forward scores before a rescale

template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         float (&dst)[D]) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    const float4 t = s4[c];
    dst[4 * c] = t.x; dst[4 * c + 1] = t.y;
    dst[4 * c + 2] = t.z; dst[4 * c + 3] = t.w;
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* __restrict__ dst,
                                          const float (&src)[D]) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int c = 0; c < D / 4; ++c)
    d4[c] = make_float4(src[4 * c], src[4 * c + 1], src[4 * c + 2],
                        src[4 * c + 3]);
}

// Stage one [kTile, D] tile of rows [row0, row0 + kTile) into shared memory.
template <int D>
__device__ __forceinline__ void stage(float4 (*dst)[D / 4],
                                      const float* __restrict__ src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int i = threadIdx.x; i < kTile * D / 4; i += kTile)
    dst[i / (D / 4)][i % (D / 4)] = s4[i];
}

template <int D>
__device__ __forceinline__ float dot(const float (&a)[D],
                                     const float4 (&b)[D / 4]) {
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    const float4 t = b[c];
    s = fmaf(a[4 * c], t.x, s);
    s = fmaf(a[4 * c + 1], t.y, s);
    s = fmaf(a[4 * c + 2], t.z, s);
    s = fmaf(a[4 * c + 3], t.w, s);
  }
  return s;
}

template <int D>
__device__ __forceinline__ void axpy(float a, const float4 (&x)[D / 4],
                                     float (&y)[D]) {
#pragma unroll
  for (int c = 0; c < D / 4; ++c) {
    const float4 t = x[c];
    y[4 * c] = fmaf(a, t.x, y[4 * c]);
    y[4 * c + 1] = fmaf(a, t.y, y[4 * c + 1]);
    y[4 * c + 2] = fmaf(a, t.z, y[4 * c + 2]);
    y[4 * c + 3] = fmaf(a, t.w, y[4 * c + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kTile)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out, int t,
                 float scale) {
  __shared__ float4 ks[kTile][D / 4];
  __shared__ float4 vs[kTile][D / 4];
  const int n_tiles = t / kTile;
  const int qt = n_tiles - 1 - blockIdx.y;   // the longest rows start first
  const int64_t bh = blockIdx.x;
  const int r = threadIdx.x;                 // row within the tile
  const int64_t row = bh * t + static_cast<int64_t>(qt) * kTile + r;

  float qr[D], acc[D];
  load_row<D>(q + row * D, qr);
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] = 0.0f;
  float m = -INFINITY, l = 0.0f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int64_t key0 = bh * t + static_cast<int64_t>(kt) * kTile;
    __syncthreads();
    stage<D>(ks, k + key0 * D);
    stage<D>(vs, v + key0 * D);
    __syncthreads();
    // keys visible to this row in this tile: all, or 0..r on the diagonal
    const int n_vis = (kt == qt) ? r + 1 : kTile;
    for (int c0 = 0; c0 < n_vis; c0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float sj = (c0 + j < n_vis) ? dot<D>(qr, ks[c0 + j]) * scale
                                          : -INFINITY;
        s[j] = sj;
        cmax = fmaxf(cmax, sj);
      }
      // key c0 is visible, so m_new is finite
      const float m_new = fmaxf(m, cmax);
      const float corr = __expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (c0 + j < n_vis) {
          const float p = __expf(s[j] - m_new);
          l += p;
          axpy<D>(p, vs[c0 + j], acc);
        }
      }
      m = m_new;
    }
  }
  const float inv_l = 1.0f / l;
#pragma unroll
  for (int c = 0; c < D; ++c) acc[c] *= inv_l;
  store_row<D>(o + row * D, acc);
  m_out[row] = m;
  l_out[row] = l;
}

template <int D>
__global__ void __launch_bounds__(kTile)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ di, float* __restrict__ dk,
                     float* __restrict__ dv, int t, float scale) {
  __shared__ float4 qs[kTile][D / 4];
  __shared__ float4 dos[kTile][D / 4];
  __shared__ float ms[kTile], inv_ls[kTile], dis[kTile];
  const int n_tiles = t / kTile;
  const int kt = blockIdx.y;                 // the longest walks start first
  const int64_t bh = blockIdx.x;
  const int c = threadIdx.x;                 // key row within the tile
  const int64_t key = bh * t + static_cast<int64_t>(kt) * kTile + c;

  float kr[D], vr[D], dkr[D], dvr[D];
  load_row<D>(k + key * D, kr);
  load_row<D>(v + key * D, vr);
#pragma unroll
  for (int j = 0; j < D; ++j) { dkr[j] = 0.0f; dvr[j] = 0.0f; }

  for (int qt = kt; qt < n_tiles; ++qt) {
    const int64_t q0 = bh * t + static_cast<int64_t>(qt) * kTile;
    __syncthreads();
    stage<D>(qs, q + q0 * D);
    stage<D>(dos, dout + q0 * D);
    ms[threadIdx.x] = m[q0 + threadIdx.x];
    inv_ls[threadIdx.x] = 1.0f / l[q0 + threadIdx.x];
    dis[threadIdx.x] = di[q0 + threadIdx.x];
    __syncthreads();
    // queries that see this key: all, or c..63 on the diagonal
    for (int r = (qt == kt) ? c : 0; r < kTile; ++r) {
      const float s = dot<D>(kr, qs[r]) * scale;
      const float p = __expf(s - ms[r]) * inv_ls[r];
      const float dp = dot<D>(vr, dos[r]);
      const float ds = p * (dp - dis[r]) * scale;
      axpy<D>(p, dos[r], dvr);
      axpy<D>(ds, qs[r], dkr);
    }
  }
  store_row<D>(dk + key * D, dkr);
  store_row<D>(dv + key * D, dvr);
}

template <int D>
__global__ void __launch_bounds__(kTile)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ di, float* __restrict__ dq,
                    int t, float scale) {
  __shared__ float4 ks[kTile][D / 4];
  __shared__ float4 vs[kTile][D / 4];
  const int n_tiles = t / kTile;
  const int qt = n_tiles - 1 - blockIdx.y;   // the longest rows start first
  const int64_t bh = blockIdx.x;
  const int r = threadIdx.x;
  const int64_t row = bh * t + static_cast<int64_t>(qt) * kTile + r;

  float qr[D], dor[D], dqr[D];
  load_row<D>(q + row * D, qr);
  load_row<D>(dout + row * D, dor);
#pragma unroll
  for (int j = 0; j < D; ++j) dqr[j] = 0.0f;
  const float mr = m[row];
  const float inv_l = 1.0f / l[row];
  const float dir = di[row];

  for (int kt = 0; kt <= qt; ++kt) {
    const int64_t key0 = bh * t + static_cast<int64_t>(kt) * kTile;
    __syncthreads();
    stage<D>(ks, k + key0 * D);
    stage<D>(vs, v + key0 * D);
    __syncthreads();
    const int n_vis = (kt == qt) ? r + 1 : kTile;
    for (int c = 0; c < n_vis; ++c) {
      const float s = dot<D>(qr, ks[c]) * scale;
      const float p = __expf(s - mr) * inv_l;
      const float dp = dot<D>(dor, vs[c]);
      const float ds = p * (dp - dir) * scale;
      axpy<D>(ds, ks[c], dqr);
    }
  }
  store_row<D>(dq + row * D, dqr);
}

// (bh, tile) blocks, bh fastest: every (b, h) of the heaviest tile goes
// out first.  A grid's y dimension holds at most 65535 tiles.
bool bad_shape(int64_t bh, int t) {
  return bh < 1 || bh > 0x7FFFFFFF || t < kTile || t % kTile != 0 ||
         t / kTile > 65535;
}

dim3 grid_of(int64_t bh, int t) {
  return dim3(static_cast<unsigned>(bh), t / kTile);
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* m, float* l, int64_t bh, int t, float scale,
               cudaStream_t stream) {
  flash_fwd_kernel<D><<<grid_of(bh, t), kTile, 0, stream>>>(q, k, v, o, m,
                                                             l, t, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* m, const float* l,
               const float* di, float* dk, float* dv, int64_t bh, int t,
               float scale, cudaStream_t stream) {
  flash_bwd_dkv_kernel<D><<<grid_of(bh, t), kTile, 0, stream>>>(
      q, k, v, dout, m, l, di, dk, dv, t, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* m, const float* l,
              const float* di, float* dq, int64_t bh, int t, float scale,
              cudaStream_t stream) {
  flash_bwd_dq_kernel<D><<<grid_of(bh, t), kTile, 0, stream>>>(
      q, k, v, dout, m, l, di, dq, t, scale);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kBadArgument = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted), or
// cudaErrorInvalidValue for a shape or head size it does not take.

extern "C" int flash_fwd_f32(const float* q, const float* k, const float* v,
                             float* o, float* m, float* l, int64_t bh, int t,
                             int d, float scale, cudaStream_t stream) {
  if (bad_shape(bh, t)) return kBadArgument;
  switch (d) {
    case 16: return launch_fwd<16>(q, k, v, o, m, l, bh, t, scale, stream);
    case 32: return launch_fwd<32>(q, k, v, o, m, l, bh, t, scale, stream);
    case 64: return launch_fwd<64>(q, k, v, o, m, l, bh, t, scale, stream);
    default: return kBadArgument;
  }
}

extern "C" int flash_bwd_dkv_f32(const float* q, const float* k,
                                 const float* v, const float* dout,
                                 const float* m, const float* l,
                                 const float* di, float* dk, float* dv,
                                 int64_t bh, int t, int d, float scale,
                                 cudaStream_t stream) {
  if (bad_shape(bh, t)) return kBadArgument;
  switch (d) {
    case 16: return launch_dkv<16>(q, k, v, dout, m, l, di, dk, dv, bh, t,
                                   scale, stream);
    case 32: return launch_dkv<32>(q, k, v, dout, m, l, di, dk, dv, bh, t,
                                   scale, stream);
    case 64: return launch_dkv<64>(q, k, v, dout, m, l, di, dk, dv, bh, t,
                                   scale, stream);
    default: return kBadArgument;
  }
}

extern "C" int flash_bwd_dq_f32(const float* q, const float* k,
                                const float* v, const float* dout,
                                const float* m, const float* l,
                                const float* di, float* dq, int64_t bh, int t,
                                int d, float scale, cudaStream_t stream) {
  if (bad_shape(bh, t)) return kBadArgument;
  switch (d) {
    case 16: return launch_dq<16>(q, k, v, dout, m, l, di, dq, bh, t, scale,
                                  stream);
    case 32: return launch_dq<32>(q, k, v, dout, m, l, di, dq, bh, t, scale,
                                  stream);
    case 64: return launch_dq<64>(q, k, v, dout, m, l, di, dq, bh, t, scale,
                                  stream);
    default: return kBadArgument;
  }
}
