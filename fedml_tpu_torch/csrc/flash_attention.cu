// Causal flash attention, forward and backward, on f32 and on bf16 data
// (K4).
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
//                        dQ from the same inputs;
//   flash_fwd_bf16, flash_bwd_dkv_bf16, flash_bwd_dq_bf16 <- the same three
//                        on bf16 q, k, v and dO (the library's path under
//                        --compute_dtype bfloat16; the bf16 section below).
//
// Layout: q, k, v, o, dO, dq, dk, dv are [BH, T, D] contiguous f32 (bf16 in
// the _bf16 entries; B and H folded; the wrapper transposes the model's [B,
// T, H, D]); m, l, di are [BH, T] f32.  Every pointer is 16-byte aligned (checked by the wrapper).  T
// is a multiple of 128 (the library's block, checked by the wrapper) and D
// is 16, 32 or 64 (the wrapper refuses other head sizes on the card).  Key
// c is visible to query r when c <= r.  The split of the backward into a
// dK/dV pass and a dQ pass is the library's: each output element has one
// owner, so the gradients need no atomics and are deterministic.
//
// What bounds them.  Per visible (query, key) pair the forward does 2 D
// multiply-adds (a score and its share of P V), dK/dV 4 D and dQ 3 D, and
// each does one exp; each reads its inputs and writes its outputs, a few
// rows of D floats per row, once.  At T = 2048, D = 32 that is 64-128
// multiply-adds per pair against about 1 KB of traffic per row, so the
// bytes at 3.35 TB/s are never the bound: the products at the H100 SXM's
// 495 TFLOP/s TF32 tensor-core rate and the exps at the SFU's 16 per clock
// per SM take about the same time (chip_smoke.py::flash_bounds computes
// all three terms).
//
// All three run their products on the tensor cores
// (mma.sync.m16n8k8, TF32 inputs, f32 accumulators) in three passes:
// each f32 operand a is split into hi = tf32(a) (cvt.rna's rounding) and
// lo = a - hi (exact) truncated to TF32, and a*b is taken as
// lo*hi + hi*lo + hi*hi, dropping lo*lo: near-f32 products (relative error
// about 2^-21) at a third of the TF32 rate.  One pass would keep 10
// mantissa bits and put the scores' relative error near 5e-4, which the
// 1e-5 x max|ref| limit on o does not allow.  So their floor is three
// times the TF32 term of the bound.  mma.sync rather than wgmma: TF32
// wgmma reads both operands K-major from shared memory as they are, so
// every lo part and every transposed operand (V for P V; Q and dO for the
// dK/dV sums; K for dS K) would be a further shared tile; with mma.sync
// the split and the transposes are register and index work.
//
// The design of the three:
//   * 4 warps a block, 16 rows a warp, one 64-row tile a block; the warp's
//     own operands (the Q rows in K4f; the K and V rows in K4dkv; the Q and
//     dO rows in K4dq) are split into hi/lo fragments once and kept in
//     registers for the whole walk, with K4dq's m, 1/l and di of its rows.
//   * The other operand's 64-row tiles (K, V; or Q, dO, m, l, di) are
//     double-buffered in shared memory with 16-byte cp.async copies: the
//     next tile lands while the current one is computed.  In [BH, T, D] a
//     tile of one (b, h) is one contiguous run.  Shared rows are padded to
//     D + 4 floats, so every fragment load (8 rows x 4 columns, or 4 row
//     pairs x 8 columns, per warp) hits 32 different banks.
//   * P (or dS) goes from the accumulator to the next product without a
//     trip through shared memory: an m16n8k8 accumulator holds columns
//     (2t, 2t+1) of rows g and g+8 (g = lane/4, t = lane%4), and the A
//     fragment wants k = t and t+4.  A sum over keys does not care about
//     their order, so columns (2t, 2t+1) serve as k = (t, t+4), and the B
//     rows (V; dO and Q; or K) are read in the same permuted order.
//   * K4f walks key tiles 0..diagonal, 32 keys at a time: S = Q K^T *
//     scale, the online softmax on the accumulator fragments (row max and
//     sum by quad shuffles, __expf), O = O corr + P V; only the diagonal
//     tile is masked; at the end o = acc / l and m, l as the library keeps
//     them.
//   * K4dkv owns 64 key rows and walks query tiles diagonal..end, 16
//     queries at a time: S^T = K Q^T, P^T = exp(S^T * scale - m) * (1/l),
//     dP^T = V dO^T, dS^T = P^T (dP^T - di) scale, then dV += P^T dO and
//     dK += dS^T Q.  1/l is taken once per query and tile.
//   * K4dq walks key tiles 0..diagonal, 16 keys at a time: S = Q K^T,
//     dP = dO V^T, P = exp(S * scale - m) * (1/l), dS = P (dP - di) scale,
//     then dQ += dS K; above the diagonal dS is set to 0 by a select, not
//     a multiply (a masked score's exp may overflow, and inf x 0 is NaN).
//   * On the diagonal tile a warp skips the keys (K4f, K4dq) or queries
//     (K4dkv) that none of its rows pairs with.
//   * The running sums (O, dK, dV, dQ) are f32 registers outside the
//     tensor cores: each product over 32 keys (K4f), 16 queries (K4dkv) or
//     16 keys (K4dq) starts from zero in the accumulator and is then added
//     in f32.  The tensor cores' accumulation is not round-to-nearest:
//     one long sum kept in their accumulator ended about ten times further
//     from the plain version (dK, dV at T = 2048) than these partial sums
//     do.
//   * Tiles above the diagonal are never visited, and the heaviest tiles
//     of every (b, h) are dispatched first (the grid's y order).
//
// Floating point: the shared build flags carry -fmad=false (K1 and K2 need
// it for their bit-equality); the products are the tensor cores', the
// scalar arithmetic rounds step by step.  exp is __expf (ex2.approx): at
// most a few ulps where the probabilities matter.  The results are held to
// the plain PyTorch versions (models/flash_attention.py) within a
// tolerance, not bit for bit.  A NaN in an input comes out as NaN in every
// output it reaches through a visible pair, as in the plain versions
// (chip_smoke.py checks it).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;    // rows of every tile
constexpr int kWarps = 4;    // 16 rows a warp
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xFFFFFFFFu;

// ---------------------------------------------------------------------------
// helpers
// ---------------------------------------------------------------------------

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero, the low 13
// bits cleared) as an integer add and mask: ptxas expands the cvt into four
// instructions around an inf check, and the split is most of these
// kernels' ALU work.  The two agree on every finite input and on inf.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both TF32: hi = tf32_rna(x); lo = x - hi, exact in f32, with
// its low 13 bits cleared (truncated; its 12 significant bits lose the last,
// 2^-23 of x at most).  A NaN reaches the products through lo: the add may
// carry a NaN's payload into hi's sign or exponent (0x7FFFFFFF becomes -0),
// but x - hi is then the canonical NaN, which the mask keeps a NaN.  So a
// NaN input makes NaN outputs, as in the plain versions; an inf makes NaN
// (inf - inf) where f32 products would make inf.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xFFFFE000u;
}

// d += a b for one m16n8k8 tile
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += (ahi + alo)(b0, b1) in three passes, the small terms first; b0 and
// b1 are the B fragment's f32 values, split here
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], float b0,
                                     float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma(d, alo, h0, h1);
  mma(d, ahi, l0, l1);
  mma(d, ahi, h0, h1);
}

// The A fragment (hi, lo) of a 16 x 8 tile from an accumulator tile c
// through the key permutation: columns (2t, 2t+1) serve as k = (t, t+4).
__device__ __forceinline__ void split_acc(const float (&c)[4],
                                          uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  split(c[0], hi[0], lo[0]);   // (g, 2t)       -> (g, t)
  split(c[2], hi[1], lo[1]);   // (g + 8, 2t)   -> (g + 8, t)
  split(c[1], hi[2], lo[2]);   // (g, 2t + 1)   -> (g, t + 4)
  split(c[3], hi[3], lo[3]);   // (g + 8, 2t+1) -> (g + 8, t + 4)
}

// The A fragments (hi, lo) of rows (row, row + 8) of a [., D] f32 array in
// device memory, k-step s covering columns 8s..8s+7.
template <int D>
__device__ __forceinline__ void split_rows(const float* __restrict__ row,
                                           int t, uint32_t (&hi)[D / 8][4],
                                           uint32_t (&lo)[D / 8][4]) {
#pragma unroll
  for (int s = 0; s < D / 8; ++s) {
    const float* p = row + 8 * s + t;
    split(__ldg(p), hi[s][0], lo[s][0]);
    split(__ldg(p + 8 * D), hi[s][1], lo[s][1]);
    split(__ldg(p + 4), hi[s][2], lo[s][2]);
    split(__ldg(p + 8 * D + 4), hi[s][3], lo[s][3]);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared rows are padded to D + 4 floats: fragment loads are conflict-free
template <int D>
constexpr int kPitch = D + 4;

// Start copying one [kTile, D] tile (contiguous rows) into a padded
// [kTile][D + 4] shared tile.
template <int D>
__device__ __forceinline__ void stage_tile(float* dst,
                                           const float* __restrict__ src) {
  for (int i = threadIdx.x; i < kTile * D / 4; i += kThreads)
    cp_async16(dst + (i / (D / 4)) * kPitch<D> + 4 * (i % (D / 4)),
               src + 4 * i);
}

// sum += A B over one 16-row chunk: A's two k-steps are the accumulator
// tiles a[0], a[1] through the permutation, B's rows are read from a padded
// shared tile in the same order (row0 = the chunk's first row + 2t).  The
// chunk's sum starts from zero and is added to the running sum in f32: the
// tensor cores' accumulation is not f32 round-to-nearest, so no long sum
// stays in their accumulator.
template <int D>
__device__ __forceinline__ void add_chunk(float (&sum)[D / 8][4],
                                          const float (&a)[2][4],
                                          const float* b, int row0, int g) {
  float part[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[n][e] = 0.0f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    uint32_t hi[4], lo[4];
    split_acc(a[j], hi, lo);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float* bp = b + (row0 + 8 * j) * kPitch<D> + 8 * n + g;
      mma3(part[n], hi, lo, bp[0], bp[kPitch<D>]);
    }
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[n][e] += part[n][e];
}

// K4f and K4dq: [2 buffers][K, V] tiles
template <int D>
__host__ __device__ constexpr int kv_smem_bytes() {
  return 2 * 2 * kTile * kPitch<D> * 4;
}

// one buffer: the Q and dO tiles, then the m, l and di rows
template <int D>
__host__ __device__ constexpr int dkv_buffer_floats() {
  return 2 * kTile * kPitch<D> + 3 * kTile;
}

template <int D>
__host__ __device__ constexpr int dkv_smem_bytes() {
  return 2 * dkv_buffer_floats<D>() * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 32 ? 4 : 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out, int t,
                 float scale) {
  constexpr int P = kPitch<D>, KS = D / 8;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int n_tiles = t / kTile;
  const int qt = n_tiles - 1 - blockIdx.y;   // the longest rows start first
  const int64_t bh = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int r0 = 16 * warp + g;              // rows r0 and r0 + 8 of the tile
  const int64_t row0 = bh * t + static_cast<int64_t>(qt) * kTile + r0;
  const float* const kbh = k + bh * t * D;
  const float* const vbh = v + bh * t * D;

  stage_tile<D>(smem, kbh);
  stage_tile<D>(smem + kTile * P, vbh);
  cp_async_commit();

  uint32_t qhi[KS][4], qlo[KS][4];
  split_rows<D>(q + row0 * D, tq, qhi, qlo);
  float acc[KS][4];                          // O: dims 8n + 2t, 8n + 2t + 1
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};       // rows r0, r0 + 8
  float l[2] = {0.0f, 0.0f};                 // this thread's columns only

  for (int kt = 0; kt <= qt; ++kt) {
    const float* const ks = smem + (kt & 1) * 2 * kTile * P;
    const float* const vs = ks + kTile * P;
    if (kt < qt) {
      float* const next = smem + ((kt + 1) & 1) * 2 * kTile * P;
      stage_tile<D>(next, kbh + static_cast<int64_t>(kt + 1) * kTile * D);
      stage_tile<D>(next + kTile * P,
                    vbh + static_cast<int64_t>(kt + 1) * kTile * D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const bool diag = kt == qt;
    // 32 keys at a time: n-tile j holds keys c0 + 8j + 2t (+1)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = 32 * half;
      // on the diagonal, keys past the warp's last row are all masked; a
      // half that is visited has a visible key for every row
      if (diag && c0 > 16 * warp + 15) continue;
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
        for (int st = 0; st < KS; ++st) {
          const float* kp = ks + (c0 + 8 * j + g) * P + 8 * st + tq;
          mma3(s[j], qhi[st], qlo[st], kp[0], kp[4]);
        }
      }
      // scale, mask the diagonal, and the online softmax's rescale
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (diag && c0 + 8 * j + 2 * tq + (e & 1) > r0 + 8 * (e >> 1))
            x = -INFINITY;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
        corr[h] = __expf(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= corr[h];
      }
      // this half's P V from zero, P from the accumulator through the key
      // permutation; then O = O corr + P V in f32 (as in add_chunk)
      float pv[KS][4];
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[n][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = __expf(s[j][e] - m[e >> 1]);
          l[e >> 1] += s[j][e];
        }
        uint32_t phi[4], plo[4];
        split_acc(s[j], phi, plo);
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          const float* vp = vs + (c0 + 8 * j + 2 * tq) * P + 8 * n + g;
          mma3(pv[n], phi, plo, vp[0], vp[P]);
        }
      }
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = acc[n][e] * corr[e >> 1] + pv[n][e];
    }
    __syncthreads();   // the next iteration's copy reuses this buffer
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
  }
#pragma unroll
  for (int n = 0; n < KS; ++n) {
    const int col = 8 * n + 2 * tq;
    *reinterpret_cast<float2*>(o + row0 * D + col) =
        make_float2(acc[n][0] / l[0], acc[n][1] / l[0]);
    *reinterpret_cast<float2*>(o + (row0 + 8) * D + col) =
        make_float2(acc[n][2] / l[1], acc[n][3] / l[1]);
  }
  if (tq == 0) {
    m_out[row0] = m[0]; m_out[row0 + 8] = m[1];
    l_out[row0] = l[0]; l_out[row0 + 8] = l[1];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 32 ? 3 : 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ di, float* __restrict__ dk,
                     float* __restrict__ dv, int t, float scale) {
  constexpr int P = kPitch<D>, KS = D / 8;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int n_tiles = t / kTile;
  const int kt = blockIdx.y;                 // the longest walks start first
  const int64_t bh = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int c0 = 16 * warp + g;              // keys c0 and c0 + 8 of the tile
  const int64_t key0 = bh * t + static_cast<int64_t>(kt) * kTile + c0;

  // one buffer: Q [kTile][P], dO [kTile][P], then m, l, di [kTile] each
  auto stage_queries = [&](int qt) {
    float* const buf = smem + ((qt - kt) & 1) * dkv_buffer_floats<D>();
    const int64_t r = bh * t + static_cast<int64_t>(qt) * kTile;
    stage_tile<D>(buf, q + r * D);
    stage_tile<D>(buf + kTile * P, dout + r * D);
    float* const vecs = buf + 2 * kTile * P;
    const int i = threadIdx.x;
    if (i < 3 * kTile / 4) {
      const float* src = (i < kTile / 4) ? m : (i < kTile / 2) ? l : di;
      cp_async16(vecs + 4 * i, src + r + 4 * (i % (kTile / 4)));
    }
    cp_async_commit();
  };
  stage_queries(kt);

  uint32_t khi[KS][4], klo[KS][4], vhi[KS][4], vlo[KS][4];
  split_rows<D>(k + key0 * D, tq, khi, klo);
  split_rows<D>(v + key0 * D, tq, vhi, vlo);
  float dka[KS][4], dva[KS][4];              // dims 8n + 2t, 8n + 2t + 1
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) { dka[n][e] = 0.0f; dva[n][e] = 0.0f; }

  for (int qt = kt; qt < n_tiles; ++qt) {
    float* const qs = smem + ((qt - kt) & 1) * dkv_buffer_floats<D>();
    const float* const dos = qs + kTile * P;
    const float* const ms = qs + 2 * kTile * P;
    float* const inv_ls = qs + 2 * kTile * P + kTile;
    const float* const dis = inv_ls + kTile;
    if (qt + 1 < n_tiles) {
      stage_queries(qt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // l -> 1/l in place, once per query instead of once per use
    if (threadIdx.x < kTile)
      inv_ls[threadIdx.x] = 1.0f / inv_ls[threadIdx.x];
    __syncthreads();
    const bool diag = qt == kt;
    // 16 queries at a time: n-tile j holds queries q0 + 8j + 2t (+1)
#pragma unroll
    for (int chunk = 0; chunk < 4; ++chunk) {
      const int q0 = 16 * chunk;
      if (diag && q0 + 15 < 16 * warp) continue;   // sees none of its keys
      float sa[2][4], dpa[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) { sa[j][e] = 0.0f; dpa[j][e] = 0.0f; }
#pragma unroll
        for (int st = 0; st < KS; ++st) {
          const int off = (q0 + 8 * j + g) * P + 8 * st + tq;
          mma3(sa[j], khi[st], klo[st], qs[off], qs[off + 4]);
          mma3(dpa[j], vhi[st], vlo[st], dos[off], dos[off + 4]);
        }
      }
      // P^T = exp(S^T scale - m) / l and dS^T = P^T (dP^T - di) scale
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qc = q0 + 8 * j + 2 * tq;
        const float2 mq = *reinterpret_cast<const float2*>(ms + qc);
        const float2 il = *reinterpret_cast<const float2*>(inv_ls + qc);
        const float2 dq = *reinterpret_cast<const float2*>(dis + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e & 1;
          float p = __expf(sa[j][e] * scale - (odd ? mq.y : mq.x)) *
                    (odd ? il.y : il.x);
          if (diag && c0 + 8 * (e >> 1) > qc + odd) p = 0.0f;
          dpa[j][e] = p * (dpa[j][e] - (odd ? dq.y : dq.x)) * scale;
          sa[j][e] = p;
        }
      }
      // dV += P^T dO and dK += dS^T Q through the query permutation
      add_chunk<D>(dva, sa, dos, q0 + 2 * tq, g);
      add_chunk<D>(dka, dpa, qs, q0 + 2 * tq, g);
    }
    __syncthreads();   // the next iteration's copy reuses this buffer
  }
#pragma unroll
  for (int n = 0; n < KS; ++n) {
    const int col = 8 * n + 2 * tq;
    *reinterpret_cast<float2*>(dk + key0 * D + col) =
        make_float2(dka[n][0], dka[n][1]);
    *reinterpret_cast<float2*>(dk + (key0 + 8) * D + col) =
        make_float2(dka[n][2], dka[n][3]);
    *reinterpret_cast<float2*>(dv + key0 * D + col) =
        make_float2(dva[n][0], dva[n][1]);
    *reinterpret_cast<float2*>(dv + (key0 + 8) * D + col) =
        make_float2(dva[n][2], dva[n][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 32 ? 3 : 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ di, float* __restrict__ dq,
                    int t, float scale) {
  constexpr int P = kPitch<D>, KS = D / 8;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int n_tiles = t / kTile;
  const int qt = n_tiles - 1 - blockIdx.y;   // the longest rows start first
  const int64_t bh = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int r0 = 16 * warp + g;              // rows r0 and r0 + 8 of the tile
  const int64_t row0 = bh * t + static_cast<int64_t>(qt) * kTile + r0;
  const float* const kbh = k + bh * t * D;
  const float* const vbh = v + bh * t * D;

  stage_tile<D>(smem, kbh);
  stage_tile<D>(smem + kTile * P, vbh);
  cp_async_commit();

  uint32_t qhi[KS][4], qlo[KS][4], dohi[KS][4], dolo[KS][4];
  split_rows<D>(q + row0 * D, tq, qhi, qlo);
  split_rows<D>(dout + row0 * D, tq, dohi, dolo);
  float mr[2], inv_l[2], dir[2];             // rows r0, r0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mr[h] = __ldg(m + row0 + 8 * h);
    inv_l[h] = 1.0f / __ldg(l + row0 + 8 * h);
    dir[h] = __ldg(di + row0 + 8 * h);
  }
  float dqa[KS][4];                          // dims 8n + 2t, 8n + 2t + 1
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.0f;

  for (int kt = 0; kt <= qt; ++kt) {
    const float* const ks = smem + (kt & 1) * 2 * kTile * P;
    const float* const vs = ks + kTile * P;
    if (kt < qt) {
      float* const next = smem + ((kt + 1) & 1) * 2 * kTile * P;
      stage_tile<D>(next, kbh + static_cast<int64_t>(kt + 1) * kTile * D);
      stage_tile<D>(next + kTile * P,
                    vbh + static_cast<int64_t>(kt + 1) * kTile * D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const bool diag = kt == qt;
    // 16 keys at a time: n-tile j holds keys c0 + 8j + 2t (+1)
#pragma unroll
    for (int chunk = 0; chunk < 4; ++chunk) {
      const int c0 = 16 * chunk;
      if (diag && c0 > 16 * warp + 15) continue;   // sees none of its rows
      float sa[2][4], dpa[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) { sa[j][e] = 0.0f; dpa[j][e] = 0.0f; }
#pragma unroll
        for (int st = 0; st < KS; ++st) {
          const int off = (c0 + 8 * j + g) * P + 8 * st + tq;
          mma3(sa[j], qhi[st], qlo[st], ks[off], ks[off + 4]);
          mma3(dpa[j], dohi[st], dolo[st], vs[off], vs[off + 4]);
        }
      }
      // P = exp(S scale - m) / l and dS = P (dP - di) scale; a pair above
      // the diagonal is set to 0, not multiplied by 0 (its exp may be inf)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p = __expf(sa[j][e] * scale - mr[h]) * inv_l[h];
          float ds = p * (dpa[j][e] - dir[h]) * scale;
          if (diag && c0 + 8 * j + 2 * tq + (e & 1) > r0 + 8 * h) ds = 0.0f;
          sa[j][e] = ds;
        }
      // dQ += dS K through the key permutation
      add_chunk<D>(dqa, sa, ks, c0 + 2 * tq, g);
    }
    __syncthreads();   // the next iteration's copy reuses this buffer
  }
#pragma unroll
  for (int n = 0; n < KS; ++n) {
    const int col = 8 * n + 2 * tq;
    *reinterpret_cast<float2*>(dq + row0 * D + col) =
        make_float2(dqa[n][0], dqa[n][1]);
    *reinterpret_cast<float2*>(dq + (row0 + 8) * D + col) =
        make_float2(dqa[n][2], dqa[n][3]);
  }
}

// ---------------------------------------------------------------------------
// bf16: the same three kernels for bf16 q, k, v, dO (the library's path
// under --compute_dtype bfloat16)
// ---------------------------------------------------------------------------
//
// The library multiplies bf16 x bf16 with f32 accumulation
// (preferred_element_type=f32) and rounds to bf16 at four points: P before
// P V (forward), P^T before P^T dO, dS before dS^T Q (dK/dV) and dS before
// dS K (dQ); m, l, di and every running sum stay f32, and o, dq, dk, dv
// are rounded once when written.  These kernels do the same with
// mma.sync.m16n8k16 (bf16 in, f32 accumulators), one pass: a bf16 product
// is exact in f32, so no hi/lo split.  The structure, grid and walks are
// the f32 kernels'; what differs:
//   * an m16n8k16 A fragment holds (row g | g + 8, k = 2t, 2t + 1 | 2t + 8,
//     2t + 9) as bf16 pairs, which is exactly what two adjacent 16 x 8
//     accumulator tiles hold (columns 2t, 2t + 1 of each): P (or dS) goes
//     to the next product through cvt.rn.bf16x2.f32 with no permutation;
//   * the score products (Q K^T; K Q^T and V dO^T; Q K^T and dO V^T) read
//     B as 32-bit pairs along d from row-major tiles; the second products
//     (P V; P^T dO and dS^T Q; dS K) read B down a column, two 16-bit
//     loads a register;
//   * shared rows are padded to D + 8 bf16 (16 bytes): rows stay 16-byte
//     aligned for cp.async, and both kinds of fragment load hit 32
//     different banks (the pitch in words is 4 mod 8 words per row pair);
//   * P (or dS) is rounded once per 16-key (or 16-query) step, from the f32
//     value the f32 kernels would use; the forward's P is exp(s - m) against
//     the running max of the 32-key half, as in the f32 kernel (the
//     library's against the running max of its 128-key block).
// They are bound by the exps more than by the products (bf16 runs at twice
// the TF32 rate and needs one pass, not three), and their bytes are half
// the f32 kernels'.

// shared bf16 rows are padded to D + 8 values
template <int D>
constexpr int kPitchH = D + 8;

// (lo, hi) rounded to bf16 (to nearest even) in one register, lo in the
// low half: the element with the lower column or k index
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d += a b for one m16n8k16 tile: bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of a 16 x 16 tile from two accumulator tiles (columns
// 0-7 and 8-15), rounded to bf16
__device__ __forceinline__ void acc_to_a(const float (&c0)[4],
                                         const float (&c1)[4],
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);   // (g, 2t)         (g, 2t + 1)
  a[1] = pack_bf16(c0[2], c0[3]);   // (g + 8, 2t)     (g + 8, 2t + 1)
  a[2] = pack_bf16(c1[0], c1[1]);   // (g, 2t + 8)     (g, 2t + 9)
  a[3] = pack_bf16(c1[2], c1[3]);   // (g + 8, 2t + 8) (g + 8, 2t + 9)
}

// The A fragments of rows (row, row + 8) of a [., D] bf16 array in device
// memory, k-step s covering columns 16s..16s+15
template <int D>
__device__ __forceinline__ void load_rows_bf16(const uint16_t* __restrict__ row,
                                               int t,
                                               uint32_t (&a)[D / 16][4]) {
  const uint32_t* const r = reinterpret_cast<const uint32_t*>(row);
#pragma unroll
  for (int s = 0; s < D / 16; ++s) {
    a[s][0] = __ldg(r + 8 * s + t);
    a[s][1] = __ldg(r + 4 * D + 8 * s + t);
    a[s][2] = __ldg(r + 8 * s + t + 4);
    a[s][3] = __ldg(r + 4 * D + 8 * s + t + 4);
  }
}

// B of an m16n8k16 product from a row-major [n][k] shared tile: rows n0 + g,
// k-step s (two 32-bit pairs along the row)
template <int D>
__device__ __forceinline__ void row_pairs(const uint16_t* tile, int n, int s,
                                          int t, uint32_t& b0, uint32_t& b1) {
  const uint32_t* const p = reinterpret_cast<const uint32_t*>(
      tile + n * kPitchH<D> + 16 * s + 2 * t);
  b0 = p[0];
  b1 = p[4];
}

// two bf16 of one column, rows r and r + 1 of a padded shared tile, as
// one B register (row r in the low half)
template <int D>
__device__ __forceinline__ uint32_t col_pair(const uint16_t* p) {
  return static_cast<uint32_t>(p[0]) |
         (static_cast<uint32_t>(p[kPitchH<D>]) << 16);
}

// Start copying one [kTile, D] bf16 tile into a padded shared tile.
template <int D>
__device__ __forceinline__ void stage_tile_bf16(
    uint16_t* dst, const uint16_t* __restrict__ src) {
  for (int i = threadIdx.x; i < kTile * D / 8; i += kThreads)
    cp_async16(dst + (i / (D / 8)) * kPitchH<D> + 8 * (i % (D / 8)),
               src + 8 * i);
}

// sum += A B over one 16-row chunk, A the accumulator tiles a[0], a[1]
// rounded to bf16, B's rows row0, row0 + 1 (row0 = the chunk's first row
// + 2t) and row0 + 8, row0 + 9 read down column 8n + g of a padded shared
// tile; the chunk's product starts from zero and is added in f32, as in
// add_chunk
template <int D>
__device__ __forceinline__ void add_chunk_bf16(float (&sum)[D / 8][4],
                                               const float (&a)[2][4],
                                               const uint16_t* b, int row0,
                                               int g) {
  uint32_t af[4];
  acc_to_a(a[0], a[1], af);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const uint16_t* const bp = b + row0 * kPitchH<D> + 8 * n + g;
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_bf16(part, af, col_pair<D>(bp), col_pair<D>(bp + 8 * kPitchH<D>));
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[n][e] += part[e];
  }
}

// two f32 values rounded to bf16 and written as one 32-bit store
__device__ __forceinline__ void store_bf16x2(uint16_t* p, float lo,
                                             float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}

// K4f and K4dq: [2 buffers][K, V] bf16 tiles
template <int D>
__host__ __device__ constexpr int kv_smem_bytes_bf16() {
  return 2 * 2 * kTile * kPitchH<D> * 2;
}

// one buffer: the Q and dO bf16 tiles, then the m, l and di f32 rows
template <int D>
__host__ __device__ constexpr int dkv_buffer_bytes_bf16() {
  return 2 * kTile * kPitchH<D> * 2 + 3 * kTile * 4;
}

template <int D>
__host__ __device__ constexpr int dkv_smem_bytes_bf16() {
  return 2 * dkv_buffer_bytes_bf16<D>();
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 32 ? 4 : 2)
flash_fwd_bf16_kernel(const uint16_t* __restrict__ q,
                      const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v,
                      uint16_t* __restrict__ o, float* __restrict__ m_out,
                      float* __restrict__ l_out, int t, float scale) {
  constexpr int P = kPitchH<D>, KS = D / 16, NT = D / 8;
  extern __shared__ float4 smem4[];
  uint16_t* const smem = reinterpret_cast<uint16_t*>(smem4);
  const int n_tiles = t / kTile;
  const int qt = n_tiles - 1 - blockIdx.y;   // the longest rows start first
  const int64_t bh = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int r0 = 16 * warp + g;              // rows r0 and r0 + 8 of the tile
  const int64_t row0 = bh * t + static_cast<int64_t>(qt) * kTile + r0;
  const uint16_t* const kbh = k + bh * t * D;
  const uint16_t* const vbh = v + bh * t * D;

  stage_tile_bf16<D>(smem, kbh);
  stage_tile_bf16<D>(smem + kTile * P, vbh);
  cp_async_commit();

  uint32_t qa[KS][4];
  load_rows_bf16<D>(q + row0 * D, tq, qa);
  float acc[NT][4];                          // O: dims 8n + 2t, 8n + 2t + 1
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};       // rows r0, r0 + 8
  float l[2] = {0.0f, 0.0f};                 // this thread's columns only

  for (int kt = 0; kt <= qt; ++kt) {
    const uint16_t* const ks = smem + (kt & 1) * 2 * kTile * P;
    const uint16_t* const vs = ks + kTile * P;
    if (kt < qt) {
      uint16_t* const next = smem + ((kt + 1) & 1) * 2 * kTile * P;
      stage_tile_bf16<D>(next, kbh + static_cast<int64_t>(kt + 1) * kTile * D);
      stage_tile_bf16<D>(next + kTile * P,
                         vbh + static_cast<int64_t>(kt + 1) * kTile * D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const bool diag = kt == qt;
    // 32 keys at a time: n-tile j holds keys c0 + 8j + 2t (+1)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = 32 * half;
      if (diag && c0 > 16 * warp + 15) continue;
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
        for (int st = 0; st < KS; ++st) {
          uint32_t b0, b1;
          row_pairs<D>(ks, c0 + 8 * j + g, st, tq, b0, b1);
          mma_bf16(s[j], qa[st], b0, b1);
        }
      }
      // scale, mask the diagonal, and the online softmax's rescale (f32)
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (diag && c0 + 8 * j + 2 * tq + (e & 1) > r0 + 8 * (e >> 1))
            x = -INFINITY;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
        corr[h] = __expf(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= corr[h];
      }
      // P = exp(s - m) in f32 (l sums it unrounded, as the library's l),
      // then this half's P V from zero with P rounded to bf16, 16 keys a
      // k-step; O = O corr + P V in f32
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = __expf(s[j][e] - m[e >> 1]);
          l[e >> 1] += s[j][e];
        }
      float pv[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t pa[4];
        acc_to_a(s[2 * kk], s[2 * kk + 1], pa);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint16_t* const vp = vs + (c0 + 16 * kk + 2 * tq) * P + 8 * n + g;
          mma_bf16(pv[n], pa, col_pair<D>(vp), col_pair<D>(vp + 8 * P));
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = acc[n][e] * corr[e >> 1] + pv[n][e];
    }
    __syncthreads();   // the next iteration's copy reuses this buffer
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = 8 * n + 2 * tq;
    store_bf16x2(o + row0 * D + col, acc[n][0] / l[0], acc[n][1] / l[0]);
    store_bf16x2(o + (row0 + 8) * D + col, acc[n][2] / l[1],
                 acc[n][3] / l[1]);
  }
  if (tq == 0) {
    m_out[row0] = m[0]; m_out[row0 + 8] = m[1];
    l_out[row0] = l[0]; l_out[row0 + 8] = l[1];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 32 ? 4 : 2)
flash_bwd_dkv_bf16_kernel(const uint16_t* __restrict__ q,
                          const uint16_t* __restrict__ k,
                          const uint16_t* __restrict__ v,
                          const uint16_t* __restrict__ dout,
                          const float* __restrict__ m,
                          const float* __restrict__ l,
                          const float* __restrict__ di,
                          uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                          int t, float scale) {
  constexpr int P = kPitchH<D>, KS = D / 16, NT = D / 8;
  extern __shared__ float4 smem4[];
  char* const smem = reinterpret_cast<char*>(smem4);
  const int n_tiles = t / kTile;
  const int kt = blockIdx.y;                 // the longest walks start first
  const int64_t bh = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int c0 = 16 * warp + g;              // keys c0 and c0 + 8 of the tile
  const int64_t key0 = bh * t + static_cast<int64_t>(kt) * kTile + c0;

  // one buffer: Q [kTile][P], dO [kTile][P] (bf16), then m, l, di [kTile]
  // (f32) each
  auto stage_queries = [&](int qt) {
    char* const buf = smem + ((qt - kt) & 1) * dkv_buffer_bytes_bf16<D>();
    uint16_t* const tiles = reinterpret_cast<uint16_t*>(buf);
    const int64_t r = bh * t + static_cast<int64_t>(qt) * kTile;
    stage_tile_bf16<D>(tiles, q + r * D);
    stage_tile_bf16<D>(tiles + kTile * P, dout + r * D);
    float* const vecs = reinterpret_cast<float*>(buf + 2 * kTile * P * 2);
    const int i = threadIdx.x;
    if (i < 3 * kTile / 4) {
      const float* src = (i < kTile / 4) ? m : (i < kTile / 2) ? l : di;
      cp_async16(vecs + 4 * i, src + r + 4 * (i % (kTile / 4)));
    }
    cp_async_commit();
  };
  stage_queries(kt);

  uint32_t ka[KS][4], va[KS][4];
  load_rows_bf16<D>(k + key0 * D, tq, ka);
  load_rows_bf16<D>(v + key0 * D, tq, va);
  float dka[NT][4], dva[NT][4];              // dims 8n + 2t, 8n + 2t + 1
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) { dka[n][e] = 0.0f; dva[n][e] = 0.0f; }

  for (int qt = kt; qt < n_tiles; ++qt) {
    char* const buf = smem + ((qt - kt) & 1) * dkv_buffer_bytes_bf16<D>();
    const uint16_t* const qs = reinterpret_cast<const uint16_t*>(buf);
    const uint16_t* const dos = qs + kTile * P;
    float* const ms = reinterpret_cast<float*>(buf + 2 * kTile * P * 2);
    float* const inv_ls = ms + kTile;
    const float* const dis = inv_ls + kTile;
    if (qt + 1 < n_tiles) {
      stage_queries(qt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // l -> 1/l in place, once per query instead of once per use
    if (threadIdx.x < kTile)
      inv_ls[threadIdx.x] = 1.0f / inv_ls[threadIdx.x];
    __syncthreads();
    const bool diag = qt == kt;
    // 16 queries at a time: n-tile j holds queries q0 + 8j + 2t (+1)
#pragma unroll
    for (int chunk = 0; chunk < 4; ++chunk) {
      const int q0 = 16 * chunk;
      if (diag && q0 + 15 < 16 * warp) continue;   // sees none of its keys
      float sa[2][4], dpa[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) { sa[j][e] = 0.0f; dpa[j][e] = 0.0f; }
#pragma unroll
        for (int st = 0; st < KS; ++st) {
          uint32_t b0, b1;
          row_pairs<D>(qs, q0 + 8 * j + g, st, tq, b0, b1);
          mma_bf16(sa[j], ka[st], b0, b1);
          row_pairs<D>(dos, q0 + 8 * j + g, st, tq, b0, b1);
          mma_bf16(dpa[j], va[st], b0, b1);
        }
      }
      // P^T = exp(S^T scale - m) / l and dS^T = P^T (dP^T - di) scale, f32
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qc = q0 + 8 * j + 2 * tq;
        const float2 mq = *reinterpret_cast<const float2*>(ms + qc);
        const float2 il = *reinterpret_cast<const float2*>(inv_ls + qc);
        const float2 dq = *reinterpret_cast<const float2*>(dis + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool odd = e & 1;
          float p = __expf(sa[j][e] * scale - (odd ? mq.y : mq.x)) *
                    (odd ? il.y : il.x);
          if (diag && c0 + 8 * (e >> 1) > qc + odd) p = 0.0f;
          dpa[j][e] = p * (dpa[j][e] - (odd ? dq.y : dq.x)) * scale;
          sa[j][e] = p;
        }
      }
      // dV += bf16(P^T) dO and dK += bf16(dS^T) Q
      add_chunk_bf16<D>(dva, sa, dos, q0 + 2 * tq, g);
      add_chunk_bf16<D>(dka, dpa, qs, q0 + 2 * tq, g);
    }
    __syncthreads();   // the next iteration's copy reuses this buffer
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = 8 * n + 2 * tq;
    store_bf16x2(dk + key0 * D + col, dka[n][0], dka[n][1]);
    store_bf16x2(dk + (key0 + 8) * D + col, dka[n][2], dka[n][3]);
    store_bf16x2(dv + key0 * D + col, dva[n][0], dva[n][1]);
    store_bf16x2(dv + (key0 + 8) * D + col, dva[n][2], dva[n][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, D <= 32 ? 4 : 2)
flash_bwd_dq_bf16_kernel(const uint16_t* __restrict__ q,
                         const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v,
                         const uint16_t* __restrict__ dout,
                         const float* __restrict__ m,
                         const float* __restrict__ l,
                         const float* __restrict__ di,
                         uint16_t* __restrict__ dq, int t, float scale) {
  constexpr int P = kPitchH<D>, KS = D / 16, NT = D / 8;
  extern __shared__ float4 smem4[];
  uint16_t* const smem = reinterpret_cast<uint16_t*>(smem4);
  const int n_tiles = t / kTile;
  const int qt = n_tiles - 1 - blockIdx.y;   // the longest rows start first
  const int64_t bh = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int r0 = 16 * warp + g;              // rows r0 and r0 + 8 of the tile
  const int64_t row0 = bh * t + static_cast<int64_t>(qt) * kTile + r0;
  const uint16_t* const kbh = k + bh * t * D;
  const uint16_t* const vbh = v + bh * t * D;

  stage_tile_bf16<D>(smem, kbh);
  stage_tile_bf16<D>(smem + kTile * P, vbh);
  cp_async_commit();

  uint32_t qa[KS][4], doa[KS][4];
  load_rows_bf16<D>(q + row0 * D, tq, qa);
  load_rows_bf16<D>(dout + row0 * D, tq, doa);
  float mr[2], inv_l[2], dir[2];             // rows r0, r0 + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mr[h] = __ldg(m + row0 + 8 * h);
    inv_l[h] = 1.0f / __ldg(l + row0 + 8 * h);
    dir[h] = __ldg(di + row0 + 8 * h);
  }
  float dqa[NT][4];                          // dims 8n + 2t, 8n + 2t + 1
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.0f;

  for (int kt = 0; kt <= qt; ++kt) {
    const uint16_t* const ks = smem + (kt & 1) * 2 * kTile * P;
    const uint16_t* const vs = ks + kTile * P;
    if (kt < qt) {
      uint16_t* const next = smem + ((kt + 1) & 1) * 2 * kTile * P;
      stage_tile_bf16<D>(next, kbh + static_cast<int64_t>(kt + 1) * kTile * D);
      stage_tile_bf16<D>(next + kTile * P,
                         vbh + static_cast<int64_t>(kt + 1) * kTile * D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const bool diag = kt == qt;
    // 16 keys at a time: n-tile j holds keys c0 + 8j + 2t (+1)
#pragma unroll
    for (int chunk = 0; chunk < 4; ++chunk) {
      const int c0 = 16 * chunk;
      if (diag && c0 > 16 * warp + 15) continue;   // sees none of its rows
      float sa[2][4], dpa[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) { sa[j][e] = 0.0f; dpa[j][e] = 0.0f; }
#pragma unroll
        for (int st = 0; st < KS; ++st) {
          uint32_t b0, b1;
          row_pairs<D>(ks, c0 + 8 * j + g, st, tq, b0, b1);
          mma_bf16(sa[j], qa[st], b0, b1);
          row_pairs<D>(vs, c0 + 8 * j + g, st, tq, b0, b1);
          mma_bf16(dpa[j], doa[st], b0, b1);
        }
      }
      // P = exp(S scale - m) / l and dS = P (dP - di) scale in f32; a pair
      // above the diagonal is set to 0, not multiplied by 0
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p = __expf(sa[j][e] * scale - mr[h]) * inv_l[h];
          float ds = p * (dpa[j][e] - dir[h]) * scale;
          if (diag && c0 + 8 * j + 2 * tq + (e & 1) > r0 + 8 * h) ds = 0.0f;
          sa[j][e] = ds;
        }
      // dQ += bf16(dS) K
      add_chunk_bf16<D>(dqa, sa, ks, c0 + 2 * tq, g);
    }
    __syncthreads();   // the next iteration's copy reuses this buffer
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = 8 * n + 2 * tq;
    store_bf16x2(dq + row0 * D + col, dqa[n][0], dqa[n][1]);
    store_bf16x2(dq + (row0 + 8) * D + col, dqa[n][2], dqa[n][3]);
  }
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

// Dynamic shared memory above 48 KB must be allowed per kernel and device
// first; `allowed` (one per kernel) keeps a bit per device where it was, so
// a launch pays for the attribute once.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes,
                       std::atomic<uint64_t>& allowed) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
  if (allowed.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) allowed.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* m, float* l, int64_t bh, int t, float scale,
               cudaStream_t stream) {
  constexpr int bytes = kv_smem_bytes<D>();
  static std::atomic<uint64_t> allowed{0};
  const cudaError_t err = allow_smem(flash_fwd_kernel<D>, bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_kernel<D><<<grid_of(bh, t), kThreads, bytes, stream>>>(
      q, k, v, o, m, l, t, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* m, const float* l,
               const float* di, float* dk, float* dv, int64_t bh, int t,
               float scale, cudaStream_t stream) {
  constexpr int bytes = dkv_smem_bytes<D>();
  static std::atomic<uint64_t> allowed{0};
  const cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D>, bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<D><<<grid_of(bh, t), kThreads, bytes, stream>>>(
      q, k, v, dout, m, l, di, dk, dv, t, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* m, const float* l,
              const float* di, float* dq, int64_t bh, int t, float scale,
              cudaStream_t stream) {
  constexpr int bytes = kv_smem_bytes<D>();
  static std::atomic<uint64_t> allowed{0};
  const cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, bytes, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D><<<grid_of(bh, t), kThreads, bytes, stream>>>(
      q, k, v, dout, m, l, di, dq, t, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fwd_bf16(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                    uint16_t* o, float* m, float* l, int64_t bh, int t,
                    float scale, cudaStream_t stream) {
  constexpr int bytes = kv_smem_bytes_bf16<D>();
  static std::atomic<uint64_t> allowed{0};
  const cudaError_t err = allow_smem(flash_fwd_bf16_kernel<D>, bytes,
                                     allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_bf16_kernel<D><<<grid_of(bh, t), kThreads, bytes, stream>>>(
      q, k, v, o, m, l, t, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_bf16(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                    const uint16_t* dout, const float* m, const float* l,
                    const float* di, uint16_t* dk, uint16_t* dv, int64_t bh,
                    int t, float scale, cudaStream_t stream) {
  constexpr int bytes = dkv_smem_bytes_bf16<D>();
  static std::atomic<uint64_t> allowed{0};
  const cudaError_t err = allow_smem(flash_bwd_dkv_bf16_kernel<D>, bytes,
                                     allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_bf16_kernel<D><<<grid_of(bh, t), kThreads, bytes, stream>>>(
      q, k, v, dout, m, l, di, dk, dv, t, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_bf16(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                   const uint16_t* dout, const float* m, const float* l,
                   const float* di, uint16_t* dq, int64_t bh, int t,
                   float scale, cudaStream_t stream) {
  constexpr int bytes = kv_smem_bytes_bf16<D>();
  static std::atomic<uint64_t> allowed{0};
  const cudaError_t err = allow_smem(flash_bwd_dq_bf16_kernel<D>, bytes,
                                     allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_bf16_kernel<D><<<grid_of(bh, t), kThreads, bytes, stream>>>(
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

// The bf16 entry points: q, k, v, dO, o, dq, dk, dv are bf16 (as uint16_t
// bit patterns), m, l, di f32.

extern "C" int flash_fwd_bf16(const uint16_t* q, const uint16_t* k,
                              const uint16_t* v, uint16_t* o, float* m,
                              float* l, int64_t bh, int t, int d, float scale,
                              cudaStream_t stream) {
  if (bad_shape(bh, t)) return kBadArgument;
  switch (d) {
    case 16: return launch_fwd_bf16<16>(q, k, v, o, m, l, bh, t, scale,
                                        stream);
    case 32: return launch_fwd_bf16<32>(q, k, v, o, m, l, bh, t, scale,
                                        stream);
    case 64: return launch_fwd_bf16<64>(q, k, v, o, m, l, bh, t, scale,
                                        stream);
    default: return kBadArgument;
  }
}

extern "C" int flash_bwd_dkv_bf16(const uint16_t* q, const uint16_t* k,
                                  const uint16_t* v, const uint16_t* dout,
                                  const float* m, const float* l,
                                  const float* di, uint16_t* dk, uint16_t* dv,
                                  int64_t bh, int t, int d, float scale,
                                  cudaStream_t stream) {
  if (bad_shape(bh, t)) return kBadArgument;
  switch (d) {
    case 16: return launch_dkv_bf16<16>(q, k, v, dout, m, l, di, dk, dv, bh,
                                        t, scale, stream);
    case 32: return launch_dkv_bf16<32>(q, k, v, dout, m, l, di, dk, dv, bh,
                                        t, scale, stream);
    case 64: return launch_dkv_bf16<64>(q, k, v, dout, m, l, di, dk, dv, bh,
                                        t, scale, stream);
    default: return kBadArgument;
  }
}

extern "C" int flash_bwd_dq_bf16(const uint16_t* q, const uint16_t* k,
                                 const uint16_t* v, const uint16_t* dout,
                                 const float* m, const float* l,
                                 const float* di, uint16_t* dq, int64_t bh,
                                 int t, int d, float scale,
                                 cudaStream_t stream) {
  if (bad_shape(bh, t)) return kBadArgument;
  switch (d) {
    case 16: return launch_dq_bf16<16>(q, k, v, dout, m, l, di, dq, bh, t,
                                       scale, stream);
    case 32: return launch_dq_bf16<32>(q, k, v, dout, m, l, di, dq, bh, t,
                                       scale, stream);
    case 64: return launch_dq_bf16<64>(q, k, v, dout, m, l, di, dq, bh, t,
                                       scale, stream);
    default: return kBadArgument;
  }
}
