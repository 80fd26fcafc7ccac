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
// The f32 kernels run their products on the tensor cores
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
// The three bf16 kernels are described in their own section below
// (wgmma, a producer warp and a ring of swizzled tiles).  The design of
// the three f32 kernels:
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
// are rounded once when written.  The bf16 kernels do the same, one pass:
// a bf16 product is exact in f32, so no hi/lo split.  All three issue
// their products with wgmma (the Hopper section below).
// Where P is rounded: the library's forward rounds exp(s - m) against the
// running max of its 128-key block, K4f against the running max of its
// 64-key tile, the plain version against the row's final max; the
// backward's P^T is exp(s - m) / l with the final m and l everywhere.
// They are bound by the exps more than by the products (bf16 runs at twice
// the TF32 rate and needs one pass, not three), and their bytes are half
// the f32 kernels'.

// (lo, hi) rounded to bf16 (to nearest even) in one register, lo in the
// low half: the element with the lower column or k index
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// two f32 values rounded to bf16 and written as one 32-bit store
__device__ __forceinline__ void store_bf16x2(uint16_t* p, float lo,
                                             float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}

// ---------------------------------------------------------------------------
// bf16 K4f, K4dkv and K4dq on Hopper: wgmma, a producer warp, a ring of
// tiles
// ---------------------------------------------------------------------------
//
// The three bf16 kernels issue every product with wgmma.mma_async (bf16
// in, f32 accumulators in registers):
//   * Tiles live in shared memory in the swizzled layout wgmma reads: a
//     row of D bf16 is R = 2D bytes (32, 64, 128), stored with the
//     R-byte swizzle (16-byte chunk c of row r at chunk c ^ ((r R / 128) &
//     (R / 16 - 1))), every tile on a 1024-byte boundary.  One tile serves
//     a product that reads it K-major (K for Q K^T, Q for K Q^T) and one
//     that reads it transposed (V for P V, dO for P^T dO, Q for dS^T Q, K
//     for dS K): an [rows][D] tile is the N-major atom of the same
//     swizzle.
//   * Loading: a producer warp copies each tile with 16-byte cp.async to
//     swizzled addresses it computes, waits for its copies, fences them to
//     the async proxy (fence.proxy.async, which wgmma's reads need) and
//     arrives on the stage's "full" mbarrier; the consumers arrive on its
//     "empty" mbarrier once their products have read it.  cp.async rather
//     than TMA: a tensor map is built on the host per tensor and launch,
//     which costs host time on every eager call and would have to stay
//     valid inside a captured CUDA graph (cohort.py's GraphedRounds
//     replays the folded calls with their own pointers); a warp of
//     cp.async needs neither, and the tiles are 2-8 KB.
//   * P (or P^T, dS^T, dS) goes from the f32 accumulator to the next
//     product's A operand in registers: an m64nNk16 accumulator gives each
//     warp rows (g, g + 8) and columns (8j + 2t, 8j + 2t + 1), which for
//     columns 16s .. 16s + 15 is exactly the A fragment of k-step s
//     (acc_frags).
//   * Exps are ex2.approx of one explicit fmaf(s, scale log2 e, -m log2 e)
//     (the build's -fmad=false fuses nothing by itself); running sums (O,
//     dK, dV, dQ) stay in the wgmma accumulators for the whole walk.

constexpr int kStages = 3;          // the ring's depth
constexpr int kKeyTile = 64;        // keys (K4f, K4dq) or queries (K4dkv)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16_s(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// byte offset of 16-byte chunk `ch` of row `row` in a swizzled tile of
// D-wide bf16 rows (CUTLASS's Swizzle<log2(R / 16), 4, 3> on the offset)
template <int D>
__device__ __forceinline__ uint32_t swz(int row, int ch) {
  constexpr uint32_t R = 2 * D;
  const uint32_t off = row * R + ch * 16;
  return off ^ (((off >> 7) & (R / 16 - 1)) << 4);
}

// Start copying ROWS contiguous rows of D bf16 into a swizzled tile at
// shared address dst: one warp, 16 bytes a lane and step.
template <int D, int ROWS>
__device__ __forceinline__ void copy_tile(uint32_t dst,
                                          const uint16_t* __restrict__ src,
                                          int lane) {
  constexpr int CR = 2 * D / 16;    // chunks a row
#pragma unroll
  for (int i = 0; i < ROWS * CR / 32; ++i) {
    const int c = lane + 32 * i;
    cp_async16_s(dst + swz<D>(c / CR, c % CR), src + 8 * c);
  }
}

// A wgmma shared-memory descriptor of a swizzled tile at address addr:
// both byte offsets are the stride between 8-row groups (8 R; SBO for a
// K-major read, the k-group stride of an N-major one, whose N = D is a
// single swizzle atom, so its LBO is never used), layout 1/2/3 = the
// 128/64/32-byte swizzle.  A k-step adds its byte offset >> 4.
template <int D>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  constexpr uint64_t stride = (8 * 2 * D) >> 4;
  constexpr uint64_t layout = D == 64 ? 1 : D == 32 ? 2 : 3;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (stride << 16) |
         (stride << 32) | (layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of the given parity has completed.  A wait that
// never ends (an arrival lost to a fault) traps after about 2^26 polls,
// so that it fails the launch instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the writing thread's shared stores made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers that an in-flight wgmma writes (or reads) are redefined here,
// after a wait: the compiler may not read or reuse them earlier.
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (+)= A B for one m64n64k16 step, A and B from shared memory
// (descriptors), both K-major; d zeroed first when scale_d is 0
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                        uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += A B for one m64n16k16 step: A (bf16 pairs) from registers, B from
// shared memory N-major (transposed: imm-trans-b)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                        const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B for one m64n32k16 step: A (bf16 pairs) from registers, B from
// shared memory N-major (transposed: imm-trans-b)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                        const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B for one m64n64k16 step: A (bf16 pairs) from registers, B from
// shared memory N-major (transposed: imm-trans-b)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                        const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += A B over 64 keys (or queries): four k-steps of m64n{D}k16, A the
// bf16 fragments a[kk], B a [64][D] tile read transposed
template <int D>
__device__ __forceinline__ void wgmma_rows(float (&acc)[D / 2],
                                           const uint32_t (&a)[4][4],
                                           uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bk = b + ((kk * 16 * 2 * D) >> 4);
    if constexpr (D == 16) wgmma_rs_n16(acc, a[kk], bk);
    else if constexpr (D == 32) wgmma_rs_n32(acc, a[kk], bk);
    else wgmma_rs_n64(acc, a[kk], bk);
  }
}

// acc (bf16-rounded) as the A fragments of four k-steps
__device__ __forceinline__ void acc_frags(const float (&acc)[32],
                                          uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(acc[8 * kk], acc[8 * kk + 1]);
    a[kk][1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
    a[kk][2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
    a[kk][3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
  }
}

// K4f's shared memory, byte offsets from a 1024-byte aligned base: the
// block's 128 Q rows, kStages K and kStages V tiles of 64 keys, then the
// full and empty barriers
template <int D>
struct FwdSmem {
  static constexpr int tile = kKeyTile * 2 * D;
  static constexpr int q = 0;
  static constexpr int k = 2 * tile;
  static constexpr int v = k + kStages * tile;
  static constexpr int bars = v + kStages * tile;
  static constexpr int bytes = bars + 2 * kStages * 8 + 1024;
};

constexpr int kFwdThreads = 2 * 128 + 32;   // two warpgroups + a producer

// K4f bf16.  A block owns 128 query rows of one (b, h): two consumer
// warpgroups of 64 rows and a producer warp that streams the 64-key K and
// V tiles 0 .. the diagonal through a ring of kStages.  Warpgroup wg
// visits key tiles 0 .. 2 qt + wg (its last is its diagonal, the only one
// masked).  Per tile: S = Q K^T (m64n64k16, A = Q and B = K from shared
// memory), the online softmax on the accumulator (row max by quad
// shuffles, one fmaf and one ex2 a score), O = O corr + bf16(P) V
// (m64n{D}k16, A = P from registers, B = V transposed).  The exps overlap
// the products inside each warpgroup (FA3's intra-warpgroup pipelining):
// tile j's S product and tile j - 1's P V product are issued together,
// and tile j's softmax runs while P V is still on the tensor cores.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, D <= 32 ? 2 : 1)
flash_fwd_bf16_kernel(const uint16_t* __restrict__ q,
                      const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v,
                      uint16_t* __restrict__ o, float* __restrict__ m_out,
                      float* __restrict__ l_out, int t, float scale) {
  using L = FwdSmem<D>;
  extern __shared__ float4 smem4[];
  const uint32_t base = (smem_u32(smem4) + 1023) & ~1023u;
  const uint32_t full = base + L::bars, empty = full + 8 * kStages;
  const int qt = t / 128 - 1 - blockIdx.y;   // the longest rows start first
  const int64_t bh = blockIdx.x;
  const int n_kv = 2 * qt + 2;               // 64-key tiles the block loads
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {   // the producer
    const uint16_t* const kbh = k + bh * t * D;
    const uint16_t* const vbh = v + bh * t * D;
    for (int i = 0; i < n_kv; ++i) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(empty + 8 * s, (i / kStages - 1) & 1);
      if (i == 0)
        copy_tile<D, 128>(base + L::q, q + (bh * t + 128 * qt) * D, lane);
      const int64_t off = static_cast<int64_t>(i) * kKeyTile * D;
      copy_tile<D, kKeyTile>(base + L::k + s * L::tile, kbh + off, lane);
      copy_tile<D, kKeyTile>(base + L::v + s * L::tile, vbh + off, lane);
      cp_async_commit();
      if (i > 0) {
        cp_async_wait<1>();
        fence_async_shared();
        mbar_arrive(full + 8 * ((i - 1) % kStages));
      }
    }
    cp_async_wait<0>();
    fence_async_shared();
    mbar_arrive(full + 8 * ((n_kv - 1) % kStages));
    return;
  }

  const int wg = warp / 4, w = warp % 4, g = lane / 4, tq = lane % 4;
  const int n = 2 * qt + 1 + wg;             // key tiles this warpgroup sees
  const float sl2 = scale * kLog2e;
  const uint64_t qdesc = make_desc<D>(base + L::q + wg * L::tile);
  float sacc[32];                            // S: keys 8j + 2t (+1), rows
  float oacc[D / 2];                         // g, g + 8 of the warp's 16
  uint32_t pa[4][4];
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.0f;

  // issue S = Q K_j^T
  auto scores = [&](int j) {
    const int s = j % kStages;
    mbar_wait(full + 8 * s, (j / kStages) & 1);
    const uint64_t kdesc = make_desc<D>(base + L::k + s * L::tile);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64(sacc, qdesc + 2 * ks, kdesc + 2 * ks, ks);
    wgmma_commit();
  };
  // issue O += bf16(P) V_j
  auto pv = [&](int j) {
    wgmma_rows<D>(oacc, pa,
                  make_desc<D>(base + L::v + (j % kStages) * L::tile));
    wgmma_commit();
  };
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (j % kStages));
  };
  // the online softmax of the scores in sacc (masked on the diagonal):
  // P = exp(s scale - m) in place (l sums it unrounded, as the library's
  // l), corr = exp(m_old - m) for O
  auto softmax = [&](bool diag, float (&corr)[2]) {
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (diag && 8 * (i >> 2) + 2 * tq + (i & 1) > 16 * w + g + 4 * (i & 2))
        sacc[i] = -INFINITY;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
    }
    float neg[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
      corr[h] = ex2((mrow[h] - mx[h]) * sl2);
      mrow[h] = mx[h];
      neg[h] = -mx[h] * sl2;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sacc[i] = ex2(__fmaf_rn(sacc[i], sl2, neg[(i >> 1) & 1]));
      sum[(i >> 1) & 1] += sacc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) lrow[h] = __fmaf_rn(lrow[h], corr[h], sum[h]);
  };

  float corr[2];
  wgmma_fence();
  scores(0);
  wgmma_wait<0>();
  keep(sacc);
  softmax(n == 1, corr);
  acc_frags(sacc, pa);
  for (int j = 1; j < n; ++j) {
    wgmma_fence();
    scores(j);
    pv(j - 1);
    wgmma_wait<1>();
    keep(sacc);
    softmax(j == n - 1, corr);
    wgmma_wait<0>();
    keep(oacc);
    keep(pa);
    release(j - 1);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] *= corr[(i >> 1) & 1];
    acc_frags(sacc, pa);
  }
  wgmma_fence();
  pv(n - 1);
  wgmma_wait<0>();
  keep(oacc);
  keep(pa);
  release(n - 1);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lrow[h] += __shfl_xor_sync(kFull, lrow[h], 1);
    lrow[h] += __shfl_xor_sync(kFull, lrow[h], 2);
  }
  const int64_t row0 = bh * t + 128 * qt + 64 * wg + 16 * w + g;
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int col = 8 * nb + 2 * tq;
    store_bf16x2(o + row0 * D + col, oacc[4 * nb] / lrow[0],
                 oacc[4 * nb + 1] / lrow[0]);
    store_bf16x2(o + (row0 + 8) * D + col, oacc[4 * nb + 2] / lrow[1],
                 oacc[4 * nb + 3] / lrow[1]);
  }
  if (tq == 0) {
    m_out[row0] = mrow[0] * scale; m_out[row0 + 8] = mrow[1] * scale;
    l_out[row0] = lrow[0]; l_out[row0 + 8] = lrow[1];
  }
}

// K4dkv's shared memory, byte offsets from a 1024-byte aligned base: the
// block's K and V tiles, kStages Q and kStages dO tiles of 64 queries,
// kStages x [3][64] f32 (-m log2 e, 1 / l and di of the tile's queries),
// then the full and empty barriers
template <int D>
struct DkvSmem {
  static constexpr int tile = kKeyTile * 2 * D;
  static constexpr int k = 0;
  static constexpr int v = tile;
  static constexpr int q = 2 * tile;
  static constexpr int dout = q + kStages * tile;
  static constexpr int vecs = dout + kStages * tile;
  static constexpr int vec_bytes = 3 * kKeyTile * 4;
  static constexpr int bars = vecs + kStages * vec_bytes;
  static constexpr int bytes = bars + 2 * kStages * 8 + 1024;
};

constexpr int kDkvThreads = 128 + 32;       // one warpgroup + a producer

// K4dkv bf16.  A block owns 64 key rows of one (b, h) as one consumer
// warpgroup; a producer warp loads its K and V tiles once, then streams
// the 64-query tiles of Q and dO from the diagonal on through the ring,
// with -m log2 e, 1 / l (taken once per query, by the producer) and di of
// their queries.  Per tile: S^T = K Q^T and dP^T = V dO^T (m64n64k16, A =
// K or V and B = Q or dO from shared memory, K-major), P^T = ex2(fmaf(s,
// scale log2 e, -m log2 e)) / l, dS^T = P^T (dP^T - di) scale (the pairs
// above the diagonal set to 0 by a select before either), then dV +=
// bf16(P^T) dO and dK += bf16(dS^T) Q (m64n{D}k16, A from registers, B =
// dO or Q read transposed from the same tiles).  Each output element has
// one owner: no atomics.  Three blocks share an SM (d <= 32), whose
// warpgroups overlap one another's products and exps.  K4f's
// intra-warpgroup pipeline would keep the next tile's S^T and dP^T
// accumulators in flight beside dV, dK and their A fragments (128
// registers at d = 32): at three blocks an SM ptxas serialises the wgmmas
// for want of registers, and at two the kernel ran slower than this form.
template <int D>
__global__ void __launch_bounds__(kDkvThreads, D <= 32 ? 3 : 2)
flash_bwd_dkv_bf16_kernel(const uint16_t* __restrict__ q,
                          const uint16_t* __restrict__ k,
                          const uint16_t* __restrict__ v,
                          const uint16_t* __restrict__ dout,
                          const float* __restrict__ m,
                          const float* __restrict__ l,
                          const float* __restrict__ di,
                          uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                          int t, float scale) {
  using L = DkvSmem<D>;
  extern __shared__ float4 smem4[];
  const uint32_t base = (smem_u32(smem4) + 1023) & ~1023u;
  char* const gbase = reinterpret_cast<char*>(smem4) + (base - smem_u32(smem4));
  const uint32_t full = base + L::bars, empty = full + 8 * kStages;
  const int kt = blockIdx.y;                 // the longest walks start first
  const int64_t bh = blockIdx.x;
  const int n = t / kKeyTile - kt;           // query tiles kt .. end
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {   // the producer
    const int64_t key0 = bh * t + static_cast<int64_t>(kt) * kKeyTile;
    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      const int64_t r = key0 + static_cast<int64_t>(i) * kKeyTile;
      float mv[2], lv[2], dv2[2];   // loaded before the wait, stored after
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mv[h] = __ldg(m + r + lane + 32 * h);
        lv[h] = __ldg(l + r + lane + 32 * h);
        dv2[h] = __ldg(di + r + lane + 32 * h);
      }
      if (i >= kStages) mbar_wait(empty + 8 * s, (i / kStages - 1) & 1);
      if (i == 0) {
        copy_tile<D, kKeyTile>(base + L::k, k + key0 * D, lane);
        copy_tile<D, kKeyTile>(base + L::v, v + key0 * D, lane);
      }
      copy_tile<D, kKeyTile>(base + L::q + s * L::tile, q + r * D, lane);
      copy_tile<D, kKeyTile>(base + L::dout + s * L::tile, dout + r * D,
                             lane);
      cp_async_commit();
      float* const vec = reinterpret_cast<float*>(gbase + L::vecs +
                                                  s * L::vec_bytes);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        vec[lane + 32 * h] = -mv[h] * kLog2e;
        vec[kKeyTile + lane + 32 * h] = 1.0f / lv[h];
        vec[2 * kKeyTile + lane + 32 * h] = dv2[h];
      }
      if (i > 0) {
        cp_async_wait<1>();
        fence_async_shared();
        mbar_arrive(full + 8 * ((i - 1) % kStages));
      }
    }
    cp_async_wait<0>();
    fence_async_shared();
    mbar_arrive(full + 8 * ((n - 1) % kStages));
    return;
  }

  const int w = warp, g = lane / 4, tq = lane % 4;
  const float sl2 = scale * kLog2e;
  const uint64_t kdesc = make_desc<D>(base + L::k);
  const uint64_t vdesc = make_desc<D>(base + L::v);
  float sacc[32], dpacc[32];                 // keys 16w + g (+8), queries
  float dka[D / 2], dva[D / 2];              // 8j + 2t (+1); dims likewise
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) { dka[i] = 0.0f; dva[i] = 0.0f; }

  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    const uint64_t qdesc = make_desc<D>(base + L::q + s * L::tile);
    const uint64_t ddesc = make_desc<D>(base + L::dout + s * L::tile);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64(sacc, kdesc + 2 * ks, qdesc + 2 * ks, ks);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64(dpacc, vdesc + 2 * ks, ddesc + 2 * ks, ks);
    wgmma_commit();
    wgmma_wait<0>();
    keep(sacc);
    keep(dpacc);

    const float* const vec = reinterpret_cast<const float*>(
        gbase + L::vecs + s * L::vec_bytes);
    const bool diag = i == 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * tq;          // queries c, c + 1
      const float2 mn = *reinterpret_cast<const float2*>(vec + c);
      const float2 il = *reinterpret_cast<const float2*>(vec + kKeyTile + c);
      const float2 dd =
          *reinterpret_cast<const float2*>(vec + 2 * kKeyTile + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        const bool odd = e & 1;
        float ex = ex2(__fmaf_rn(sacc[x], sl2, odd ? mn.y : mn.x));
        if (diag && 16 * w + g + 4 * (e & 2) > c + odd) ex = 0.0f;
        const float p = ex * (odd ? il.y : il.x);
        const float ps = p * scale;
        dpacc[x] = __fmaf_rn(ps, dpacc[x], -(ps * (odd ? dd.y : dd.x)));
        sacc[x] = p;
      }
    }
    acc_frags(sacc, pa);
    acc_frags(dpacc, da);
    wgmma_fence();
    wgmma_rows<D>(dva, pa, ddesc);
    wgmma_rows<D>(dka, da, qdesc);
    wgmma_commit();
    wgmma_wait<0>();
    keep(dva);
    keep(dka);
    keep(pa);
    keep(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  const int64_t key0 = bh * t + static_cast<int64_t>(kt) * kKeyTile +
                       16 * w + g;
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int col = 8 * nb + 2 * tq;
    store_bf16x2(dk + key0 * D + col, dka[4 * nb], dka[4 * nb + 1]);
    store_bf16x2(dk + (key0 + 8) * D + col, dka[4 * nb + 2],
                 dka[4 * nb + 3]);
    store_bf16x2(dv + key0 * D + col, dva[4 * nb], dva[4 * nb + 1]);
    store_bf16x2(dv + (key0 + 8) * D + col, dva[4 * nb + 2],
                 dva[4 * nb + 3]);
  }
}

// K4dq's shared memory, byte offsets from a 1024-byte aligned base: the
// block's Q and dO tiles, kStages K and kStages V tiles of 64 keys, then
// the full and empty barriers
template <int D>
struct DqSmem {
  static constexpr int tile = kKeyTile * 2 * D;
  static constexpr int q = 0;
  static constexpr int dout = tile;
  static constexpr int k = 2 * tile;
  static constexpr int v = k + kStages * tile;
  static constexpr int bars = v + kStages * tile;
  static constexpr int bytes = bars + 2 * kStages * 8 + 1024;
};

constexpr int kDqThreads = 128 + 32;        // one warpgroup + a producer

// K4dq bf16, K4dkv turned around.  A block owns 64 query rows of one (b, h)
// as one consumer warpgroup; a producer warp loads its Q and dO tiles once,
// with the first stage, then streams the 64-key K and V tiles 0 .. the
// diagonal through the ring.  Each thread computes -m log2 e + log2(scale
// / l) and loads di for its two rows (16w + g, 16w + g + 8) before the
// walk.  Per tile: S = Q K^T and dP = dO V^T (m64n64k16, A = Q or dO and
// B = K or V from shared memory, K-major), P scale = ex2(fmaf(s, scale
// log2 e, -m log2 e + log2(scale / l))) (1 / l and scale folded into the
// exponent: one multiply a pair fewer), dS = fmaf(P scale, dP, -(P scale)
// di), on the diagonal tile the pairs above it set to 0 by a select in a
// pass of its own (a masked score's exp may be inf, and inf x 0 is NaN),
// then dQ += bf16(dS) K (m64n{D}k16, A from registers, B = the same K tile
// read transposed).  dQ stays in the wgmma accumulator for the whole walk
// and is written once.  Inside the warpgroup tile j's S, its dP and tile
// j - 1's dS K are three groups issued together: the exps start once S is
// in, while dP and dS K are still on the tensor cores.  Three blocks share
// an SM (d <= 32), whose warpgroups overlap one another's products and
// exps.  The producer signals each tile as soon as its own copies land
// (K4f and K4dkv signal a tile once the next one's copies are issued).  A
// second S and dP pair in flight (tile j + 1's during tile j's exps)
// needs 64 registers more and two blocks an SM, where ptxas serialised
// its wgmmas and spilled: it ran 2.6x slower.
template <int D>
__global__ void __launch_bounds__(kDqThreads, D <= 32 ? 3 : 2)
flash_bwd_dq_bf16_kernel(const uint16_t* __restrict__ q,
                         const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v,
                         const uint16_t* __restrict__ dout,
                         const float* __restrict__ m,
                         const float* __restrict__ l,
                         const float* __restrict__ di,
                         uint16_t* __restrict__ dq, int t, float scale) {
  using L = DqSmem<D>;
  extern __shared__ float4 smem4[];
  const uint32_t base = (smem_u32(smem4) + 1023) & ~1023u;
  const uint32_t full = base + L::bars, empty = full + 8 * kStages;
  const int qt = t / kKeyTile - 1 - blockIdx.y;   // the longest rows first
  const int64_t bh = blockIdx.x;
  const int n = qt + 1;                      // key tiles 0 .. the diagonal
  const int64_t row0 = bh * t + static_cast<int64_t>(qt) * kKeyTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {   // the producer
    const uint16_t* const kbh = k + bh * t * D;
    const uint16_t* const vbh = v + bh * t * D;
    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(empty + 8 * s, (i / kStages - 1) & 1);
      if (i == 0) {
        copy_tile<D, kKeyTile>(base + L::q, q + row0 * D, lane);
        copy_tile<D, kKeyTile>(base + L::dout, dout + row0 * D, lane);
      }
      const int64_t off = static_cast<int64_t>(i) * kKeyTile * D;
      copy_tile<D, kKeyTile>(base + L::k + s * L::tile, kbh + off, lane);
      copy_tile<D, kKeyTile>(base + L::v + s * L::tile, vbh + off, lane);
      cp_async_commit();
      cp_async_wait<0>();
      fence_async_shared();
      mbar_arrive(full + 8 * s);
    }
    return;
  }

  const int w = warp, g = lane / 4, tq = lane % 4;
  const int r = 16 * w + g;                  // rows r and r + 8 of the tile
  const float sl2 = scale * kLog2e;
  const uint64_t qdesc = make_desc<D>(base + L::q);
  const uint64_t ddesc = make_desc<D>(base + L::dout);
  float nl[2], dd[2];              // -m log2 e + log2(scale / l), and di
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    nl[h] = -__ldg(m + row0 + r + 8 * h) * kLog2e +
            __log2f(scale / __ldg(l + row0 + r + 8 * h));
    dd[h] = __ldg(di + row0 + r + 8 * h);
  }
  float sacc[32], dpacc[32];                 // keys 8j + 2t (+1), rows r
  float dqa[D / 2];                          // (+8); dims likewise
  uint32_t da[4][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.0f;

  // issue S = Q K_j^T and dP = dO V_j^T, a group each
  auto products = [&](int j) {
    const int s = j % kStages;
    mbar_wait(full + 8 * s, (j / kStages) & 1);
    const uint64_t kdesc = make_desc<D>(base + L::k + s * L::tile);
    const uint64_t vdesc = make_desc<D>(base + L::v + s * L::tile);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64(sacc, qdesc + 2 * ks, kdesc + 2 * ks, ks);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64(dpacc, ddesc + 2 * ks, vdesc + 2 * ks, ks);
    wgmma_commit();
  };
  // issue dQ += bf16(dS) K_j
  auto dsk = [&](int j) {
    wgmma_rows<D>(dqa, da,
                  make_desc<D>(base + L::k + (j % kStages) * L::tile));
    wgmma_commit();
  };
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (j % kStages));
  };
  // P scale in place
  auto probs = [&]() {
#pragma unroll
    for (int x = 0; x < 32; ++x)
      sacc[x] = ex2(__fmaf_rn(sacc[x], sl2, nl[(x >> 1) & 1]));
  };
  // dS in place; on the diagonal tile the pairs above it are set to 0
  auto grads = [&](bool diag) {
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const float ps = sacc[x];
      sacc[x] = __fmaf_rn(ps, dpacc[x], -(ps * dd[(x >> 1) & 1]));
    }
    if (diag) {
#pragma unroll
      for (int x = 0; x < 32; ++x)
        if (8 * (x >> 2) + 2 * tq + (x & 1) > r + 8 * ((x >> 1) & 1))
          sacc[x] = 0.0f;
    }
  };

  wgmma_fence();
  products(0);
  wgmma_wait<0>();
  keep(sacc);
  keep(dpacc);
  probs();
  grads(n == 1);
  acc_frags(sacc, da);
  for (int j = 1; j < n; ++j) {
    wgmma_fence();
    products(j);
    dsk(j - 1);
    wgmma_wait<2>();                         // S of tile j
    keep(sacc);
    probs();
    wgmma_wait<1>();                         // dP of tile j
    keep(dpacc);
    grads(j == n - 1);
    wgmma_wait<0>();                         // dS K of tile j - 1
    keep(dqa);
    keep(da);
    release(j - 1);
    acc_frags(sacc, da);
  }
  wgmma_fence();
  dsk(n - 1);
  wgmma_wait<0>();
  keep(dqa);
  keep(da);
  release(n - 1);

#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int col = 8 * nb + 2 * tq;
    store_bf16x2(dq + (row0 + r) * D + col, dqa[4 * nb], dqa[4 * nb + 1]);
    store_bf16x2(dq + (row0 + r + 8) * D + col, dqa[4 * nb + 2],
                 dqa[4 * nb + 3]);
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
  constexpr int bytes = FwdSmem<D>::bytes;
  static std::atomic<uint64_t> allowed{0};
  const cudaError_t err = allow_smem(flash_fwd_bf16_kernel<D>, bytes,
                                     allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_bf16_kernel<D><<<dim3(static_cast<unsigned>(bh), t / 128),
                             kFwdThreads, bytes, stream>>>(q, k, v, o, m, l,
                                                           t, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_bf16(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                    const uint16_t* dout, const float* m, const float* l,
                    const float* di, uint16_t* dk, uint16_t* dv, int64_t bh,
                    int t, float scale, cudaStream_t stream) {
  constexpr int bytes = DkvSmem<D>::bytes;
  static std::atomic<uint64_t> allowed{0};
  const cudaError_t err = allow_smem(flash_bwd_dkv_bf16_kernel<D>, bytes,
                                     allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_bf16_kernel<D><<<grid_of(bh, t), kDkvThreads, bytes,
                                 stream>>>(q, k, v, dout, m, l, di, dk, dv, t,
                                           scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_bf16(const uint16_t* q, const uint16_t* k, const uint16_t* v,
                   const uint16_t* dout, const float* m, const float* l,
                   const float* di, uint16_t* dq, int64_t bh, int t,
                   float scale, cudaStream_t stream) {
  constexpr int bytes = DqSmem<D>::bytes;
  static std::atomic<uint64_t> allowed{0};
  const cudaError_t err = allow_smem(flash_bwd_dq_bf16_kernel<D>, bytes,
                                     allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_bf16_kernel<D><<<grid_of(bh, t), kDqThreads, bytes,
                                stream>>>(q, k, v, dout, m, l, di, dq, t,
                                          scale);
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
  if (bad_shape(bh, t) || t % 128 != 0) return kBadArgument;
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
