// K2, K3, K4: blockwise ("flash") attention, forward and backward, written
// by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernels of horovod_tpu/ops/flash_attention.py:
//   K2  _fwd_kernel (:120), launched by _mha_fwd (pl.pallas_call at :193)
//   K3  _bwd_dq_kernel (:235), launched by _mha_bwd_dq (:361)
//   K4  _bwd_dkv_kernel (:290), launched by _mha_bwd_dkv (:398)
// and with them the ring-attention entry points mha_partial, mha_bwd_dq and
// mha_bwd_dkv (:442-474), which call the same bodies at runtime offsets.
//
// What they compute, on [b, h, s, d] tensors (any strides with the head dim
// contiguous), with q_pos = q_off + i and k_pos = kv_off + j:
//   K2  s = (q.k) * scale, masked to NEG_INF where causal and q_pos < k_pos;
//       online softmax over kv tiles: m, l and the o accumulator;
//       o = acc / max(l, 1e-30) in q's type (normalize) or acc in float32
//   K3  p = exp(s - lse) (masked to 0), dp = do.v, ds = p * (dp - delta) *
//       scale; dq = sum_kv ds.k, in float32
//   K4  dv = sum_q p^T.do, dk = sum_q ds^T.q, in float32
// following the Pallas bodies' casts: p is rounded to v's (do's) type before
// its product and ds to k's (q's) type, as p.astype(vb.dtype) (:161) and
// ds.astype(kb.dtype) (:276, :337) do.  The finite NEG_INF keeps a row whose
// every key is masked free of NaN: exp(NEG_INF - NEG_INF) = 1 is zeroed by
// the second mask select, exactly as in the TPU kernel.
//
// Design.  On the TPU the kv loop was the innermost, sequential grid
// dimension with the accumulators in VMEM scratch (:9-13).  Here blocks run
// in parallel and in no order, so each thread block owns its outputs and
// loops itself:
//   K2, K3  one block per (b, h, q tile), looping over kv tiles and
//           stopping at the last tile a causal q tile can see;
//   K4      one block per (b, h, kv tile), looping over q tiles from the
//           first that can see it: each block owns its dk and dv rows, so
//           no atomics are needed.
// The ragged tail of either sequence is masked here (the Pallas launcher
// shrank its blocks to a divisor, _fit_block :95); rows past the end are
// loaded as zeros and never stored.
//
// Three mainloops.  kernels.py's flash_plan picks one by an explicit rule
// and passes it in HvdFlashArgs.mainloop; hvd_flash_* refuse a plan the
// operands do not meet (nothing falls back):
//
//   TMA + wgmma (K2, K3 and K4, bfloat16, head dim 64, every operand that
//   TMA reads 16-byte aligned with 16-byte strides: GPT-2's path)
//     Two consumer warpgroups of 64 rows each and one producer warp, 288
//     threads, one block an SM.  ptxas holds a 288-thread block to 168
//     registers a thread (9 warps, 3 on one of the SM's four register
//     files): K2 takes 167, K3 132 and K4 168, with no spills.  The producer's copies
//     land in shared memory with the 128-byte swizzle (a head-dim row of
//     64 bf16 is 128 bytes), through 4-D tensor maps (d, s, h, b) over
//     each operand's own strides: the model's [b, s, h, d] activations
//     arrive as [b, h, s, d] views whose s stride is h * d, and TMA walks
//     them as they are.  Rows past sq or sk are zero-filled by the copy.
//     The maps are encoded per launch (the pointers change), through
//     cudaGetDriverEntryPoint (hopper.cuh).
//     - K2: a block owns a 128-row q tile (the heaviest causal tiles
//       start first).  Q arrives once; K and V arrive as a 2-stage ring of
//       128-key tiles, with a full barrier each for K and V (S = Q.K^T
//       starts before V has landed) and an empty barrier per stage.
//       S = Q.K^T is wgmma m64n128k16 with both operands K-major in shared
//       memory; the online softmax runs on its accumulators in registers
//       (finite NEG_INF, masking by keys_seen, alpha rescaling, l in
//       float32); P is rounded to bf16 in registers, the Pallas body's
//       p.astype(vb.dtype), and O += P.V is wgmma m64n64k16 with P as the
//       register A operand and V the MN-major B operand (transpose bit).
//       kv tiles wholly in the future are skipped, and only a warp whose
//       rows do not all see the whole tile (the diagonal, a ragged end)
//       masks: the per-element mask cost more than the rest of the
//       softmax (0.072 -> 0.050 ms at GPT-2's shape).  128-key tiles halve
//       the softmax's passes against 64-key ones (64-key tiles at two
//       blocks an SM ran no faster); the plain forward runs its online
//       softmax at the plan's tile on the card, where it rounds p against
//       the same running max.
//     - K4: a block owns a 128-key kv tile.  K and V arrive once; Q and
//       dO arrive as a 3-stage ring of 64-row q tiles from first_q_tile,
//       lse and delta staged beside each by the producer warp's 32 lanes
//       (the full barrier counts the copy's bytes and their 32 arrivals).
//       S^T = K.Q^T and dP^T = V.dO^T are wgmma m64n64k16 from shared
//       memory (both K-major), P^T = exp(S^T scale - lse) and dS^T =
//       P^T (dP^T - delta) scale are masked by queries_seen in registers
//       (again only where a warp's keys do not all see the whole q tile),
//       and dV += bf16(P^T).dO, dK += bf16(dS^T).Q take them as the
//       register A operand with dO and Q the MN-major B operand: the same
//       shared-memory tile read K-major for S^T and MN-major for dK.  Live
//       a thread: S^T, dP^T, dK and dV, 4 x 32 float32.
//     - K3: a block owns a 128-row q tile (the heaviest causal tiles
//       start first), as in K2.  Q and dO arrive once; K and V arrive as
//       a 3-stage ring of 64-key tiles, a full barrier each (S = Q.K^T
//       starts before V has landed) and an empty barrier per stage.  A
//       row's lse and delta do not change along the kv loop: each thread
//       reads its two rows' once into registers.  S = Q.K^T and dP =
//       dO.V^T are wgmma m64n64k16 from shared memory (both K-major);
//       P = exp(S scale - lse) and dS = P (dP - delta) scale are masked by
//       keys_seen in registers (only where a warp's rows do not all see
//       the whole kv tile), and dQ += bf16(dS).K takes dS as the register
//       A operand and K as the MN-major B operand: the K tile is read
//       K-major for S and MN-major for dQ, as K4 reads Q.  Live a thread:
//       S, dP and dQ, 3 x 32 float32 (128-key tiles would need 160
//       float32 of accumulators alone, past the cap).  A q tile that sees
//       no key (a kv shard wholly in its future) copies nothing and
//       stores zeros.  At GPT-2's shape on the H100 it took K3 from 0.105
//       ms (mma.sync) to 0.051.
//     All three exponentiate with __expf (softmax_step).  Tried and dropped:
//     issuing K2's next S = Q.K^T beside the running P.V and its softmax
//     while P.V runs (FA3's intra-warpgroup overlap, 3 stages): it needs a
//     second score tile live, spilled at the 168-register cap and ran at
//     0.050 ms against 0.041; a 3-stage K2 ring or a 2-stage K4 ring ran
//     no faster.  Head dims other than 64 take mma.sync: d 16 and 32 rows
//     are shorter than the 128-byte swizzle, and at d 128 K4's four
//     accumulators alone would be 4 x 64 float32 a thread, past the cap.
//   mma.sync (bfloat16 operands the rule sends elsewhere)
//     The first version of these kernels: one block per 64-row tile, 4
//     warps each owning 16 rows; the four products of each tile run on the
//     tensor cores as mma.sync m16n8k16 bf16 tiles with float32
//     accumulation; tiles are staged in shared memory as bf16 by the
//     threads that use them (rows padded by 16 bytes so a warp's fragment
//     loads hit 32 banks) and read by ldmatrix.trans where a tile is the B
//     operand of a product over its rows (p.v, ds.k, ...).  A score tile's
//     float32 accumulators are rounded to bf16 and reused in registers as
//     the A operand of the next product (p.v, ds.k, p^T.do, ds^T.q): that
//     rounding is the Pallas body's astype.  Head dims 16, 32, 64, 128.
//   float32 (parity and tests)  scalar float32 FMAs over float32 tiles in
//     shared memory, 256 threads, thread (ty, tx) = (t / 16, t % 16)
//     owning rows 4ty..4ty+3 and columns 4tx..4tx+3 of each 64x64 score
//     tile; the tensor cores would round float32 to TF32.
//
// Bound.  At GPT-2 small's shapes (b 4, h 12, s 1024, d 64, causal, bf16)
// and counting the causal half only: K2 does 4*b*h*d*s^2/2 = 6.4 GFLOP and
// moves q, k, v and o (4 x 6.3 MB); K3 does 6*b*h*d*s^2/2 = 9.7 GFLOP and
// moves q, k, v, do (bf16), lse, delta and dq (f32), about 38 MB; K4 does
// 8*b*h*d*s^2/2 = 12.9 GFLOP and moves about 50 MB.  Against the H100 SXM
// data sheet (989 TFLOP/s dense bf16, 3.35 TB/s) each is bound by its bytes
// at 7.5-15 us.  The mma.sync kernels stay far above that bound: mma.sync
// reaches a fraction of the rate of wgmma, their tiles are loaded by the
// threads that use them with no copy in flight during the products, and
// K and V (Q and dO in K4) are read again by every 64-row tile.  The TMA +
// wgmma mainloop keeps the next tiles' copies in flight during the
// products, runs them at wgmma's rate, halves the re-reads with 128-row
// blocks, skips the mask off the diagonal and exponentiates in hardware
// (softmax_step).  At d 64 the exponentials take the SM's MUFU pipe (16 a
// clock) as long as the products take its tensor cores, and the two
// alternate within a warpgroup.  What it does not do yet: overlap one
// warpgroup's softmax with the other's products (the ping-pong schedule,
// which a 384-thread block with setmaxnreg would give the registers for)
// or hide each block's first copies behind another tile (a persistent
// schedule).
// The file is built with --fmad=false for K1; the scalar products here use
// fmaf explicitly, so they stay fused.
//
// Each launch function returns cudaGetLastError() (0 on success); the
// Python wrapper raises on anything else.  Nothing here allocates or
// synchronizes; the caller passes its current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, tensor-map encoders

namespace {

constexpr int kTile = 64;           // rows of a q tile and of a kv tile
constexpr float kNegInf = -1e30f;   // NEG_INF of the Pallas kernels

// float32 kernels
constexpr int kThreads = 256;
constexpr int kLd = kTile + 4;      // row stride of a transposed tile

// bfloat16 kernels
constexpr int kMmaThreads = 128;    // 4 warps x 16 rows of the tile
constexpr int kPad = 8;             // bf16 elements of padding per row

using bf16 = __nv_bfloat16;

}  // namespace

extern "C" {

// One [b, h, s, d] operand: element (b, h, s, e) is at
// ptr + b*sb + h*sh + s*ss + e.
struct HvdBhsd {
  void* ptr;
  int64_t sb, sh, ss;
};

// Everything a launch needs; mirrored by kernels.py's _FlashArgs.  Operands
// a kernel does not use are null.  m, l, lse and delta are contiguous
// [b, h, sq] float32.
struct HvdFlashArgs {
  HvdBhsd q, k, v, o, dout, dq, dk, dv;
  float* m;
  float* l;
  const float* lse;
  const float* delta;
  int64_t b, h, sq, sk, d;
  int64_t q_off, kv_off;
  float scale;
  // dtype: 0 float32, 1 bfloat16; mainloop (bfloat16): 0 mma.sync, 1 TMA +
  // wgmma (kernels.flash_plan's rule), 0 for float32
  int32_t causal, normalize, dtype, mainloop;
};

}  // extern "C"

namespace {

template <typename T>
__device__ __forceinline__ T* at(const HvdBhsd& t, int64_t b, int64_t h,
                                 int64_t s) {
  return static_cast<T*>(t.ptr) + b * t.sb + h * t.sh + s * t.ss;
}

// tiles of `tile` rows that cover n rows
__host__ __device__ __forceinline__ int64_t tiles(int64_t n,
                                                  int64_t tile = kTile) {
  return (n + tile - 1) / tile;
}

// kv tiles of kv_rows keys that a q tile whose last position is q_last can
// see under the causal mask: tile j is visible iff kv_off + j * kv_rows <=
// q_last
__device__ __forceinline__ int64_t causal_kv_tiles(const HvdFlashArgs& a,
                                                   int64_t q_last,
                                                   int64_t kv_rows) {
  const int64_t n = tiles(a.sk, kv_rows);
  const int64_t span = q_last - a.kv_off;
  if (span < 0) return 0;
  const int64_t seen = span / kv_rows + 1;
  return seen < n ? seen : n;
}

// kv tiles (of kv_rows keys) K2 and K3 visit for the q tile of q_rows rows
// starting at q0
__device__ __forceinline__ int64_t kv_tiles_for(const HvdFlashArgs& a,
                                                int64_t q0,
                                                int64_t q_rows = kTile,
                                                int64_t kv_rows = kTile) {
  const int64_t q_end = q0 + q_rows < a.sq ? q0 + q_rows : a.sq;
  return a.causal ? causal_kv_tiles(a, a.q_off + q_end - 1, kv_rows)
                  : tiles(a.sk, kv_rows);
}

// first q tile that can see the kv tile starting at k0 under the causal
// mask: q_off + i0 * kTile + kTile - 1 >= kv_off + k0
__device__ __forceinline__ int64_t first_q_tile(const HvdFlashArgs& a,
                                                int64_t k0) {
  if (!a.causal) return 0;
  const int64_t need = a.kv_off + k0 - a.q_off - (kTile - 1);
  return need <= 0 ? 0 : (need + kTile - 1) / kTile;
}

__device__ __forceinline__ bool visible(const HvdFlashArgs& a, int64_t qi,
                                        int64_t ki) {
  return ki < a.sk && qi < a.sq &&
         (!a.causal || a.q_off + qi >= a.kv_off + ki);
}

// ===========================================================================
// float32: scalar FMA over float32 tiles
// ===========================================================================

// Rows [row0, row0 + kTile) of one (b, h) slice into shared memory, zero
// past `rows`: transposed into trans[e * kLd + r] and/or as is into
// plain[r * D + e] (either may be null).
template <int D>
__device__ void load_tile(const HvdBhsd& t, int64_t b, int64_t h,
                          int64_t row0, int64_t rows, float* trans,
                          float* plain) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D;
    const int e = i % D;
    float x = 0.f;
    if (row0 + r < rows) x = at<const float>(t, b, h, row0 + r)[e];
    if (trans != nullptr) trans[e * kLd + r] = x;
    if (plain != nullptr) plain[r * D + e] = x;
  }
}

// acc[i][j] = sum_e At[e][4ty + i] * Bt[e][4tx + j] over the D rows of two
// transposed tiles: one 64x64 tile of A.B^T, 4x4 per thread.
template <int D>
__device__ __forceinline__ void tile_abt(const float* At, const float* Bt,
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int e = 0; e < D; ++e) {
    const float4 a = *reinterpret_cast<const float4*>(At + e * kLd + 4 * ty);
    const float4 b = *reinterpret_cast<const float4*>(Bt + e * kLd + 4 * tx);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// C consecutive floats of shared memory (16-byte loads when C allows)
template <int C>
__device__ __forceinline__ void load_cols(const float* p, float x[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + c);
      x[c] = v.x;
      x[c + 1] = v.y;
      x[c + 2] = v.z;
      x[c + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = p[c];
  }
}

// out[i][c] = sum_k P[4ty + i][k] * X[k][tx*C + c], C = D / 16: rows of a
// 64x64 tile (row stride kLd) times a 64xD tile (row stride D).
template <int D>
__device__ __forceinline__ void tile_pv(const float* P, const float* X,
                                        int ty, int tx,
                                        float out[4][D / 16]) {
  constexpr int C = D / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) out[i][c] = 0.f;
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v =
          *reinterpret_cast<const float4*>(P + (4 * ty + i) * kLd + k);
      p[i][0] = v.x;
      p[i][1] = v.y;
      p[i][2] = v.z;
      p[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float x[C];
      load_cols<C>(X + (k + kk) * D + tx * C, x);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) out[i][c] = fmaf(p[i][kk], x[c], out[i][c]);
    }
  }
}

// Writes a thread's 4x4 values into rows 4ty.. / columns 4tx.. of a tile
// with row stride kLd.
__device__ __forceinline__ void store_scores(float* S, int ty, int tx,
                                             float v[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    *reinterpret_cast<float4*>(S + (4 * ty + i) * kLd + 4 * tx) =
        make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
  }
}

// A row's max / sum over the 16 lanes of a half-warp that share the row.
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// K2, float32
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const HvdFlashArgs a) {
  constexpr int C = D / 16;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][kLd]
  float* Kt = Qt + D * kLd;                     // [D][kLd]
  float* Vs = Kt + D * kLd;                     // [kTile][D]
  float* Ps = Vs + kTile * D;                   // [kTile][kLd]

  const int64_t bh = blockIdx.x;
  const int64_t bi = bh / a.h, hi = bh % a.h;
  // the last q tiles see the most kv tiles: start them first
  const int64_t q0 = (static_cast<int64_t>(gridDim.y) - 1 - blockIdx.y) * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<D>(a.q, bi, hi, q0, a.sq, Qt, nullptr);

  float acc[4][C], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const int64_t n_kv = kv_tiles_for(a, q0);
  for (int64_t j = 0; j < n_kv; ++j) {
    const int64_t k0 = j * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(a.k, bi, hi, k0, a.sk, Kt, nullptr);
    load_tile<D>(a.v, bi, hi, k0, a.sk, nullptr, Vs);
    __syncthreads();

    float s[4][4];
    tile_abt<D>(Qt, Kt, ty, tx, s);
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qi = q0 + 4 * ty + i;
      bool ok[4];
      float mt = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        // rows past sq are never stored; only the key side is masked
        const int64_t ki = k0 + 4 * tx + jj;
        ok[jj] = ki < a.sk && (!a.causal || a.q_off + qi >= a.kv_off + ki);
        s[i][jj] = ok[jj] ? s[i][jj] * a.scale : kNegInf;
        mt = fmaxf(mt, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mt));
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        s[i][jj] = ok[jj] ? p : 0.f;
        ps += s[i][jj];
      }
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      l[i] = l[i] * alpha[i] + half_warp_sum(ps);
    }
    store_scores(Ps, ty, tx, s);
    __syncwarp();  // a row's writers are its readers
    float pv[4][C];
    tile_pv<D>(Ps, Vs, ty, tx, pv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] = acc[i][c] * alpha[i] + pv[i][c];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qi = q0 + 4 * ty + i;
    if (qi >= a.sq) continue;
    float* o = at<float>(a.o, bi, hi, qi) + tx * C;
    const float den = a.normalize ? fmaxf(l[i], 1e-30f) : 1.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
      o[c] = a.normalize ? acc[i][c] / den : acc[i][c];
    if (tx == 0) {
      a.m[bh * a.sq + qi] = m[i];
      a.l[bh * a.sq + qi] = l[i];
    }
  }
}

// K3, float32
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const HvdFlashArgs a) {
  constexpr int C = D / 16;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][kLd]
  float* dOt = Qt + D * kLd;                    // [D][kLd]
  float* Kt = dOt + D * kLd;                    // [D][kLd]
  float* Vt = Kt + D * kLd;                     // [D][kLd]
  float* Ks = Vt + D * kLd;                     // [kTile][D]
  float* DS = Ks + kTile * D;                   // [kTile][kLd]

  const int64_t bh = blockIdx.x;
  const int64_t bi = bh / a.h, hi = bh % a.h;
  const int64_t q0 = (static_cast<int64_t>(gridDim.y) - 1 - blockIdx.y) * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<D>(a.q, bi, hi, q0, a.sq, Qt, nullptr);
  load_tile<D>(a.dout, bi, hi, q0, a.sq, dOt, nullptr);
  float lse[4], delta[4], dq[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qi = q0 + 4 * ty + i;
    lse[i] = qi < a.sq ? a.lse[bh * a.sq + qi] : 0.f;
    delta[i] = qi < a.sq ? a.delta[bh * a.sq + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) dq[i][c] = 0.f;
  }

  const int64_t n_kv = kv_tiles_for(a, q0);
  for (int64_t j = 0; j < n_kv; ++j) {
    const int64_t k0 = j * kTile;
    __syncthreads();
    load_tile<D>(a.k, bi, hi, k0, a.sk, Kt, Ks);
    load_tile<D>(a.v, bi, hi, k0, a.sk, Vt, nullptr);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_abt<D>(Qt, Kt, ty, tx, s);
    tile_abt<D>(dOt, Vt, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qi = q0 + 4 * ty + i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int64_t ki = k0 + 4 * tx + jj;
        const bool ok =
            ki < a.sk && (!a.causal || a.q_off + qi >= a.kv_off + ki);
        const float sv = ok ? s[i][jj] * a.scale : kNegInf;
        float p = expf(sv - lse[i]);
        p = ok ? p : 0.f;
        s[i][jj] = p * (dp[i][jj] - delta[i]) * a.scale;  // ds
      }
    }
    store_scores(DS, ty, tx, s);
    __syncwarp();
    float t[4][C];
    tile_pv<D>(DS, Ks, ty, tx, t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) dq[i][c] += t[i][c];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t qi = q0 + 4 * ty + i;
    if (qi >= a.sq) continue;
    float* out = at<float>(a.dq, bi, hi, qi) + tx * C;
#pragma unroll
    for (int c = 0; c < C; ++c) out[c] = dq[i][c];
  }
}

// K4, float32
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const HvdFlashArgs a) {
  constexpr int C = D / 16;
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // [D][kLd]
  float* Vt = Kt + D * kLd;                     // [D][kLd]
  float* Qt = Vt + D * kLd;                     // [D][kLd]
  float* dOt = Qt + D * kLd;                    // [D][kLd]
  float* Qs = dOt + D * kLd;                    // [kTile][D]
  float* dOs = Qs + kTile * D;                  // [kTile][D]
  float* PB = dOs + kTile * D;                  // [kTile][kLd]: p, then ds
  float* lse_s = PB + kTile * kLd;              // [kTile]
  float* delta_s = lse_s + kTile;               // [kTile]

  const int64_t bh = blockIdx.x;
  const int64_t bi = bh / a.h, hi = bh % a.h;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<D>(a.k, bi, hi, k0, a.sk, Kt, nullptr);
  load_tile<D>(a.v, bi, hi, k0, a.sk, Vt, nullptr);
  float dk[4][C], dv[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int64_t n_q = tiles(a.sq);
  for (int64_t it = first_q_tile(a, k0); it < n_q; ++it) {
    const int64_t q0 = it * kTile;
    __syncthreads();
    load_tile<D>(a.q, bi, hi, q0, a.sq, Qt, Qs);
    load_tile<D>(a.dout, bi, hi, q0, a.sq, dOt, dOs);
    if (threadIdx.x < kTile) {
      const int64_t qi = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qi < a.sq ? a.lse[bh * a.sq + qi] : 0.f;
      delta_s[threadIdx.x] = qi < a.sq ? a.delta[bh * a.sq + qi] : 0.f;
    }
    __syncthreads();

    // transposed scores: row = key 4ty + i, column = query 4tx + jj
    float s[4][4], dp[4][4];
    tile_abt<D>(Kt, Qt, ty, tx, s);
    tile_abt<D>(Vt, dOt, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t ki = k0 + 4 * ty + i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int q = 4 * tx + jj;
        const bool ok = visible(a, q0 + q, ki);
        const float sv = ok ? s[i][jj] * a.scale : kNegInf;
        float p = expf(sv - lse_s[q]);
        p = ok ? p : 0.f;
        s[i][jj] = p;
        dp[i][jj] = p * (dp[i][jj] - delta_s[q]) * a.scale;  // ds
      }
    }
    float t[4][C];
    store_scores(PB, ty, tx, s);
    __syncwarp();
    tile_pv<D>(PB, dOs, ty, tx, t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) dv[i][c] += t[i][c];
    __syncwarp();
    store_scores(PB, ty, tx, dp);
    __syncwarp();
    tile_pv<D>(PB, Qs, ty, tx, t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) dk[i][c] += t[i][c];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t ki = k0 + 4 * ty + i;
    if (ki >= a.sk) continue;
    float* dko = at<float>(a.dk, bi, hi, ki) + tx * C;
    float* dvo = at<float>(a.dv, bi, hi, ki) + tx * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dko[c] = dk[i][c];
      dvo[c] = dv[i][c];
    }
  }
}

// ===========================================================================
// bfloat16: mma.sync m16n8k16 on the tensor cores
// ===========================================================================
//
// Fragments of one warp (lane = 4 * g + q): an A tile 16x16 (row major) is
// four 32-bit registers holding (row g | g+8, columns 2q, 2q+1 | +8); a B
// tile 16x8 (k x n) is two, holding (k = 2q, 2q+1 | +8, n = g); the float32
// accumulator 16x8 is (row g | g+8, columns 2q, 2q+1).  A 16x64 score tile
// is 8 accumulators s[n] over columns 8n..8n+7.

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a . b
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices of shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8 and receives, of matrix i, the
// elements (2q, g) and (2q + 1, g) in register i.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Rows [row0, row0 + kTile) of one (b, h) slice into shared memory as bf16,
// dst[r * (D + kPad) + e], zero past `rows`.  16-byte loads where the
// operand's address and strides allow them.
template <int D>
__device__ void load_tile_bf16(const HvdBhsd& t, int64_t b, int64_t h,
                               int64_t row0, int64_t rows, bf16* dst) {
  constexpr int LD = D + kPad, C = D / 8;
  const bool vec = ((reinterpret_cast<uintptr_t>(t.ptr) |
                     static_cast<uintptr_t>((t.sb | t.sh | t.ss) * 2)) &
                    15) == 0;
  const bf16* base = at<const bf16>(t, b, h, 0);
  for (int i = threadIdx.x; i < kTile * C; i += kMmaThreads) {
    const int r = i / C;
    const int c = (i % C) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      const bf16* src = base + (row0 + r) * t.ss + c;
      if (vec) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int k = 0; k < 8; ++k) e[k] = src[k];
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
  }
}

// s = X[r0 .. r0+16) . Y^T over all kTile rows of Y: a warp's 16x64 score
// tile from two row-major [kTile][D + kPad] tiles.
template <int D>
__device__ __forceinline__ void warp_abt(const bf16* X, const bf16* Y,
                                         int r0, int lane, float s[8][4]) {
  constexpr int LD = D + kPad;
  const int g = lane >> 2, q = (lane & 3) * 2;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[n][i] = 0.f;
#pragma unroll
  for (int k = 0; k < D; k += 16) {
    const uint32_t a[4] = {ld32(X + (r0 + g) * LD + k + q),
                           ld32(X + (r0 + g + 8) * LD + k + q),
                           ld32(X + (r0 + g) * LD + k + q + 8),
                           ld32(X + (r0 + g + 8) * LD + k + q + 8)};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const bf16* y = Y + (n * 8 + g) * LD + k + q;
      mma_bf16(s[n], a, ld32(y), ld32(y + 8));
    }
  }
}

// out += bf16(p) . X for a warp's 16x64 tile p and the row-major
// [kTile][D + kPad] tile X; p's rounding to bf16 is the Pallas body's
// astype before the product.  The B fragments of X's rows 16k..16k+15 and
// columns 8n..8n+15 come from one ldmatrix.x4.trans.
template <int D>
__device__ __forceinline__ void warp_pv(const float p[8][4], const bf16* X,
                                        int lane, float out[D / 8][4]) {
  constexpr int LD = D + kPad;
  const int i = lane >> 3, r = lane & 7;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t a[4] = {pack_bf16(p[2 * k][0], p[2 * k][1]),
                           pack_bf16(p[2 * k][2], p[2 * k][3]),
                           pack_bf16(p[2 * k + 1][0], p[2 * k + 1][1]),
                           pack_bf16(p[2 * k + 1][2], p[2 * k + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, X + (k * 16 + (i & 1) * 8 + r) * LD +
                           (n + (i >> 1)) * 8);
      mma_bf16(out[n], a, b[0], b[1]);
      mma_bf16(out[n + 1], a, b[2], b[3]);
    }
  }
}

// Keys [k0, k0 + n) of a kv tile of kv_rows keys that query qi sees (the
// same mask as the float32 kernels', computed once a row), n in [0,
// kv_rows].
__device__ __forceinline__ int keys_seen(const HvdFlashArgs& a, int64_t qi,
                                         int64_t k0,
                                         int64_t kv_rows = kTile) {
  int64_t n = a.sk - k0;
  if (a.causal) {
    const int64_t c = a.q_off + qi - a.kv_off - k0 + 1;
    n = c < n ? c : n;
  }
  return static_cast<int>(n < 0 ? 0 : (n > kv_rows ? kv_rows : n));
}

// Queries [q0 + lo, q0 + hi) of a q tile that key ki sees: visible().
__device__ __forceinline__ void queries_seen(const HvdFlashArgs& a,
                                             int64_t ki, int64_t q0,
                                             int& lo, int& hi) {
  const int64_t h = ki < a.sk ? a.sq - q0 : 0;
  const int64_t l = a.causal ? a.kv_off + ki - a.q_off - q0 : 0;
  hi = static_cast<int>(h < 0 ? 0 : (h > kTile ? kTile : h));
  lo = static_cast<int>(l < 0 ? 0 : (l > kTile ? kTile : l));
}

// A row's max / sum over the 4 lanes that share it.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Row `row` of a [.., D] output, from a warp's accumulators over columns
// 8n + 2q, 8n + 2q + 1 (half hf: accumulator entries 2hf, 2hf + 1).
template <typename T, int D>
__device__ __forceinline__ void store_row(T* row, const float acc[D / 8][4],
                                          int hf, int q, float den) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if constexpr (sizeof(T) == 2) {
      row[n * 8 + q] = __float2bfloat16_rn(acc[n][2 * hf] / den);
      row[n * 8 + q + 1] = __float2bfloat16_rn(acc[n][2 * hf + 1] / den);
    } else {
      row[n * 8 + q] = acc[n][2 * hf];
      row[n * 8 + q + 1] = acc[n][2 * hf + 1];
    }
  }
}

// K2, bfloat16
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const HvdFlashArgs a) {
  constexpr int LD = D + kPad;
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);  // [kTile][LD]
  bf16* Ks = Qs + kTile * LD;                   // [kTile][LD]
  bf16* Vs = Ks + kTile * LD;                   // [kTile][LD]

  const int64_t bh = blockIdx.x;
  const int64_t bi = bh / a.h, hi = bh % a.h;
  const int64_t q0 = (static_cast<int64_t>(gridDim.y) - 1 - blockIdx.y) * kTile;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, q = (lane & 3) * 2;

  load_tile_bf16<D>(a.q, bi, hi, q0, a.sq, Qs);
  float o[D / 8][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;

  const int64_t n_kv = kv_tiles_for(a, q0);
  for (int64_t j = 0; j < n_kv; ++j) {
    const int64_t k0 = j * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile_bf16<D>(a.k, bi, hi, k0, a.sk, Ks);
    load_tile_bf16<D>(a.v, bi, hi, k0, a.sk, Vs);
    __syncthreads();

    float s[8][4];
    warp_abt<D>(Qs, Ks, r0, lane, s);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      // rows past sq are never stored; only the key side is masked
      const int seen = keys_seen(a, q0 + r0 + g + 8 * hf, k0);
      float mt = kNegInf;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * hf + e];
          x = n * 8 + q + e < seen ? x * a.scale : kNegInf;
          mt = fmaxf(mt, x);
        }
      const float m_new = fmaxf(m[hf], quad_max(mt));
      float ps = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * hf + e];
          x = n * 8 + q + e < seen ? expf(x - m_new) : 0.f;
          ps += x;
        }
      const float alpha = expf(m[hf] - m_new);
      m[hf] = m_new;
      l[hf] = l[hf] * alpha + quad_sum(ps);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * hf] *= alpha;
        o[n][2 * hf + 1] *= alpha;
      }
    }
    warp_pv<D>(s, Vs, lane, o);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int64_t qi = q0 + r0 + g + 8 * hf;
    if (qi >= a.sq) continue;
    if (a.normalize)
      store_row<bf16, D>(at<bf16>(a.o, bi, hi, qi), o, hf, q,
                         fmaxf(l[hf], 1e-30f));
    else
      store_row<float, D>(at<float>(a.o, bi, hi, qi), o, hf, q, 1.f);
    if (q == 0) {
      a.m[bh * a.sq + qi] = m[hf];
      a.l[bh * a.sq + qi] = l[hf];
    }
  }
}

// K3, bfloat16
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_mma_kernel(const HvdFlashArgs a) {
  constexpr int LD = D + kPad;
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);  // [kTile][LD]
  bf16* dOs = Qs + kTile * LD;                  // [kTile][LD]
  bf16* Ks = dOs + kTile * LD;                  // [kTile][LD]
  bf16* Vs = Ks + kTile * LD;                   // [kTile][LD]

  const int64_t bh = blockIdx.x;
  const int64_t bi = bh / a.h, hi = bh % a.h;
  const int64_t q0 = (static_cast<int64_t>(gridDim.y) - 1 - blockIdx.y) * kTile;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, q = (lane & 3) * 2;

  load_tile_bf16<D>(a.q, bi, hi, q0, a.sq, Qs);
  load_tile_bf16<D>(a.dout, bi, hi, q0, a.sq, dOs);
  float lse[2], delta[2], dq[D / 8][4];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int64_t qi = q0 + r0 + g + 8 * hf;
    lse[hf] = qi < a.sq ? a.lse[bh * a.sq + qi] : 0.f;
    delta[hf] = qi < a.sq ? a.delta[bh * a.sq + qi] : 0.f;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;

  const int64_t n_kv = kv_tiles_for(a, q0);
  for (int64_t j = 0; j < n_kv; ++j) {
    const int64_t k0 = j * kTile;
    __syncthreads();
    load_tile_bf16<D>(a.k, bi, hi, k0, a.sk, Ks);
    load_tile_bf16<D>(a.v, bi, hi, k0, a.sk, Vs);
    __syncthreads();

    float s[8][4], dp[8][4];
    warp_abt<D>(Qs, Ks, r0, lane, s);
    warp_abt<D>(dOs, Vs, r0, lane, dp);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int seen = keys_seen(a, q0 + r0 + g + 8 * hf, k0);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = n * 8 + q + e < seen;
          const int i = 2 * hf + e;
          const float sv = ok ? s[n][i] * a.scale : kNegInf;
          float p = expf(sv - lse[hf]);
          p = ok ? p : 0.f;
          s[n][i] = p * (dp[n][i] - delta[hf]) * a.scale;  // ds
        }
    }
    warp_pv<D>(s, Ks, lane, dq);  // ds.astype(k.dtype) . k
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int64_t qi = q0 + r0 + g + 8 * hf;
    if (qi < a.sq)
      store_row<float, D>(at<float>(a.dq, bi, hi, qi), dq, hf, q, 1.f);
  }
}

// K4, bfloat16
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkv_mma_kernel(const HvdFlashArgs a) {
  constexpr int LD = D + kPad;
  extern __shared__ uint4 smem_u4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_u4);  // [kTile][LD]
  bf16* Vs = Ks + kTile * LD;                   // [kTile][LD]
  bf16* Qs = Vs + kTile * LD;                   // [kTile][LD]
  bf16* dOs = Qs + kTile * LD;                  // [kTile][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + kTile * LD);  // [kTile]
  float* delta_s = lse_s + kTile;                              // [kTile]

  const int64_t bh = blockIdx.x;
  const int64_t bi = bh / a.h, hi = bh % a.h;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, q = (lane & 3) * 2;

  load_tile_bf16<D>(a.k, bi, hi, k0, a.sk, Ks);
  load_tile_bf16<D>(a.v, bi, hi, k0, a.sk, Vs);
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  const int64_t n_q = tiles(a.sq);
  for (int64_t it = first_q_tile(a, k0); it < n_q; ++it) {
    const int64_t q0 = it * kTile;
    __syncthreads();
    load_tile_bf16<D>(a.q, bi, hi, q0, a.sq, Qs);
    load_tile_bf16<D>(a.dout, bi, hi, q0, a.sq, dOs);
    if (threadIdx.x < kTile) {
      const int64_t qi = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qi < a.sq ? a.lse[bh * a.sq + qi] : 0.f;
      delta_s[threadIdx.x] = qi < a.sq ? a.delta[bh * a.sq + qi] : 0.f;
    }
    __syncthreads();

    // transposed scores: row = this warp's key, column = query
    float s[8][4], dp[8][4];
    warp_abt<D>(Ks, Qs, r0, lane, s);
    warp_abt<D>(Vs, dOs, r0, lane, dp);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      int lo, hi;
      queries_seen(a, k0 + r0 + g + 8 * hf, q0, lo, hi);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + q + e;
          const int i = 2 * hf + e;
          const bool ok = lo <= c && c < hi;
          const float sv = ok ? s[n][i] * a.scale : kNegInf;
          float p = expf(sv - lse_s[c]);
          p = ok ? p : 0.f;
          s[n][i] = p;
          dp[n][i] = p * (dp[n][i] - delta_s[c]) * a.scale;  // ds
        }
    }
    warp_pv<D>(s, dOs, lane, dv);   // p.astype(do.dtype)^T . do
    warp_pv<D>(dp, Qs, lane, dk);   // ds.astype(q.dtype)^T . q
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int64_t ki = k0 + r0 + g + 8 * hf;
    if (ki >= a.sk) continue;
    store_row<float, D>(at<float>(a.dk, bi, hi, ki), dk, hf, q, 1.f);
    store_row<float, D>(at<float>(a.dv, bi, hi, ki), dv, hf, q, 1.f);
  }
}

// ===========================================================================
// bfloat16, head dim 64: TMA + wgmma (K2, K3 and K4)
// ===========================================================================
//
// Warps 0-7 are two consumer warpgroups, warp 8 the producer.  Warp w of
// warpgroup wg holds rows 64 wg + 16 (w % 4) + g and + 8 of the block's
// tile (lane 4g + q); a wgmma m64nN accumulator d holds, for each 8-column
// group j, d[4j], d[4j + 1] (row g, columns 8j + 2q, + 1) and d[4j + 2],
// d[4j + 3] (row g + 8), the layout of the mma.sync kernels' s[n].  Its
// columns 16k .. 16k + 15, rounded to bf16 pairs, are the register A
// fragment of the next product's k16 step k.

constexpr int kWgD = 64;                 // head dim: one 128-byte row
constexpr int kRowBytes = kWgD * 2;      // a swizzled shared-memory row
constexpr int kWgRows = 128;             // rows a block owns: 2 x 64
constexpr int kWgThreads = 256 + 32;     // two warpgroups + the producer
constexpr int kWgTileBytes = kWgRows * kRowBytes;  // 16 KB
// K2
constexpr int kFwdKv = 128;              // keys of a kv tile
constexpr int kFwdKvBytes = kFwdKv * kRowBytes;
constexpr int kFwdStages = 2;
constexpr int kFwdSmem = 1024 + kWgTileBytes +
                         2 * kFwdStages * kFwdKvBytes +
                         8 * (1 + 3 * kFwdStages);
// K4
constexpr int kDkvQ = kTile;             // queries of a q tile (64)
constexpr int kDkvStages = 3;
constexpr int kDkvQBytes = kDkvQ * kRowBytes;     // 8 KB
constexpr int kDkvSmem = 1024 + 2 * kWgTileBytes +
                         kDkvStages * (2 * kDkvQBytes + 2 * kDkvQ * 4) +
                         8 * (1 + 2 * kDkvStages);
// K3
constexpr int kDqKv = kTile;             // keys of a kv tile (64)
constexpr int kDqStages = 3;
constexpr int kDqKvBytes = kDqKv * kRowBytes;     // 8 KB
constexpr int kDqSmem = 1024 + 2 * kWgTileBytes +
                        2 * kDqStages * kDqKvBytes + 8 * (1 + 3 * kDqStages);

// wgmma descriptors of a tile of 128-byte rows in shared memory, with
// 8-row groups 1 KB apart (the 128-byte swizzle's pattern).  K-major: the
// rows are the M or N rows and the head dim is K; a k16 step is 32 bytes
// along the row.  MN-major: the rows are K and the head dim is N; a k16
// step is 16 rows.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, int kk) {
  return gmma_desc(addr + kk * 32, 16, 1024);
}

__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, int kk) {
  return gmma_desc(addr + kk * 16 * kRowBytes, 8192, 1024);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The A fragments of k16 steps 0 .. N/16 - 1 from an m64nN accumulator,
// rounded to bf16 pairs: a[4k .. 4k + 3] for columns 16k .. 16k + 15.
template <int N>
__device__ __forceinline__ void to_a_fragments(const float* d, uint32_t* a) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k) {
    a[4 * k + 0] = pack_bf16(d[8 * k + 0], d[8 * k + 1]);  // row g
    a[4 * k + 1] = pack_bf16(d[8 * k + 2], d[8 * k + 3]);  // row g + 8
    a[4 * k + 2] = pack_bf16(d[8 * k + 4], d[8 * k + 5]);  // row g, + 8
    a[4 * k + 3] = pack_bf16(d[8 * k + 6], d[8 * k + 7]);  // row g + 8, + 8
  }
}

// One row's step of K2's online softmax over a kv tile of N keys: the
// row's scores sc[4j + 2hf + e] (this thread's columns 8j + q2 + e),
// masked past `seen` keys (kMask), scaled, exponentiated against the new
// running max m; l and the row's o accumulators o[4n + 2hf + e] rescaled
// by alpha.  Called by the whole warp (the row's max and sum cross its
// 4 lanes).  The TMA + wgmma kernels exponentiate with __expf, the
// hardware's 2^x of x log2(e) (ex2.approx): a relative error near 2^-21
// where expf's is one ulp, which moves p far less than its bf16 rounding
// (2^-9); at GPT-2's shape on the H100 it took K2 from 0.050 to 0.041 ms
// and K4 from 0.066 to 0.062.
template <int N, bool kMask>
__device__ __forceinline__ void softmax_step(float* sc, int hf, int q2,
                                             int seen, float scale, float& m,
                                             float& l, float* o) {
  float mt = kNegInf;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float& x = sc[4 * j + 2 * hf + e];
      x = !kMask || 8 * j + q2 + e < seen ? x * scale : kNegInf;
      mt = fmaxf(mt, x);
    }
  const float m_new = fmaxf(m, quad_max(mt));
  float ps = 0.f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float& x = sc[4 * j + 2 * hf + e];
      x = !kMask || 8 * j + q2 + e < seen ? __expf(x - m_new) : 0.f;
      ps += x;
    }
  const float alpha = __expf(m - m_new);
  m = m_new;
  l = l * alpha + quad_sum(ps);
#pragma unroll
  for (int n = 0; n < kWgD / 8; ++n) {
    o[4 * n + 2 * hf] *= alpha;
    o[4 * n + 2 * hf + 1] *= alpha;
  }
}

// K2, bfloat16, head dim 64
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                           const __grid_constant__ CUtensorMap tmap_k,
                           const __grid_constant__ CUtensorMap tmap_v,
                           const HvdFlashArgs a) {
  constexpr int S = kFwdStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);          // [128 rows][64]
  uint8_t* sk = sq + kWgTileBytes;            // [S][kv keys][64]
  uint8_t* sv = sk + S * kFwdKvBytes;         // [S][kv keys][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + S * kFwdKvBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + S;
  uint64_t* empty = v_full + S;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t bh = blockIdx.x;
  const int bi = static_cast<int>(bh / a.h), hi = static_cast<int>(bh % a.h);
  // the last q tiles see the most kv tiles: start them first
  const int64_t q0 =
      (static_cast<int64_t>(gridDim.y) - 1 - blockIdx.y) * kWgRows;
  const int n_kv = static_cast<int>(kv_tiles_for(a, q0, kWgRows, kFwdKv));

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&k_full[s], 1);  // the producer's arrive + the bytes
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);   // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    // producer: one thread issues every copy; the ring's stage s is in
    // round parity ^ 1 (a stage starts out free)
    if (lane != 0 || n_kv == 0) return;
    mbar_arrive_expect_tx(q_full, kWgTileBytes);
    tma_load_4d(sq, &tmap_q, q_full, 0, static_cast<int>(q0), hi, bi);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % S;
      const uint32_t parity = (j / S) & 1;
      mbar_wait(&empty[s], parity ^ 1);
      mbar_arrive_expect_tx(&k_full[s], kFwdKvBytes);
      tma_load_4d(sk + s * kFwdKvBytes, &tmap_k, &k_full[s], 0, j * kFwdKv,
                  hi, bi);
      mbar_arrive_expect_tx(&v_full[s], kFwdKvBytes);
      tma_load_4d(sv + s * kFwdKvBytes, &tmap_v, &v_full[s], 0, j * kFwdKv,
                  hi, bi);
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63; this thread rows
  // q0 + r0 and q0 + r0 + 8
  const int wg = warp >> 2;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const int r0 = wg * 64 + (warp & 3) * 16 + g;
  float o[32], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  const uint32_t q_addr = smem_u32(sq + wg * 64 * kRowBytes);
  if (n_kv > 0) mbar_wait(q_full, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % S;
    const uint32_t parity = (j / S) & 1;
    const int64_t k0 = static_cast<int64_t>(j) * kFwdKv;

    // S = Q . K^T over the 64 dims: 64 rows x kv keys
    float sc[kFwdKv / 2];
#pragma unroll
    for (int i = 0; i < kFwdKv / 2; ++i) sc[i] = 0.f;
    mbar_wait(&k_full[s], parity);
    __syncwarp();  // wgmma is .aligned: the warp converged
    const uint32_t k_addr = smem_u32(sk + s * kFwdKvBytes);
    fence_operands<kFwdKv / 2>(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgD / 16; ++kk)
      wgmma_ss<kFwdKv, 0>(sc, kmajor_desc(q_addr, kk),
                          kmajor_desc(k_addr, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands<kFwdKv / 2>(sc);

    // the online softmax of rows g (hf 0) and g + 8 (hf 1); rows past sq
    // are never stored, only the key side is masked.  A warp whose rows
    // all see the whole tile (every tile but the diagonal ones and a
    // ragged last one) skips the mask.
    int seen[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      seen[hf] = keys_seen(a, q0 + r0 + 8 * hf, k0, kFwdKv);
    if (__all_sync(0xffffffffu, seen[0] == kFwdKv && seen[1] == kFwdKv)) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        softmax_step<kFwdKv, false>(sc, hf, q2, kFwdKv, a.scale, m[hf],
                                    l[hf], o);
    } else {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        softmax_step<kFwdKv, true>(sc, hf, q2, seen[hf], a.scale, m[hf],
                                   l[hf], o);
    }
    uint32_t p[kFwdKv / 4];  // bf16(P): p.astype(vb.dtype)
    to_a_fragments<kFwdKv>(sc, p);

    // O += P . V over the kv keys
    mbar_wait(&v_full[s], parity);
    __syncwarp();
    const uint32_t v_addr = smem_u32(sv + s * kFwdKvBytes);
    fence_operands<32>(o);
    fence_operands<kFwdKv / 4>(p);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kFwdKv / 16; ++kk)
      wgmma_rs_m64n64k16<1>(o, &p[4 * kk], mnmajor_desc(v_addr, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands<32>(o);
    fence_operands<kFwdKv / 4>(p);
    // both products of stage s have completed: K and V are free
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int64_t qi = q0 + r0 + 8 * hf;
    if (qi >= a.sq) continue;
    if (a.normalize) {
      const float den = fmaxf(l[hf], 1e-30f);
      bf16* row = at<bf16>(a.o, bi, hi, qi);
#pragma unroll
      for (int n = 0; n < kWgD / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * n + q2) =
            __floats2bfloat162_rn(o[4 * n + 2 * hf] / den,
                                  o[4 * n + 2 * hf + 1] / den);
    } else {
      float* row = at<float>(a.o, bi, hi, qi);
#pragma unroll
      for (int n = 0; n < kWgD / 8; ++n)
        *reinterpret_cast<float2*>(row + 8 * n + q2) =
            make_float2(o[4 * n + 2 * hf], o[4 * n + 2 * hf + 1]);
    }
    if (q2 == 0) {
      a.m[bh * a.sq + qi] = m[hf];
      a.l[bh * a.sq + qi] = l[hf];
    }
  }
}

// One key row's P^T and dS^T in K4, in place of its S^T and dP^T
// (st[4j + 2hf + e], dpt[..], query 8j + q2 + e of the q tile), masked to
// the queries [lo, hi) it sees (kMask).
template <bool kMask>
__device__ __forceinline__ void dkv_probs(float* st, float* dpt, int hf,
                                          int q2, int lo, int hi,
                                          const float* lse,
                                          const float* delta, float scale) {
#pragma unroll
  for (int j = 0; j < kDkvQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + q2 + e;
      const int i = 4 * j + 2 * hf + e;
      const bool ok = !kMask || (lo <= c && c < hi);
      const float x = ok ? st[i] * scale : kNegInf;
      float p = __expf(x - lse[c]);
      p = ok ? p : 0.f;
      st[i] = p;
      dpt[i] = p * (dpt[i] - delta[c]) * scale;  // ds
    }
}

// K4, bfloat16, head dim 64
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                               const __grid_constant__ CUtensorMap tmap_k,
                               const __grid_constant__ CUtensorMap tmap_v,
                               const __grid_constant__ CUtensorMap tmap_do,
                               const HvdFlashArgs a) {
  constexpr int S = kDkvStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = align1024(smem_raw);          // [128 keys][64]
  uint8_t* sv = sk + kWgTileBytes;            // [128 keys][64]
  uint8_t* sq = sv + kWgTileBytes;            // [S][64 queries][64]
  uint8_t* sdo = sq + S * kDkvQBytes;         // [S][64 queries][64]
  float* lse_s = reinterpret_cast<float*>(sdo + S * kDkvQBytes);  // [S][64]
  float* delta_s = lse_s + S * kDkvQ;                              // [S][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(delta_s + S * kDkvQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t bh = blockIdx.x;
  const int bi = static_cast<int>(bh / a.h), hi = static_cast<int>(bh % a.h);
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * kWgRows;
  const int it0 = static_cast<int>(first_q_tile(a, k0));
  const int n_q = static_cast<int>(tiles(a.sq, kDkvQ));

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1 + 32);  // the copy's arrive + bytes, 32 lanes
      mbar_init(&empty[s], 8);      // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    // producer: lane 0 issues the copies, every lane stages lse and delta
    if (it0 >= n_q) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * kWgTileBytes);
      tma_load_4d(sk, &tmap_k, kv_full, 0, static_cast<int>(k0), hi, bi);
      tma_load_4d(sv, &tmap_v, kv_full, 0, static_cast<int>(k0), hi, bi);
    }
    for (int it = it0; it < n_q; ++it) {
      const int j = it - it0, s = j % S;
      const uint32_t parity = (j / S) & 1;
      const int64_t q0 = static_cast<int64_t>(it) * kDkvQ;
      mbar_wait(&empty[s], parity ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * kDkvQBytes);
        tma_load_4d(sq + s * kDkvQBytes, &tmap_q, &full[s], 0,
                    static_cast<int>(q0), hi, bi);
        tma_load_4d(sdo + s * kDkvQBytes, &tmap_do, &full[s], 0,
                    static_cast<int>(q0), hi, bi);
      }
      for (int r = lane; r < kDkvQ; r += 32) {
        const int64_t qi = q0 + r;
        lse_s[s * kDkvQ + r] = qi < a.sq ? a.lse[bh * a.sq + qi] : 0.f;
        delta_s[s * kDkvQ + r] = qi < a.sq ? a.delta[bh * a.sq + qi] : 0.f;
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  // consumers: warpgroup wg owns keys k0 + 64 wg .. + 63; this thread keys
  // k0 + r0 and k0 + r0 + 8
  const int wg = warp >> 2;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const int r0 = wg * 64 + (warp & 3) * 16 + g;
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  const uint32_t k_addr = smem_u32(sk + wg * 64 * kRowBytes);
  const uint32_t v_addr = smem_u32(sv + wg * 64 * kRowBytes);
  if (it0 < n_q) mbar_wait(kv_full, 0);
  for (int it = it0; it < n_q; ++it) {
    const int j = it - it0, s = j % S;
    const uint32_t parity = (j / S) & 1;
    const int64_t q0 = static_cast<int64_t>(it) * kDkvQ;
    const uint32_t qa = smem_u32(sq + s * kDkvQBytes);
    const uint32_t da = smem_u32(sdo + s * kDkvQBytes);

    // S^T = K . Q^T and dP^T = V . dO^T: 64 keys x 64 queries each
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    mbar_wait(&full[s], parity);
    __syncwarp();  // wgmma is .aligned: the warp converged
    fence_operands<32>(st);
    fence_operands<32>(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgD / 16; ++kk)
      wgmma_ss_m64n64k16<0>(st, kmajor_desc(k_addr, kk),
                            kmajor_desc(qa, kk));
#pragma unroll
    for (int kk = 0; kk < kWgD / 16; ++kk)
      wgmma_ss_m64n64k16<0>(dpt, kmajor_desc(v_addr, kk),
                            kmajor_desc(da, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands<32>(st);
    fence_operands<32>(dpt);

    // P^T and dS^T, masked to the queries each key sees; a warp whose
    // keys all see the whole q tile skips the mask
    const float* lse = lse_s + s * kDkvQ;
    const float* delta = delta_s + s * kDkvQ;
    int lo[2], hi_q[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      queries_seen(a, k0 + r0 + 8 * hf, q0, lo[hf], hi_q[hf]);
    if (__all_sync(0xffffffffu, lo[0] == 0 && hi_q[0] == kDkvQ &&
                                    lo[1] == 0 && hi_q[1] == kDkvQ)) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        dkv_probs<false>(st, dpt, hf, q2, 0, kDkvQ, lse, delta, a.scale);
    } else {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        dkv_probs<true>(st, dpt, hf, q2, lo[hf], hi_q[hf], lse, delta,
                        a.scale);
    }
    uint32_t pf[kDkvQ / 4], dsf[kDkvQ / 4];
    to_a_fragments<kDkvQ>(st, pf);   // p.astype(do.dtype)
    to_a_fragments<kDkvQ>(dpt, dsf); // ds.astype(q.dtype)

    // dV += P^T . dO and dK += dS^T . Q over the 64 queries
    fence_operands<32>(dv);
    fence_operands<32>(dk);
    fence_operands<kDkvQ / 4>(pf);
    fence_operands<kDkvQ / 4>(dsf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDkvQ / 16; ++kk)
      wgmma_rs_m64n64k16<1>(dv, &pf[4 * kk], mnmajor_desc(da, kk));
#pragma unroll
    for (int kk = 0; kk < kDkvQ / 16; ++kk)
      wgmma_rs_m64n64k16<1>(dk, &dsf[4 * kk], mnmajor_desc(qa, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands<32>(dv);
    fence_operands<32>(dk);
    fence_operands<kDkvQ / 4>(pf);
    fence_operands<kDkvQ / 4>(dsf);
    // every product of stage s has completed: Q, dO and the stats are free
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int64_t ki = k0 + r0 + 8 * hf;
    if (ki >= a.sk) continue;
    float* dko = at<float>(a.dk, bi, hi, ki);
    float* dvo = at<float>(a.dv, bi, hi, ki);
#pragma unroll
    for (int n = 0; n < kWgD / 8; ++n) {
      *reinterpret_cast<float2*>(dko + 8 * n + q2) =
          make_float2(dk[4 * n + 2 * hf], dk[4 * n + 2 * hf + 1]);
      *reinterpret_cast<float2*>(dvo + 8 * n + q2) =
          make_float2(dv[4 * n + 2 * hf], dv[4 * n + 2 * hf + 1]);
    }
  }
}

// One q row's dS in K3, in place of its S (sc[4j + 2hf + e], key 8j + q2 +
// e of the kv tile), from its dP, masked past the `seen` keys the row sees
// (kMask).
template <bool kMask>
__device__ __forceinline__ void dq_grads(float* sc, const float* dp, int hf,
                                         int q2, int seen, float lse,
                                         float delta, float scale) {
#pragma unroll
  for (int j = 0; j < kDqKv / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 4 * j + 2 * hf + e;
      const bool ok = !kMask || 8 * j + q2 + e < seen;
      const float x = ok ? sc[i] * scale : kNegInf;
      float p = __expf(x - lse);
      p = ok ? p : 0.f;
      sc[i] = p * (dp[i] - delta) * scale;  // ds
    }
}

// K3, bfloat16, head dim 64
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                              const __grid_constant__ CUtensorMap tmap_k,
                              const __grid_constant__ CUtensorMap tmap_v,
                              const __grid_constant__ CUtensorMap tmap_do,
                              const HvdFlashArgs a) {
  constexpr int S = kDqStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);          // [128 rows][64]
  uint8_t* sdo = sq + kWgTileBytes;           // [128 rows][64]
  uint8_t* sk = sdo + kWgTileBytes;           // [S][64 keys][64]
  uint8_t* sv = sk + S * kDqKvBytes;          // [S][64 keys][64]
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(sv + S * kDqKvBytes);
  uint64_t* k_full = qd_full + 1;
  uint64_t* v_full = k_full + S;
  uint64_t* empty = v_full + S;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t bh = blockIdx.x;
  const int bi = static_cast<int>(bh / a.h), hi = static_cast<int>(bh % a.h);
  // the last q tiles see the most kv tiles: start them first
  const int64_t q0 =
      (static_cast<int64_t>(gridDim.y) - 1 - blockIdx.y) * kWgRows;
  const int n_kv = static_cast<int>(kv_tiles_for(a, q0, kWgRows, kDqKv));

  if (tid == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&k_full[s], 1);  // the producer's arrive + the bytes
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);   // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    // producer: one thread issues every copy; none when the tile sees no
    // key
    if (lane != 0 || n_kv == 0) return;
    mbar_arrive_expect_tx(qd_full, 2 * kWgTileBytes);
    tma_load_4d(sq, &tmap_q, qd_full, 0, static_cast<int>(q0), hi, bi);
    tma_load_4d(sdo, &tmap_do, qd_full, 0, static_cast<int>(q0), hi, bi);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % S;
      const uint32_t parity = (j / S) & 1;
      mbar_wait(&empty[s], parity ^ 1);
      mbar_arrive_expect_tx(&k_full[s], kDqKvBytes);
      tma_load_4d(sk + s * kDqKvBytes, &tmap_k, &k_full[s], 0, j * kDqKv,
                  hi, bi);
      mbar_arrive_expect_tx(&v_full[s], kDqKvBytes);
      tma_load_4d(sv + s * kDqKvBytes, &tmap_v, &v_full[s], 0, j * kDqKv,
                  hi, bi);
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0 + 64 wg .. + 63; this thread rows
  // q0 + r0 and q0 + r0 + 8, whose lse and delta it keeps in registers
  const int wg = warp >> 2;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const int r0 = wg * 64 + (warp & 3) * 16 + g;
  float lse[2], delta[2], dq[32];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int64_t qi = q0 + r0 + 8 * hf;
    lse[hf] = qi < a.sq ? a.lse[bh * a.sq + qi] : 0.f;
    delta[hf] = qi < a.sq ? a.delta[bh * a.sq + qi] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;

  const uint32_t q_addr = smem_u32(sq + wg * 64 * kRowBytes);
  const uint32_t do_addr = smem_u32(sdo + wg * 64 * kRowBytes);
  if (n_kv > 0) mbar_wait(qd_full, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int s = j % S;
    const uint32_t parity = (j / S) & 1;
    const int64_t k0 = static_cast<int64_t>(j) * kDqKv;
    const uint32_t k_addr = smem_u32(sk + s * kDqKvBytes);
    const uint32_t v_addr = smem_u32(sv + s * kDqKvBytes);

    // S = Q . K^T, then dP = dO . V^T once V has landed: 64 rows x 64 keys
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    mbar_wait(&k_full[s], parity);
    __syncwarp();  // wgmma is .aligned: the warp converged
    fence_operands<32>(sc);
    fence_operands<32>(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgD / 16; ++kk)
      wgmma_ss_m64n64k16<0>(sc, kmajor_desc(q_addr, kk),
                            kmajor_desc(k_addr, kk));
    wgmma_commit();
    mbar_wait(&v_full[s], parity);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgD / 16; ++kk)
      wgmma_ss_m64n64k16<0>(dp, kmajor_desc(do_addr, kk),
                            kmajor_desc(v_addr, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands<32>(sc);
    fence_operands<32>(dp);

    // dS of rows g (hf 0) and g + 8 (hf 1); rows past sq are never
    // stored, only the key side is masked.  A warp whose rows all see the
    // whole tile skips the mask.
    int seen[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      seen[hf] = keys_seen(a, q0 + r0 + 8 * hf, k0, kDqKv);
    if (__all_sync(0xffffffffu, seen[0] == kDqKv && seen[1] == kDqKv)) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        dq_grads<false>(sc, dp, hf, q2, kDqKv, lse[hf], delta[hf],
                        a.scale);
    } else {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        dq_grads<true>(sc, dp, hf, q2, seen[hf], lse[hf], delta[hf],
                       a.scale);
    }
    uint32_t dsf[kDqKv / 4];
    to_a_fragments<kDqKv>(sc, dsf);  // ds.astype(k.dtype)

    // dQ += dS . K over the 64 keys, K the MN-major B operand
    fence_operands<32>(dq);
    fence_operands<kDqKv / 4>(dsf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDqKv / 16; ++kk)
      wgmma_rs_m64n64k16<1>(dq, &dsf[4 * kk], mnmajor_desc(k_addr, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands<32>(dq);
    fence_operands<kDqKv / 4>(dsf);
    // every product of stage s has completed: K and V are free
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // a tile that saw no key stores its zeros too: dq is not initialised
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int64_t qi = q0 + r0 + 8 * hf;
    if (qi >= a.sq) continue;
    float* row = at<float>(a.dq, bi, hi, qi);
#pragma unroll
    for (int n = 0; n < kWgD / 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n + q2) =
          make_float2(dq[4 * n + 2 * hf], dq[4 * n + 2 * hf + 1]);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
enum class Kind { kFwd, kDq, kDkv };

constexpr int32_t kMainMmaSync = 0, kMainWgmma = 1;

template <int D>
constexpr size_t smem_f32(Kind kind) {
  return sizeof(float) *
         (kind == Kind::kFwd
              ? 2 * D * kLd + kTile * D + kTile * kLd
              : kind == Kind::kDq
                    ? 4 * D * kLd + kTile * D + kTile * kLd
                    : 4 * D * kLd + 2 * kTile * D + kTile * kLd + 2 * kTile);
}

template <int D>
constexpr size_t smem_bf16(Kind kind) {
  constexpr size_t tile = sizeof(bf16) * kTile * (D + kPad);
  return kind == Kind::kFwd ? 3 * tile
                            : 4 * tile + (kind == Kind::kDkv
                                              ? sizeof(float) * 2 * kTile
                                              : 0);
}

// One block per (b, h) and tile of `tile` rows of q (K2, K3) or k (K4).
bool grid_of(Kind kind, const HvdFlashArgs& a, int64_t tile, dim3* grid) {
  const int64_t n_tiles = tiles(kind == Kind::kDkv ? a.sk : a.sq, tile);
  const int64_t bh = a.b * a.h;
  if (bh > 0x7fffffff || n_tiles > 65535) return false;
  *grid = dim3(static_cast<unsigned>(bh), static_cast<unsigned>(n_tiles));
  return true;
}

// The mma.sync and float32 kernels: their shared-memory limit is raised
// once per device (`smem_set`, the instance's own), not per launch.
cudaError_t run(void (*kernel)(const HvdFlashArgs), int threads, size_t smem,
                std::atomic<uint64_t>& smem_set, Kind kind,
                const HvdFlashArgs& a, cudaStream_t stream) {
  cudaError_t err =
      allow_smem_once(smem_set, kernel, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid;
  if (!grid_of(kind, a, kTile, &grid)) return cudaErrorInvalidConfiguration;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(Kind kind, const HvdFlashArgs& a, cudaStream_t stream) {
  // a bit per device below 64 for each (type, kind) instance at this D
  static std::atomic<uint64_t> smem_set[2][3] = {};
  const int k = static_cast<int>(kind);
  if (a.dtype == 0) {
    void (*kernel)(const HvdFlashArgs) =
        kind == Kind::kFwd  ? &flash_fwd_kernel<D>
        : kind == Kind::kDq ? &flash_bwd_dq_kernel<D>
                            : &flash_bwd_dkv_kernel<D>;
    return run(kernel, kThreads, smem_f32<D>(kind), smem_set[0][k], kind, a,
               stream);
  }
  if (a.dtype == 1) {
    void (*kernel)(const HvdFlashArgs) =
        kind == Kind::kFwd  ? &flash_fwd_mma_kernel<D>
        : kind == Kind::kDq ? &flash_bwd_dq_mma_kernel<D>
                            : &flash_bwd_dkv_mma_kernel<D>;
    return run(kernel, kMmaThreads, smem_bf16<D>(kind), smem_set[1][k], kind,
               a, stream);
  }
  return cudaErrorInvalidValue;
}

// What TMA can address: a 16-byte aligned base and 16-byte strides (the
// head dim is contiguous: kernels.py checks it for every launch).
bool tma_ok(const HvdBhsd& t) {
  const int64_t e = sizeof(bf16);
  return (reinterpret_cast<uintptr_t>(t.ptr) & 15u) == 0 && t.sb > 0 &&
         t.sh > 0 && t.ss > 0 && (t.sb * e) % 16 == 0 &&
         (t.sh * e) % 16 == 0 && (t.ss * e) % 16 == 0;
}

// A 4-D tiled map over one [b, h, s, 64] bf16 operand: dims (d, s, h, b)
// innermost first over its own strides, a box of `rows` rows of one (b,
// h), the 128-byte swizzle; rows past s read as zeros.
cudaError_t bhsd_map(CUtensorMap* map, const HvdBhsd& t, int64_t b, int64_t h,
                     int64_t s, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t e = sizeof(bf16);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kWgD),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(t.ss) * e,
                                 static_cast<cuuint64_t>(t.sh) * e,
                                 static_cast<cuuint64_t>(t.sb) * e};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kWgD),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, t.ptr, dims, strides, box,
      ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// K2, K3 or K4 on the TMA + wgmma mainloop: encodes the maps of the
// operands it copies, launches, returns the launch's error.
cudaError_t launch_wgmma(Kind kind, const HvdFlashArgs& a,
                         cudaStream_t stream) {
  static std::atomic<uint64_t> smem_set[3] = {};
  CUtensorMap tq, tk, tv, tdo;
  // the rows of a q (and dO) tile and of a kv tile each kernel copies
  const int q_rows = kind == Kind::kDkv ? kDkvQ : kWgRows;
  const int kv_rows = kind == Kind::kFwd ? kFwdKv
                      : kind == Kind::kDq ? kDqKv
                                          : kWgRows;
  cudaError_t err;
  if ((err = bhsd_map(&tq, a.q, a.b, a.h, a.sq, q_rows)) != cudaSuccess ||
      (err = bhsd_map(&tk, a.k, a.b, a.h, a.sk, kv_rows)) != cudaSuccess ||
      (err = bhsd_map(&tv, a.v, a.b, a.h, a.sk, kv_rows)) != cudaSuccess)
    return err;
  dim3 grid;
  if (!grid_of(kind, a, kWgRows, &grid)) return cudaErrorInvalidConfiguration;
  if (kind == Kind::kFwd) {
    err = allow_smem_once(smem_set[0], flash_fwd_wgmma_kernel, kFwdSmem);
    if (err != cudaSuccess) return err;
    flash_fwd_wgmma_kernel<<<grid, kWgThreads, kFwdSmem, stream>>>(tq, tk,
                                                                  tv, a);
    return cudaGetLastError();
  }
  if ((err = bhsd_map(&tdo, a.dout, a.b, a.h, a.sq, q_rows)) != cudaSuccess)
    return err;
  if (kind == Kind::kDq) {
    err = allow_smem_once(smem_set[2], flash_bwd_dq_wgmma_kernel, kDqSmem);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_wgmma_kernel<<<grid, kWgThreads, kDqSmem, stream>>>(
        tq, tk, tv, tdo, a);
    return cudaGetLastError();
  }
  err = allow_smem_once(smem_set[1], flash_bwd_dkv_wgmma_kernel, kDkvSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_wgmma_kernel<<<grid, kWgThreads, kDkvSmem, stream>>>(
      tq, tk, tv, tdo, a);
  return cudaGetLastError();
}

int dispatch(Kind kind, const HvdFlashArgs* a, void* stream) {
  if (a->b * a->h == 0 || (kind == Kind::kDkv ? a->sk : a->sq) == 0)
    return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->mainloop == kMainWgmma) {
    // kernels.flash_plan's rule, checked: bf16, d 64, both lengths
    // nonzero, every operand the kernel copies addressable by TMA
    if (a->dtype != 1 || a->d != kWgD || a->sq <= 0 || a->sk <= 0 ||
        !tma_ok(a->q) || !tma_ok(a->k) || !tma_ok(a->v) ||
        (kind != Kind::kFwd && !tma_ok(a->dout)))
      return cudaErrorInvalidValue;
    return launch_wgmma(kind, *a, st);
  }
  if (a->mainloop != kMainMmaSync) return cudaErrorInvalidValue;
  switch (a->d) {
    case 16:
      return launch<16>(kind, *a, st);
    case 32:
      return launch<32>(kind, *a, st);
    case 64:
      return launch<64>(kind, *a, st);
    case 128:
      return launch<128>(kind, *a, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int hvd_flash_fwd(const HvdFlashArgs* a, void* stream) {
  return dispatch(Kind::kFwd, a, stream);
}

int hvd_flash_bwd_dq(const HvdFlashArgs* a, void* stream) {
  return dispatch(Kind::kDq, a, stream);
}

int hvd_flash_bwd_dkv(const HvdFlashArgs* a, void* stream) {
  return dispatch(Kind::kDkv, a, stream);
}

}  // extern "C"
