// K6, K6' and K7: the ResNet elementwise joins, written by hand for Hopper
// (sm_90a), and K6's backward.
//
// Replaces the Pallas kernels of horovod_tpu/ops/elementwise.py:
//   K6   _scale_bias_relu_kernel (:105), launched by _affine_call
//        (pl.pallas_call at :118): out = relu(float(x) * scale + bias) per
//        channel, cast back to x's type (the norm+activation join of
//        models/resnet.py BatchNormReLU);
//   K6'  _relu_grad_kernel (:39), launched by _flat_call (:57):
//        dx = where(float(out) > 0, g, 0), the backward of K7;
//   K7   _residual_relu_kernel (:35), launched by the same _flat_call:
//        out = relu(x + y) in x's type (the block output's residual join);
//   K6's backward, the reference's _scale_bias_relu_bwd (:159): the mask
//        kernel K6' and a float32 jnp tail that XLA fuses (dx = gm * scale,
//        dscale = sum gm * x, dbias = sum gm over the non-channel axes).
//        Here it is one pass over x, out and g that writes dx and each
//        block's channel sums, then a second pass that adds the blocks'
//        sums in a fixed order.
//
// The operands are channels-last tensors seen as a contiguous [rows, C]
// (the port's NCHW activations are views of NHWC memory, so the wrapper
// hands x.permute(0, 2, 3, 1) over with no copy); K6' and K7 treat them as
// flat.  float32 and bfloat16 are instances; the wrapper raises on any
// other type.
//
// Arithmetic.  Each kernel rounds where the Pallas body (and the plain
// PyTorch version beside the wrapper) rounds, so the two are bit-equal:
// K7 adds in float and rounds the sum once to x's type, then takes the max
// with 0; K6 computes float(x) * s, rounded, then + b, rounded (the library
// is built with --fmad=false, so nvcc does not contract the two into an
// FMA), then the max with 0, then the cast; K6' compares float(out) > 0;
// K6's backward takes gm = float(out) > 0 ? g : 0 and writes dx =
// T(float(gm) * s), the float32 product rounded once more to T.  relu is
// written as v < 0 ? 0 : v so that a NaN passes through as jnp.maximum and
// torch.clamp_min pass it.  dscale and dbias are float32 sums of the same
// float32 terms as the plain version's, in another order: close to it, not
// bit-equal; but the order is fixed by the shape and the card alone (no
// atomics), so two calls, or a graph's replay and the eager call, give the
// same bits.
//
// Bound.  Each does a few flops an element and is bound by device memory:
// K7 and K6' read two tensors and write one (3 x 2 B an element in bf16),
// K6 reads one and writes one (2 x 2 B; scale and bias are C floats each,
// read from cache), K6's backward reads three and writes one (4 x 2 B).  At
// ResNet-50's largest residual join, [128, 56, 56, 256] bf16 (102.8 M
// elements), K7 and K6' move 616.6 MB, >= 0.184 ms at 3.35 TB/s (H100 SXM
// data sheet); K6's 20 joins a step hold 369.3 M elements, >= 0.441 ms a
// step forward and >= 0.882 ms backward.  What that bound calls for is one
// pass with 16-byte loads and stores (8 bf16 or 4 float32 a thread), several
// in flight a thread, enough blocks to cover memory latency, and nothing per
// element but the arithmetic.
//
// The loops.
//   flat_binary: one 16-byte pack a thread an iteration of a grid-stride
//     loop, on a grid capped at kBlocksPerSM blocks an SM.  K6 ran on it
//     with a 64-bit (i * N) % c and 2N scalar loads of scale and bias a
//     pack; it stays as K6's route for any C the channel loop cannot take
//     (C not a multiple of the pack, a block that is not a whole number of
//     rows of packs, a misaligned operand), bit for bit as before, and as
//     K7's and K6''s old loop, to be timed beside the new ones.
//   stream (K6' and K7): block b takes packs [b R, (b + 1) R),
//     R = THREADS x PACKS, thread t the t-th, (t + THREADS)-th, ... of
//     them, all loaded before any is used, so that a warp's loads are
//     contiguous; a block for each round, no cap; then the scalar tail.
//   channel (K6 and its backward): the stream loop where a block is a
//     whole number of rows of packs (THREADS a multiple of C / N), so a
//     thread's packs all start at channel (t mod C/N) N.  The thread loads
//     its N scale and bias values once, as 16-byte loads, into registers,
//     and does no division in the loop.
// The kernels of these loops are templates of their block; the library
// launches one block each (kJoin*, kReluGrad*, kBwd* below), chosen by a
// sweep over the path's and serving's shapes (scripts/elementwise_sweep.py,
// which builds the other blocks from this file), and kernels.py mirrors
// them in elementwise_plan.
//
// K6's backward on the channel loop runs G blocks (the caller's, from
// elementwise_plan: it sizes the scratch) over the rounds, interleaved;
// each thread keeps its pack's 2N sums in registers, the threads of one
// channel pack add theirs through shared memory in thread order, and block
// b writes row b of a [2, G, C] float32 scratch; the second pass (after
// hvd_conv_stats_reduce_kernel) adds the G rows of each channel in a fixed
// order.  Any other C takes the general route of the same backward: block
// b over a contiguous range of rows, a thread a channel, then the same
// second pass.
//
// Each launch function returns cudaGetLastError() (0 on success); the
// Python wrapper raises on anything else.  Nothing here allocates or
// synchronizes; the caller passes its current stream and the scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;    // flat_binary's block
constexpr int kBlocksPerSM = 8;  // flat_binary's grid cap
// the blocks the library launches (kernels.py's EW_* mirror them):
// threads, and 16-byte packs a thread
constexpr int kReluGradThreads = 256, kReluGradPacks = 2;  // K6'
constexpr int kJoinThreads = 128, kJoinPacks = 2;          // K6, K7
constexpr int kBwdThreads = 256, kBwdPacks = 4;  // K6's backward, channel
constexpr int kBwdGeneralThreads = 128;          // its general route

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// jnp.maximum(v, 0) with NaN passed through
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

template <typename T>
struct ResidualRelu {
  __device__ __forceinline__ T operator()(T x, T y) const {
    const T sum = from_f<T>(to_f(x) + to_f(y));  // one rounding to T
    return to_f(sum) < 0.f ? from_f<T>(0.f) : sum;
  }
};

template <typename T>
struct ReluGrad {
  __device__ __forceinline__ T operator()(T out, T g) const {
    return to_f(out) > 0.f ? g : from_f<T>(0.f);
  }
};

// o = op(a, b) over n elements: n_vec 16-byte packs from the start (0 when
// an operand is misaligned), then the scalar tail.
template <typename T, typename Op>
__device__ __forceinline__ void flat_binary(const T* __restrict__ a,
                                            const T* __restrict__ b,
                                            T* __restrict__ o, int64_t n,
                                            int64_t n_vec, Op op) {
  constexpr int N = 16 / sizeof(T);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t start =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t i = start; i < n_vec; i += stride) {
    const uint4 va = reinterpret_cast<const uint4*>(a)[i];
    const uint4 vb = reinterpret_cast<const uint4*>(b)[i];
    uint4 vo;
    const T* ea = reinterpret_cast<const T*>(&va);
    const T* eb = reinterpret_cast<const T*>(&vb);
    T* eo = reinterpret_cast<T*>(&vo);
#pragma unroll
    for (int k = 0; k < N; ++k) eo[k] = op(ea[k], eb[k]);
    reinterpret_cast<uint4*>(o)[i] = vo;
  }
  for (int64_t i = n_vec * N + start; i < n; i += stride) o[i] = op(a[i], b[i]);
}

// o = op(a, b) on the stream loop: block b takes packs [b R, (b + 1) R),
// R = THREADS PACKS, thread t the t-th, (t + THREADS)-th, ... of them, all
// loaded before any is used; then the scalar tail, one element a thread.
// The launch gives a block for each round of packs, or for each THREADS
// elements when there are no packs, so that neither part needs a loop.
template <typename T, int THREADS, int PACKS, typename Op>
__device__ __forceinline__ void stream_binary(const T* __restrict__ a,
                                              const T* __restrict__ b,
                                              T* __restrict__ o, int64_t n,
                                              int64_t n_vec, Op op) {
  constexpr int N = 16 / sizeof(T);
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * THREADS * PACKS + threadIdx.x;
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  const uint4* b4 = reinterpret_cast<const uint4*>(b);
  uint4 va[PACKS], vb[PACKS];
#pragma unroll
  for (int k = 0; k < PACKS; ++k) {
    const int64_t i = base + k * THREADS;
    if (i < n_vec) {
      va[k] = a4[i];
      vb[k] = b4[i];
    }
  }
#pragma unroll
  for (int k = 0; k < PACKS; ++k) {
    const int64_t i = base + k * THREADS;
    if (i < n_vec) {
      uint4 vo;
      const T* ea = reinterpret_cast<const T*>(&va[k]);
      const T* eb = reinterpret_cast<const T*>(&vb[k]);
      T* eo = reinterpret_cast<T*>(&vo);
#pragma unroll
      for (int e = 0; e < N; ++e) eo[e] = op(ea[e], eb[e]);
      reinterpret_cast<uint4*>(o)[i] = vo;
    }
  }
  const int64_t i =
      n_vec * N + static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i < n) o[i] = op(a[i], b[i]);
}

// K7 on flat_binary's loop (timed beside its own)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    hvd_residual_relu_kernel(const T* __restrict__ x, const T* __restrict__ y,
                             T* __restrict__ out, int64_t n, int64_t n_vec) {
  flat_binary<T>(x, y, out, n, n_vec, ResidualRelu<T>());
}

// K7 on the stream loop
template <typename T, int THREADS, int PACKS>
__global__ void __launch_bounds__(THREADS)
    hvd_residual_relu_stream_kernel(const T* __restrict__ x,
                                    const T* __restrict__ y,
                                    T* __restrict__ out, int64_t n,
                                    int64_t n_vec) {
  stream_binary<T, THREADS, PACKS>(x, y, out, n, n_vec, ResidualRelu<T>());
}

// K6' on flat_binary's loop (timed beside its own)
template <typename T>
__global__ void __launch_bounds__(kThreads)
    hvd_relu_grad_kernel(const T* __restrict__ out, const T* __restrict__ g,
                         T* __restrict__ dx, int64_t n, int64_t n_vec) {
  flat_binary<T>(out, g, dx, n, n_vec, ReluGrad<T>());
}

// K6' on its own loop: the stream loop at its block
template <typename T>
__global__ void __launch_bounds__(kReluGradThreads)
    hvd_relu_grad_stream_kernel(const T* __restrict__ out,
                                const T* __restrict__ g, T* __restrict__ dx,
                                int64_t n, int64_t n_vec) {
  stream_binary<T, kReluGradThreads, kReluGradPacks>(out, g, dx, n, n_vec,
                                                     ReluGrad<T>());
}

template <typename T>
__device__ __forceinline__ T affine_relu(T x, float s, float b) {
  const float v = to_f(x) * s + b;  // two roundings: built with --fmad=false
  return from_f<T>(relu(v));
}

// K6 over [rows, c] on flat_binary's loop: n_vec 16-byte packs (0 unless
// every pack lies in one row, i.e. c is a multiple of the pack, and the
// operands are aligned), then the scalar elements.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    hvd_scale_bias_relu_kernel(const T* __restrict__ x,
                               const float* __restrict__ scale,
                               const float* __restrict__ bias,
                               T* __restrict__ out, int64_t n, int64_t c,
                               int64_t n_vec) {
  constexpr int N = 16 / sizeof(T);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t start =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t i = start; i < n_vec; i += stride) {
    const int64_t ch = (i * N) % c;
    const uint4 vx = reinterpret_cast<const uint4*>(x)[i];
    uint4 vo;
    const T* ex = reinterpret_cast<const T*>(&vx);
    T* eo = reinterpret_cast<T*>(&vo);
#pragma unroll
    for (int k = 0; k < N; ++k)
      eo[k] = affine_relu(ex[k], __ldg(scale + ch + k), __ldg(bias + ch + k));
    reinterpret_cast<uint4*>(out)[i] = vo;
  }
  for (int64_t i = n_vec * N + start; i < n; i += stride) {
    const int64_t ch = i % c;
    out[i] = affine_relu(x[i], __ldg(scale + ch), __ldg(bias + ch));
  }
}

// the N floats of v from channel ch (a multiple of 4; v 16-byte aligned)
template <int N>
__device__ __forceinline__ void load_channels(const float* __restrict__ v,
                                              int ch, float (&r)[N]) {
#pragma unroll
  for (int k = 0; k < N; k += 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(v + ch + k));
    r[k] = q.x;
    r[k + 1] = q.y;
    r[k + 2] = q.z;
    r[k + 3] = q.w;
  }
}

// K6 on the channel loop: n_vec packs of [rows, c], c / N of them a row,
// THREADS a multiple of that, a block for each round of packs.
template <typename T, int THREADS, int PACKS>
__global__ void __launch_bounds__(THREADS)
    hvd_scale_bias_relu_chan_kernel(const T* __restrict__ x,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ bias,
                                    T* __restrict__ out, int64_t n_vec,
                                    int packs_a_row) {
  constexpr int N = 16 / sizeof(T);
  const int64_t base =
      static_cast<int64_t>(blockIdx.x) * THREADS * PACKS + threadIdx.x;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  uint4 vx[PACKS];
#pragma unroll
  for (int k = 0; k < PACKS; ++k) {
    const int64_t i = base + k * THREADS;
    if (i < n_vec) vx[k] = x4[i];
  }
  float s[N], b[N];
  const int ch = (static_cast<int>(threadIdx.x) % packs_a_row) * N;
  load_channels<N>(scale, ch, s);
  load_channels<N>(bias, ch, b);
#pragma unroll
  for (int k = 0; k < PACKS; ++k) {
    const int64_t i = base + k * THREADS;
    if (i < n_vec) {
      uint4 vo;
      const T* ex = reinterpret_cast<const T*>(&vx[k]);
      T* eo = reinterpret_cast<T*>(&vo);
#pragma unroll
      for (int e = 0; e < N; ++e) eo[e] = affine_relu(ex[e], s[e], b[e]);
      reinterpret_cast<uint4*>(out)[i] = vo;
    }
  }
}

// K6's backward on the channel loop: gridDim.x blocks over `rounds` rounds
// of packs, block b taking rounds b, b + gridDim.x, ...; each thread's 2N
// sums (dscale's, then dbias's) go to red[threadIdx.x], the threads of each
// channel pack are added in thread order, and block b writes
// partial[0][b][:] (dscale) and partial[1][b][:] (dbias).
template <typename T, int THREADS, int PACKS>
__global__ void __launch_bounds__(THREADS)
    hvd_scale_bias_relu_bwd_kernel(const T* __restrict__ x,
                                   const float* __restrict__ scale,
                                   const T* __restrict__ out,
                                   const T* __restrict__ g,
                                   T* __restrict__ dx,
                                   float* __restrict__ partial, int64_t n_vec,
                                   int c, int64_t rounds) {
  constexpr int N = 16 / sizeof(T);
  // [THREADS][2N], sized at launch (with a static array of that size the
  // kernel ran slower on an H100)
  extern __shared__ float red[];
  const int t = threadIdx.x;
  const int packs_a_row = c / N;
  float s[N], ds[N], db[N];
  load_channels<N>(scale, (t % packs_a_row) * N, s);
#pragma unroll
  for (int e = 0; e < N; ++e) ds[e] = db[e] = 0.f;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  const uint4* o4 = reinterpret_cast<const uint4*>(out);
  const uint4* g4 = reinterpret_cast<const uint4*>(g);
  for (int64_t r = blockIdx.x; r < rounds; r += gridDim.x) {
    const int64_t base = r * THREADS * PACKS + t;
    uint4 vx[PACKS], vo[PACKS], vg[PACKS];
#pragma unroll
    for (int k = 0; k < PACKS; ++k) {
      const int64_t i = base + k * THREADS;
      if (i < n_vec) {
        vx[k] = x4[i];
        vo[k] = o4[i];
        vg[k] = g4[i];
      }
    }
#pragma unroll
    for (int k = 0; k < PACKS; ++k) {
      const int64_t i = base + k * THREADS;
      if (i < n_vec) {
        uint4 vd;
        const T* ex = reinterpret_cast<const T*>(&vx[k]);
        const T* eo = reinterpret_cast<const T*>(&vo[k]);
        const T* eg = reinterpret_cast<const T*>(&vg[k]);
        T* ed = reinterpret_cast<T*>(&vd);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float gm = to_f(eo[e]) > 0.f ? to_f(eg[e]) : 0.f;
          ed[e] = from_f<T>(gm * s[e]);
          ds[e] += gm * to_f(ex[e]);
          db[e] += gm;
        }
        reinterpret_cast<uint4*>(dx)[i] = vd;
      }
    }
  }
  float* mine = red + t * 2 * N;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    mine[e] = ds[e];
    mine[N + e] = db[e];
  }
  __syncthreads();
  const int sharing = THREADS / packs_a_row;  // threads a channel pack
  for (int ch = t; ch < c; ch += THREADS) {
    const float* p = red + (ch / N) * 2 * N + ch % N;
    float a = 0.f, b = 0.f;
    for (int j = 0; j < sharing; ++j) {
      a += p[j * packs_a_row * 2 * N];
      b += p[j * packs_a_row * 2 * N + N];
    }
    partial[static_cast<int64_t>(blockIdx.x) * c + ch] = a;
    partial[static_cast<int64_t>(gridDim.x + blockIdx.x) * c + ch] = b;
  }
}

// K6's backward on the general route: block b over rows [b rpb, (b + 1)
// rpb), a thread a channel (c, c + blockDim.x, ...), element by element.
template <typename T>
__global__ void __launch_bounds__(kBwdGeneralThreads)
    hvd_scale_bias_relu_bwd_general_kernel(
        const T* __restrict__ x, const float* __restrict__ scale,
        const T* __restrict__ out, const T* __restrict__ g,
        T* __restrict__ dx, float* __restrict__ partial, int64_t rows,
        int64_t c, int64_t rows_per_block) {
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  for (int64_t ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const float s = scale[ch];
    float a = 0.f, b = 0.f;
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t i = r * c + ch;
      const float gm = to_f(out[i]) > 0.f ? to_f(g[i]) : 0.f;
      dx[i] = from_f<T>(gm * s);
      a += gm * to_f(x[i]);
      b += gm;
    }
    partial[static_cast<int64_t>(blockIdx.x) * c + ch] = a;
    partial[static_cast<int64_t>(gridDim.x + blockIdx.x) * c + ch] = b;
  }
}

// K6's backward, second pass: dscale[ch] and dbias[ch] over the blocks'
// rows of partial, thread (tx, ty) adding rows ty, ty + 32, ... of channel
// tx, then the 32 in order.
__global__ void __launch_bounds__(1024)
    hvd_scale_bias_relu_bwd_reduce_kernel(const float* __restrict__ partial,
                                          float* __restrict__ dscale,
                                          float* __restrict__ dbias,
                                          int64_t blocks, int64_t c) {
  __shared__ float red[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t ch = static_cast<int64_t>(blockIdx.x) * 32 + tx;
  const float* p = partial + blockIdx.y * blocks * c;
  float s = 0.f;
  if (ch < c)
    for (int64_t b = ty; b < blocks; b += 32) s += p[b * c + ch];
  red[ty][tx] = s;
  __syncthreads();
  if (ty != 0 || ch >= c) return;
  float total = 0.f;
  for (int i = 0; i < 32; ++i) total += red[i][tx];
  (blockIdx.y == 0 ? dscale : dbias)[ch] = total;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// Enough blocks to keep every SM at kBlocksPerSM resident blocks, fewer
// when the tensor is small; the grid-stride loop covers the rest.
cudaError_t grid_for(int64_t work, int* grid) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSM;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  *grid = static_cast<int>(blocks);
  return cudaSuccess;
}

// a block for each round of `per_block` units of work
cudaError_t rounds_grid(int64_t work, int64_t per_block, int* grid) {
  const int64_t blocks = (work + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  *grid = static_cast<int>(blocks < 1 ? 1 : blocks);
  return cudaSuccess;
}

enum class Flat { kResidualRelu, kReluGrad };

template <typename T>
cudaError_t launch_flat(Flat kind, const void* a, const void* b, void* o,
                        int64_t n, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const int64_t n_vec =
      aligned16(a) && aligned16(b) && aligned16(o) ? n / N : 0;
  int grid = 0;
  cudaError_t err = grid_for(n_vec > 0 ? n_vec : n, &grid);
  if (err != cudaSuccess) return err;
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  T* to = static_cast<T*>(o);
  if (kind == Flat::kResidualRelu)
    hvd_residual_relu_kernel<T><<<grid, kThreads, 0, stream>>>(ta, tb, to, n,
                                                               n_vec);
  else
    hvd_relu_grad_kernel<T><<<grid, kThreads, 0, stream>>>(ta, tb, to, n,
                                                           n_vec);
  return cudaGetLastError();
}

// the stream loop's grid: a block for each round of THREADS x PACKS packs,
// or for each THREADS elements when an operand is misaligned (n_vec 0); a
// tail of fewer than N elements after the packs falls to block 0
template <int THREADS, int PACKS>
cudaError_t stream_grid(int64_t n, int64_t n_vec, int* grid) {
  return n_vec > 0 ? rounds_grid(n_vec, THREADS * PACKS, grid)
                   : rounds_grid(n, THREADS, grid);
}

// K7 on the stream loop at THREADS x PACKS
template <typename T, int THREADS, int PACKS>
cudaError_t launch_residual_stream(const void* x, const void* y, void* out,
                                   int64_t n, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const int64_t n_vec =
      aligned16(x) && aligned16(y) && aligned16(out) ? n / N : 0;
  int grid = 0;
  cudaError_t err = stream_grid<THREADS, PACKS>(n, n_vec, &grid);
  if (err != cudaSuccess) return err;
  hvd_residual_relu_stream_kernel<T, THREADS, PACKS>
      <<<grid, THREADS, 0, stream>>>(static_cast<const T*>(x),
                                     static_cast<const T*>(y),
                                     static_cast<T*>(out), n, n_vec);
  return cudaGetLastError();
}

// K6' on its own loop
template <typename T>
cudaError_t launch_relu_grad_stream(const void* out, const void* g, void* dx,
                                    int64_t n, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const int64_t n_vec =
      aligned16(out) && aligned16(g) && aligned16(dx) ? n / N : 0;
  int grid = 0;
  cudaError_t err =
      stream_grid<kReluGradThreads, kReluGradPacks>(n, n_vec, &grid);
  if (err != cudaSuccess) return err;
  hvd_relu_grad_stream_kernel<T><<<grid, kReluGradThreads, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(g),
      static_cast<T*>(dx), n, n_vec);
  return cudaGetLastError();
}

// whether K6 (and its backward) can run [rows, c] on the channel loop at
// `threads`: whole packs a row, a whole number of rows of packs a block,
// and every operand 16-byte aligned
template <typename T>
bool channel_fits(int64_t c, int threads,
                  std::initializer_list<const void*> ptrs) {
  constexpr int N = 16 / sizeof(T);
  if (c <= 0 || c % N != 0 || threads % (c / N) != 0) return false;
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

template <typename T>
cudaError_t launch_affine_flat(const void* x, const float* scale,
                               const float* bias, void* out, int64_t rows,
                               int64_t c, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const int64_t n = rows * c;
  const int64_t n_vec =
      c % N == 0 && aligned16(x) && aligned16(out) ? n / N : 0;
  int grid = 0;
  cudaError_t err = grid_for(n_vec > 0 ? n_vec : n, &grid);
  if (err != cudaSuccess) return err;
  hvd_scale_bias_relu_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(out), n, c,
      n_vec);
  return cudaGetLastError();
}

// K6 on the channel loop at THREADS x PACKS; invalid where it cannot run
template <typename T, int THREADS, int PACKS>
cudaError_t launch_affine_channel(const void* x, const float* scale,
                                  const float* bias, void* out, int64_t rows,
                                  int64_t c, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  if (!channel_fits<T>(c, THREADS, {x, out, scale, bias}))
    return cudaErrorInvalidValue;
  const int64_t n_vec = rows * c / N;
  int grid = 0;
  cudaError_t err = rounds_grid(n_vec, THREADS * PACKS, &grid);
  if (err != cudaSuccess) return err;
  hvd_scale_bias_relu_chan_kernel<T, THREADS, PACKS>
      <<<grid, THREADS, 0, stream>>>(static_cast<const T*>(x), scale, bias,
                                     static_cast<T*>(out), n_vec,
                                     static_cast<int>(c / N));
  return cudaGetLastError();
}

// K6's backward on `blocks` blocks: the channel loop at THREADS x PACKS,
// or (general) the general route; then the second pass
template <typename T, int THREADS, int PACKS>
cudaError_t launch_affine_bwd(const void* x, const float* scale,
                              const void* out, const void* g, void* dx,
                              float* partial, float* dscale, float* dbias,
                              int64_t rows, int64_t c, bool general,
                              int32_t blocks, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  if (blocks < 1) return cudaErrorInvalidValue;
  const T* tx = static_cast<const T*>(x);
  const T* tout = static_cast<const T*>(out);
  const T* tg = static_cast<const T*>(g);
  T* tdx = static_cast<T*>(dx);
  if (general) {
    const int64_t rows_per_block = (rows + blocks - 1) / blocks;
    hvd_scale_bias_relu_bwd_general_kernel<T>
        <<<blocks, kBwdGeneralThreads, 0, stream>>>(
            tx, scale, tout, tg, tdx, partial, rows, c, rows_per_block);
  } else {
    if (!channel_fits<T>(c, THREADS, {x, out, g, dx, scale}))
      return cudaErrorInvalidValue;
    const int64_t n_vec = rows * c / N;
    const int64_t rounds = (n_vec + THREADS * PACKS - 1) / (THREADS * PACKS);
    const size_t smem = THREADS * 2 * N * sizeof(float);
    hvd_scale_bias_relu_bwd_kernel<T, THREADS, PACKS>
        <<<blocks, THREADS, smem, stream>>>(tx, scale, tout, tg, tdx, partial,
                                            n_vec, static_cast<int>(c),
                                            rounds);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((c + 31) / 32), 2);
  hvd_scale_bias_relu_bwd_reduce_kernel<<<grid, dim3(32, 32), 0, stream>>>(
      partial, dscale, dbias, blocks, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  flat_loop: 0 the stream loop, 1
// flat_binary's (launch_residual_stream, launch_flat)
int hvd_residual_relu(const void* x, const void* y, void* out, int64_t n,
                      int32_t dtype, int32_t flat_loop, void* stream) {
  if (n <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return flat_loop
               ? launch_flat<float>(Flat::kResidualRelu, x, y, out, n, st)
               : launch_residual_stream<float, kJoinThreads, kJoinPacks>(
                     x, y, out, n, st);
  if (dtype == 1)
    return flat_loop
               ? launch_flat<bf16>(Flat::kResidualRelu, x, y, out, n, st)
               : launch_residual_stream<bf16, kJoinThreads, kJoinPacks>(
                     x, y, out, n, st);
  return cudaErrorInvalidValue;
}

// flat_loop: 0 for K6''s own loop, 1 for flat_binary's
int hvd_relu_grad(const void* out, const void* g, void* dx, int64_t n,
                  int32_t dtype, int32_t flat_loop, void* stream) {
  if (n <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return flat_loop ? launch_flat<float>(Flat::kReluGrad, out, g, dx, n, st)
                     : launch_relu_grad_stream<float>(out, g, dx, n, st);
  if (dtype == 1)
    return flat_loop ? launch_flat<bf16>(Flat::kReluGrad, out, g, dx, n, st)
                     : launch_relu_grad_stream<bf16>(out, g, dx, n, st);
  return cudaErrorInvalidValue;
}

// flat_loop: 0 the channel loop (invalid where it cannot run), 1
// flat_binary's
int hvd_scale_bias_relu(const void* x, const float* scale, const float* bias,
                        void* out, int64_t rows, int64_t c, int32_t dtype,
                        int32_t flat_loop, void* stream) {
  if (rows <= 0 || c <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return flat_loop
               ? launch_affine_flat<float>(x, scale, bias, out, rows, c, st)
               : launch_affine_channel<float, kJoinThreads, kJoinPacks>(
                     x, scale, bias, out, rows, c, st);
  if (dtype == 1)
    return flat_loop
               ? launch_affine_flat<bf16>(x, scale, bias, out, rows, c, st)
               : launch_affine_channel<bf16, kJoinThreads, kJoinPacks>(
                     x, scale, bias, out, rows, c, st);
  return cudaErrorInvalidValue;
}

// K6's backward: dx, and dscale / dbias through partial ([2, blocks, c]
// float32).  general: 0 the channel loop, 1 the general route; `blocks`
// blocks either way, then the second pass.
int hvd_scale_bias_relu_bwd(const void* x, const float* scale,
                            const void* out, const void* g, void* dx,
                            float* partial, float* dscale, float* dbias,
                            int64_t rows, int64_t c, int32_t dtype,
                            int32_t general, int32_t blocks, void* stream) {
  if (rows <= 0 || c <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_affine_bwd<float, kBwdThreads, kBwdPacks>(
        x, scale, out, g, dx, partial, dscale, dbias, rows, c, general != 0,
        blocks, st);
  if (dtype == 1)
    return launch_affine_bwd<bf16, kBwdThreads, kBwdPacks>(
        x, scale, out, g, dx, partial, dscale, dbias, rows, c, general != 0,
        blocks, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
