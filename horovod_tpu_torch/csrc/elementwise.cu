// K6, K6' and K7: the ResNet elementwise joins, written by hand for Hopper
// (sm_90a).
//
// Replaces the Pallas kernels of horovod_tpu/ops/elementwise.py:
//   K6   _scale_bias_relu_kernel (:105), launched by _affine_call
//        (pl.pallas_call at :118): out = relu(float(x) * scale + bias) per
//        channel, cast back to x's type (the norm+activation join of
//        models/resnet.py BatchNormReLU);
//   K6'  _relu_grad_kernel (:39), launched by _flat_call (:57):
//        dx = where(float(out) > 0, g, 0), the backward of K6 and K7;
//   K7   _residual_relu_kernel (:35), launched by the same _flat_call:
//        out = relu(x + y) in x's type (the block output's residual join).
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
// FMA), then the max with 0, then the cast; K6' compares float(out) > 0.
// relu is written as v < 0 ? 0 : v so that a NaN passes through as
// jnp.maximum and torch.clamp_min pass it.
//
// Bound.  Each does one or two flops an element and is bound by device
// memory: K7 and K6' read two tensors and write one (3 x 2 B an element in
// bf16), K6 reads one and writes one (2 x 2 B; scale and bias are C floats
// each, read from cache).  At ResNet-50's largest join, [128, 56, 56, 256]
// bf16 (102.8 M elements), K7 and K6' move 616.6 MB, >= 0.184 ms at
// 3.35 TB/s (H100 SXM data sheet), and K6 411.0 MB, >= 0.123 ms.  What
// that bound calls for is one pass with 16-byte loads and stores (8 bf16
// or 4 float32 a thread an iteration), enough blocks in flight on every SM
// to cover memory latency, and no scratch: that is these kernels.  The
// TPU's [block_rows, C] blocking and its 2 MB VMEM budget are gone; a
// ragged end, a misaligned operand or (K6) a channel count that does not
// divide into 16-byte packs takes the scalar loop, masked by the element
// count.
//
// Each launch function returns cudaGetLastError() (0 on success); the
// Python wrapper raises on anything else.  Nothing here allocates or
// synchronizes; the caller passes its current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

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

// K7
template <typename T>
__global__ void __launch_bounds__(kThreads)
    hvd_residual_relu_kernel(const T* __restrict__ x, const T* __restrict__ y,
                             T* __restrict__ out, int64_t n, int64_t n_vec) {
  flat_binary<T>(x, y, out, n, n_vec, ResidualRelu<T>());
}

// K6'
template <typename T>
__global__ void __launch_bounds__(kThreads)
    hvd_relu_grad_kernel(const T* __restrict__ out, const T* __restrict__ g,
                         T* __restrict__ dx, int64_t n, int64_t n_vec) {
  flat_binary<T>(out, g, dx, n, n_vec, ReluGrad<T>());
}

template <typename T>
__device__ __forceinline__ T affine_relu(T x, float s, float b) {
  const float v = to_f(x) * s + b;  // two roundings: built with --fmad=false
  return from_f<T>(relu(v));
}

// K6 over [rows, c]: n_vec 16-byte packs (0 unless every pack lies in one
// row, i.e. c is a multiple of the pack, and the operands are aligned),
// then the scalar elements.
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

int flat(Flat kind, const void* a, const void* b, void* o, int64_t n,
         int32_t dtype, void* stream) {
  if (n <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_flat<float>(kind, a, b, o, n, st);
  if (dtype == 1) return launch_flat<bf16>(kind, a, b, o, n, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_affine(const void* x, const float* scale,
                          const float* bias, void* out, int64_t rows,
                          int64_t c, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const int64_t n = rows * c;
  const int64_t n_vec = c % N == 0 && aligned16(x) && aligned16(out) ? n / N
                                                                      : 0;
  int grid = 0;
  cudaError_t err = grid_for(n_vec > 0 ? n_vec : n, &grid);
  if (err != cudaSuccess) return err;
  hvd_scale_bias_relu_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(out), n, c,
      n_vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16
int hvd_residual_relu(const void* x, const void* y, void* out, int64_t n,
                      int32_t dtype, void* stream) {
  return flat(Flat::kResidualRelu, x, y, out, n, dtype, stream);
}

int hvd_relu_grad(const void* out, const void* g, void* dx, int64_t n,
                  int32_t dtype, void* stream) {
  return flat(Flat::kReluGrad, out, g, dx, n, dtype, stream);
}

int hvd_scale_bias_relu(const void* x, const float* scale, const float* bias,
                        void* out, int64_t rows, int64_t c, int32_t dtype,
                        void* stream) {
  if (rows <= 0 || c <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_affine<float>(x, scale, bias, out, rows, c, st);
  if (dtype == 1) return launch_affine<bf16>(x, scale, bias, out, rows, c, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
