// K1: the flat fused optimizer update, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernels of horovod_tpu/optim/fused_update.py:
// _sgd_kernel (:139), _momentum_kernel (:143) and _adam_kernel (:149),
// launched by _pallas_elementwise (:170, pl.pallas_call at :192) once per
// dtype group over [rows, 128] blocks.  Here each rule is one grid-stride
// pass over one dtype group's flat buffers (float32 or bfloat16),
// updating p and the moments in place:
//
//   sgd       p = p + (-lr) * g
//   momentum  t = m * t + g;            p = p + (-lr) * t
//   adam      mu = (1-b1) * g + b1 * mu;  nu = (1-b2) * (g*g) + b2 * nu
//             p = p + (-lr) * ((mu * inv_bc1) / (sqrt(nu * inv_bc2) + eps))
//
// Adam's bias corrections inv_bc1 = 1 / (1 - b1^count) and inv_bc2 change
// every step, so they are not launch arguments: the step writes them on
// the device into a 2-float buffer (bc), from the device step count, and
// every thread loads the pair once before its loop, as the Pallas kernel
// reads them from its bc_ref row.  A launch captured into a CUDA graph
// therefore stays right on every replay.
//
// in the expression order of _sgd_update / _momentum_update / _adam_update
// (:120-135).  The library is built with --fmad=false, so nvcc does not
// contract m * t + g into an FMA.  Every operation is computed in float32
// and rounded to the group's type right after it (rnd<T> below: a no-op
// for float32, round-to-nearest-even for bfloat16), which is where
// PyTorch rounds each operation of the plain version on a bf16 tensor; so
// each kernel is bit-equal to the plain version of optim/fused_update.py
// in both types.
//
// Bound.  The update does a handful of flops per element and is bound by
// device memory.  Per element it moves, each once: sgd 3 elements (read
// p, g; write p), momentum 5 (read p, g, t; write p, t), adam 7 (read p,
// g, mu, nu; write p, mu, nu), of 4 bytes in float32 and 2 in bfloat16.
// At ResNet-50's 25,557,032 float32 parameters (161 leaves, one dtype
// group) momentum moves 511 MB a step: >= 0.153 ms at 3.35 TB/s (H100 SXM
// data sheet); sgd >= 0.092 ms, adam >= 0.214 ms; a bfloat16 group moves
// half.  What that bound calls for is a single pass with 16-byte loads and
// stores (4 float32 or 8 bfloat16 values), enough blocks in flight on
// every SM to cover memory latency, and no scratch: that is this kernel.
// The TPU's padding to 128 lanes is gone; the ragged end is a scalar tail
// the kernel masks itself.  Fusing the gradient-bucket unpack into the
// update is later work.
//
// Each launch function returns cudaGetLastError() (0 on success); the
// Python wrapper raises on anything else.  Nothing here allocates or
// synchronizes; the caller passes its current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

struct AdamArgs {
  float lr, b1, b2, eps, one_minus_b1, one_minus_b2;
};

// One operation's result rounded to the buffer's type.
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

template <typename T>
__device__ __forceinline__ void sgd_math(float& p, float g, float lr) {
  p = rnd<T>(p + rnd<T>((-lr) * g));
}

template <typename T>
__device__ __forceinline__ void momentum_math(float& p, float g, float& t,
                                              float lr, float m) {
  t = rnd<T>(rnd<T>(m * t) + g);
  p = rnd<T>(p + rnd<T>((-lr) * t));
}

template <typename T>
__device__ __forceinline__ void adam_math(float& p, float g, float& mu,
                                          float& nu, const AdamArgs& a,
                                          float inv_bc1, float inv_bc2) {
  mu = rnd<T>(rnd<T>(a.one_minus_b1 * g) + rnd<T>(a.b1 * mu));
  nu = rnd<T>(rnd<T>(a.one_minus_b2 * rnd<T>(g * g)) + rnd<T>(a.b2 * nu));
  const float den = rnd<T>(rnd<T>(sqrtf(rnd<T>(nu * inv_bc2))) + a.eps);
  const float step = rnd<T>(rnd<T>(mu * inv_bc1) / den);
  p = rnd<T>(p + rnd<T>((-a.lr) * step));
}

// 16 bytes of T: 4 float32 or 8 bfloat16 values, unpacked to float32.
template <typename T>
struct Pack {
  static constexpr int kN = 16 / sizeof(T);
  float v[kN];

  __device__ __forceinline__ void load(const T* base, int64_t i) {
    const uint4 raw = reinterpret_cast<const uint4*>(base)[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] = to_f(e[k]);
  }

  __device__ __forceinline__ void store(T* base, int64_t i) const {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < kN; ++k) e[k] = from_f<T>(v[k]);
    reinterpret_cast<uint4*>(base)[i] = raw;
  }
};

// n_vec 16-byte packs from the start, then the scalar tail
// [n_vec * Pack<T>::kN, n).  n_vec is 0 when any base pointer is not
// 16-byte aligned.
template <typename T>
__global__ void sgd_kernel(T* __restrict__ p, const T* __restrict__ g,
                           int64_t n, int64_t n_vec, float lr) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  for (int64_t i = start; i < n_vec; i += stride) {
    Pack<T> pv, gv;
    pv.load(p, i);
    gv.load(g, i);
#pragma unroll
    for (int k = 0; k < Pack<T>::kN; ++k) sgd_math<T>(pv.v[k], gv.v[k], lr);
    pv.store(p, i);
  }
  for (int64_t i = Pack<T>::kN * n_vec + start; i < n; i += stride) {
    float pv = to_f(p[i]);
    sgd_math<T>(pv, to_f(g[i]), lr);
    p[i] = from_f<T>(pv);
  }
}

template <typename T>
__global__ void momentum_kernel(T* __restrict__ p, const T* __restrict__ g,
                                T* __restrict__ t, int64_t n, int64_t n_vec,
                                float lr, float m) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  for (int64_t i = start; i < n_vec; i += stride) {
    Pack<T> pv, gv, tv;
    pv.load(p, i);
    gv.load(g, i);
    tv.load(t, i);
#pragma unroll
    for (int k = 0; k < Pack<T>::kN; ++k)
      momentum_math<T>(pv.v[k], gv.v[k], tv.v[k], lr, m);
    tv.store(t, i);
    pv.store(p, i);
  }
  for (int64_t i = Pack<T>::kN * n_vec + start; i < n; i += stride) {
    float pv = to_f(p[i]);
    float tv = to_f(t[i]);
    momentum_math<T>(pv, to_f(g[i]), tv, lr, m);
    t[i] = from_f<T>(tv);
    p[i] = from_f<T>(pv);
  }
}

template <typename T>
__global__ void adam_kernel(T* __restrict__ p, const T* __restrict__ g,
                            T* __restrict__ mu, T* __restrict__ nu, int64_t n,
                            int64_t n_vec, AdamArgs a,
                            const float* __restrict__ bc) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const float inv_bc1 = bc[0];
  const float inv_bc2 = bc[1];
  for (int64_t i = start; i < n_vec; i += stride) {
    Pack<T> pv, gv, mv, vv;
    pv.load(p, i);
    gv.load(g, i);
    mv.load(mu, i);
    vv.load(nu, i);
#pragma unroll
    for (int k = 0; k < Pack<T>::kN; ++k)
      adam_math<T>(pv.v[k], gv.v[k], mv.v[k], vv.v[k], a, inv_bc1, inv_bc2);
    mv.store(mu, i);
    vv.store(nu, i);
    pv.store(p, i);
  }
  for (int64_t i = Pack<T>::kN * n_vec + start; i < n; i += stride) {
    float pv = to_f(p[i]);
    float mv = to_f(mu[i]);
    float vv = to_f(nu[i]);
    adam_math<T>(pv, to_f(g[i]), mv, vv, a, inv_bc1, inv_bc2);
    mu[i] = from_f<T>(mv);
    nu[i] = from_f<T>(vv);
    p[i] = from_f<T>(pv);
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// Enough blocks to keep every SM at kBlocksPerSM resident blocks, fewer
// when the buffer is small; the grid-stride loop covers the rest.
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

// Packs of the vector loop: 0 unless every buffer is 16-byte aligned.
template <typename T>
int64_t packs(int64_t n, std::initializer_list<const void*> bufs) {
  for (const void* b : bufs)
    if (!aligned16(b)) return 0;
  return n / Pack<T>::kN;
}

template <typename T>
int sgd(void* p, const void* g, int64_t n, float lr, cudaStream_t st) {
  const int64_t n_vec = packs<T>(n, {p, g});
  int grid = 0;
  cudaError_t err = grid_for(n_vec > 0 ? n_vec : n, &grid);
  if (err != cudaSuccess) return err;
  sgd_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<T*>(p), static_cast<const T*>(g), n, n_vec, lr);
  return cudaGetLastError();
}

template <typename T>
int momentum(void* p, const void* g, void* t, int64_t n, float lr, float m,
             cudaStream_t st) {
  const int64_t n_vec = packs<T>(n, {p, g, t});
  int grid = 0;
  cudaError_t err = grid_for(n_vec > 0 ? n_vec : n, &grid);
  if (err != cudaSuccess) return err;
  momentum_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<T*>(p), static_cast<const T*>(g), static_cast<T*>(t), n,
      n_vec, lr, m);
  return cudaGetLastError();
}

template <typename T>
int adam(void* p, const void* g, void* mu, void* nu, int64_t n,
         const AdamArgs& a, const float* bc, cudaStream_t st) {
  const int64_t n_vec = packs<T>(n, {p, g, mu, nu});
  int grid = 0;
  cudaError_t err = grid_for(n_vec > 0 ? n_vec : n, &grid);
  if (err != cudaSuccess) return err;
  adam_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<T*>(p), static_cast<const T*>(g), static_cast<T*>(mu),
      static_cast<T*>(nu), n, n_vec, a, bc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (kernels.py's _DTYPES); every buffer of a
// launch has that type.

int hvd_sgd(void* p, const void* g, int64_t n, float lr, int32_t dtype,
            void* stream) {
  if (n <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return sgd<float>(p, g, n, lr, st);
  if (dtype == 1) return sgd<bf16>(p, g, n, lr, st);
  return cudaErrorInvalidValue;
}

int hvd_momentum(void* p, const void* g, void* t, int64_t n, float lr,
                 float m, int32_t dtype, void* stream) {
  if (n <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return momentum<float>(p, g, t, n, lr, m, st);
  if (dtype == 1) return momentum<bf16>(p, g, t, n, lr, m, st);
  return cudaErrorInvalidValue;
}

// bc: [inv_bc1, inv_bc2] as float32 on the device, each already rounded to
// the group's type.
int hvd_adam(void* p, const void* g, void* mu, void* nu, int64_t n, float lr,
             float b1, float b2, float eps, float one_minus_b1,
             float one_minus_b2, const float* bc, int32_t dtype,
             void* stream) {
  if (n <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const AdamArgs a{lr, b1, b2, eps, one_minus_b1, one_minus_b2};
  if (dtype == 0) return adam<float>(p, g, mu, nu, n, a, bc, st);
  if (dtype == 1) return adam<bf16>(p, g, mu, nu, n, a, bc, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
