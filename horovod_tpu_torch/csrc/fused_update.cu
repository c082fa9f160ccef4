// K1: the flat fused optimizer update, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernels of horovod_tpu/optim/fused_update.py:
// _sgd_kernel (:139), _momentum_kernel (:143) and _adam_kernel (:149),
// launched by _pallas_elementwise (:170, pl.pallas_call at :192) once per
// dtype group over [rows, 128] blocks.  Here each rule is one grid-stride
// pass over the flat float32 buffers, updating p and the moments in place:
//
//   sgd       p = p + (-lr) * g
//   momentum  t = m * t + g;            p = p + (-lr) * t
//   adam      mu = (1-b1) * g + b1 * mu;  nu = (1-b2) * (g*g) + b2 * nu
//             p = p + (-lr) * ((mu * inv_bc1) / (sqrt(nu * inv_bc2) + eps))
//
// in the expression order of _sgd_update / _momentum_update / _adam_update
// (:120-135).  The library is built with --fmad=false, so nvcc does not
// contract m * t + g into an FMA and each kernel rounds exactly as the
// plain PyTorch version of optim/fused_update.py does.
//
// Bound.  The update does a handful of flops per element and is bound by
// device memory.  Per element it moves, each once: sgd 3 x 4 B (read p, g;
// write p), momentum 5 x 4 B (read p, g, t; write p, t), adam 7 x 4 B
// (read p, g, mu, nu; write p, mu, nu).  At ResNet-50's 25,557,032 float32
// parameters (161 leaves, one dtype group) momentum moves 511 MB a step:
// >= 0.153 ms at 3.35 TB/s (H100 SXM data sheet); sgd >= 0.092 ms, adam
// >= 0.214 ms.  What that bound calls for is a single pass with 16-byte
// loads and stores, enough blocks in flight on every SM to cover memory
// latency, and no scratch: that is this kernel.  The TPU's padding to 128
// lanes is gone; the ragged end is a scalar tail the kernel masks itself.
// Fusing the gradient-bucket unpack into the update is later work.
//
// Each launch function returns cudaGetLastError() (0 on success); the
// Python wrapper raises on anything else.  Nothing here allocates or
// synchronizes; the caller passes its current stream.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

struct AdamArgs {
  float lr, b1, b2, eps, one_minus_b1, one_minus_b2, inv_bc1, inv_bc2;
};

__device__ __forceinline__ void sgd_math(float& p, float g, float lr) {
  p = p + (-lr) * g;
}

__device__ __forceinline__ void momentum_math(float& p, float g, float& t,
                                              float lr, float m) {
  t = m * t + g;
  p = p + (-lr) * t;
}

__device__ __forceinline__ void adam_math(float& p, float g, float& mu,
                                          float& nu, const AdamArgs& a) {
  mu = a.one_minus_b1 * g + a.b1 * mu;
  nu = a.one_minus_b2 * (g * g) + a.b2 * nu;
  const float step = (mu * a.inv_bc1) / (sqrtf(nu * a.inv_bc2) + a.eps);
  p = p + (-a.lr) * step;
}

// n_vec float4 groups from the start, then the scalar tail [4*n_vec, n).
// n_vec is 0 when any base pointer is not 16-byte aligned.
__global__ void sgd_kernel(float* __restrict__ p, const float* __restrict__ g,
                           int64_t n, int64_t n_vec, float lr) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (int64_t i = start; i < n_vec; i += stride) {
    float4 pv = p4[i];
    const float4 gv = g4[i];
    sgd_math(pv.x, gv.x, lr);
    sgd_math(pv.y, gv.y, lr);
    sgd_math(pv.z, gv.z, lr);
    sgd_math(pv.w, gv.w, lr);
    p4[i] = pv;
  }
  for (int64_t i = 4 * n_vec + start; i < n; i += stride) {
    float pv = p[i];
    sgd_math(pv, g[i], lr);
    p[i] = pv;
  }
}

__global__ void momentum_kernel(float* __restrict__ p,
                                const float* __restrict__ g,
                                float* __restrict__ t, int64_t n,
                                int64_t n_vec, float lr, float m) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* t4 = reinterpret_cast<float4*>(t);
  for (int64_t i = start; i < n_vec; i += stride) {
    float4 pv = p4[i];
    const float4 gv = g4[i];
    float4 tv = t4[i];
    momentum_math(pv.x, gv.x, tv.x, lr, m);
    momentum_math(pv.y, gv.y, tv.y, lr, m);
    momentum_math(pv.z, gv.z, tv.z, lr, m);
    momentum_math(pv.w, gv.w, tv.w, lr, m);
    t4[i] = tv;
    p4[i] = pv;
  }
  for (int64_t i = 4 * n_vec + start; i < n; i += stride) {
    float pv = p[i];
    float tv = t[i];
    momentum_math(pv, g[i], tv, lr, m);
    t[i] = tv;
    p[i] = pv;
  }
}

__global__ void adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                            float* __restrict__ mu, float* __restrict__ nu,
                            int64_t n, int64_t n_vec, AdamArgs a) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* mu4 = reinterpret_cast<float4*>(mu);
  float4* nu4 = reinterpret_cast<float4*>(nu);
  for (int64_t i = start; i < n_vec; i += stride) {
    float4 pv = p4[i];
    const float4 gv = g4[i];
    float4 mv = mu4[i];
    float4 vv = nu4[i];
    adam_math(pv.x, gv.x, mv.x, vv.x, a);
    adam_math(pv.y, gv.y, mv.y, vv.y, a);
    adam_math(pv.z, gv.z, mv.z, vv.z, a);
    adam_math(pv.w, gv.w, mv.w, vv.w, a);
    mu4[i] = mv;
    nu4[i] = vv;
    p4[i] = pv;
  }
  for (int64_t i = 4 * n_vec + start; i < n; i += stride) {
    float pv = p[i];
    float mv = mu[i];
    float vv = nu[i];
    adam_math(pv, g[i], mv, vv, a);
    mu[i] = mv;
    nu[i] = vv;
    p[i] = pv;
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

}  // namespace

extern "C" {

int hvd_sgd_f32(float* p, const float* g, int64_t n, float lr,
                void* stream) {
  if (n <= 0) return cudaSuccess;
  const int64_t n_vec = aligned16(p) && aligned16(g) ? n / 4 : 0;
  int grid = 0;
  cudaError_t err = grid_for(n_vec > 0 ? n_vec : n, &grid);
  if (err != cudaSuccess) return err;
  sgd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, g, n, n_vec, lr);
  return cudaGetLastError();
}

int hvd_momentum_f32(float* p, const float* g, float* t, int64_t n,
                     float lr, float m, void* stream) {
  if (n <= 0) return cudaSuccess;
  const int64_t n_vec =
      aligned16(p) && aligned16(g) && aligned16(t) ? n / 4 : 0;
  int grid = 0;
  cudaError_t err = grid_for(n_vec > 0 ? n_vec : n, &grid);
  if (err != cudaSuccess) return err;
  momentum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, g, t, n, n_vec, lr, m);
  return cudaGetLastError();
}

int hvd_adam_f32(float* p, const float* g, float* mu, float* nu, int64_t n,
                 float lr, float b1, float b2, float eps, float one_minus_b1,
                 float one_minus_b2, float inv_bc1, float inv_bc2,
                 void* stream) {
  if (n <= 0) return cudaSuccess;
  const int64_t n_vec = aligned16(p) && aligned16(g) && aligned16(mu) &&
                                aligned16(nu)
                            ? n / 4
                            : 0;
  int grid = 0;
  cudaError_t err = grid_for(n_vec > 0 ? n_vec : n, &grid);
  if (err != cudaSuccess) return err;
  const AdamArgs a{lr, b1, b2, eps, one_minus_b1, one_minus_b2, inv_bc1,
                   inv_bc2};
  adam_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, g, mu, nu, n, n_vec, a);
  return cudaGetLastError();
}

}  // extern "C"
