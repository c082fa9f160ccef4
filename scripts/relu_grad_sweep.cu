// The loops that scripts/relu_grad_sweep.py times against K6' (the ReLU
// gradient, dx = where(float(out) > 0, g, 0); horovod_tpu_torch/csrc/
// elementwise.cu) on an H100.  Not part of the library: the library keeps
// the loop this sweep found fastest ("grid", 2 packs, no hint) and the
// flat_binary loop it replaced.
//
// Each thread issues all its loads of U packs of out and g before it uses
// any, with one of three cache hints, over one of three schedules: one
// resident wave of blocks each taking a contiguous chunk (kChunk), one
// wave taking interleaved rounds (kStride), or a block for each round
// (kGrid); or (kBulk) one wave of blocks keeping 1-D TMA bulk copies of
// their next chunks in flight in a ring of shared memory.  The scalar
// tail covers a ragged end or a misaligned operand.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "hopper.cuh"  // mbarriers, the smem limit

namespace {

constexpr int kThreads = 256;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
struct ReluGrad {
  __device__ __forceinline__ T operator()(T out, T g) const {
    return to_f(out) > 0.f ? g : T(0.f);
  }
};

// `bytes` (a multiple of 16) of contiguous global memory at src into dst,
// both 16-byte aligned, as one 1-D bulk copy; counted on bar.
__device__ __forceinline__ void tma_load_1d(void* dst, const void* src,
                                            uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

enum Schedule { kChunk = 1, kStride = 2, kGrid = 3, kBulk = 4 };

// The streaming pass's cache hints: none; loads and stores evict-first
// (ld.global.cs, st.global.cs); loads through the non-coherent path with
// no L1 allocation, stores evict-first.
enum Hint { kHintNone = 0, kHintCs = 1, kHintNc = 2 };

template <int kHint>
__device__ __forceinline__ uint4 load_pack(const uint4* p) {
  if constexpr (kHint == kHintCs) {
    return __ldcs(p);
  } else if constexpr (kHint == kHintNc) {
    uint4 v;
    asm volatile(
        "ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
        : "l"(p));
    return v;
  } else {
    return *p;
  }
}

template <int kHint>
__device__ __forceinline__ void store_pack(uint4* p, const uint4& v) {
  if constexpr (kHint == kHintNone)
    *p = v;
  else
    __stcs(p, v);
}

// K6', the streaming pass, in rounds of U packs a thread (kThreads apart,
// so that a warp's loads are contiguous), every load of a round issued
// before its first use; then the scalar tail.  kChunk: block b takes the
// contiguous packs [b per, (b + 1) per); else block b takes rounds b, b +
// gridDim.x, ... (all blocks stream through neighbouring addresses).
template <typename T, int U, int kHint, bool kChunk>
__global__ void __launch_bounds__(kThreads)
    stream_kernel(const T* __restrict__ out,
                                const T* __restrict__ g, T* __restrict__ dx,
                                int64_t n, int64_t n_vec) {
  constexpr int N = 16 / sizeof(T);
  constexpr int64_t kRound = static_cast<int64_t>(kThreads) * U;
  const ReluGrad<T> op{};
  int64_t first, end, step;
  if constexpr (kChunk) {
    const int64_t per = (n_vec + gridDim.x - 1) / gridDim.x;
    first = static_cast<int64_t>(blockIdx.x) * per;
    end = first + per < n_vec ? first + per : n_vec;
    step = kRound;
  } else {
    first = static_cast<int64_t>(blockIdx.x) * kRound;
    end = n_vec;
    step = static_cast<int64_t>(gridDim.x) * kRound;
  }
  const uint4* o4 = reinterpret_cast<const uint4*>(out);
  const uint4* g4 = reinterpret_cast<const uint4*>(g);
  uint4* d4 = reinterpret_cast<uint4*>(dx);
  for (int64_t base = first + threadIdx.x; base < end; base += step) {
    uint4 vo[U], vg[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int64_t i = base + k * kThreads;
      if (i < end) {
        vo[k] = load_pack<kHint>(o4 + i);
        vg[k] = load_pack<kHint>(g4 + i);
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int64_t i = base + k * kThreads;
      if (i < end) {
        uint4 vd;
        const T* eo = reinterpret_cast<const T*>(&vo[k]);
        const T* eg = reinterpret_cast<const T*>(&vg[k]);
        T* ed = reinterpret_cast<T*>(&vd);
#pragma unroll
        for (int e = 0; e < N; ++e) ed[e] = op(eo[e], eg[e]);
        store_pack<kHint>(d4 + i, vd);
      }
    }
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = n_vec * N + static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride)
    dx[i] = op(out[i], g[i]);
}

// K6' through a ring of 1-D bulk copies (TMA): one resident wave of
// blocks takes chunks b, b + gridDim.x, ... of kThreads U packs of each
// operand; thread 0 keeps the next 8 / U chunks' copies in flight in a
// 64 KB ring of shared memory, every thread computes its U packs of a
// landed chunk into global memory, and the block's barrier frees the
// stage for the chunk after next.  Then the scalar tail.
template <typename T, int U>
__global__ void __launch_bounds__(kThreads)
    bulk_kernel(const T* __restrict__ out,
                              const T* __restrict__ g, T* __restrict__ dx,
                              int64_t n, int64_t n_vec) {
  constexpr int N = 16 / sizeof(T);
  constexpr int kStages = 8 / U;
  constexpr int64_t kPacks = static_cast<int64_t>(kThreads) * U;
  extern __shared__ uint4 ring[];  // [kStages][out, g][kPacks]
  __shared__ uint64_t full[kStages];
  const ReluGrad<T> op{};
  const int tid = threadIdx.x;
  const uint4* o4 = reinterpret_cast<const uint4*>(out);
  const uint4* g4 = reinterpret_cast<const uint4*>(g);
  uint4* d4 = reinterpret_cast<uint4*>(dx);
  const int64_t n_chunks = (n_vec + kPacks - 1) / kPacks;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  // chunk c into stage s: both operands, counted in bytes on full[s]
  const auto issue = [&](int64_t c, int s) {
    const int64_t p0 = c * kPacks;
    const int64_t packs = n_vec - p0 < kPacks ? n_vec - p0 : kPacks;
    const uint32_t bytes = static_cast<uint32_t>(packs * 16);
    mbar_arrive_expect_tx(&full[s], 2 * bytes);
    tma_load_1d(ring + 2 * s * kPacks, o4 + p0, bytes, &full[s]);
    tma_load_1d(ring + (2 * s + 1) * kPacks, g4 + p0, bytes, &full[s]);
  };
  if (tid == 0)
    for (int s = 0; s < kStages; ++s) {
      const int64_t c = blockIdx.x + static_cast<int64_t>(s) * gridDim.x;
      if (c < n_chunks) issue(c, s);
    }
  int it = 0;
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x, ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    const int64_t p0 = c * kPacks;
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int j = tid + k * kThreads;
      if (p0 + j < n_vec) {
        const uint4 vo = ring[2 * s * kPacks + j];
        const uint4 vg = ring[(2 * s + 1) * kPacks + j];
        uint4 vd;
        const T* eo = reinterpret_cast<const T*>(&vo);
        const T* eg = reinterpret_cast<const T*>(&vg);
        T* ed = reinterpret_cast<T*>(&vd);
#pragma unroll
        for (int e = 0; e < N; ++e) ed[e] = op(eo[e], eg[e]);
        d4[p0 + j] = vd;
      }
    }
    __syncthreads();  // every thread has read stage s
    const int64_t next = c + static_cast<int64_t>(kStages) * gridDim.x;
    if (tid == 0 && next < n_chunks) issue(next, s);
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = n_vec * N + static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   tid;
       i < n; i += stride)
    dx[i] = op(out[i], g[i]);
}

// Blocks of one resident wave of `kernel` with `smem` bytes of dynamic
// shared memory on the current device, asked once per device below 64
// (`wave`, the instance's own).
template <typename Kernel>
cudaError_t one_wave(Kernel kernel, int smem, std::atomic<int>* wave,
                     int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  *blocks = dev < 64 ? wave[dev].load(std::memory_order_relaxed) : 0;
  if (*blocks > 0) return cudaSuccess;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  *blocks = sms * per_sm;
  if (dev < 64) wave[dev].store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

// K6' on the bulk ring (64 KB of dynamic shared memory a block)
template <typename T, int U>
cudaError_t launch_relu_grad_bulk(const T* out, const T* g, T* dx, int64_t n,
                                  int64_t n_vec, cudaStream_t stream) {
  constexpr int kSmem = 64 * 1024;
  auto* kernel = &bulk_kernel<T, U>;
  static std::atomic<uint64_t> smem_set{0};
  static std::atomic<int> wave[64] = {};
  cudaError_t err = allow_smem_once(smem_set, kernel, kSmem);
  if (err != cudaSuccess) return err;
  int blocks_wave = 0;
  if ((err = one_wave(kernel, kSmem, wave, &blocks_wave)) != cudaSuccess)
    return err;
  const int64_t per = static_cast<int64_t>(kThreads) * (n_vec > 0 ? U : 1);
  int64_t blocks = ((n_vec > 0 ? n_vec : n) + per - 1) / per;
  if (blocks > blocks_wave) blocks = blocks_wave;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<int>(blocks), kThreads, kSmem, stream>>>(out, g, dx,
                                                                n, n_vec);
  return cudaGetLastError();
}

template <typename T, int U, int kHint, bool kChunked>
cudaError_t launch_relu_grad_stream(int32_t schedule, const T* out,
                                    const T* g, T* dx, int64_t n,
                                    int64_t n_vec, cudaStream_t stream) {
  auto* kernel = &stream_kernel<T, U, kHint, kChunked>;
  static std::atomic<int> wave[64] = {};
  int blocks_wave = 0;
  cudaError_t err = one_wave(kernel, 0, wave, &blocks_wave);
  if (err != cudaSuccess) return err;
  // rounds of the packs, or of the scalar loop when there are none
  const int64_t per = static_cast<int64_t>(kThreads) * (n_vec > 0 ? U : 1);
  int64_t blocks = ((n_vec > 0 ? n_vec : n) + per - 1) / per;
  if (schedule != kGrid && blocks > blocks_wave) blocks = blocks_wave;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<int>(blocks), kThreads, 0, stream>>>(out, g, dx, n,
                                                            n_vec);
  return cudaGetLastError();
}

template <typename T, int U, int kHint>
cudaError_t relu_grad_schedule(int32_t schedule, const T* out, const T* g,
                               T* dx, int64_t n, int64_t n_vec,
                               cudaStream_t stream) {
  if (schedule == kChunk)
    return launch_relu_grad_stream<T, U, kHint, true>(schedule, out, g, dx,
                                                      n, n_vec, stream);
  if (schedule == kStride || schedule == kGrid)
    return launch_relu_grad_stream<T, U, kHint, false>(schedule, out, g, dx,
                                                       n, n_vec, stream);
  return cudaErrorInvalidValue;
}

template <typename T, int U>
cudaError_t relu_grad_hint(int32_t schedule, int32_t hint, const T* out,
                           const T* g, T* dx, int64_t n, int64_t n_vec,
                           cudaStream_t stream) {
  if (schedule == kBulk)
    return hint == kHintNone
               ? launch_relu_grad_bulk<T, U>(out, g, dx, n, n_vec, stream)
               : cudaErrorInvalidValue;
  switch (hint) {
    case kHintNone:
      return relu_grad_schedule<T, U, kHintNone>(schedule, out, g, dx, n,
                                                 n_vec, stream);
    case kHintCs:
      return relu_grad_schedule<T, U, kHintCs>(schedule, out, g, dx, n,
                                               n_vec, stream);
    case kHintNc:
      return relu_grad_schedule<T, U, kHintNc>(schedule, out, g, dx, n,
                                               n_vec, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// the loop (schedule, unroll, hint)
template <typename T>
cudaError_t launch_relu_grad(const void* out, const void* g, void* dx,
                             int64_t n, int32_t schedule, int32_t unroll,
                             int32_t hint, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const int64_t n_vec =
      aligned16(out) && aligned16(g) && aligned16(dx) ? n / N : 0;
  const T* to = static_cast<const T*>(out);
  const T* tg = static_cast<const T*>(g);
  T* td = static_cast<T*>(dx);
  switch (unroll) {
    case 2:
      return relu_grad_hint<T, 2>(schedule, hint, to, tg, td, n, n_vec,
                                  stream);
    case 4:
      return relu_grad_hint<T, 4>(schedule, hint, to, tg, td, n, n_vec,
                                  stream);
    case 8:
      return relu_grad_hint<T, 8>(schedule, hint, to, tg, td, n, n_vec,
                                  stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16; the schedule and hint as numbered above
int sweep_relu_grad(const void* out, const void* g, void* dx, int64_t n,
                    int32_t dtype, int32_t schedule, int32_t unroll,
                    int32_t hint, void* stream) {
  if (n <= 0) return cudaSuccess;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_relu_grad<float>(out, g, dx, n, schedule, unroll, hint,
                                   st);
  if (dtype == 1)
    return launch_relu_grad<bf16>(out, g, dx, n, schedule, unroll, hint, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
