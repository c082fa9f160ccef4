// The blocks that scripts/elementwise_sweep.py times for K6 (the
// norm+activation join), its backward and K7 (the residual join).  Not part
// of the library: horovod_tpu_torch/csrc/elementwise.cu launches one block
// of each (its kJoin* and kBwd*).  This file includes that source and
// instantiates the same kernels, in bf16, at the blocks that one was chosen
// from: 128, 256 or 512 threads x 1, 2 or 4 16-byte packs a thread.

#include "elementwise.cu"

namespace {

// F::run<T, THREADS, PACKS>(a...) at the block (threads, packs)
template <typename F, typename T, int THREADS, typename... A>
cudaError_t at_packs(int packs, A... a) {
  switch (packs) {
    case 1:
      return F::template run<T, THREADS, 1>(a...);
    case 2:
      return F::template run<T, THREADS, 2>(a...);
    case 4:
      return F::template run<T, THREADS, 4>(a...);
  }
  return cudaErrorInvalidValue;
}

template <typename F, typename T, typename... A>
cudaError_t at_block(int threads, int packs, A... a) {
  switch (threads) {
    case 128:
      return at_packs<F, T, 128>(packs, a...);
    case 256:
      return at_packs<F, T, 256>(packs, a...);
    case 512:
      return at_packs<F, T, 512>(packs, a...);
  }
  return cudaErrorInvalidValue;
}

struct Residual {
  template <typename T, int THREADS, int PACKS>
  static cudaError_t run(const void* x, const void* y, void* out, int64_t n,
                         cudaStream_t stream) {
    return launch_residual_stream<T, THREADS, PACKS>(x, y, out, n, stream);
  }
};

struct Affine {
  template <typename T, int THREADS, int PACKS>
  static cudaError_t run(const void* x, const float* scale, const float* bias,
                         void* out, int64_t rows, int64_t c,
                         cudaStream_t stream) {
    return launch_affine_channel<T, THREADS, PACKS>(x, scale, bias, out, rows,
                                                    c, stream);
  }
};

struct AffineBwd {
  template <typename T, int THREADS, int PACKS>
  static cudaError_t run(const void* x, const float* scale, const void* out,
                         const void* g, void* dx, float* partial,
                         float* dscale, float* dbias, int64_t rows, int64_t c,
                         int32_t blocks, cudaStream_t stream) {
    return launch_affine_bwd<T, THREADS, PACKS>(x, scale, out, g, dx, partial,
                                                dscale, dbias, rows, c, false,
                                                blocks, stream);
  }
};

}  // namespace

extern "C" {

// K7 on the stream loop at (threads, packs), bf16
int sweep_residual_relu(const void* x, const void* y, void* out, int64_t n,
                        int32_t threads, int32_t packs, void* stream) {
  return at_block<Residual, bf16>(threads, packs, x, y, out, n,
                                  static_cast<cudaStream_t>(stream));
}

// K6 on the channel loop at (threads, packs), bf16
int sweep_scale_bias_relu(const void* x, const float* scale,
                          const float* bias, void* out, int64_t rows,
                          int64_t c, int32_t threads, int32_t packs,
                          void* stream) {
  return at_block<Affine, bf16>(threads, packs, x, scale, bias, out, rows, c,
                                static_cast<cudaStream_t>(stream));
}

// K6's backward on the channel loop at (threads, packs) on `blocks`
// blocks, then its second pass, bf16
int sweep_scale_bias_relu_bwd(const void* x, const float* scale,
                              const void* out, const void* g, void* dx,
                              float* partial, float* dscale, float* dbias,
                              int64_t rows, int64_t c, int32_t threads,
                              int32_t packs, int32_t blocks, void* stream) {
  return at_block<AffineBwd, bf16>(threads, packs, x, scale, out, g, dx,
                                   partial, dscale, dbias, rows, c, blocks,
                                   static_cast<cudaStream_t>(stream));
}

}  // extern "C"
