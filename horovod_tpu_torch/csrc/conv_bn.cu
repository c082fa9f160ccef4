// K8, K9 and K10: the 3x3 SAME stride-1 convolution with its three
// epilogues, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas kernels of horovod_tpu/ops/conv_bn.py, which share
// one body, _conv_taps (:39-49: nine shift-and-matmul taps, float32
// accumulation), and differ only in what they do with the accumulator:
//   K8   _bn_relu_kernel (:52), launched by conv3x3_bn_relu (:103):
//        relu(acc * scale + bias), cast to x's type (the eval forward of
//        models/resnet.py PallasConvBN3x3);
//   K9   _stats_kernel (:61), launched by conv3x3_stats (:125): y = acc in
//        x's type, plus the per-channel sum of acc and of acc^2 over the
//        whole batch, taken from the float32 accumulator, not from the
//        rounded y (:64-76) (the train forward);
//   K10  _plain_kernel (:79), launched by conv3x3_plain (:153): y = acc
//        (dx of the train backward, on flipped io-transposed weights).
//
// Layout: x NHWC [b, h, w, cin], w the HWIO kernel flattened to
// [9 * cin, cout] (row (dy * 3 + dx) * cin + c), y NHWC [b, h, w, cout],
// all contiguous.  Any cin, cout, h and w: channel counts that do not
// divide into 16-byte packs, a rectangular cin != cout and odd sizes take
// the masked paths below.
//
// Design.  An implicit GEMM: M = b*h*w output pixels, N = cout,
// K = 9*cin, walked tap by tap, 32 channels of a tap at a time.  The
// halo is masked in the loads (a tap's pixel outside the image loads as
// zeros), so the padded copy that _pad_and_pack made with jnp.pad is
// never materialised; a row past M or a channel past cin loads as zeros
// too, so it adds exactly 0 to every accumulator.  Blocks run in parallel
// and in no order, where the TPU grid walked the batch in order:
//   bfloat16 (the training path)  a block owns a 128-pixel x 64-channel
//     output tile, 8 warps of 32 x 32; the products run on the tensor
//     cores as mma.sync m16n8k16 bf16 tiles with float32 accumulation, A
//     fragments read from shared memory as 32-bit words, B fragments by
//     ldmatrix.trans, tiles staged in shared memory (rows padded by 16
//     bytes, so fragment loads hit 32 banks) by cp.async 16-byte copies,
//     double-buffered so the next K step's loads are in flight during the
//     current step's products (the halo's zeros are cp.async's zero fill).
//     Operands that are misaligned or whose channel counts are not
//     multiples of 8 are staged element by element instead.
//   float32 (parity and tests)  scalar FMAs (fmaf, fused on purpose even
//     under --fmad=false) over 64 x 64 tiles, 4 x 4 outputs a thread; the
//     tensor cores would round float32 to TF32.
// K9's sums cross blocks: the TPU body carried them across its sequential
// grid; here each block writes its tile's column sums (a fixed-order
// reduction over its rows) to a [2, row tiles, cout] float32 scratch that
// the wrapper allocates, and a second kernel adds the row tiles of each
// column in a fixed order.  No atomics: the sums are the same from run to
// run.  K8's epilogue computes acc * scale, rounded, then + bias, rounded,
// as the plain version does (the library is built with --fmad=false).
//
// Bound.  At ResNet-50's four stride-1 3x3 shapes, [128, 56, 56, 64] ->
// 64, [128, 28, 28, 128] -> 128, [128, 14, 14, 256] -> 256 and
// [128, 7, 7, 512] -> 512, each launch does 2 * M * cout * 9 * cin =
// 29.6 GFLOP: >= 0.030 ms at 989 TFLOP/s dense bf16 (H100 SXM data
// sheet).  The 56x56 one reads x and writes y, 51.4 MB each, so it moves
// 102.8 MB, >= 0.031 ms at 3.35 TB/s; the smaller ones move less and are
// bound by their operations.  mma.sync reaches a fraction of the rate of
// wgmma, and each x tile is read nine times (once a tap) through L2: this
// first version stays well above the bound.  wgmma fed by TMA, with the
// halo tile of x loaded once, is the later work that the bound calls for.
//
// Each launch function returns cudaGetLastError() (0 on success); the
// Python wrapper raises on anything else.  Nothing here allocates or
// synchronizes; the caller passes its current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

extern "C" {

// Everything a launch needs; mirrored by kernels.py's _ConvArgs.  Operands
// an epilogue does not use are null.
struct HvdConvArgs {
  const void* x;       // [b, h, w, cin]
  const void* w;       // [9 * cin, cout]
  void* y;             // [b, h, w, cout]
  const float* scale;  // [cout], K8
  const float* bias;   // [cout], K8
  float* partial;      // [2, hvd_conv3x3_tiles(b * h * wd), cout], K9
  float* sum;          // [cout], K9
  float* sumsq;        // [cout], K9
  int64_t b, h, wd, cin, cout;
  int32_t epilogue;    // 0 store (K10), 1 stats (K9), 2 bn_relu (K8)
  int32_t dtype;       // 0 float32, 1 bfloat16
};

}  // extern "C"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kStore = 0, kStats = 1, kBnRelu = 2;

// bfloat16 kernel: 128 x 64 output tile, 32 channels a K step, 8 warps
constexpr int kBM = 128, kBN = 64, kBK = 32;
constexpr int kMmaThreads = 256;
constexpr int kLdA = kBK + 8;  // bf16 row stride of a staged A tile
constexpr int kLdB = kBN + 8;  // ... of a staged B tile
constexpr int kStages = 2;

// float32 kernel: 64 x 64 output tile, 16 channels a K step
constexpr int kFM = 64, kFN = 64, kFK = 16;
constexpr int kF32Threads = 256;

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

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// The epilogue of one output element: K8's affine and relu, then the cast.
template <typename T>
__device__ __forceinline__ T epilogue_value(const HvdConvArgs& a, int64_t n,
                                            float v) {
  if (a.epilogue == kBnRelu) v = relu(v * a.scale[n] + a.bias[n]);
  return from_f<T>(v);
}

// Output pixel m = (b * h + oh) * w + ow, split.
struct Pixel {
  int b, oh, ow;
  bool ok;
};

__device__ __forceinline__ Pixel pixel_of(const HvdConvArgs& a, int64_t m,
                                          int64_t M) {
  Pixel p;
  p.ok = m < M;
  const int64_t mm = p.ok ? m : 0;
  p.ow = static_cast<int>(mm % a.wd);
  const int64_t t = mm / a.wd;
  p.oh = static_cast<int>(t % a.h);
  p.b = static_cast<int>(t / a.h);
  return p;
}

// Offset of x[b, oh + dy - 1, ow + dx - 1, c], or -1 where that tap of the
// pixel falls in the halo (or the pixel is past M, or c past cin).
__device__ __forceinline__ int64_t tap_offset(const HvdConvArgs& a,
                                              const Pixel& p, int dy, int dx,
                                              int64_t c) {
  const int ih = p.oh + dy - 1, iw = p.ow + dx - 1;
  if (!p.ok || c >= a.cin || ih < 0 || ih >= a.h || iw < 0 || iw >= a.wd)
    return -1;
  return ((static_cast<int64_t>(p.b) * a.h + ih) * a.wd + iw) * a.cin + c;
}

// K9's tile sums: red[which][rows_part][kBN-wide columns], reduced over
// rows_part in order by the first 2 * cols threads into
// partial[which][blockIdx.x][n0 + col].
__device__ __forceinline__ void write_partials(const HvdConvArgs& a,
                                               const float* red, int parts,
                                               int cols, int64_t n0) {
  const int tid = threadIdx.x;
  if (tid >= 2 * cols) return;
  const int which = tid / cols, col = tid % cols;
  if (n0 + col >= a.cout) return;
  float s = 0.f;
  for (int i = 0; i < parts; ++i) s += red[(which * parts + i) * cols + col];
  const int64_t tiles = gridDim.x;
  a.partial[(which * tiles + blockIdx.x) * a.cout + n0 + col] = s;
}

// ===========================================================================
// bfloat16: mma.sync m16n8k16 on the tensor cores
// ===========================================================================
//
// Fragments of one warp (lane = 4 * g + q): an A tile 16x16 (row major) is
// four 32-bit registers holding (row g | g+8, columns 2q, 2q+1 | +8); a B
// tile 16x8 (k x n) is two, holding (k = 2q, 2q+1 | +8, n = g); the float32
// accumulator 16x8 is (row g | g+8, columns 2q, 2q+1).

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// 16 bytes global -> shared, in flight until waited for; zeros when !pred
// (src-size 0: nothing is read, the destination is zero-filled).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stages K step ks (tap ks / chunks, channels c0 .. c0 + 31) of A (the
// block's 128 pixels) and B (its 64 output channels) into shared memory.
// kVec: cin and cout are multiples of 8 and x, w 16-byte aligned, so every
// 8-channel pack lies wholly inside or outside the channels and is one
// cp.async; each thread copies two A packs (rows tid / 4 and tid / 4 + 64,
// whose pixels px it has split once) and one B pack.  Otherwise element
// by element.
template <bool kVec>
__device__ __forceinline__ void load_stage(const HvdConvArgs& a,
                                           const Pixel px[2], int64_t m0,
                                           int64_t n0, int64_t M, int ks,
                                           int chunks, bf16* As, bf16* Bs) {
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* w = static_cast<const bf16*>(a.w);
  const int tap = ks / chunks, dy = tap / 3, dx = tap % 3;
  const int64_t c0 = static_cast<int64_t>(ks % chunks) * kBK;
  const int tid = threadIdx.x;
  if constexpr (kVec) {
    const int cc = (tid & 3) * 8;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = (tid >> 2) + 64 * j;
      const int64_t off = tap_offset(a, px[j], dy, dx, c0 + cc);
      cp_async16(As + row * kLdA + cc, off >= 0 ? x + off : x, off >= 0);
    }
    const int kr = tid >> 3, nc = (tid & 7) * 8;
    const bool ok = c0 + kr < a.cin && n0 + nc < a.cout;
    const int64_t woff = (tap * a.cin + c0 + kr) * a.cout + n0 + nc;
    cp_async16(Bs + kr * kLdB + nc, ok ? w + woff : w, ok);
  } else {
    for (int i = tid; i < kBM * kBK; i += kMmaThreads) {
      const int row = i / kBK, k = i % kBK;
      const int64_t off =
          tap_offset(a, pixel_of(a, m0 + row, M), dy, dx, c0 + k);
      As[row * kLdA + k] = off >= 0 ? x[off] : from_f<bf16>(0.f);
    }
    for (int i = tid; i < kBK * kBN; i += kMmaThreads) {
      const int kr = i / kBN, n = i % kBN;
      const bool ok = c0 + kr < a.cin && n0 + n < a.cout;
      Bs[kr * kLdB + n] =
          ok ? w[(tap * a.cin + c0 + kr) * a.cout + n0 + n] : from_f<bf16>(0.f);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kMmaThreads)
    hvd_conv3x3_mma_kernel(const HvdConvArgs a) {
  __shared__ __align__(16) bf16 As[kStages][kBM * kLdA];
  __shared__ __align__(16) bf16 Bs[kStages][kBK * kLdB];
  __shared__ float red[2 * 4 * kBN];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // 32 rows x 32 columns a warp
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const int li = lane >> 3, lr = lane & 7;
  const int64_t M = a.b * a.h * a.wd;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * kBN;
  const int chunks = static_cast<int>((a.cin + kBK - 1) / kBK);
  const int nk = 9 * chunks;

  Pixel px[2];  // read by the kVec staging only
#pragma unroll
  for (int j = 0; j < 2; ++j) px[j] = pixel_of(a, m0 + (tid >> 2) + 64 * j, M);

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  load_stage<kVec>(a, px, m0, n0, M, 0, chunks, As[0], Bs[0]);
  cp_async_commit();
  for (int ks = 0; ks < nk; ++ks) {
    if (ks + 1 < nk)
      load_stage<kVec>(a, px, m0, n0, M, ks + 1, chunks, As[(ks + 1) & 1],
                       Bs[(ks + 1) & 1]);
    cp_async_commit();  // possibly empty: keeps the group count regular
    cp_async_wait_all_but_one();
    __syncthreads();
    const bf16* A = As[ks & 1];
    const bf16* B = Bs[ks & 1];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const bf16* r = A + (wm * 32 + mi * 16 + g) * kLdA + kk + q2;
        af[mi][0] = ld32(r);
        af[mi][1] = ld32(r + 8 * kLdA);
        af[mi][2] = ld32(r + 8);
        af[mi][3] = ld32(r + 8 * kLdA + 8);
      }
#pragma unroll
      for (int nj = 0; nj < 4; nj += 2) {
        uint32_t bfr[4];
        ldsm_x4_trans(bfr, B + (kk + (li & 1) * 8 + lr) * kLdB + wn * 32 +
                               (nj + (li >> 1)) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][nj], af[mi], bfr[0], bfr[1]);
          mma_bf16(acc[mi][nj + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // the stage is free for the load two steps on
  }

  // epilogue: rows m0 + wm*32 + mi*16 + g (+8), columns n0 + wn*32 + nj*8 +
  // q2 (+1)
  bf16* y = static_cast<bf16*>(a.y);
  const bool pairs = (a.cout & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + wm * 32 + mi * 16 + g + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int64_t n = n0 + wn * 32 + nj * 8 + q2;
        if (n >= a.cout) continue;
        const bf16 v0 = epilogue_value<bf16>(a, n, acc[mi][nj][2 * half]);
        bf16* dst = y + m * a.cout + n;
        if (n + 1 < a.cout) {
          const bf16 v1 =
              epilogue_value<bf16>(a, n + 1, acc[mi][nj][2 * half + 1]);
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(dst) = __halves2bfloat162(v0, v1);
          } else {
            dst[0] = v0;
            dst[1] = v1;
          }
        } else {
          dst[0] = v0;
        }
      }
    }

  if (a.epilogue != kStats) return;
  // K9: column sums of acc and acc^2 over the tile's rows (rows past M
  // hold exact zeros): a thread's 4 rows, then the 8 lanes of a column
  // (xor over g), then the 4 warps of a column in order.
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float s = 0.f, sq = 0.f;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float v = acc[mi][nj][2 * half + j];
          s += v;
          sq += v * v;
        }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
      }
      if (g == 0) {
        const int col = wn * 32 + nj * 8 + q2 + j;
        red[(0 * 4 + wm) * kBN + col] = s;
        red[(1 * 4 + wm) * kBN + col] = sq;
      }
    }
  __syncthreads();
  write_partials(a, red, 4, kBN, n0);
}

// ===========================================================================
// float32: scalar FMAs
// ===========================================================================

__global__ void __launch_bounds__(kF32Threads)
    hvd_conv3x3_f32_kernel(const HvdConvArgs a) {
  __shared__ __align__(16) float As[kFK][kFM + 4];  // transposed: [k][row]
  __shared__ __align__(16) float Bs[kFK][kFN + 4];
  __shared__ float red[2 * 16 * kFN];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t M = a.b * a.h * a.wd;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kFM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * kFN;
  const int chunks = static_cast<int>((a.cin + kFK - 1) / kFK);
  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);

  // the A rows this thread stages: ty + 16 j, channel tx
  Pixel px[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) px[j] = pixel_of(a, m0 + ty + 16 * j, M);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int ks = 0; ks < 9 * chunks; ++ks) {
    const int tap = ks / chunks, dy = tap / 3, dx = tap % 3;
    const int64_t c0 = static_cast<int64_t>(ks % chunks) * kFK;
    __syncthreads();  // the previous step's readers are done
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t off = tap_offset(a, px[j], dy, dx, c0 + tx);
      As[tx][ty + 16 * j] = off >= 0 ? x[off] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kr = tid / kFN + 4 * j, n = tid % kFN;
      const bool ok = c0 + kr < a.cin && n0 + n < a.cout;
      Bs[kr][n] = ok ? w[(tap * a.cin + c0 + kr) * a.cout + n0 + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }

  float* y = static_cast<float*>(a.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + 4 * ty + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t n = n0 + 4 * tx + j;
      if (n < a.cout) y[m * a.cout + n] = epilogue_value<float>(a, n, acc[i][j]);
    }
  }

  if (a.epilogue != kStats) return;
  // K9: a thread's 4 rows, then the 16 row groups of a column in order
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float s = 0.f, sq = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s += acc[i][j];
      sq += acc[i][j] * acc[i][j];
    }
    red[(0 * 16 + ty) * kFN + 4 * tx + j] = s;
    red[(1 * 16 + ty) * kFN + 4 * tx + j] = sq;
  }
  __syncthreads();
  write_partials(a, red, 16, kFN, n0);
}

// K9's second pass: sum[n] and sumsq[n] over the row tiles' partials,
// thread (tx, ty) adding tiles ty, ty + 32, ... of column tx, then the 32
// in order.
__global__ void __launch_bounds__(1024)
    hvd_conv_stats_reduce_kernel(const float* __restrict__ partial,
                                 float* __restrict__ sum,
                                 float* __restrict__ sumsq, int64_t tiles,
                                 int64_t cout) {
  __shared__ float red[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t n = static_cast<int64_t>(blockIdx.x) * 32 + tx;
  const float* p = partial + blockIdx.y * tiles * cout;
  float s = 0.f;
  if (n < cout)
    for (int64_t t = ty; t < tiles; t += 32) s += p[t * cout + n];
  red[ty][tx] = s;
  __syncthreads();
  if (ty != 0 || n >= cout) return;
  float total = 0.f;
  for (int i = 0; i < 32; ++i) total += red[i][tx];
  (blockIdx.y == 0 ? sum : sumsq)[n] = total;
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

int64_t row_tiles(int64_t m, int32_t dtype) {
  const int64_t bm = dtype == 1 ? kBM : kFM;
  return (m + bm - 1) / bm;
}

}  // namespace

extern "C" {

// Row tiles of a launch over m output pixels: K9's scratch holds
// 2 * tiles * cout floats.
int64_t hvd_conv3x3_tiles(int64_t m, int32_t dtype) {
  return row_tiles(m, dtype);
}

int hvd_conv3x3(const HvdConvArgs* args, void* stream) {
  const HvdConvArgs& a = *args;
  const int64_t M = a.b * a.h * a.wd;
  if (M <= 0 || a.cout <= 0 || a.cin <= 0) return cudaErrorInvalidValue;
  if (a.epilogue < kStore || a.epilogue > kBnRelu) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t tiles = row_tiles(M, a.dtype);
  if (tiles > 0x7fffffff) return cudaErrorInvalidConfiguration;
  if (a.dtype == 1) {
    const dim3 grid(static_cast<unsigned>(tiles),
                    static_cast<unsigned>((a.cout + kBN - 1) / kBN));
    const bool vec = a.cin % 8 == 0 && a.cout % 8 == 0 && aligned16(a.x) &&
                     aligned16(a.w);
    if (vec)
      hvd_conv3x3_mma_kernel<true><<<grid, kMmaThreads, 0, st>>>(a);
    else
      hvd_conv3x3_mma_kernel<false><<<grid, kMmaThreads, 0, st>>>(a);
  } else if (a.dtype == 0) {
    const dim3 grid(static_cast<unsigned>(tiles),
                    static_cast<unsigned>((a.cout + kFN - 1) / kFN));
    hvd_conv3x3_f32_kernel<<<grid, kF32Threads, 0, st>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.epilogue != kStats) return err;
  const dim3 grid(static_cast<unsigned>((a.cout + 31) / 32), 2);
  hvd_conv_stats_reduce_kernel<<<grid, dim3(32, 32), 0, st>>>(
      a.partial, a.sum, a.sumsq, tiles, a.cout);
  return cudaGetLastError();
}

}  // extern "C"
