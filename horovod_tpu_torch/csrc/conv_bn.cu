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
// all contiguous.  Every kernel is an implicit GEMM: M = b*h*w output
// pixels, N = cout, K = 9*cin walked tap by tap.  The halo is never
// materialised (the padded copy that _pad_and_pack made with jnp.pad): a
// tap's pixel outside the image reads as zeros, and so does a row past M
// or a channel past cin, which adds exactly 0 to every accumulator.
// Blocks run in parallel and in no order, where the TPU grid walked the
// batch in order.
//
// Three mainloops; kernels.py's conv3x3_plan picks one by an explicit
// rule, passed in HvdConvArgs.mainloop, and hvd_conv3x3 refuses a plan
// the operands do not meet (nothing falls back):
//
//   TMA + wgmma (bfloat16, cin and cout multiples of 8, x and w 16-byte
//   aligned: what TMA can address; every ResNet-50 shape)
//     One block owns a 128-pixel x tile_n output tile (tile_n 64 or 128):
//     two consumer warpgroups of 64 rows each and one producer warp.  The
//     producer's one thread keeps a ring of shared-memory stages (4 deep
//     at tile_n 64, 3 at 128; 24 or 32 KB each) full with TMA copies,
//     each stage one K step of 64 channels of one tap, completion counted
//     on an mbarrier per stage; the consumers hand a stage back on a
//     second mbarrier once their products have read it.
//     - A (x) comes by TMA's im2col mode: a 4-D map over [b, h, w, cin]
//       whose bounding box starts one pixel before the image and ends one
//       pixel short of it (corners -1, -1), 64 channels a pixel, 128
//       pixels a copy.  The 128 pixels are the tile's consecutive output
//       pixels m0 .. m0 + 127, across rows and images, at any W; the tap
//       (dy, dx) is the copy's im2col offset.  The hardware computes every
//       address and zero-fills whatever falls outside the image, past the
//       last image or past cin: the halo costs no instruction.
//     - B (w) comes as a tiled 3-D box over [9, cin, cout]: 64 channels x
//       64 output channels of one tap (two boxes at tile_n 128).  Its rows
//       are cout-contiguous, that is MN-major, which wgmma reads as is
//       (transpose bit): no weight copy.  Channels past cin or cout read
//       as zeros.
//     - Both land with the 128-byte swizzle, the layout wgmma's shared-
//       memory descriptors read without bank conflicts.
//     - Products: wgmma m64n{64,128}k16, bf16 in, float32 accumulators
//       in registers, four per 64-channel stage; one wgmma group stays in
//       flight while the next stage's are issued, and a stage is handed
//       back when the group that read it has completed.
//     - Tile and waves.  At ResNet-50's 7x7 shape (M 6,272, cout 512)
//       128 x 128 tiles give 196 tiles for 132 SMs: two blocks share an
//       SM on 64 of them and one SM's work is twice another's.  tile_n 64
//       there gives 392 tiles, about three half-size tiles an SM.  So
//       conv3x3_plan takes tile_n 128 only when that grid still has two
//       tiles for every SM (28x28, 14x14), else 64 (56x56, whose cout is
//       64 anyway, and 7x7).  Shared memory (101-105 KB a block) and
//       registers (288 threads) leave room for two blocks an SM, so one
//       block's epilogue overlaps the other's mainloop.
//     - Persistent at many tiles.  The kernel walks tiles blockIdx.x,
//       + gridDim.x, ...; the stage ring runs on across tiles, so the
//       producer loads the next tile while the consumers write this one.
//       conv3x3_plan launches as many blocks as fit at once when there
//       are at least 4 tiles for each (56x56: 3136 tiles for 264 blocks),
//       else one block a tile: with fewer tiles a fixed assignment left
//       SMs unevenly loaded and ran slower on the card than the
//       hardware's own placement of the second wave.
//     - The schedule (tile_n and the block count) is decided in one
//       place, kernels.py's conv3x3_plan, from the card's SM count and
//       the blocks an SM holds (hvd_conv3x3_wgmma_occupancy, asked once
//       per device), and passed in HvdConvArgs; hvd_conv3x3 only checks
//       that it fits the launch.
//     - Epilogues straight from the wgmma accumulator layout (warp w of a
//       warpgroup holds rows 16w .. 16w + 15; lane 4g + q holds rows g and
//       g + 8, columns 8j + 2q and 8j + 2q + 1 of every 8-column group j):
//       K10 stores bf16 pairs; K9 the same plus the tile's column sums
//       of acc and acc^2 (see below); K8 acc * scale rounded, + bias
//       rounded, relu, then the bf16 pair, scale and bias staged in
//       shared memory per tile (read from device memory in the loop they
//       cost as much as the rest of the epilogue at 56x56).
//     - Tried and dropped: loading x once per tap row, the dx = 1, 2 taps
//       read as the same 130-row copy shifted (over W + 2 positions a
//       row, two dropped).  It cut the L2 traffic of A by two thirds and
//       ran slower at every ResNet-50 shape: L2 bandwidth is not what
//       bounds this mainloop.  It taught that a descriptor whose start is
//       off the 1 KB swizzle pattern takes base offset 0: the hardware
//       swizzles by the absolute shared-memory address.
//     The TMA maps are encoded on the host for every launch (x and w move
//     between calls) through cuTensorMapEncodeIm2col / Tiled, reached with
//     cudaGetDriverEntryPoint (hopper.cuh, which also holds the mbarrier,
//     TMA and wgmma wrappers), so the library needs no -lcuda; they are
//     passed as __grid_constant__ kernel parameters.  The kernel's shared-
//     memory limit is raised once per device, not per launch.
//   mma.sync (bfloat16 operands that TMA cannot take: cin or cout not a
//   multiple of 8, or x or w off 16-byte alignment)
//     The first version of these kernels: a 128-pixel x 64-channel tile,
//     8 warps of 32 x 32, mma.sync m16n8k16 bf16 tiles with float32
//     accumulation, A fragments read from shared memory as 32-bit words,
//     B fragments by ldmatrix.trans, tiles staged in shared memory (rows
//     padded by 16 bytes) by cp.async 16-byte copies with zero fill for
//     the halo, double-buffered, 32 channels a K step; element by element
//     where channel counts are not multiples of 8 or operands misaligned.
//     Kept for those operands and as the yardstick of the TMA mainloop.
//   float32 (parity and tests)  scalar FMAs (fmaf, fused on purpose even
//     under --fmad=false) over 64 x 64 tiles, 4 x 4 outputs a thread; the
//     tensor cores would round float32 to TF32.
// K9's sums cross blocks: the TPU body carried them across its sequential
// grid; here each block writes its tile's column sums (a fixed-order
// reduction over its rows: a thread's rows, the lanes of a column by
// shuffles (a reduce-scatter on the wgmma mainloop), then the warps in
// order) to a [2, row tiles, cout] float32
// scratch that the wrapper allocates, and a second kernel adds the row
// tiles of each column in a fixed order.  No atomics: the sums are the
// same from run to run.  Rows past M are left out of them explicitly.
// K8's epilogue computes acc * scale, rounded, then + bias, rounded, as
// the plain version does (the library is built with --fmad=false).
//
// Bound.  At ResNet-50's four stride-1 3x3 shapes, [128, 56, 56, 64] ->
// 64, [128, 28, 28, 128] -> 128, [128, 14, 14, 256] -> 256 and
// [128, 7, 7, 512] -> 512, each launch does 2 * M * cout * 9 * cin =
// 29.6 GFLOP: >= 0.030 ms at 989 TFLOP/s dense bf16 (H100 SXM data
// sheet).  The 56x56 one reads x and writes y, 51.4 MB each, so it moves
// 102.8 MB, >= 0.031 ms at 3.35 TB/s; the smaller ones move less and are
// bound by their operations.  The TMA + wgmma mainloop is the design that
// bound calls for: products at wgmma's rate, operands fed by the copy
// engine with no address arithmetic in the threads, each x element read
// from device memory once (its nine taps hit L2).  What it does not do
// yet: store y through shared memory and TMA (each warp's bf16 pairs are
// 16-byte pieces of 8 rows), or give a block's own consumers two tiles to
// alternate between, so its tensor cores stay busy through its epilogue.
//
// Each launch function returns a cudaError_t (0 on success); the Python
// wrapper raises on anything else.  Nothing here allocates or
// synchronizes; the caller passes its current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, tensor-map encoders

extern "C" {

// Everything a launch needs; mirrored by kernels.py's _ConvArgs.  Operands
// an epilogue does not use are null.
struct HvdConvArgs {
  const void* x;       // [b, h, w, cin]
  const void* w;       // [9 * cin, cout]
  void* y;             // [b, h, w, cout]
  const float* scale;  // [cout], K8
  const float* bias;   // [cout], K8
  float* partial;      // [2, tiles, cout], K9
  float* sum;          // [cout], K9
  float* sumsq;        // [cout], K9
  int64_t b, h, wd, cin, cout;
  int64_t tiles;       // row tiles, ceil(b * h * wd / the M tile)
  int32_t epilogue;    // 0 store (K10), 1 stats (K9), 2 bn_relu (K8)
  int32_t dtype;       // 0 float32, 1 bfloat16
  int32_t mainloop;    // bfloat16: 0 mma.sync, 1 TMA + wgmma
  int32_t tile_n;      // the N tile of the TMA + wgmma mainloop: 64 or 128
  int32_t blocks;      // blocks of a TMA + wgmma launch, 1 .. its tiles
};

}  // extern "C"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kStore = 0, kStats = 1, kBnRelu = 2;
constexpr int kMmaSync = 0, kWgmma = 1;

// bfloat16 mma.sync kernel: 128 x 64 output tile, 32 channels a K step,
// 8 warps
constexpr int kBM = 128, kBN = 64, kBK = 32;
constexpr int kMmaThreads = 256;
constexpr int kLdA = kBK + 8;  // bf16 row stride of a staged A tile
constexpr int kLdB = kBN + 8;  // ... of a staged B tile
constexpr int kStages = 2;

// float32 kernel: 64 x 64 output tile, 16 channels a K step
constexpr int kFM = 64, kFN = 64, kFK = 16;
constexpr int kF32Threads = 256;


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

// ===========================================================================
// bfloat16: TMA + wgmma
// ===========================================================================

constexpr int kTmaBM = 128;             // output pixels a block
constexpr int kTmaBK = 64;              // channels a K step (128 bytes)
constexpr int kConsumerThreads = 256;   // two warpgroups
constexpr int kTmaThreads = kConsumerThreads + 32;  // + the producer warp
constexpr int kSwizzleRow = 128;        // bytes: one swizzled smem row
constexpr int kATileBytes = kTmaBM * kTmaBK * 2;  // 16 KB
constexpr int kBBoxBytes = kTmaBK * 64 * 2;       // 8 KB: 64 k x 64 n

template <int BN>
struct TmaCfg {
  static constexpr int kStages = BN == 64 ? 4 : 3;
  static constexpr int kBBytes = kBBoxBytes * (BN / 64);
  static constexpr int kStageBytes = kATileBytes + kBBytes;
  static constexpr int kRedFloats = 2 * 8 * BN;  // [sum|sumsq][warp][col]
  // + 1 KB to align the tiles to the 128-byte swizzle's 1 KB pattern
  static constexpr int kSmem = 1024 + kStages * kStageBytes +
                               kRedFloats * 4 + 2 * kStages * 8;
};

// One level of reduce_scatter8: a lane keeps the upper or the lower half
// of v[0 .. 2 HALF), sends the other half to the lane `mask` away and
// adds what it gets into v[0 .. HALF).
template <int HALF, int V>
__device__ __forceinline__ void scatter_level(float (&v)[V], bool upper,
                                              int mask) {
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float lo = v[k], hi = v[HALF + k];
    const float got = __shfl_xor_sync(0xffffffffu, upper ? lo : hi, mask);
    v[k] = (upper ? hi : lo) + got;
  }
}

// Sums v over the 8 lanes that share lane % 4 (g = lane / 4), as a
// reduce-scatter: at each of 3 levels a lane keeps one half of its
// values, sends the other to the lane g ^ 4, 2, 1 and adds what it gets.
// After it, v[0 .. V/8) of lane g are the sums of the values
// (g & 4 ? V/2 : 0) + (g & 2 ? V/4 : 0) + (g & 1 ? V/8 : 0) + k, each
// added in the same order on every run.
template <int V>
__device__ __forceinline__ void reduce_scatter8(float (&v)[V], int g) {
  scatter_level<V / 2>(v, (g >> 2) & 1, 16);
  scatter_level<V / 4>(v, (g >> 1) & 1, 8);
  scatter_level<V / 8>(v, g & 1, 4);
}

// A persistent block: it takes the 128 x BN output tiles blockIdx.x,
// blockIdx.x + gridDim.x, ... (N tiles fastest, so the blocks that share
// an x tile run together), warps 0-7 the two consumer warpgroups, warp 8
// the producer.  The stage ring runs on across tiles: the producer loads
// the next tile's first stages while the consumers finish this tile and
// write it out.
template <int BN>
__global__ void __launch_bounds__(kTmaThreads, 2)
    hvd_conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_x,
                             const __grid_constant__ CUtensorMap tmap_w,
                             const HvdConvArgs a) {
  using Cfg = TmaCfg<BN>;
  constexpr int S = Cfg::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sa = smem;                         // [S][128 pixels][64 ch]
  uint8_t* sb = smem + S * kATileBytes;       // [S][BN / 64][64 ch][64 n]
  float* red = reinterpret_cast<float*>(sb + S * Cfg::kBBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + Cfg::kRedFloats);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_n = static_cast<int>((a.cout + BN - 1) / BN);
  const int tiles = static_cast<int>(a.tiles) * tiles_n;  // < 2^31
  const int64_t M = a.b * a.h * a.wd;
  const int chunks = static_cast<int>((a.cin + kTmaBK - 1) / kTmaBK);
  const int nk = 9 * chunks;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive + the bytes
      mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {
    // producer: one thread issues every copy
    if (lane != 0) return;
    const int64_t hw = a.h * a.wd;
    // the ring's position over all tiles: stage s, in round parity ^ 1
    // (a stage starts out free)
    int s = 0;
    uint32_t parity = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int64_t m0 = static_cast<int64_t>(tile / tiles_n) * kTmaBM;
      const int n0 = (tile % tiles_n) * BN;
      const int img = static_cast<int>(m0 / hw);
      const int64_t rem = m0 % hw;
      // the traversal's coordinates of pixel m0: its output position less
      // the bounding box's lower corner (-1, -1)
      const int oh = static_cast<int>(rem / a.wd) - 1;
      const int ow = static_cast<int>(rem % a.wd) - 1;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&empty[s], parity ^ 1);
        mbar_arrive_expect_tx(&full[s], Cfg::kStageBytes);
        const int tap = kb / chunks;
        const int c0 = (kb % chunks) * kTmaBK;
        tma_load_im2col(sa + s * kATileBytes, &tmap_x, &full[s], c0, ow, oh,
                        img, static_cast<uint16_t>(tap % 3),
                        static_cast<uint16_t>(tap / 3));
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_3d(sb + s * Cfg::kBBytes + j * kBBoxBytes, &tmap_w,
                      &full[s], n0 + 64 * j, c0, tap);
        if (++s == S) {
          s = 0;
          parity ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile
  const int wg = warp >> 2;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const int r0 = wg * 64 + (warp & 3) * 16 + g;
  bf16* y = static_cast<bf16*>(a.y);
  int s = 0, last = 0;  // the ring's position, as the producer's
  uint32_t parity = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tile_m = tile / tiles_n;
    const int n0 = (tile % tiles_n) * BN;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&full[s], parity);
      __syncwarp();  // wgmma is .aligned: the warp converged
      const uint32_t a_addr =
          smem_u32(sa + s * kATileBytes + wg * 64 * kSwizzleRow);
      const uint32_t b_addr = smem_u32(sb + s * Cfg::kBBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTmaBK / 16; ++kk) {
        // A: K-major, rows of 128 bytes, 8-row groups 1 KB apart; a k16
        // step is 32 bytes along the row.  B: MN-major, a k16 step is 16
        // rows of 128 bytes; 8-row groups 1 KB apart, the second
        // 64-column box 8 KB on.
        wgmma_ss<BN, 1>(acc, gmma_desc(a_addr + kk * 32, 16, 1024),
                        gmma_desc(b_addr + kk * 16 * kSwizzleRow, kBBoxBytes,
                                  1024));
      }
      wgmma_commit();
      // the group before this one has completed: its stage is free
      wgmma_wait<1>();
      if (kb > 0 && lane == 0) mbar_arrive(&empty[last]);
      last = s;
      if (++s == S) {
        s = 0;
        parity ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operands<BN / 2>(acc);
    if (lane == 0) mbar_arrive(&empty[last]);

    // epilogue: rows r0 and r0 + 8 of the tile, columns 8j + 2q (+1).
    // K8 first stages the tile's scale and bias in red (it takes no
    // sums), between two meetings of the consumers at the named barrier 1
    // (the producer warp never joins it).
    const int64_t m_lo = static_cast<int64_t>(tile_m) * kTmaBM + r0;
    const int64_t m_hi = m_lo + 8;
    const bool lo_ok = m_lo < M, hi_ok = m_hi < M;
    const bool affine = a.epilogue == kBnRelu;
    if (affine) {
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
      if (tid < 2 * BN) {
        const int64_t n = n0 + tid % BN;
        red[tid] = n >= a.cout ? 0.f : tid < BN ? a.scale[n] : a.bias[n];
      }
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int64_t n = n0 + 8 * j + q2;
      if (n >= a.cout) continue;  // cout is even: n + 1 < cout too
      float sc[2] = {0.f, 0.f}, bi[2] = {0.f, 0.f};
      if (affine) {
        sc[0] = red[8 * j + q2];
        sc[1] = red[8 * j + q2 + 1];
        bi[0] = red[BN + 8 * j + q2];
        bi[1] = red[BN + 8 * j + q2 + 1];
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (!(half ? hi_ok : lo_ok)) continue;
        float v[2] = {acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]};
        if (affine) {
          // rounded after the product and after the sum, as the plain
          // version (--fmad=false keeps them apart)
          v[0] = relu(v[0] * sc[0] + bi[0]);
          v[1] = relu(v[1] * sc[1] + bi[1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(y + (half ? m_hi : m_lo) * a.cout +
                                           n) =
            __halves2bfloat162(from_f<bf16>(v[0]), from_f<bf16>(v[1]));
      }
    }

    if (a.epilogue != kStats) continue;
    // K9: column sums of acc and acc^2 over the tile's rows below M: a
    // thread's 2 rows, the 8 lanes of a column (a reduce-scatter over g:
    // 7/8 of a shuffle a value, where a full xor tree takes 3), then the
    // 8 consumer warps in order; 64 columns at a time, so that the sums
    // in flight stay in registers.  The consumers alone meet at the named
    // barrier 1 (the producer warp never does): before red is written,
    // so the last tile's readers are done, and before it is read.
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
    constexpr int V = 16;  // a thread's columns of 64: i = 2j + e
    const int base = (g & 4 ? V / 2 : 0) + (g & 2 ? V / 4 : 0) +
                     (g & 1 ? V / 8 : 0);
#pragma unroll
    for (int c64 = 0; c64 < BN / 64; ++c64) {
      float sm[V], sq[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const int at = 4 * (8 * c64 + (i >> 1)) + (i & 1);
        const float v0 = lo_ok ? acc[at] : 0.f;
        const float v1 = hi_ok ? acc[at + 2] : 0.f;
        sm[i] = v0 + v1;
        sq[i] = v0 * v0 + v1 * v1;
      }
      reduce_scatter8<V>(sm, g);
      reduce_scatter8<V>(sq, g);
#pragma unroll
      for (int k = 0; k < V / 8; ++k) {
        const int i = base + k;
        const int col = 64 * c64 + 8 * (i >> 1) + q2 + (i & 1);
        red[(0 * 8 + warp) * BN + col] = sm[k];
        red[(1 * 8 + warp) * BN + col] = sq[k];
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
    if (tid < 2 * BN) {
      const int which = tid / BN, col = tid % BN;
      if (n0 + col < a.cout) {
        float total = 0.f;
        for (int i = 0; i < 8; ++i) total += red[(which * 8 + i) * BN + col];
        a.partial[(which * a.tiles + tile_m) * a.cout + n0 + col] = total;
      }
    }
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// The M tile of a launch: 128 for both bfloat16 mainloops, 64 for float32.
int64_t tile_m(int32_t dtype) { return dtype == 1 ? kBM : kFM; }

// Lets hvd_conv3x3_wgmma_kernel<BN> take its dynamic shared memory (over
// the 48 KB default) on the current device: set once per device, not per
// launch.
template <int BN>
cudaError_t allow_wgmma_smem() {
  static std::atomic<uint64_t> done{0};
  return allow_smem_once(done, hvd_conv3x3_wgmma_kernel<BN>,
                         TmaCfg<BN>::kSmem);
}

// The TMA + wgmma mainloop of one launch: encodes x's im2col map and w's
// tiled map, launches, returns the launch's error.
template <int BN>
cudaError_t launch_wgmma(const HvdConvArgs& a, cudaStream_t st) {
  const EncodeIm2colFn im2col = encode_im2col();
  const EncodeTiledFn tiled = encode_tiled();
  if (im2col == nullptr || tiled == nullptr) return cudaErrorNotSupported;

  const cuuint64_t e = sizeof(bf16);
  const cuuint64_t cin = a.cin, cout = a.cout;
  CUtensorMap tmap_x, tmap_w;
  const cuuint64_t x_dims[4] = {cin, static_cast<cuuint64_t>(a.wd),
                                static_cast<cuuint64_t>(a.h),
                                static_cast<cuuint64_t>(a.b)};
  const cuuint64_t x_strides[3] = {cin * e, cin * a.wd * e,
                                   cin * a.wd * a.h * e};
  // the traversal's bounding box over (w, h): from one pixel before the
  // image (the SAME padding) to one pixel short of its end (the filter's
  // extent 3 less the padding), so it visits each output position once
  const int lower[2] = {-1, -1}, upper[2] = {-1, -1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUresult r = im2col(
      &tmap_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(a.x),
      x_dims, x_strides, lower, upper, kTmaBK, kTmaBM, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const cuuint64_t w_dims[3] = {cout, cin, 9};
  const cuuint64_t w_strides[2] = {cout * e, cin * cout * e};
  const cuuint32_t w_box[3] = {64, kTmaBK, 1};
  r = tiled(&tmap_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<void*>(a.w), w_dims, w_strides, w_box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;

  cudaError_t err = allow_wgmma_smem<BN>();
  if (err != cudaSuccess) return err;
  // the schedule is conv3x3_plan's: one block a tile, or fewer blocks
  // each walking its tiles; any count from 1 to the tiles is correct
  const int64_t tiles = a.tiles * ((a.cout + BN - 1) / BN);
  if (tiles > 0x7fffffff || a.blocks < 1 || a.blocks > tiles)
    return cudaErrorInvalidConfiguration;
  hvd_conv3x3_wgmma_kernel<BN><<<static_cast<unsigned>(a.blocks),
                                 kTmaThreads, TmaCfg<BN>::kSmem, st>>>(
      tmap_x, tmap_w, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The blocks of the TMA + wgmma mainloop at N tile tile_n that one SM
// of the current device holds at once, into *blocks_per_sm; conv3x3_plan
// sizes a persistent launch from it (kernels.py asks once per device).
int hvd_conv3x3_wgmma_occupancy(int32_t tile_n, int32_t* blocks_per_sm) {
  int per_sm = 0;
  cudaError_t err;
  if (tile_n == 64) {
    if ((err = allow_wgmma_smem<64>()) != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hvd_conv3x3_wgmma_kernel<64>, kTmaThreads,
        TmaCfg<64>::kSmem);
  } else if (tile_n == 128) {
    if ((err = allow_wgmma_smem<128>()) != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hvd_conv3x3_wgmma_kernel<128>, kTmaThreads,
        TmaCfg<128>::kSmem);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  *blocks_per_sm = per_sm;
  return per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

int hvd_conv3x3(const HvdConvArgs* args, void* stream) {
  const HvdConvArgs& a = *args;
  const int64_t M = a.b * a.h * a.wd;
  if (M <= 0 || a.cout <= 0 || a.cin <= 0) return cudaErrorInvalidValue;
  if (a.epilogue < kStore || a.epilogue > kBnRelu) return cudaErrorInvalidValue;
  if (a.dtype != 0 && a.dtype != 1) return cudaErrorInvalidValue;
  // the plan's row tiles size K9's scratch: they must be this launch's
  const int64_t tiles = (M + tile_m(a.dtype) - 1) / tile_m(a.dtype);
  if (a.tiles != tiles) return cudaErrorInvalidValue;
  if (tiles > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (a.dtype == 1 && a.mainloop == kWgmma) {
    // what TMA can address: 16-byte strides and base addresses
    if (a.cin % 8 || a.cout % 8 || !aligned16(a.x) || !aligned16(a.w) ||
        !aligned16(a.y))
      return cudaErrorInvalidValue;
    if (a.tile_n == 64)
      err = launch_wgmma<64>(a, st);
    else if (a.tile_n == 128)
      err = launch_wgmma<128>(a, st);
    else
      return cudaErrorInvalidValue;
  } else if (a.dtype == 1 && a.mainloop == kMmaSync) {
    const dim3 grid(static_cast<unsigned>(tiles),
                    static_cast<unsigned>((a.cout + kBN - 1) / kBN));
    const bool vec = a.cin % 8 == 0 && a.cout % 8 == 0 && aligned16(a.x) &&
                     aligned16(a.w);
    if (vec)
      hvd_conv3x3_mma_kernel<true><<<grid, kMmaThreads, 0, st>>>(a);
    else
      hvd_conv3x3_mma_kernel<false><<<grid, kMmaThreads, 0, st>>>(a);
    err = cudaGetLastError();
  } else if (a.dtype == 0) {
    const dim3 grid(static_cast<unsigned>(tiles),
                    static_cast<unsigned>((a.cout + kFN - 1) / kFN));
    hvd_conv3x3_f32_kernel<<<grid, kF32Threads, 0, st>>>(a);
    err = cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || a.epilogue != kStats) return err;
  const dim3 grid(static_cast<unsigned>((a.cout + 31) / 32), 2);
  hvd_conv_stats_reduce_kernel<<<grid, dim3(32, 32), 0, st>>>(
      a.partial, a.sum, a.sumsq, tiles, a.cout);
  return cudaGetLastError();
}

}  // extern "C"
