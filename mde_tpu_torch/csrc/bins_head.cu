// Fused AdaBins bins head in float32, forward and backward, on the CUDA cores
// of Hopper (sm_90a). bf16 features go to the tensor-core kernels of
// bins_head_tc.cu; the wrapper (kernels/bins_head.py) sends only float32 here.
//
// Forward. Replaces the Pallas TPU kernel mde_tpu/kernels/bins_head.py::
// _fwd_kernel (:76, launched per image by _fwd_one). For every pixel of the
// decoder's 128-channel range-attention map:
//   logit_n = sum_c W[n, c] x[c] + b[n]               (n < n_bins)
//   depth   = sum_n softmax(logit)_n * centers[n]
// without writing the (B, n_bins, HW) logits to device memory.
//
// What bounds it. 2 x 128 x n_bins flops a pixel (65,536 at 256 bins)
// against 512 bytes of features read and 4 bytes of depth written: 128 flops
// a byte, six times the card's float32 balance (67 TFLOP/s over 3.35 TB/s).
// So the FMAs bound it: 10.07 GFLOP, 0.150 ms, at the serving shape (B=2,
// 240x320 pixels, 256 bins). They run as full float32 FMAs, no TF32: the
// serving path is the parity setting.
//
// Design. The logits are a (pixels x 128) by (128 x bins) product, tiled as
// an SGEMM, with the softmax folded in after each 128-bin chunk.
//  - A block owns kFwdPx consecutive pixels of one image. Its feature tile
//    X[128 ch][kFwdPx px] goes to shared memory once, by cp.async, as one
//    contiguous row per channel of the NCHW layout.
//  - W goes to shared memory transposed, W^T[ch][128 bins] for one chunk,
//    kSliceCh channels at a time, through a double buffer: the next slice
//    arrives by cp.async while the current one is in use. Every block reads
//    W, so it comes from L2. A warp copies 4 bins x 8 channels per
//    instruction (whole 32-byte sectors of W's rows), and the 132-float rows
//    of W^T put those 32 stores on 32 banks.
//  - Each thread accumulates 8 pixels x 8 bins in 64 registers (tile_fma):
//    per channel two LDS.128 of X and two of W^T feed 64 FMAs. A warp is 4
//    pixel groups x 8 bin groups, and a thread's 8 pixels (bins) are two
//    runs of 4 half a tile apart, so each LDS.128 reads 64 (128) contiguous
//    bytes: one wavefront, no bank conflict.
//  - After each chunk a thread folds its 8 bins into a running (max, sum,
//    sum e c) for each of its 8 pixels, in registers: no thread talks to
//    another inside the bin loop, and every bin count that is a multiple of
//    128 runs. At the end the 16 threads that share a pixel merge their
//    states through shared memory by the log-sum-exp rule.
//  - When a backward will follow, the merge also writes each pixel's
//    softmax max and sum (8 bytes a pixel), which the backward reads instead
//    of running the softmax again.
//  - Pixels past hw are zero in the tile and not written. A feature row
//    moves in 16-byte copies where hw % 4 == 0 and the features are 16-byte
//    aligned, else element by element into the same layout.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kChannels = 128;      // decoder output channels (conv_out input)

constexpr int kFwdPx = 128;                      // forward: pixels per block
constexpr int kSliceCh = 32;                     // forward: W^T channels per stage
constexpr int kFwdMinBlocks = 2;                 // forward: blocks per SM (launch bounds)
constexpr int kFwdBins = 128;                    // forward: bins per chunk
constexpr int kBinGroups = kFwdBins / 8;         // threads that share a pixel
constexpr int kFwdThreads = kFwdPx / 8 * kBinGroups;
constexpr int kPxWarps = kFwdPx / 32;            // warps along the pixels (4 groups each)
constexpr int kSlices = kChannels / kSliceCh;    // stages per chunk
constexpr int kWtStride = kFwdBins + 4;          // a W^T row in shared memory, floats
constexpr int kXFloats = kChannels * kFwdPx;
constexpr int kStageFloats = kSliceCh * kWtStride;
constexpr size_t kFwdSmem = (size_t)(kXFloats + 2 * kStageFloats) * sizeof(float);
static_assert(kChannels % kSliceCh == 0 && kSliceCh % 8 == 0, "W^T slices");
static_assert(kFwdThreads == 32 * kPxWarps * (kBinGroups / 8), "warp layout");
static_assert(3 * kBinGroups * kFwdPx <= 2 * kStageFloats, "merge scratch fits the W^T buffers");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; src_bytes 0 fills a zero.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A feature tile of one image, channel rows of kPx pixels from p0, kStride
// floats apart in shared memory.
template <int kPx, int kStride>
__device__ __forceinline__ void load_x_tile(float* xs, const float* x_img, int p0, int hw,
                                            bool vec) {
  if (vec) {  // hw % 4 == 0: a 4-pixel chunk is wholly in or out
    constexpr int kRowChunks = kPx / 4;
    for (int i = threadIdx.x; i < kChannels * kRowChunks; i += kFwdThreads) {
      const int ch = i / kRowChunks, q = 4 * (i % kRowChunks), p = p0 + q;
      const bool in = p < hw;
      cp_async16(xs + ch * kStride + q, x_img + (size_t)ch * hw + (in ? p : 0), in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kChannels * kPx; i += kFwdThreads) {
      const int ch = i / kPx, q = i % kPx, p = p0 + q;
      const bool in = p < hw;
      cp_async4(xs + ch * kStride + q, x_img + (size_t)ch * hw + (in ? p : 0), in ? 4 : 0);
    }
  }
}

// W^T for bins n0..n0+127 and channels k0..k0+kSliceCh-1: lane & 7 picks the
// channel, lane >> 3 the bin, of a warp's 4 x 8 group.
__device__ __forceinline__ void load_wt_slice(float* wt, const float* w, int n0, int k0) {
  constexpr int kChGroups = kSliceCh / 8;
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < kChGroups * (kFwdBins / 4); g += kFwdThreads / 32) {
    const int ch = (g % kChGroups) * 8 + (lane & 7);
    const int bin = (g / kChGroups) * 4 + (lane >> 3);
    cp_async4(wt + ch * kWtStride + bin, w + (size_t)(n0 + bin) * kChannels + k0 + ch, 4);
  }
}

// acc[i][j] += sum_k a[k][i'] b[k][j'] over kK rows of two k-major operands
// in shared memory, a thread's 8 x 8 tile: its result rows are a's columns
// ia..ia+3 and ib..ib+3, its result columns b's columns ja.. and jb... The
// forward's logits (a = X, b = W^T) and both products of the backward's
// pixel kernel run it; the pixel kernel thus forms each logit with the
// forward's FMAs in the forward's order, bit for bit the same value.
template <int kK>
__device__ __forceinline__ void tile_fma(const float* a, int lda, int ia, int ib, const float* b,
                                         int ldb, int ja, int jb, float (&acc)[8][8]) {
#pragma unroll 8
  for (int k = 0; k < kK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * lda + ia);
    const float4 a1 = *reinterpret_cast<const float4*>(a + k * lda + ib);
    const float4 b0 = *reinterpret_cast<const float4*>(b + k * ldb + ja);
    const float4 b1 = *reinterpret_cast<const float4*>(b + k * ldb + jb);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks)
bins_head_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, const float* __restrict__ c,
                     float* __restrict__ out, float* __restrict__ stats, int hw, int n_bins,
                     int vec) {
  extern __shared__ float4 smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [kChannels][kFwdPx]
  float* wts = xs + kXFloats;                  // 2 x [kSliceCh][kWtStride]

  const int img = blockIdx.y;
  const int p0 = blockIdx.x * kFwdPx;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pg = (warp % kPxWarps) * 4 + (lane >> 3);  // pixel group
  const int bg = (warp / kPxWarps) * 8 + (lane & 7);   // bin group
  const int xa = pg * 4, xb = kFwdPx / 2 + pg * 4;     // the thread's pixels: xa.., xb..
  const int wa = bg * 4, wb = kFwdBins / 2 + bg * 4;   // and bins in the chunk: wa.., wb..

  load_x_tile<kFwdPx, kFwdPx>(xs, x + (size_t)img * kChannels * hw, p0, hw, vec != 0);
  load_wt_slice(wts, w, 0, 0);
  cp_async_commit();

  const float* c_img = c + (size_t)img * n_bins;
  float run_max[8], run_sum[8], run_depth[8], acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    run_max[i] = -CUDART_INF_F;
    run_sum[i] = run_depth[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int stages = n_bins / kFwdBins * kSlices;
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {
      load_wt_slice(wts + ((st + 1) & 1) * kStageFloats, w, (st + 1) / kSlices * kFwdBins,
                    (st + 1) % kSlices * kSliceCh);
    }
    cp_async_commit();
    cp_async_wait<1>();  // the tile and this stage's slice are in
    __syncthreads();

    tile_fma<kSliceCh>(xs + (st % kSlices) * kSliceCh * kFwdPx, kFwdPx, xa, xb,
                          wts + (st & 1) * kStageFloats, kWtStride, wa, wb, acc);

    if (st % kSlices == kSlices - 1) {  // a chunk is done: fold its 8 bins per pixel
      const int n0 = st / kSlices * kFwdBins;
      float bias[8], center[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + (j < 4 ? wa + j : wb + j - 4);
        bias[j] = __ldg(b + n);
        center[j] = __ldg(c_img + n);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float logit[8], chunk_max = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          logit[j] = acc[i][j] + bias[j];
          chunk_max = fmaxf(chunk_max, logit[j]);
          acc[i][j] = 0.f;
        }
        const float m = fmaxf(run_max[i], chunk_max);
        const float scale = expf(run_max[i] - m);
        float sum = 0.f, depth = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float e = expf(logit[j] - m);
          sum += e;
          depth = fmaf(e, center[j], depth);
        }
        run_sum[i] = fmaf(run_sum[i], scale, sum);
        run_depth[i] = fmaf(run_depth[i], scale, depth);
        run_max[i] = m;
      }
    }
    __syncthreads();  // every thread is done with this stage's buffer
  }

  // Merge the 16 bin groups' states of each pixel: [3][kBinGroups][kFwdPx],
  // in the W^T buffers, which no copy writes any more.
  float* red = wts;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int px = i < 4 ? xa + i : xb + i - 4;
    red[(0 * kBinGroups + bg) * kFwdPx + px] = run_max[i];
    red[(1 * kBinGroups + bg) * kFwdPx + px] = run_sum[i];
    red[(2 * kBinGroups + bg) * kFwdPx + px] = run_depth[i];
  }
  __syncthreads();
  if (threadIdx.x < kFwdPx && p0 + (int)threadIdx.x < hw) {
    const int px = threadIdx.x;
    float m = -CUDART_INF_F;
#pragma unroll
    for (int g = 0; g < kBinGroups; ++g) m = fmaxf(m, red[g * kFwdPx + px]);
    float sum = 0.f, depth = 0.f;
#pragma unroll
    for (int g = 0; g < kBinGroups; ++g) {
      const float scale = expf(red[g * kFwdPx + px] - m);
      sum = fmaf(red[(kBinGroups + g) * kFwdPx + px], scale, sum);
      depth = fmaf(red[(2 * kBinGroups + g) * kFwdPx + px], scale, depth);
    }
    const size_t at = (size_t)img * hw + p0 + px;
    out[at] = depth / sum;
    if (stats != nullptr) {
      stats[at] = m;
      stats[(size_t)gridDim.y * hw + at] = sum;
    }
  }
}

cudaError_t launch(const float* x, const float* w, const float* b, const float* c, float* out,
                   float* stats, int batch, int hw, int n_bins, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(bins_head_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kFwdSmem);
  if (err != cudaSuccess) return err;
  const int vec = hw % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((hw + kFwdPx - 1) / kFwdPx, batch);
  bins_head_fwd_kernel<<<grid, kFwdThreads, kFwdSmem, stream>>>(x, w, b, c, out, stats, hw,
                                                                n_bins, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward.
//
// Replaces the Pallas TPU kernel mde_tpu/kernels/bins_head.py::_bwd_kernel
// (:84, launched per image by _bwd_one; its per-tile partials folded by
// _fused_core_bwd). With p = softmax(W x + b), depth = sum_n p_n c_n and the
// upstream gradient g of the depth:
//   dlog_n = p_n (c_n - depth) g
//   dx     = W^T dlog                         per pixel
//   dW     = sum_px dlog x^T,  db = sum_px dlog      over the batch
//   dc_n   = sum_px p_n g                             per image
// p comes from the logits formed again and each pixel's softmax (max m,
// sum s), which the forward saved: p = exp(logit - m) / s. The depth is the
// forward's output.
//
// What bounds it. Three products of 2 x 128 x n_bins flops a pixel (the
// logits, dx, dW): at the flagship training shape (16 x 208 x 272 pixels,
// 256 bins) 178 GFLOP, 2.656 ms at the card's 67 TFLOP/s of float32 FMAs,
// above the 463 MB of x read and the 463 MB of dx written (0.28 ms at 3.35
// TB/s). The FMAs run in full float32, no TF32: the float32 path is the
// parity setting. It runs only under --compute_dtype float32; the default
// bf16 training takes bins_head_tc.cu.
//
// Design. Every product is a register-tiled SGEMM on the CUDA cores, 8 x 8
// outputs a thread and 4 FMAs per float loaded from shared memory. The
// logits are formed once, and no float atomics are used, so two calls give
// the same bits. Two kernels:
//  1. pixel kernel (dx, db, dc, and dlog): a block owns 128 pixels of one
//     image, its feature tile in shared memory once (the forward's loader).
//     For each 128-bin chunk it forms S = X^T W^T from the same W^T slices
//     and the same tile_fma as the forward (so the same logits), turns S
//     into dlog in registers, sums p g and dlog over its pixels (shuffles
//     in the warp, then a fixed order over the warps through shared memory)
//     into per-block db and dc partials, stores dlog to shared memory as
//     [bin][px], copies it to device memory for kernel 2, and accumulates
//     dx += dlog W over the chunk's bins with W's rows in 32-bin slices on
//     the same cp.async double buffer. dx stays in 64 registers a thread
//     across the chunks and is written once, in 16-byte rows where
//     hw % 4 == 0. 252 registers and 169 KB of shared memory: one block of
//     8 warps an SM.
//  2. weight kernel (dW): a block owns 128 bins and a contiguous range of
//     64-pixel tiles (across images); each tile's features and dlog arrive
//     by cp.async, double-buffered, and dW += dlog X^T is a product over the
//     tile's pixels in which each thread reads 4 pixels of a row at once
//     (the rows are 68 floats apart, so 4 or 8 consecutive rows fall on
//     distinct banks). The grid is one wave over the card's SMs; each block
//     writes one dW partial, which the wrapper folds in a fixed order.
// dlog goes through device memory rather than being formed again from the
// logits in kernel 2: (B, n_bins, hw rounded up to 128) f32, 927 MB at the
// flagship shape, written once and read once (0.55 ms of traffic at 3.35
// TB/s), where forming S^T = W X again in kernel 2 costs a fourth product
// (59.3 GFLOP, 0.885 ms at the peak rate): 5.37 against 6.79 ms for both
// kernels, on an NVIDIA H100 80GB HBM3 at 700 W.

constexpr int kDlogStride = kFwdPx + 4;       // pixel kernel: a dlog row [bin][px], floats
constexpr int kStagesPerChunk = 2 * kSlices;  // 4 W^T slices (S), then 4 W-row slices (dx)
constexpr int kDwPx = 64;                     // weight kernel: pixels per tile
constexpr int kDwStride = kDwPx + 4;          // a tile row in shared memory, floats
constexpr int kDwTileFloats = kChannels * kDwStride;
constexpr size_t kPixSmem =
    (size_t)(kXFloats + kFwdBins * kDlogStride + 2 * kStageFloats + 2 * kPxWarps * kFwdBins +
             3 * kFwdPx) * sizeof(float);
constexpr size_t kDwSmem = (size_t)4 * kDwTileFloats * sizeof(float);  // 2 x (X, dlog)
static_assert(kSliceCh * kStagesPerChunk / 2 == kFwdBins, "W-row slices cover a chunk");
static_assert(kFwdThreads == 2 * kFwdBins, "one thread per (bin, db or dc) partial");
static_assert(kFwdBins == kChannels, "dx reuses the S thread layout");
static_assert(kFwdThreads == 256 && kFwdBins == 128, "weight kernel: dW as 4 x 2 warps");

// W rows n0..n0+kSliceCh-1, all channels, as [bin][kWtStride].
__device__ __forceinline__ void load_w_rows(float* ws, const float* w, int n0) {
  for (int i = threadIdx.x; i < kSliceCh * kChannels; i += kFwdThreads) {
    const int r = i / kChannels, ch = i % kChannels;
    cp_async4(ws + r * kWtStride + ch, w + (size_t)(n0 + r) * kChannels + ch, 4);
  }
}

__global__ void __launch_bounds__(kFwdThreads, 1)
bins_head_bwd_pixel_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           const float* __restrict__ b, const float* __restrict__ c,
                           const float* __restrict__ g, const float* __restrict__ out,
                           const float* __restrict__ stats, float* __restrict__ dx,
                           float* __restrict__ dlog, float* __restrict__ part_db,
                           float* __restrict__ part_dc, int hw, int hw_pad, int n_bins,
                           int vec_x, int vec_dx) {
  extern __shared__ float4 smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [kChannels][kFwdPx]
  float* dls = xs + kXFloats;                  // [kFwdBins][kDlogStride]
  float* bufs = dls + kFwdBins * kDlogStride;  // 2 x [kSliceCh][kWtStride]
  float* red = bufs + 2 * kStageFloats;        // [db, dc][kPxWarps][kFwdBins]
  float* px_max = red + 2 * kPxWarps * kFwdBins;
  float* px_scale = px_max + kFwdPx;  // g / s
  float* px_depth = px_scale + kFwdPx;

  const int img = blockIdx.y;
  const int p0 = blockIdx.x * kFwdPx;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pw = warp % kPxWarps;
  const int pg = pw * 4 + (lane >> 3);                // pixel group
  const int bg = (warp / kPxWarps) * 8 + (lane & 7);  // bin (S) or channel (dx) group
  const int xa = pg * 4, xb = kFwdPx / 2 + pg * 4;
  const int wa = bg * 4, wb = kFwdBins / 2 + bg * 4;

  load_x_tile<kFwdPx, kFwdPx>(xs, x + (size_t)img * kChannels * hw, p0, hw, vec_x != 0);
  load_wt_slice(bufs, w, 0, 0);
  cp_async_commit();
  if (threadIdx.x < kFwdPx) {  // pixels past hw get p g = 0, so dlog = 0
    const int p = p0 + threadIdx.x;
    const bool in = p < hw;
    const size_t at = (size_t)img * hw + (in ? p : 0);
    px_max[threadIdx.x] = in ? stats[at] : 0.f;
    px_scale[threadIdx.x] = in ? g[at] / stats[(size_t)gridDim.y * hw + at] : 0.f;
    px_depth[threadIdx.x] = in ? out[at] : 0.f;
  }

  const float* c_img = c + (size_t)img * n_bins;
  const size_t part = ((size_t)img * gridDim.x + blockIdx.x) * n_bins;
  float acc[8][8], dxa[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = dxa[i][j] = 0.f;
  }

  const int stages = n_bins / kFwdBins * kStagesPerChunk;
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages) {
      const int chunk = (st + 1) / kStagesPerChunk, phase = (st + 1) % kStagesPerChunk;
      float* next = bufs + ((st + 1) & 1) * kStageFloats;
      if (phase < kSlices) {
        load_wt_slice(next, w, chunk * kFwdBins, phase * kSliceCh);
      } else {
        load_w_rows(next, w, chunk * kFwdBins + (phase - kSlices) * kSliceCh);
      }
    }
    cp_async_commit();
    cp_async_wait<1>();  // the tile and this stage's slice are in
    __syncthreads();

    const int n0 = st / kStagesPerChunk * kFwdBins, phase = st % kStagesPerChunk;
    const float* buf = bufs + (st & 1) * kStageFloats;
    if (phase < kSlices) {  // S += X^T W^T over this slice's channels
      tile_fma<kSliceCh>(xs + phase * kSliceCh * kFwdPx, kFwdPx, xa, xb, buf, kWtStride, wa, wb,
                         acc);
    }
    if (phase == kSlices - 1) {  // S is done: dlog, its sums, and dlog to shared memory
      float bias[8], center[8], sum_dl[8], sum_pg[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + (j < 4 ? wa + j : wb + j - 4);
        bias[j] = __ldg(b + n);
        center[j] = __ldg(c_img + n);
        sum_dl[j] = sum_pg[j] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int px = i < 4 ? xa + i : xb + i - 4;
        const float m = px_max[px], scale = px_scale[px], depth = px_depth[px];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float pgv = expf(acc[i][j] + bias[j] - m) * scale;
          const float dl = pgv * (center[j] - depth);
          sum_pg[j] += pgv;
          sum_dl[j] += dl;
          acc[i][j] = dl;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* row = dls + (j < 4 ? wa + j : wb + j - 4) * kDlogStride;
        *reinterpret_cast<float4*>(row + xa) = make_float4(acc[0][j], acc[1][j], acc[2][j],
                                                           acc[3][j]);
        *reinterpret_cast<float4*>(row + xb) = make_float4(acc[4][j], acc[5][j], acc[6][j],
                                                           acc[7][j]);
        // over the warp's 4 pixel groups (lane bits 3 and 4), a fixed order
        float dl = sum_dl[j], pgv = sum_pg[j];
        dl += __shfl_xor_sync(0xffffffffu, dl, 8);
        pgv += __shfl_xor_sync(0xffffffffu, pgv, 8);
        dl += __shfl_xor_sync(0xffffffffu, dl, 16);
        pgv += __shfl_xor_sync(0xffffffffu, pgv, 16);
        if (lane < 8) {
          const int n = j < 4 ? wa + j : wb + j - 4;
          red[pw * kFwdBins + n] = dl;
          red[(kPxWarps + pw) * kFwdBins + n] = pgv;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = 0.f;
      }
    }
    if (phase == kSlices) {  // dlog and the sums are in
      // the block's db and dc partials, over the warps in a fixed order
      const int which = threadIdx.x / kFwdBins, n = threadIdx.x % kFwdBins;
      const float* r = red + which * kPxWarps * kFwdBins + n;
      float v = r[0];
#pragma unroll
      for (int q = 1; q < kPxWarps; ++q) v += r[q * kFwdBins];
      (which ? part_dc : part_db)[part + n0 + n] = v;
      // dlog to device memory for the weight kernel, 16-byte rows
      for (int i = threadIdx.x; i < kFwdBins * (kFwdPx / 4); i += kFwdThreads) {
        const int r = i / (kFwdPx / 4), q = 4 * (i % (kFwdPx / 4));
        *reinterpret_cast<float4*>(dlog + ((size_t)img * n_bins + n0 + r) * hw_pad + p0 + q) =
            *reinterpret_cast<const float4*>(dls + r * kDlogStride + q);
      }
    }
    if (phase >= kSlices) {  // dx += dlog W over this slice's bins
      tile_fma<kSliceCh>(dls + (phase - kSlices) * kSliceCh * kDlogStride, kDlogStride, xa, xb,
                         buf, kWtStride, wa, wb, dxa);
    }
    __syncthreads();  // every thread is done with this stage's buffer (and dlog, red)
  }

  // dx: the thread's 8 pixels of channels wa.. and wb..
  float* dx_img = dx + (size_t)img * kChannels * hw;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float* row = dx_img + (size_t)(j < 4 ? wa + j : wb + j - 4) * hw;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + (h ? xb : xa);
      if (vec_dx) {  // hw % 4 == 0: 4 pixels wholly in or out
        if (p < hw) {
          *reinterpret_cast<float4*>(row + p) =
              make_float4(dxa[4 * h][j], dxa[4 * h + 1][j], dxa[4 * h + 2][j], dxa[4 * h + 3][j]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (p + q < hw) row[p + q] = dxa[4 * h + q][j];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kFwdThreads, 1)
bins_head_bwd_weight_kernel(const float* __restrict__ x, const float* __restrict__ dlog,
                            float* __restrict__ part_dw, int batch, int hw, int hw_pad,
                            int n_bins, int vec) {
  extern __shared__ float4 smem[];
  float* xts = reinterpret_cast<float*>(smem);  // 2 x [kChannels][kDwStride]
  float* dlt = xts + 2 * kDwTileFloats;         // 2 x [kFwdBins][kDwStride]

  const int n0 = blockIdx.y * kFwdBins;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the thread's bins ib + 4 r and channels jc + 8 r, r < 8
  const int ib = (warp & 3) * 32 + (lane >> 3), jc = (warp >> 2) * 64 + (lane & 7);

  const int per_img = (hw + kDwPx - 1) / kDwPx, total = batch * per_img;
  const int per_block = (total + gridDim.x - 1) / gridDim.x;
  const int begin = min(total, (int)blockIdx.x * per_block), end = min(total, begin + per_block);

  auto load = [&](int buf, int tile) {  // features and dlog of one tile
    const int img = tile / per_img, p0 = (tile % per_img) * kDwPx;
    load_x_tile<kDwPx, kDwStride>(xts + buf * kDwTileFloats, x + (size_t)img * kChannels * hw,
                                  p0, hw, vec != 0);
    for (int i = threadIdx.x; i < kFwdBins * (kDwPx / 4); i += kFwdThreads) {
      const int r = i / (kDwPx / 4), q = 4 * (i % (kDwPx / 4));
      cp_async16(dlt + buf * kDwTileFloats + r * kDwStride + q,
                 dlog + ((size_t)img * n_bins + n0 + r) * hw_pad + p0 + q, 16);
    }
  };

  if (begin < end) load(0, begin);
  cp_async_commit();
  float dw[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int q = 0; q < 8; ++q) dw[r][q] = 0.f;
  }

  for (int tile = begin, buf = 0; tile < end; ++tile, buf ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // this tile is in; every thread is done with the previous one
    if (tile + 1 < end) load(buf ^ 1, tile + 1);
    cp_async_commit();
    const float* xs = xts + buf * kDwTileFloats;
    const float* dls = dlt + buf * kDwTileFloats;
    // dW += dlog X^T over the tile's pixels, 4 at a time
#pragma unroll 2
    for (int k = 0; k < kDwPx; k += 4) {
      float4 a[8], v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        a[r] = *reinterpret_cast<const float4*>(dls + (ib + 4 * r) * kDwStride + k);
        v[r] = *reinterpret_cast<const float4*>(xs + (jc + 8 * r) * kDwStride + k);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          float t = fmaf(a[r].x, v[q].x, dw[r][q]);
          t = fmaf(a[r].y, v[q].y, t);
          t = fmaf(a[r].z, v[q].z, t);
          dw[r][q] = fmaf(a[r].w, v[q].w, t);
        }
      }
    }
  }

  // this block's partial; a block with no tiles writes zeros
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float* row = part_dw + ((size_t)blockIdx.x * n_bins + n0 + ib + 4 * r) * kChannels + jc;
#pragma unroll
    for (int q = 0; q < 8; ++q) row[8 * q] = dw[r][q];
  }
}

cudaError_t weight_blocks(int batch, int hw, int n_bins, int device, int* blocks) {
  int sms = 0, occupancy = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bins_head_bwd_weight_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDwSmem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, bins_head_bwd_weight_kernel,
                                                      kFwdThreads, kDwSmem);
  if (err != cudaSuccess) return err;
  const long tiles = (long)batch * ((hw + kDwPx - 1) / kDwPx);
  const long columns = n_bins / kFwdBins;
  const long wanted = (long)sms * std::max(occupancy, 1) / std::max(columns, 1L);
  *blocks = (int)std::max(1L, std::min(tiles, wanted));
  return cudaSuccess;
}

cudaError_t launch_bwd(const float* x, const float* w, const float* b, const float* c,
                       const float* g, const float* out, const float* stats, float* dx,
                       float* dlog, float* part_db, float* part_dc, float* part_dw,
                       int dw_blocks, int batch, int hw, int n_bins, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(bins_head_bwd_pixel_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kPixSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bins_head_bwd_weight_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDwSmem);
  if (err != cudaSuccess) return err;
  const int vec_x = hw % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_dx = hw % 4 == 0 && reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const int blocks = (hw + kFwdPx - 1) / kFwdPx, hw_pad = blocks * kFwdPx;
  bins_head_bwd_pixel_kernel<<<dim3(blocks, batch), kFwdThreads, kPixSmem, stream>>>(
      x, w, b, c, g, out, stats, dx, dlog, part_db, part_dc, hw, hw_pad, n_bins, vec_x, vec_dx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bins_head_bwd_weight_kernel<<<dim3(dw_blocks, n_bins / kFwdBins), kFwdThreads, kDwSmem,
                                stream>>>(x, dlog, part_dw, batch, hw, hw_pad, n_bins, vec_x);
  return cudaGetLastError();
}

}  // namespace

// x: (batch, 128, hw) f32; w: (n_bins, 128) f32; b: (n_bins,) f32;
// c: (batch, n_bins) f32; out: (batch, hw) f32, the depth; stats: null, or
// (2, batch, hw) f32 for each pixel's softmax max and sum. n_bins is a
// multiple of 128. All contiguous, on `device`, whose stream `stream` is.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mde_bins_head_fwd(const void* x, const void* w, const void* b, const void* c,
                                 void* out, void* stats, int batch, int hw, int n_bins,
                                 int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  return (int)launch(static_cast<const float*>(x), static_cast<const float*>(w),
                     static_cast<const float*>(b), static_cast<const float*>(c),
                     static_cast<float*>(out), static_cast<float*>(stats), batch, hw, n_bins,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int mde_bins_head_bwd_pixels_per_block() { return kFwdPx; }

// Blocks along the pixels of the backward weight kernel (its grid is this
// by n_bins / 128): one wave over the card. Negative on error.
extern "C" int mde_bins_head_bwd_weight_blocks(int batch, int hw, int n_bins, int device) {
  int blocks = 0;
  if (cudaSetDevice(device) != cudaSuccess ||
      weight_blocks(batch, hw, n_bins, device, &blocks) != cudaSuccess) {
    return -1;
  }
  return blocks;
}

// x, w, b, c as for the forward; g: (batch, hw) f32, the gradient of the
// depth; out and stats: the forward's depth and (max, sum). Writes dx:
// (batch, 128, hw) f32; dlog: (batch, n_bins, P) f32 scratch, P = hw
// rounded up to the pixel kernel's 128 pixels a block (16-byte aligned);
// part_db, part_dc: (batch, P / 128, n_bins) f32 partials; part_dw:
// (dw_blocks, n_bins, 128) f32 partials, dw_blocks from
// mde_bins_head_bwd_weight_blocks. n_bins is a multiple of 128. All
// contiguous, on `device`, whose stream `stream` is. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int mde_bins_head_bwd(const void* x, const void* w, const void* b, const void* c,
                                 const void* g, const void* out, const void* stats, void* dx,
                                 void* dlog, void* part_db, void* part_dc, void* part_dw,
                                 int dw_blocks, int batch, int hw, int n_bins, int device,
                                 void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  return (int)launch_bwd(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(g), static_cast<const float*>(out),
      static_cast<const float*>(stats), static_cast<float*>(dx), static_cast<float*>(dlog),
      static_cast<float*>(part_db), static_cast<float*>(part_dc), static_cast<float*>(part_dw),
      dw_blocks, batch, hw, n_bins, static_cast<cudaStream_t>(stream));
}

extern "C" const char* mde_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
