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
//  - Each thread accumulates 8 pixels x 8 bins in 64 registers: per channel
//    two LDS.128 of X and two of W^T feed 64 FMAs. A warp is 4 pixel groups
//    x 8 bin groups, and a thread's 8 pixels (bins) are two runs of 4 half a
//    tile apart, so each LDS.128 reads 64 (128) contiguous bytes: one
//    wavefront, no bank conflict.
//  - After each chunk a thread folds its 8 bins into a running (max, sum,
//    sum e c) for each of its 8 pixels, in registers: no thread talks to
//    another inside the bin loop, and every bin count that is a multiple of
//    128 runs. At the end the 16 threads that share a pixel merge their
//    states through shared memory by the log-sum-exp rule.
//  - Pixels past hw are zero in the tile and not written. A feature row
//    moves in 16-byte copies where hw % 4 == 0 and the features are 16-byte
//    aligned, else element by element into the same layout.

#include <cuda_runtime.h>
#include <math_constants.h>

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

// The block's feature tile, channel rows of kFwdPx pixels from p0.
__device__ __forceinline__ void load_x_tile(float* xs, const float* x_img, int p0, int hw,
                                            bool vec) {
  if (vec) {  // hw % 4 == 0: a 4-pixel chunk is wholly in or out
    constexpr int kRowChunks = kFwdPx / 4;
    for (int i = threadIdx.x; i < kChannels * kRowChunks; i += kFwdThreads) {
      const int ch = i / kRowChunks, p = p0 + 4 * (i % kRowChunks);
      const bool in = p < hw;
      cp_async16(xs + 4 * i, x_img + (size_t)ch * hw + (in ? p : 0), in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kChannels * kFwdPx; i += kFwdThreads) {
      const int ch = i / kFwdPx, p = p0 + i % kFwdPx;
      const bool in = p < hw;
      cp_async4(xs + i, x_img + (size_t)ch * hw + (in ? p : 0), in ? 4 : 0);
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

__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks)
bins_head_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, const float* __restrict__ c,
                     float* __restrict__ out, int hw, int n_bins, int vec) {
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

  load_x_tile(xs, x + (size_t)img * kChannels * hw, p0, hw, vec != 0);
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

    const float* xk = xs + (st % kSlices) * kSliceCh * kFwdPx;
    const float* wk = wts + (st & 1) * kStageFloats;
#pragma unroll 8
    for (int k = 0; k < kSliceCh; ++k) {
      const float4 x0 = *reinterpret_cast<const float4*>(xk + k * kFwdPx + xa);
      const float4 x1 = *reinterpret_cast<const float4*>(xk + k * kFwdPx + xb);
      const float4 w0 = *reinterpret_cast<const float4*>(wk + k * kWtStride + wa);
      const float4 w1 = *reinterpret_cast<const float4*>(wk + k * kWtStride + wb);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      }
    }

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
    out[(size_t)img * hw + p0 + px] = depth / sum;
  }
}

cudaError_t launch(const float* x, const float* w, const float* b, const float* c, float* out,
                   int batch, int hw, int n_bins, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(bins_head_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kFwdSmem);
  if (err != cudaSuccess) return err;
  const int vec = hw % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((hw + kFwdPx - 1) / kFwdPx, batch);
  bins_head_fwd_kernel<<<grid, kFwdThreads, kFwdSmem, stream>>>(x, w, b, c, out, hw, n_bins,
                                                                vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward.
//
// Replaces the Pallas TPU kernel mde_tpu/kernels/bins_head.py::_bwd_kernel
// (launched per image by _bwd_one; its per-tile partials folded by
// _fused_core_bwd). With p = softmax(logit), depth = sum_n p_n c_n and the
// upstream gradient g of the depth:
//   dlog_n = p_n (c_n - depth) g
//   dx     = sum_n dlog_n W[n, :]           per pixel
//   dW     = sum_px dlog x^T,  db = sum_px dlog      over the batch
//   dc_n   = sum_px p_n g                             per image
// recomputing the logits instead of keeping them.
//
// A thread holding a pixel's 128 channels and its 128 dx sums needs more
// than the 255 registers a thread has, so two threads share a pixel: lanes
// l and l^16 of a warp hold channels 0-63 and 64-127, and a logit is their
// two half dot products added with one shuffle. Two kernels:
//  1. pixel kernel, 64 pixels per block (16 per warp): pass 1 runs the
//     online softmax over the bins (max, sum, depth); pass 2 recomputes each
//     logit, forms dlog, accumulates dx in registers and sums p g and dlog
//     over the warp's pixels with shuffles (lanes 0-15 carry p g, lanes
//     16-31 dlog) into shared memory. It writes dx, the per-block db and dc
//     partials and each pixel's (max, sum, depth) for kernel 2.
//  2. weight kernel, 64 bins per block (two threads a bin, holding half of
//     its W row): it walks a range of pixels staged through shared memory,
//     recomputes the logit and dlog from the pixel's saved (max, sum, depth)
//     and accumulates dlog x for its bin in registers; it writes per-block
//     dW partials.
// The wrapper folds all partials with torch (as _fused_core_bwd folds its
// lanes and images). Both kernels compute a logit with the same code, so they
// agree on dlog bit for bit.
//
// What bounds it. 3 x 2 x 128 x n_bins flops per pixel (logits, dx, dW) at
// the least: at the flagship training shape (16 x 208 x 272 pixels, 256
// bins) 178 GFLOP, at least 2.7 ms on the f32 CUDA cores; these kernels
// compute the logits three times (5 x 2 x 128 x n_bins per pixel). The x
// read and dx write are 2 x 463 MB, 0.28 ms at 3.35 TB/s. So the FMAs bound
// this version. The float32 backward runs only under --compute_dtype
// float32; the default bf16 training takes bins_head_tc.cu.

constexpr int kBinsPerChunk = 128;      // pixel kernel: bins staged in shared memory at a time
constexpr int kHalf = kChannels / 2;    // channels per thread of a pair
constexpr int kPixPerBlockBwd = 64;     // pixel kernel: 4 warps x 16 pixels
constexpr int kBinsPerBlockDw = 64;     // weight kernel: 4 warps x 16 bins
constexpr int kPixPerBlockDw = 2048;    // weight kernel: pixels walked per block
constexpr int kPixStage = 32;           // weight kernel: pixels staged at a time
constexpr int kStageRow = 2 * (kHalf + 4);  // staged pixel row, halves 4 floats apart
constexpr size_t kSmemBwd =
    (size_t)(kBinsPerChunk * kChannels + 4 * kBinsPerChunk) * sizeof(float);
constexpr unsigned kFull = 0xffffffffu;

// Dot product of 64 weights and 64 features, one operand in registers and
// the other read from shared memory as float4s. Both forms sum in the same
// order, so the two backward kernels compute the same logits.
__device__ __forceinline__ float half_dot(const float4* shared4, const float* regs) {
  float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
  for (int q = 0; q < kHalf / 4; ++q) {
    const float4 v = shared4[q];
    d0 = fmaf(v.x, regs[4 * q + 0], d0);
    d1 = fmaf(v.y, regs[4 * q + 1], d1);
    d2 = fmaf(v.z, regs[4 * q + 2], d2);
    d3 = fmaf(v.w, regs[4 * q + 3], d3);
  }
  return (d0 + d1) + (d2 + d3);
}

// acc[i] += s * shared[i] for the 64 values of a half row.
__device__ __forceinline__ void half_axpy(float s, const float4* shared4, float* acc) {
#pragma unroll
  for (int q = 0; q < kHalf / 4; ++q) {
    const float4 v = shared4[q];
    acc[4 * q + 0] = fmaf(s, v.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(s, v.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(s, v.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(s, v.w, acc[4 * q + 3]);
  }
}

// The full logit of a pixel from the two halves' dot products; every lane of
// the warp must call it.
__device__ __forceinline__ float pair_logit(float partial, float bias) {
  return partial + __shfl_xor_sync(kFull, partial, 16) + bias;
}

__global__ void __launch_bounds__(kPixPerBlockBwd * 2)
bins_head_bwd_pixel_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           const float* __restrict__ b, const float* __restrict__ c,
                           const float* __restrict__ g, float* __restrict__ dx,
                           float* __restrict__ stats, float* __restrict__ part_db,
                           float* __restrict__ part_dc, int batch, int hw, int n_bins) {
  extern __shared__ float4 smem[];
  float* w_s = reinterpret_cast<float*>(smem);   // [kBinsPerChunk][kChannels]
  float* b_s = w_s + kBinsPerChunk * kChannels;  // [kBinsPerChunk]
  float* c_s = b_s + kBinsPerChunk;              // [kBinsPerChunk]
  float* db_s = c_s + kBinsPerChunk;             // [kBinsPerChunk]
  float* dc_s = db_s + kBinsPerChunk;            // [kBinsPerChunk]

  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int img = blockIdx.y;
  const int pix = blockIdx.x * kPixPerBlockBwd + (threadIdx.x >> 5) * 16 + (lane & 15);
  const bool live = pix < hw;

  float xr[kHalf];
  const float* xp = x + ((size_t)img * kChannels + half * kHalf) * hw + (live ? pix : 0);
#pragma unroll
  for (int ch = 0; ch < kHalf; ++ch) {
    xr[ch] = live ? xp[(size_t)ch * hw] : 0.f;
  }
  const float gv = live ? g[(size_t)img * hw + pix] : 0.f;
  const float* c_img = c + (size_t)img * n_bins;

  auto stage = [&](int n0, int nb) {
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < nb * kChannels; i += blockDim.x) {
      w_s[i] = w[(size_t)n0 * kChannels + i];
    }
    for (int i = threadIdx.x; i < nb; i += blockDim.x) {
      b_s[i] = b[n0 + i];
      c_s[i] = c_img[n0 + i];
      db_s[i] = 0.f;
      dc_s[i] = 0.f;
    }
    __syncthreads();
  };

  // Pass 1: softmax max, sum and depth.
  float run_max = -CUDART_INF_F, run_sum = 0.f, run_depth = 0.f;
  for (int n0 = 0; n0 < n_bins; n0 += kBinsPerChunk) {
    const int nb = min(kBinsPerChunk, n_bins - n0);
    stage(n0, nb);
    for (int n = 0; n < nb; ++n) {
      const float4* w_row = reinterpret_cast<const float4*>(w_s + n * kChannels + half * kHalf);
      const float logit = pair_logit(half_dot(w_row, xr), b_s[n]);
      if (logit > run_max) {
        const float scale = expf(run_max - logit);
        run_sum *= scale;
        run_depth *= scale;
        run_max = logit;
      }
      const float e = expf(logit - run_max);
      run_sum += e;
      run_depth = fmaf(e, c_s[n], run_depth);
    }
  }
  const float depth = run_depth / run_sum;

  // Pass 2: dlog, dx, and the block's db and dc.
  float dxr[kHalf];
#pragma unroll
  for (int ch = 0; ch < kHalf; ++ch) dxr[ch] = 0.f;
  const size_t part = ((size_t)img * gridDim.x + blockIdx.x) * n_bins;
  for (int n0 = 0; n0 < n_bins; n0 += kBinsPerChunk) {
    const int nb = min(kBinsPerChunk, n_bins - n0);
    stage(n0, nb);
    for (int n = 0; n < nb; ++n) {
      const float4* w_row = reinterpret_cast<const float4*>(w_s + n * kChannels + half * kHalf);
      const float logit = pair_logit(half_dot(w_row, xr), b_s[n]);
      const float pg = expf(logit - run_max) / run_sum * gv;
      const float dlog = pg * (c_s[n] - depth);
      half_axpy(dlog, w_row, dxr);
      // lanes 0-15 sum p g (for dc), lanes 16-31 dlog (for db), over the
      // warp's 16 pixels
      float v = half ? dlog : pg;
      v += __shfl_xor_sync(kFull, v, 8);
      v += __shfl_xor_sync(kFull, v, 4);
      v += __shfl_xor_sync(kFull, v, 2);
      v += __shfl_xor_sync(kFull, v, 1);
      if ((lane & 15) == 0) atomicAdd(half ? &db_s[n] : &dc_s[n], v);
    }
    __syncthreads();  // the chunk's sums are in
    for (int i = threadIdx.x; i < nb; i += blockDim.x) {
      part_db[part + n0 + i] = db_s[i];
      part_dc[part + n0 + i] = dc_s[i];
    }
  }

  if (live) {
    float* dxp = dx + ((size_t)img * kChannels + half * kHalf) * hw + pix;
#pragma unroll
    for (int ch = 0; ch < kHalf; ++ch) dxp[(size_t)ch * hw] = dxr[ch];
    if (half == 0) {
      const size_t plane = (size_t)batch * hw;
      const size_t at = (size_t)img * hw + pix;
      stats[at] = run_max;
      stats[plane + at] = run_sum;
      stats[2 * plane + at] = depth;
    }
  }
}

__global__ void __launch_bounds__(kBinsPerBlockDw * 2)
bins_head_bwd_weight_kernel(const float* __restrict__ x, const float* __restrict__ w,
                            const float* __restrict__ b, const float* __restrict__ c,
                            const float* __restrict__ g, const float* __restrict__ stats,
                            float* __restrict__ part_dw, int batch, int hw, int n_bins) {
  __shared__ __align__(16) float x_s[kPixStage * kStageRow];
  __shared__ float max_s[kPixStage], sum_s[kPixStage], depth_s[kPixStage], g_s[kPixStage];

  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int img = blockIdx.z;
  const int bin = blockIdx.y * kBinsPerBlockDw + (threadIdx.x >> 5) * 16 + (lane & 15);

  float wr[kHalf];
  const float* w_row = w + (size_t)bin * kChannels + half * kHalf;
#pragma unroll
  for (int ch = 0; ch < kHalf; ++ch) wr[ch] = w_row[ch];
  const float bias = b[bin];
  const float center = c[(size_t)img * n_bins + bin];
  float acc[kHalf];
#pragma unroll
  for (int ch = 0; ch < kHalf; ++ch) acc[ch] = 0.f;

  const size_t plane = (size_t)batch * hw;
  const float* x_img = x + (size_t)img * kChannels * hw;
  const int begin = blockIdx.x * kPixPerBlockDw;
  const int end = min(hw, begin + kPixPerBlockDw);
  for (int p0 = begin; p0 < end; p0 += kPixStage) {
    const int count = min(kPixStage, end - p0);
    __syncthreads();  // every thread is done with the previous pixels
    for (int i = threadIdx.x; i < kPixStage * kChannels; i += blockDim.x) {
      const int ch = i / kPixStage, j = i % kPixStage;
      const float v = j < count ? x_img[(size_t)ch * hw + p0 + j] : 0.f;
      x_s[j * kStageRow + (ch / kHalf) * (kHalf + 4) + ch % kHalf] = v;
    }
    for (int j = threadIdx.x; j < count; j += blockDim.x) {
      const size_t at = (size_t)img * hw + p0 + j;
      max_s[j] = stats[at];
      sum_s[j] = stats[plane + at];
      depth_s[j] = stats[2 * plane + at];
      g_s[j] = g[at];
    }
    __syncthreads();
    for (int j = 0; j < count; ++j) {
      const float4* xj = reinterpret_cast<const float4*>(x_s + j * kStageRow + half * (kHalf + 4));
      const float logit = pair_logit(half_dot(xj, wr), bias);
      const float pg = expf(logit - max_s[j]) / sum_s[j] * g_s[j];
      const float dlog = pg * (center - depth_s[j]);
      half_axpy(dlog, xj, acc);
    }
  }

  float* out = part_dw + (((size_t)img * gridDim.x + blockIdx.x) * n_bins + bin) * kChannels +
               half * kHalf;
#pragma unroll
  for (int ch = 0; ch < kHalf; ++ch) out[ch] = acc[ch];
}

cudaError_t launch_bwd(const float* x, const float* w, const float* b, const float* c,
                       const float* g, float* dx, float* stats, float* part_db, float* part_dc,
                       float* part_dw, int batch, int hw, int n_bins, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(bins_head_bwd_pixel_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBwd);
  if (err != cudaSuccess) return err;
  const dim3 grid1((hw + kPixPerBlockBwd - 1) / kPixPerBlockBwd, batch);
  bins_head_bwd_pixel_kernel<<<grid1, kPixPerBlockBwd * 2, kSmemBwd, stream>>>(
      x, w, b, c, g, dx, stats, part_db, part_dc, batch, hw, n_bins);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2((hw + kPixPerBlockDw - 1) / kPixPerBlockDw, n_bins / kBinsPerBlockDw,
                   batch);
  bins_head_bwd_weight_kernel<<<grid2, kBinsPerBlockDw * 2, 0, stream>>>(
      x, w, b, c, g, stats, part_dw, batch, hw, n_bins);
  return cudaGetLastError();
}

}  // namespace

// x: (batch, 128, hw) f32; w: (n_bins, 128) f32; b: (n_bins,) f32;
// c: (batch, n_bins) f32; out: (batch, hw) f32. n_bins is a multiple of 128.
// All contiguous, on `device`, whose stream `stream` is. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int mde_bins_head_fwd(const void* x, const void* w, const void* b, const void* c,
                                 void* out, int batch, int hw, int n_bins, int device,
                                 void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  return (int)launch(static_cast<const float*>(x), static_cast<const float*>(w),
                     static_cast<const float*>(b), static_cast<const float*>(c),
                     static_cast<float*>(out), batch, hw, n_bins,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int mde_bins_head_bwd_pixels_per_block() { return kPixPerBlockBwd; }
extern "C" int mde_bins_head_bwd_weight_pixels_per_block() { return kPixPerBlockDw; }

// x: (batch, 128, hw) f32; w: (n_bins, 128) f32; b: (n_bins,) f32;
// c: (batch, n_bins) f32; g: (batch, hw) f32, the gradient of the depth.
// Writes dx: (batch, 128, hw) f32; stats: (3, batch, hw) f32 scratch;
// part_db, part_dc: (batch, ceil(hw / 64), n_bins) f32 partials;
// part_dw: (batch, ceil(hw / 2048), n_bins, 128) f32 partials. n_bins is a
// multiple of 64. All contiguous, on `device`, whose stream `stream` is.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int mde_bins_head_bwd(const void* x, const void* w, const void* b, const void* c,
                                 const void* g, void* dx, void* stats, void* part_db,
                                 void* part_dc, void* part_dw, int batch, int hw, int n_bins,
                                 int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  return (int)launch_bwd(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(g), static_cast<float*>(dx),
      static_cast<float*>(stats), static_cast<float*>(part_db), static_cast<float*>(part_dc),
      static_cast<float*>(part_dw), batch, hw, n_bins, static_cast<cudaStream_t>(stream));
}

extern "C" const char* mde_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
