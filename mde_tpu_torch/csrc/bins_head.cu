// Fused AdaBins bins head, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mde_tpu/kernels/bins_head.py::_fwd_kernel
// (launched per image by _fwd_one). For every pixel of the decoder's
// 128-channel range-attention map:
//   logit_n = sum_c W[n, c] x[c] + b[n]               (n < n_bins)
//   depth   = sum_n softmax(logit)_n * centers[n]
// without writing the (B, n_bins, HW) logits to device memory.
//
// Layout. The port is NCHW, so per image the features are a channel-major
// (128, HW) matrix. A block owns kTile consecutive pixels of one image and
// each thread owns one pixel: for a fixed channel, neighbouring threads read
// neighbouring addresses (coalesced), and the thread keeps its pixel's 128
// channels in registers. W, b and the image's centers are staged through
// shared memory kBinsPerChunk bins at a time (66,560 bytes, above the 48 KB
// default, hence the attribute); every thread reads the same W row, which
// shared memory broadcasts. An online softmax (running max, sum and
// centers-weighted sum) carries across the chunks. The ragged pixel edge is
// masked here; the wrapper takes any HW.
//
// What bounds it. At the serving shape (B=2, 240x320 pixels, 256 bins) the
// head is 2*128*256 = 65,536 flops per pixel, about 10 GFLOP per request, on
// the f32 CUDA cores (67 TFLOP/s), against about 79 MB of feature reads
// (3.35 TB/s): some 0.15 ms of FMAs against 0.02 ms of reads, so the FMAs
// and the shared-memory loads that feed them bound this version. Moving the
// logits onto the tensor cores (wgmma on TMA-fed tiles) is later work.
//
// bf16 features reproduce the JAX rounding points (_logits_block): W rounded
// to bf16, products accumulated in f32, the logit rounded to bf16, the bf16
// bias added in bf16, then f32 for the softmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kChannels = 128;      // decoder output channels (conv_out input)
constexpr int kTile = 128;          // pixels per block = threads per block
constexpr int kBinsPerChunk = 128;  // bins staged in shared memory at a time
constexpr size_t kSmemBytes =
    (size_t)(kBinsPerChunk * kChannels + 2 * kBinsPerChunk) * sizeof(float);

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(kTile)
bins_head_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, const float* __restrict__ c,
                     float* __restrict__ out, int hw, int n_bins) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ float4 smem[];
  float* w_s = reinterpret_cast<float*>(smem);  // [kBinsPerChunk][kChannels]
  float* b_s = w_s + kBinsPerChunk * kChannels;  // [kBinsPerChunk]
  float* c_s = b_s + kBinsPerChunk;              // [kBinsPerChunk]

  const int img = blockIdx.y;
  const int pix = blockIdx.x * kTile + threadIdx.x;
  const bool live = pix < hw;

  float xr[kChannels];
  const T* xp = x + (size_t)img * kChannels * hw + (live ? pix : 0);
#pragma unroll
  for (int ch = 0; ch < kChannels; ++ch) {
    xr[ch] = live ? to_float(xp[(size_t)ch * hw]) : 0.f;
  }

  const float* c_img = c + (size_t)img * n_bins;
  float run_max = -CUDART_INF_F, run_sum = 0.f, run_depth = 0.f;
  for (int n0 = 0; n0 < n_bins; n0 += kBinsPerChunk) {
    const int nb = min(kBinsPerChunk, n_bins - n0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < nb * kChannels; i += kTile) {
      const float v = w[(size_t)n0 * kChannels + i];
      w_s[i] = kBf16 ? round_bf16(v) : v;
    }
    for (int i = threadIdx.x; i < nb; i += kTile) {
      b_s[i] = kBf16 ? round_bf16(b[n0 + i]) : b[n0 + i];
      c_s[i] = c_img[n0 + i];
    }
    __syncthreads();

    for (int n = 0; n < nb; ++n) {
      const float4* w_row = reinterpret_cast<const float4*>(w_s + n * kChannels);
      float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
      for (int q = 0; q < kChannels / 4; ++q) {
        const float4 wv = w_row[q];
        d0 = fmaf(wv.x, xr[4 * q + 0], d0);
        d1 = fmaf(wv.y, xr[4 * q + 1], d1);
        d2 = fmaf(wv.z, xr[4 * q + 2], d2);
        d3 = fmaf(wv.w, xr[4 * q + 3], d3);
      }
      const float dot = (d0 + d1) + (d2 + d3);
      const float logit = kBf16 ? round_bf16(round_bf16(dot) + b_s[n]) : dot + b_s[n];
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
  if (live) out[(size_t)img * hw + pix] = run_depth / run_sum;
}

template <typename T>
cudaError_t launch(const void* x, const float* w, const float* b, const float* c,
                   float* out, int batch, int hw, int n_bins, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(bins_head_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((hw + kTile - 1) / kTile, batch);
  bins_head_fwd_kernel<T><<<grid, kTile, kSmemBytes, stream>>>(
      static_cast<const T*>(x), w, b, c, out, hw, n_bins);
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
// bf16 features keep the JAX rounding points: logits as in the forward, and
// dlog rounded to bf16 before both products (dx = dlog_bf16 W_bf16 summed in
// f32, then rounded to bf16; dW = sum dlog_bf16 x_bf16 in f32); db and dc
// are summed from the f32 values.
//
// What bounds it. 3 x 2 x 128 x n_bins flops per pixel (logits, dx, dW) at
// the least: at the flagship training shape (16 x 208 x 272 pixels, 256
// bins) 178 GFLOP, at least 2.7 ms on the f32 CUDA cores; these kernels
// compute the logits three times (5 x 2 x 128 x n_bins per pixel). The x
// read and dx write are 2 x 232 MB in bf16, 0.14 ms at 3.35 TB/s. So the
// FMAs bound this version; moving the three products onto the tensor cores
// is later work.

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
template <bool kBf16>
__device__ __forceinline__ float pair_logit(float partial, float bias) {
  const float dot = partial + __shfl_xor_sync(kFull, partial, 16);
  return kBf16 ? round_bf16(round_bf16(dot) + bias) : dot + bias;
}

__device__ __forceinline__ float to_storage(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_storage(float v, __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kPixPerBlockBwd * 2)
bins_head_bwd_pixel_kernel(const T* __restrict__ x, const float* __restrict__ w,
                           const float* __restrict__ b, const float* __restrict__ c,
                           const float* __restrict__ g, T* __restrict__ dx,
                           float* __restrict__ stats, float* __restrict__ part_db,
                           float* __restrict__ part_dc, int batch, int hw, int n_bins) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
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
  const T* xp = x + ((size_t)img * kChannels + half * kHalf) * hw + (live ? pix : 0);
#pragma unroll
  for (int ch = 0; ch < kHalf; ++ch) {
    xr[ch] = live ? to_float(xp[(size_t)ch * hw]) : 0.f;
  }
  const float gv = live ? g[(size_t)img * hw + pix] : 0.f;
  const float* c_img = c + (size_t)img * n_bins;

  auto stage = [&](int n0, int nb) {
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < nb * kChannels; i += blockDim.x) {
      const float v = w[(size_t)n0 * kChannels + i];
      w_s[i] = kBf16 ? round_bf16(v) : v;
    }
    for (int i = threadIdx.x; i < nb; i += blockDim.x) {
      b_s[i] = kBf16 ? round_bf16(b[n0 + i]) : b[n0 + i];
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
      const float logit = pair_logit<kBf16>(half_dot(w_row, xr), b_s[n]);
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
      const float logit = pair_logit<kBf16>(half_dot(w_row, xr), b_s[n]);
      const float pg = expf(logit - run_max) / run_sum * gv;
      const float dlog = pg * (c_s[n] - depth);
      const float dlog_c = kBf16 ? round_bf16(dlog) : dlog;
      half_axpy(dlog_c, w_row, dxr);
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
    T* dxp = dx + ((size_t)img * kChannels + half * kHalf) * hw + pix;
#pragma unroll
    for (int ch = 0; ch < kHalf; ++ch) {
      dxp[(size_t)ch * hw] = to_storage(dxr[ch], static_cast<T*>(nullptr));
    }
    if (half == 0) {
      const size_t plane = (size_t)batch * hw;
      const size_t at = (size_t)img * hw + pix;
      stats[at] = run_max;
      stats[plane + at] = run_sum;
      stats[2 * plane + at] = depth;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBinsPerBlockDw * 2)
bins_head_bwd_weight_kernel(const T* __restrict__ x, const float* __restrict__ w,
                            const float* __restrict__ b, const float* __restrict__ c,
                            const float* __restrict__ g, const float* __restrict__ stats,
                            float* __restrict__ part_dw, int batch, int hw, int n_bins) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  __shared__ __align__(16) float x_s[kPixStage * kStageRow];
  __shared__ float max_s[kPixStage], sum_s[kPixStage], depth_s[kPixStage], g_s[kPixStage];

  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int img = blockIdx.z;
  const int bin = blockIdx.y * kBinsPerBlockDw + (threadIdx.x >> 5) * 16 + (lane & 15);

  float wr[kHalf];
  const float* w_row = w + (size_t)bin * kChannels + half * kHalf;
#pragma unroll
  for (int ch = 0; ch < kHalf; ++ch) wr[ch] = kBf16 ? round_bf16(w_row[ch]) : w_row[ch];
  const float bias = kBf16 ? round_bf16(b[bin]) : b[bin];
  const float center = c[(size_t)img * n_bins + bin];
  float acc[kHalf];
#pragma unroll
  for (int ch = 0; ch < kHalf; ++ch) acc[ch] = 0.f;

  const size_t plane = (size_t)batch * hw;
  const T* x_img = x + (size_t)img * kChannels * hw;
  const int begin = blockIdx.x * kPixPerBlockDw;
  const int end = min(hw, begin + kPixPerBlockDw);
  for (int p0 = begin; p0 < end; p0 += kPixStage) {
    const int count = min(kPixStage, end - p0);
    __syncthreads();  // every thread is done with the previous pixels
    for (int i = threadIdx.x; i < kPixStage * kChannels; i += blockDim.x) {
      const int ch = i / kPixStage, j = i % kPixStage;
      const float v = j < count ? to_float(x_img[(size_t)ch * hw + p0 + j]) : 0.f;
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
      const float logit = pair_logit<kBf16>(half_dot(xj, wr), bias);
      const float pg = expf(logit - max_s[j]) / sum_s[j] * g_s[j];
      const float dlog = pg * (center - depth_s[j]);
      const float dlog_c = kBf16 ? round_bf16(dlog) : dlog;
      half_axpy(dlog_c, xj, acc);
    }
  }

  float* out = part_dw + (((size_t)img * gridDim.x + blockIdx.x) * n_bins + bin) * kChannels +
               half * kHalf;
#pragma unroll
  for (int ch = 0; ch < kHalf; ++ch) out[ch] = acc[ch];
}

template <typename T>
cudaError_t launch_bwd(const void* x, const float* w, const float* b, const float* c,
                       const float* g, void* dx, float* stats, float* part_db,
                       float* part_dc, float* part_dw, int batch, int hw, int n_bins,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(bins_head_bwd_pixel_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBwd);
  if (err != cudaSuccess) return err;
  const dim3 grid1((hw + kPixPerBlockBwd - 1) / kPixPerBlockBwd, batch);
  bins_head_bwd_pixel_kernel<T><<<grid1, kPixPerBlockBwd * 2, kSmemBwd, stream>>>(
      static_cast<const T*>(x), w, b, c, g, static_cast<T*>(dx), stats, part_db, part_dc,
      batch, hw, n_bins);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid2((hw + kPixPerBlockDw - 1) / kPixPerBlockDw, n_bins / kBinsPerBlockDw,
                   batch);
  bins_head_bwd_weight_kernel<T><<<grid2, kBinsPerBlockDw * 2, 0, stream>>>(
      static_cast<const T*>(x), w, b, c, g, stats, part_dw, batch, hw, n_bins);
  return cudaGetLastError();
}

}  // namespace

// x: (batch, 128, hw) f32 or bf16; w: (n_bins, 128) f32; b: (n_bins,) f32;
// c: (batch, n_bins) f32; out: (batch, hw) f32. All contiguous, on `device`,
// whose stream `stream` is. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int mde_bins_head_fwd(const void* x, int x_is_bf16, const void* w,
                                 const void* b, const void* c, void* out, int batch,
                                 int hw, int n_bins, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_is_bf16 ? launch<__nv_bfloat16>(x, wf, bf, cf, of, batch, hw, n_bins, s)
                : launch<float>(x, wf, bf, cf, of, batch, hw, n_bins, s);
  return (int)err;
}

extern "C" int mde_bins_head_bwd_pixels_per_block() { return kPixPerBlockBwd; }
extern "C" int mde_bins_head_bwd_weight_pixels_per_block() { return kPixPerBlockDw; }

// x: (batch, 128, hw) f32 or bf16; w: (n_bins, 128) f32; b: (n_bins,) f32;
// c: (batch, n_bins) f32; g: (batch, hw) f32, the gradient of the depth.
// Writes dx: (batch, 128, hw) in x's type; stats: (3, batch, hw) f32 scratch;
// part_db, part_dc: (batch, ceil(hw / 64), n_bins) f32 partials;
// part_dw: (batch, ceil(hw / 2048), n_bins, 128) f32 partials. n_bins is a
// multiple of 64. All contiguous, on `device`, whose stream `stream` is.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int mde_bins_head_bwd(const void* x, int x_is_bf16, const void* w, const void* b,
                                 const void* c, const void* g, void* dx, void* stats,
                                 void* part_db, void* part_dc, void* part_dw, int batch,
                                 int hw, int n_bins, int device, void* stream) {
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  const float* gf = static_cast<const float*>(g);
  float* sf = static_cast<float*>(stats);
  float* dbf = static_cast<float*>(part_db);
  float* dcf = static_cast<float*>(part_dc);
  float* dwf = static_cast<float*>(part_dw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_is_bf16 ? launch_bwd<__nv_bfloat16>(x, wf, bf, cf, gf, dx, sf, dbf, dcf, dwf, batch,
                                            hw, n_bins, s)
                : launch_bwd<float>(x, wf, bf, cf, gf, dx, sf, dbf, dcf, dwf, batch, hw,
                                    n_bins, s);
  return (int)err;
}

extern "C" const char* mde_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
