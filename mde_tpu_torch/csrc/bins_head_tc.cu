// Fused AdaBins bins head on the tensor cores: the bf16 forward and backward
// for Hopper (sm_90a). The float32 path keeps the CUDA-core kernels of
// bins_head.cu; the wrapper (kernels/bins_head.py) picks the family by the
// features' dtype.
//
// Replaces the Pallas TPU kernels of mde_tpu/kernels/bins_head.py:
// _fwd_kernel (:76, launched per image by _fwd_one) and _bwd_kernel (:84,
// launched per image by _bwd_one, its per-tile sums folded by
// _fused_core_bwd). For each pixel's 128-channel feature x, with W the
// (n_bins, 128) conv_out weight, b its bias and c the image's bin centres:
//   logit  = W x + b,  p = softmax(logit),  depth = sum_n p_n c_n
//   dlog_n = p_n (c_n - depth) g            (g: the depth's gradient)
//   dx = W^T dlog,  dW = sum_px dlog x^T,  db = sum_px dlog,
//   dc = sum_px p g (per image)
//
// The head is attention with a scalar value: each pixel is a 128-dim query,
// the bins are keys shared by every pixel, the centres a 1-wide value. So
// the forward is a flash-attention forward and the backward its dQ (dx) and
// dK (dW, summed over all pixels).
//
// Design: mma.sync.m16n8k16 (bf16 in, f32 sums) with ldmatrix(.trans)
// operand loads and cp.async double buffering. This is the second design
// the port's plan allows beside wgmma/TMA: every operand layout here is
// fixed by the PTX fragment definitions, where a wgmma shared-memory
// descriptor can only be checked on the card; wgmma is later work (ROADMAP
// queue 2).
//
// Layouts. Per image the features are a channel-major (128, HW) matrix,
// pixels contiguous; W is (n_bins, 128), channels contiguous. Each operand
// keeps one physical shared-memory layout, read as ldmatrix or
// ldmatrix.trans as the product needs:
//  - W: bf16, [bin][channel], 256-byte rows whose 16-byte chunks are XOR-
//    swizzled by (row & 7), rounded to bf16 as it is staged. Non-trans reads
//    give the B operand of S = X^T W^T, trans reads that of dx = dlog W.
//  - a forward / pixel-kernel warp's 16-pixel slice of X: [channel][16 px],
//    32-byte rows, chunks swizzled by (row >> 2) & 1; trans reads give the
//    A operand X^T.
//  - a weight-kernel tile of X: [channel][64 px], 128-byte rows, chunks
//    swizzled by (row & 7); trans reads give the B operand of S^T = W X,
//    non-trans reads that of dW = dlog^T X^T.
// The swizzles make every ldmatrix phase touch 8 distinct bank groups.
//
// Kernels.
//  1. forward: persistent blocks of 8 warps; each warp walks 16-pixel units
//     with its next unit's slice in flight (cp.async), forms S (16 px x 64
//     bins at a time, 8 k16 steps over the channels) in registers and runs
//     an online softmax over the bins with quad shuffles. Writes the depth
//     and each pixel's softmax (max, sum) for the backward: 12 bytes a
//     pixel. W stays resident in shared memory where it fits beside the
//     slices (n_bins <= 640: 166 KB + 64 KB); above that the block stages
//     it in chunks of up to 640 bins for every round of units, its warps in
//     step, and the online softmax carries across the chunks.
//  2. backward pixel kernel: the same walk, W staging and S code (so the
//     same logits as the forward, bit for bit); p from the forward's (max,
//     sum),
//     dlog rounded to bf16 and repacked from the accumulator layout into A
//     fragments in k16 chunks, as FA2/FA3 do, and dx += dlog W (16 px x 128
//     channels in registers). dx is rounded to bf16, staged through the
//     warp's slice and stored as 16-byte rows.
//  3. backward weight kernel: a block owns 128 bins (16 per warp, their W
//     rows held as A fragments for the whole kernel) and a contiguous range
//     of 64-pixel tiles, double-buffered by cp.async; per tile it forms
//     S^T = W X (16 bins x 64 px per warp), dlog^T from the saved (max, sum,
//     depth), and dW += dlog^T X^T with dlog^T repacked as A fragments. It
//     also sums db and dc over its pixels with quad shuffles. It writes
//     per-block partials (dW: blocks x n_bins x 128 f32, 8.7 MB at the
//     flagship shape; db; dc per image) that the wrapper folds in a fixed
//     order, so the result is deterministic.
// The backward thus forms the logits twice (S, S^T) beside dx and dW: four
// products, plus the forward's one.
//
// Rounding points (_logits_block, :46-58, and _bwd_kernel, :108-116): W and
// x in bf16, products summed in f32; each logit rounded to bf16 and the
// bf16 bias added in bf16; softmax in f32; dlog rounded to bf16 before both
// products; dx rounded to bf16 at the end; db and dc summed from the f32
// values. Only the order of the sums differs from the TPU kernel. The pixel
// kernel forms S = X^T W^T, the weight kernel S^T = W X: the same products
// with the operands' roles swapped, whose f32 sum may round apart, so one
// logit's bf16 value can differ by an ulp between the two kernels. The
// 2e-2 bf16 gradient tolerance covers that.
//
// What bounds it. At the flagship training shape (16 x 208 x 272 pixels,
// 256 bins) the head is 2 x 128 x 256 flops a pixel per product: the
// forward 59.3 GFLOP (0.060 ms at the bf16 tensor-core peak of 989 TFLOP/s)
// against a 232 MB bf16 feature read (0.070 ms at 3.35 TB/s), so bytes bound
// it; the backward's least work is three products (logits, dx, dW), 178
// GFLOP, 0.18 ms, above its 464 MB of feature read and dx write (0.14 ms),
// so operations bound it. mma.sync reaches about half of wgmma's rate, and
// each warp reads its B operand from shared memory itself, so these kernels
// aim at a few times their bounds, not at the bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kChannels = 128;                       // decoder output channels
constexpr int kUnitPx = 16;                          // pixels per warp unit (one m16 tile)
constexpr int kSliceBytes = kChannels * kUnitPx * 2; // a warp's bf16 X slice, 4 KB
constexpr int kBinChunk = 64;                        // bins per S chunk (8 n8 blocks)
constexpr int kMaxWarps = 8;                         // forward and pixel kernel
constexpr int kWRowBytes = kChannels * 2;            // a bf16 W row in shared memory
constexpr int kTilePx = 64;                          // weight kernel: pixels per tile
constexpr int kTileBytes = kChannels * kTilePx * 2;  // 16 KB
constexpr int kDwWarps = 8;
constexpr int kDwBins = kDwWarps * 16;               // weight kernel: bins per block
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a b for one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
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

// Two floats as a bf16 pair, round to nearest even; lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The bf16 logit from the f32 sum and the bf16-rounded bias.
__device__ __forceinline__ float logit_bf16(float dot, float bias_bf16) {
  return round_bf16(round_bf16(dot) + bias_bf16);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

// Byte offsets of 16-byte chunks in the three shared-memory layouts.
__device__ __forceinline__ int w_offset(int bin, int chunk) {
  return bin * kWRowBytes + ((chunk ^ (bin & 7)) << 4);
}
__device__ __forceinline__ int slice_offset(int ch, int chunk) {
  return ch * (kUnitPx * 2) + ((chunk ^ ((ch >> 2) & 1)) << 4);
}
__device__ __forceinline__ int tile_offset(int ch, int chunk) {
  return ch * (kTilePx * 2) + ((chunk ^ (ch & 7)) << 4);
}

// ------------------------------------------- forward and pixel kernel parts

// The block stages W (rounded to bf16, swizzled) and the bf16-rounded bias.
__device__ void stage_weights(char* w_s, float* b_s, const float* __restrict__ w,
                              const float* __restrict__ b, int n_bins) {
  for (int i = threadIdx.x; i < n_bins * (kChannels / 8); i += blockDim.x) {
    const int bin = i / (kChannels / 8), chunk = i % (kChannels / 8);
    const float* src = w + (size_t)bin * kChannels + chunk * 8;
    uint4 v;
    v.x = pack_bf16x2(src[0], src[1]);
    v.y = pack_bf16x2(src[2], src[3]);
    v.z = pack_bf16x2(src[4], src[5]);
    v.w = pack_bf16x2(src[6], src[7]);
    *reinterpret_cast<uint4*>(w_s + w_offset(bin, chunk)) = v;
  }
  for (int i = threadIdx.x; i < n_bins; i += blockDim.x) b_s[i] = round_bf16(b[i]);
}

// A warp loads pixels p0 .. p0+15 of image img into its slice, zeros past
// hw. vec: hw % 8 == 0 and x 16-byte aligned, so each 8-pixel chunk is
// wholly in or out and goes by cp.async; else element by element.
__device__ __forceinline__ void load_unit(char* slice, const uint16_t* __restrict__ x, int img,
                                          int p0, int hw, bool vec, int lane) {
  const uint16_t* src = x + (size_t)img * kChannels * hw;
  if (vec) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = lane + 32 * j;  // 256 chunks: channel i / 2, pixels (i % 2) * 8 ..
      const int ch = i >> 1, chunk = i & 1, p = p0 + chunk * 8;
      const bool in = p < hw;
      cp_async16(smem_u32(slice + slice_offset(ch, chunk)), src + (size_t)ch * hw + (in ? p : 0),
                 in ? 16 : 0);
    }
  } else {
    for (int i = lane; i < kChannels * kUnitPx; i += 32) {
      const int ch = i / kUnitPx, px = i % kUnitPx, p = p0 + px;
      *reinterpret_cast<uint16_t*>(slice + slice_offset(ch, px >> 3) + (px & 7) * 2) =
          p < hw ? src[(size_t)ch * hw + p] : (uint16_t)0;
    }
  }
}

// The warp stores its slice (dx of pixels p0 .. p0+15) to image img.
__device__ __forceinline__ void store_unit(uint16_t* __restrict__ dx, const char* slice, int img,
                                           int p0, int hw, bool vec, int lane) {
  uint16_t* dst = dx + (size_t)img * kChannels * hw;
  if (vec) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = lane + 32 * j;
      const int ch = i >> 1, chunk = i & 1, p = p0 + chunk * 8;
      if (p < hw) {
        *reinterpret_cast<uint4*>(dst + (size_t)ch * hw + p) =
            *reinterpret_cast<const uint4*>(slice + slice_offset(ch, chunk));
      }
    }
  } else {
    for (int i = lane; i < kChannels * kUnitPx; i += 32) {
      const int ch = i / kUnitPx, px = i % kUnitPx, p = p0 + px;
      if (p < hw) {
        dst[(size_t)ch * hw + p] =
            *reinterpret_cast<const uint16_t*>(slice + slice_offset(ch, px >> 3) + (px & 7) * 2);
      }
    }
  }
}

// A fragments of X^T (16 px x 128 channels) from the warp's slice: k16 step
// kk holds channels 16 kk .. 16 kk + 15.
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[8][4], const char* slice, int lane) {
  const int mat = lane >> 3, i = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    ldsm_x4_trans(smem_u32(slice + slice_offset(16 * kk + (mat >> 1) * 8 + i, mat & 1)), a[kk]);
  }
}

// s = X^T W^T for the warp's 16 pixels and bins n0 .. n0+63: s[nb] is the
// m16n8 accumulator of bins n0 + 8 nb .. n0 + 8 nb + 7.
__device__ __forceinline__ void logits_chunk(float (&s)[8][4], const uint32_t (&a)[8][4],
                                             const char* w_s, int n0, int lane) {
  const int mat = lane >> 3, i = lane & 7;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int nb = 0; nb < 8; nb += 2) {
      uint32_t b[4];
      ldsm_x4(smem_u32(w_s + w_offset(n0 + (nb + (mat >> 1)) * 8 + i, 2 * kk + (mat & 1))), b);
      mma_bf16(s[nb], a[kk], b[0], b[1]);
      mma_bf16(s[nb + 1], a[kk], b[2], b[3]);
    }
  }
}

// The warp walk shared by the forward and the pixel kernel. Global warp w
// takes units w, w + stride, ... (a unit: 16 pixels of one image), with the
// next unit's slice loading while the current one is worked:
// begin(slice, img, p0), then chunk(c0, cn) for each run of cn bins from c0
// whose W is in shared memory, then end(slice, img, p0). With W resident
// (kChunked false: chunk_bins == n_bins) the block stages it once and each
// warp walks on its own. Else the block stages W chunk by chunk for every
// round of units, all warps in step; a warp with no unit left still joins
// the staging.
template <bool kChunked, typename Begin, typename Chunk, typename End>
__device__ __forceinline__ void walk_units(char* w_s, float* b_s, char* slices,
                                           const uint16_t* __restrict__ x,
                                           const float* __restrict__ w,
                                           const float* __restrict__ b, int batch, int hw,
                                           int n_bins, int chunk_bins, bool vec, Begin begin,
                                           Chunk chunk, End end) {
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  const int per_img = (hw + kUnitPx - 1) / kUnitPx, total = batch * per_img;
  const int stride = gridDim.x * warps;
  if (!kChunked) stage_weights(w_s, b_s, w, b, n_bins);
  __syncthreads();
  int u = blockIdx.x * warps + (threadIdx.x >> 5);
  if (u < total) load_unit(slices, x, u / per_img, (u % per_img) * kUnitPx, hw, vec, lane);
  cp_async_commit();
  for (int base = blockIdx.x * warps, buf = 0; base < total;
       base += stride, u += stride, buf ^= 1) {
    const bool live = u < total;  // warp-uniform
    if (!kChunked && !live) break;
    const int next = u + stride;
    if (next < total) {
      load_unit(slices + (buf ^ 1) * kSliceBytes, x, next / per_img,
                (next % per_img) * kUnitPx, hw, vec, lane);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    char* slice = slices + buf * kSliceBytes;
    const int img = u / per_img, p0 = (u % per_img) * kUnitPx;
    if (live) begin(slice, img, p0);
    for (int c0 = 0; c0 < n_bins; c0 += chunk_bins) {
      const int cn = min(chunk_bins, n_bins - c0);
      if (kChunked) {
        __syncthreads();  // every warp is done with the previous chunk
        stage_weights(w_s, b_s, w + (size_t)c0 * kChannels, b + c0, cn);
        __syncthreads();
      }
      if (live) chunk(c0, cn);
    }
    if (live) end(slice, img, p0);
    __syncwarp();  // every lane is done with the slice before it is reloaded
  }
}

// Shared memory of the forward and the pixel kernel: a W chunk of
// chunk_bins rows (bf16) and its bias (f32), then two slices a warp.
struct UnitSmem {
  char* w;
  float* b;
  char* slices;
  __device__ UnitSmem(char* smem, int chunk_bins)
      : w(smem),
        b(reinterpret_cast<float*>(smem + chunk_bins * kWRowBytes)),
        slices(smem + chunk_bins * (kWRowBytes + 4) + (threadIdx.x >> 5) * 2 * kSliceBytes) {}
};

template <bool kChunked>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
bins_head_tc_fwd_kernel(const uint16_t* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ b, const float* __restrict__ c,
                        float* __restrict__ out, float* __restrict__ stats, int batch, int hw,
                        int n_bins, int chunk_bins, int vec) {
  extern __shared__ __align__(128) char smem[];
  const UnitSmem sm(smem, chunk_bins);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const size_t plane = (size_t)batch * hw;

  // per unit: X^T fragments; the online softmax of rows g (r = 0) and g + 8
  // (r = 1) over this lane's columns, the four lanes of a quad sharing the
  // row max
  uint32_t a[8][4];
  const float* c_img = c;
  float mx[2], sum[2], dep[2];
  walk_units<kChunked>(
      sm.w, sm.b, sm.slices, x, w, b, batch, hw, n_bins, chunk_bins, vec,
      [&](char* slice, int img, int) {
        load_a_frags(a, slice, lane);
        c_img = c + (size_t)img * n_bins;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = -CUDART_INF_F;
          sum[r] = dep[r] = 0.f;
        }
      },
      [&](int c0, int cn) {
        for (int n0 = 0; n0 < cn; n0 += kBinChunk) {
          float s[8][4];
          logits_chunk(s, a, sm.w, n0, lane);
          float cm[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              s[nb][j] = logit_bf16(s[nb][j], sm.b[n0 + nb * 8 + 2 * t + (j & 1)]);
              cm[j >> 1] = fmaxf(cm[j >> 1], s[nb][j]);
            }
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float m = fmaxf(mx[r], quad_max(cm[r]));
            const float scale = __expf(mx[r] - m);
            sum[r] *= scale;
            dep[r] *= scale;
            mx[r] = m;
          }
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const int bin = c0 + n0 + nb * 8 + 2 * t;
            const float c_lo = __ldg(c_img + bin), c_hi = __ldg(c_img + bin + 1);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float e = __expf(s[nb][j] - mx[j >> 1]);
              sum[j >> 1] += e;
              dep[j >> 1] = fmaf(e, (j & 1) ? c_hi : c_lo, dep[j >> 1]);
            }
          }
        }
      },
      [&](char*, int img, int p0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float total = quad_sum(sum[r]), depth = quad_sum(dep[r]);
          const int p = p0 + g + 8 * r;
          if (t == 0 && p < hw) {
            const size_t at = (size_t)img * hw + p;
            out[at] = depth / total;
            stats[at] = mx[r];
            stats[plane + at] = total;
          }
        }
      });
}

template <bool kChunked>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
bins_head_tc_bwd_pixel_kernel(const uint16_t* __restrict__ x, const float* __restrict__ w,
                              const float* __restrict__ b, const float* __restrict__ c,
                              const float* __restrict__ grad, const float* __restrict__ out,
                              const float* __restrict__ stats, uint16_t* __restrict__ dx,
                              int batch, int hw, int n_bins, int chunk_bins, int vec) {
  extern __shared__ __align__(128) char smem[];
  const UnitSmem sm(smem, chunk_bins);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mat = lane >> 3, i = lane & 7;
  const size_t plane = (size_t)batch * hw;

  // per unit: X^T fragments; rows g and g + 8: softmax max, g / sum (so
  // p g = e * scale) and depth, zeros for pixels past hw (whose dlog is then
  // 0); dx: 16 px x 128 channels, n8 block cb = channels 8 cb ..
  uint32_t a[8][4];
  const float* c_img = c;
  float rmax[2], rscale[2], rdep[2];
  float d[16][4];
  walk_units<kChunked>(
      sm.w, sm.b, sm.slices, x, w, b, batch, hw, n_bins, chunk_bins, vec,
      [&](char* slice, int img, int p0) {
        load_a_frags(a, slice, lane);
        __syncwarp();  // the slice is free for dx once every lane holds X^T
        c_img = c + (size_t)img * n_bins;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = p0 + g + 8 * r;
          const size_t at = (size_t)img * hw + (p < hw ? p : 0);
          rmax[r] = p < hw ? stats[at] : 0.f;
          rscale[r] = p < hw ? grad[at] / stats[plane + at] : 0.f;
          rdep[r] = p < hw ? out[at] : 0.f;
        }
#pragma unroll
        for (int cb = 0; cb < 16; ++cb) d[cb][0] = d[cb][1] = d[cb][2] = d[cb][3] = 0.f;
      },
      [&](int c0, int cn) {
        for (int n0 = 0; n0 < cn; n0 += kBinChunk) {
          float s[8][4];
          logits_chunk(s, a, sm.w, n0, lane);
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            const int bin = n0 + nb * 8 + 2 * t;  // in the chunk
            const float c_lo = __ldg(c_img + c0 + bin), c_hi = __ldg(c_img + c0 + bin + 1);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int r = j >> 1;
              const float pg =
                  __expf(logit_bf16(s[nb][j], sm.b[bin + (j & 1)]) - rmax[r]) * rscale[r];
              s[nb][j] = pg * ((j & 1 ? c_hi : c_lo) - rdep[r]);
            }
          }
          // dx += dlog W over these 64 bins, 16 at a time: dlog's
          // accumulator blocks 2 kk and 2 kk + 1 are the A fragment of k16
          // step kk
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint32_t da[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                                    pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                                    pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                    pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
            for (int cb = 0; cb < 16; cb += 2) {
              uint32_t bw[4];
              ldsm_x4_trans(smem_u32(sm.w + w_offset(n0 + 16 * kk + (mat & 1) * 8 + i,
                                                      cb + (mat >> 1))),
                            bw);
              mma_bf16(d[cb], da, bw[0], bw[1]);
              mma_bf16(d[cb + 1], da, bw[2], bw[3]);
            }
          }
        }
      },
      [&](char* slice, int img, int p0) {
        // dx in bf16 through the slice ([channel][16 px]) to 16-byte stores
#pragma unroll
        for (int cb = 0; cb < 16; ++cb) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ch = cb * 8 + 2 * t + (j & 1), px = g + 8 * (j >> 1);
            *reinterpret_cast<uint16_t*>(slice + slice_offset(ch, px >> 3) + (px & 7) * 2) =
                bf16_bits(d[cb][j]);
          }
        }
        __syncwarp();
        store_unit(dx, slice, img, p0, hw, vec, lane);
      });
}

// ------------------------------------------------------ weight kernel

// The block loads pixels p0 .. p0+63 of image img into a tile, zeros past hw.
__device__ __forceinline__ void load_tile(char* tile, const uint16_t* __restrict__ x, int img,
                                          int p0, int hw, bool vec) {
  const uint16_t* src = x + (size_t)img * kChannels * hw;
  if (vec) {
    for (int i = threadIdx.x; i < kChannels * (kTilePx / 8); i += blockDim.x) {
      const int ch = i / (kTilePx / 8), chunk = i % (kTilePx / 8), p = p0 + chunk * 8;
      const bool in = p < hw;
      cp_async16(smem_u32(tile + tile_offset(ch, chunk)), src + (size_t)ch * hw + (in ? p : 0),
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kChannels * kTilePx; i += blockDim.x) {
      const int ch = i / kTilePx, px = i % kTilePx, p = p0 + px;
      *reinterpret_cast<uint16_t*>(tile + tile_offset(ch, px >> 3) + (px & 7) * 2) =
          p < hw ? src[(size_t)ch * hw + p] : (uint16_t)0;
    }
  }
}

struct TileRows {  // per pixel of a tile: softmax max, g / sum, depth
  float max[kTilePx], scale[kTilePx], depth[kTilePx];
};

__global__ void __launch_bounds__(kDwWarps * 32, 1)
bins_head_tc_bwd_weight_kernel(const uint16_t* __restrict__ x, const float* __restrict__ w,
                               const float* __restrict__ b, const float* __restrict__ c,
                               const float* __restrict__ grad, const float* __restrict__ out,
                               const float* __restrict__ stats, float* __restrict__ part_dw,
                               float* __restrict__ part_db, float* __restrict__ part_dc,
                               int batch, int hw, int n_bins, int vec) {
  __shared__ __align__(128) char tiles[2][kTileBytes];
  __shared__ TileRows rows[2];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mat = lane >> 3, i = lane & 7;
  const int bin0 = (int)blockIdx.y * kDwBins + warp * 16 + g;
  const int bin[2] = {bin0, bin0 + 8};

  // this warp's 16 W rows as bf16 A fragments (16 bins x 128 channels)
  uint32_t wa[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const float* w0 = w + (size_t)bin[0] * kChannels + 16 * kk + 2 * t;
    const float* w1 = w + (size_t)bin[1] * kChannels + 16 * kk + 2 * t;
    wa[kk][0] = pack_bf16x2(w0[0], w0[1]);
    wa[kk][1] = pack_bf16x2(w1[0], w1[1]);
    wa[kk][2] = pack_bf16x2(w0[8], w0[9]);
    wa[kk][3] = pack_bf16x2(w1[8], w1[9]);
  }
  const float bias[2] = {round_bf16(b[bin[0]]), round_bf16(b[bin[1]])};
  float dw[16][4];  // dW rows bin[0], bin[1]; n8 block cb = channels 8 cb ..
#pragma unroll
  for (int cb = 0; cb < 16; ++cb) dw[cb][0] = dw[cb][1] = dw[cb][2] = dw[cb][3] = 0.f;
  float db[2] = {0.f, 0.f}, dc[2] = {0.f, 0.f};

  const int per_img = (hw + kTilePx - 1) / kTilePx, total = batch * per_img;
  const int per_block = (total + gridDim.x - 1) / gridDim.x;
  const int begin = min(total, blockIdx.x * per_block), end = min(total, begin + per_block);
  const size_t plane = (size_t)batch * hw;

  // dc of image img is this block's sum over the image's pixels in its range
  auto flush_dc = [&](int img) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float v = quad_sum(dc[r]);
      if (t == 0) part_dc[((size_t)blockIdx.x * batch + img) * n_bins + bin[r]] = v;
      dc[r] = 0.f;
    }
  };
  auto load = [&](int buf, int tile) {
    const int img = tile / per_img, p0 = (tile % per_img) * kTilePx;
    load_tile(tiles[buf], x, img, p0, hw, vec);
    if (threadIdx.x < kTilePx) {
      const int p = p0 + threadIdx.x;
      const size_t at = (size_t)img * hw + (p < hw ? p : 0);
      rows[buf].max[threadIdx.x] = p < hw ? stats[at] : 0.f;
      rows[buf].scale[threadIdx.x] = p < hw ? grad[at] / stats[plane + at] : 0.f;
      rows[buf].depth[threadIdx.x] = p < hw ? out[at] : 0.f;
    }
  };

  int img = begin < end ? begin / per_img : 0;
  float cen[2] = {c[(size_t)img * n_bins + bin[0]], c[(size_t)img * n_bins + bin[1]]};
  if (begin < end) load(0, begin);
  cp_async_commit();
  for (int tile = begin, buf = 0; tile < end; ++tile, buf ^= 1) {
    if (tile + 1 < end) load(buf ^ 1, tile + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (tile / per_img != img) {  // block-uniform
      flush_dc(img);
      img = tile / per_img;
      cen[0] = c[(size_t)img * n_bins + bin[0]];
      cen[1] = c[(size_t)img * n_bins + bin[1]];
    }
    const char* xt = tiles[buf];
    const TileRows& tr = rows[buf];

    // S^T = W X: 16 bins x 64 px; n8 block nb = pixels 8 nb ..
    float s[8][4];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int nb = 0; nb < 8; nb += 2) {
        uint32_t bx[4];
        ldsm_x4_trans(smem_u32(xt + tile_offset(16 * kk + (mat & 1) * 8 + i, nb + (mat >> 1))),
                      bx);
        mma_bf16(s[nb], wa[kk], bx[0], bx[1]);
        mma_bf16(s[nb + 1], wa[kk], bx[2], bx[3]);
      }
    }
    // dlog^T, and the block's db and dc sums
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j >> 1, px = nb * 8 + 2 * t + (j & 1);
        const float pg = __expf(logit_bf16(s[nb][j], bias[r]) - tr.max[px]) * tr.scale[px];
        const float dl = pg * (cen[r] - tr.depth[px]);
        dc[r] += pg;
        db[r] += dl;
        s[nb][j] = dl;
      }
    }
    // dW += dlog^T X^T over the tile's pixels, 16 at a time
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t da[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int cb = 0; cb < 16; cb += 2) {
        uint32_t bx[4];
        ldsm_x4(smem_u32(xt + tile_offset((cb + (mat >> 1)) * 8 + i, 2 * kk + (mat & 1))), bx);
        mma_bf16(dw[cb], da, bx[0], bx[1]);
        mma_bf16(dw[cb + 1], da, bx[2], bx[3]);
      }
    }
    __syncthreads();  // every warp is done with the tile before it is reloaded
  }
  if (begin < end) flush_dc(img);

  // this block's partials; a block with no tiles writes zeros
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float v = quad_sum(db[r]);
    if (t == 0) part_db[(size_t)blockIdx.x * n_bins + bin[r]] = v;
  }
#pragma unroll
  for (int cb = 0; cb < 16; ++cb) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float2* dst = reinterpret_cast<float2*>(
          part_dw + ((size_t)blockIdx.x * n_bins + bin[r]) * kChannels + cb * 8 + 2 * t);
      *dst = make_float2(dw[cb][2 * r], dw[cb][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------- launch

cudaError_t device_limits(int device, int* max_smem, int* sms) {
  const cudaError_t err =
      cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

// Bins of W a block of the forward or the pixel kernel holds in shared
// memory beside its 8 warps' slices: all of them where they fit (n_bins <=
// 640 on the H100), else the largest multiple of 64 that fits, and W goes
// chunk by chunk.
cudaError_t unit_chunk(int n_bins, int device, int* chunk_bins, size_t* smem) {
  int max_smem = 0, sms = 0;
  const cudaError_t err = device_limits(device, &max_smem, &sms);
  if (err != cudaSuccess) return err;
  const long slices = (long)kMaxWarps * 2 * kSliceBytes;
  const int fit = (int)((max_smem - slices) / (kWRowBytes + 4)) / kBinChunk * kBinChunk;
  if (fit < kBinChunk) return cudaErrorInvalidValue;
  *chunk_bins = std::min(n_bins, fit);
  *smem = (size_t)*chunk_bins * (kWRowBytes + 4) + slices;
  return cudaSuccess;
}

// Persistent launch shape of the forward and the pixel kernel: 8 warps a
// block, one wave of blocks over the card.
template <typename Kernel>
cudaError_t unit_grid(Kernel kernel, int batch, int hw, size_t smem, int device, dim3* grid) {
  int max_smem = 0, sms = 0, occupancy = 0;
  cudaError_t err = device_limits(device, &max_smem, &sms);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, kernel, kMaxWarps * 32, smem);
  if (err != cudaSuccess) return err;
  const long units = (long)batch * ((hw + kUnitPx - 1) / kUnitPx);
  const long wanted = (units + kMaxWarps - 1) / kMaxWarps;
  *grid = dim3((unsigned)std::max(1L, std::min(wanted, (long)sms * std::max(occupancy, 1))));
  return cudaSuccess;
}

template <bool kChunked>
cudaError_t launch_fwd(const uint16_t* x, const float* w, const float* b, const float* c,
                       float* out, float* stats, int batch, int hw, int n_bins, int chunk_bins,
                       size_t smem, int vec, int device, cudaStream_t stream) {
  dim3 grid;
  const cudaError_t err =
      unit_grid(bins_head_tc_fwd_kernel<kChunked>, batch, hw, smem, device, &grid);
  if (err != cudaSuccess) return err;
  bins_head_tc_fwd_kernel<kChunked><<<grid, kMaxWarps * 32, smem, stream>>>(
      x, w, b, c, out, stats, batch, hw, n_bins, chunk_bins, vec);
  return cudaGetLastError();
}

template <bool kChunked>
cudaError_t launch_pixel(const uint16_t* x, const float* w, const float* b, const float* c,
                         const float* g, const float* out, const float* stats, uint16_t* dx,
                         int batch, int hw, int n_bins, int chunk_bins, size_t smem, int vec,
                         int device, cudaStream_t stream) {
  dim3 grid;
  const cudaError_t err =
      unit_grid(bins_head_tc_bwd_pixel_kernel<kChunked>, batch, hw, smem, device, &grid);
  if (err != cudaSuccess) return err;
  bins_head_tc_bwd_pixel_kernel<kChunked><<<grid, kMaxWarps * 32, smem, stream>>>(
      x, w, b, c, g, out, stats, dx, batch, hw, n_bins, chunk_bins, vec);
  return cudaGetLastError();
}

}  // namespace

// x: (batch, 128, hw) bf16; w: (n_bins, 128) f32; b: (n_bins,) f32;
// c: (batch, n_bins) f32. Writes out: (batch, hw) f32, the depth, and
// stats: (2, batch, hw) f32, each pixel's softmax max and sum. n_bins is a
// multiple of 128. vec: hw % 8 == 0 and x 16-byte aligned. All contiguous,
// on `device`, whose stream `stream` is. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int mde_bins_head_tc_fwd(const void* x, const void* w, const void* b, const void* c,
                                    void* out, void* stats, int batch, int hw, int n_bins,
                                    int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int chunk_bins = 0;
  size_t smem = 0;
  err = unit_chunk(n_bins, device, &chunk_bins, &smem);
  if (err != cudaSuccess) return (int)err;
  const auto launch = chunk_bins < n_bins ? &launch_fwd<true> : &launch_fwd<false>;
  return (int)launch(static_cast<const uint16_t*>(x), static_cast<const float*>(w),
                     static_cast<const float*>(b), static_cast<const float*>(c),
                     static_cast<float*>(out), static_cast<float*>(stats), batch, hw, n_bins,
                     chunk_bins, smem, vec, device, static_cast<cudaStream_t>(stream));
}

// Blocks along the pixels of the weight kernel (its grid is this by
// n_bins / 128): one wave over the card. Negative on error.
extern "C" int mde_bins_head_tc_weight_blocks(int batch, int hw, int n_bins, int device) {
  int max_smem = 0, sms = 0, occupancy = 0;
  if (device_limits(device, &max_smem, &sms) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, bins_head_tc_bwd_weight_kernel,
                                                    kDwWarps * 32, 0) != cudaSuccess) {
    return -1;
  }
  const long tiles = (long)batch * ((hw + kTilePx - 1) / kTilePx);
  const long columns = n_bins / kDwBins;
  const long wanted = (long)sms * std::max(occupancy, 1) / std::max(columns, 1L);
  return (int)std::max(1L, std::min(tiles, wanted));
}

// x: (batch, 128, hw) bf16; w, b, c as for the forward; g: (batch, hw) f32,
// the depth's gradient; out and stats: the forward's. Writes dx: (batch,
// 128, hw) bf16; part_dw: (dw_blocks, n_bins, 128), part_db: (dw_blocks,
// n_bins) and part_dc: (dw_blocks, batch, n_bins) f32 partials, part_dc
// zeroed by the caller. Returns the cudaError_t of the launches.
extern "C" int mde_bins_head_tc_bwd(const void* x, const void* w, const void* b, const void* c,
                                    const void* g, const void* out, const void* stats, void* dx,
                                    void* part_dw, void* part_db, void* part_dc, int dw_blocks,
                                    int batch, int hw, int n_bins, int vec, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* xb = static_cast<const uint16_t*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  const float* gf = static_cast<const float*>(g);
  const float* of = static_cast<const float*>(out);
  const float* sf = static_cast<const float*>(stats);
  int chunk_bins = 0;
  size_t smem = 0;
  err = unit_chunk(n_bins, device, &chunk_bins, &smem);
  if (err != cudaSuccess) return (int)err;
  const auto pixel = chunk_bins < n_bins ? &launch_pixel<true> : &launch_pixel<false>;
  err = pixel(xb, wf, bf, cf, gf, of, sf, static_cast<uint16_t*>(dx), batch, hw, n_bins,
              chunk_bins, smem, vec, device, s);
  if (err != cudaSuccess) return (int)err;
  bins_head_tc_bwd_weight_kernel<<<dim3(dw_blocks, n_bins / kDwBins), kDwWarps * 32, 0, s>>>(
      xb, wf, bf, cf, gf, of, sf, static_cast<float*>(part_dw), static_cast<float*>(part_db),
      static_cast<float*>(part_dc), batch, hw, n_bins, vec);
  return (int)cudaGetLastError();
}

extern "C" const char* mde_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
