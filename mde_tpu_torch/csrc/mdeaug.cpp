// mdeaug — the port's host library for the NYUD2/KITTI data pipeline: image
// decoding and the fused train-time augmentation, built with the host C++
// compiler (kernels/build.py, `load_host`) and bound with ctypes
// (data/native.py, data/decode.py).
//
// Augmentation: the JAX package's native/mdeaug.cpp, unchanged in its
// arithmetic. It fuses rotate (PIL-exact inverse-map sampling), depth
// rescale, crop, h-flip, gamma/brightness/color jitter and ImageNet
// normalize into one pass per sample, parallel across the batch with
// std::thread. Randomness stays in Python (the parameters are inputs), so
// the numpy and native paths draw the same values under one seed.
//
// Decoding: written here, with no image library. The machines this runs on
// need not have libjpeg or libpng; zlib is the one library linked.
//   * JPEG: baseline and extended sequential Huffman, 8-bit, one component
//     (grayscale) or three (YCbCr, or RGB by Adobe transform 0 or component
//     ids 'R','G','B'),
//     interleaved or not, with restart markers. Its arithmetic is libjpeg's
//     as PIL runs it (libjpeg-turbo's defaults): the ISLOW integer IDCT of
//     jidctint.c, h2v1 / h1v2 / h2v2 fancy upsampling of jdsample.c with the
//     context rows of jdmainct.c (the first and last rows repeated), and the
//     fixed-point YCbCr->RGB of jdcolor.c, so a frame decodes to PIL's bytes.
//     Progressive, arithmetic-coded, lossless, 12-bit and other sampling
//     ratios are refused with an error.
//   * PNG: non-interlaced 8- or 16-bit grayscale (to uint16), 8-bit RGB,
//     and 8-bit grey-alpha and RGBA (to RGB only); the IDAT stream inflated
//     by zlib, then unfiltered. Other kinds are refused with an error.
//   * To RGB (`mdeaug_decode_rgb`): every 8-bit kind above as PIL's
//     `convert("RGB")` gives it: grey replicated, alpha dropped.
//
// Polygon fill (`mdeaug_fill_polygon`): PIL's `ImageDraw.polygon` with a fill
// on an 8-bit image (Draw.c, ImagingDrawPolygon and polygon_generic): the
// vertices cast to int, the edge list, and the float32
// scanline with its corner rules, so a COCO polygon rasterises to PIL's
// pixels.
//
// C ABI only. Every decoding entry returns 0 on success, or -1 with a
// message written into the caller's `err` buffer.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr float kImagenetMean[3] = {0.485f, 0.456f, 0.406f};
constexpr float kImagenetStd[3] = {0.229f, 0.224f, 0.225f};

struct AugParams {
  // geometry
  float angle_deg;      // rotation angle (0 = skip)
  int32_t crop_x;       // crop origin in the rotated frame
  int32_t crop_y;
  int32_t do_flip;      // horizontal flip after crop
  // photometric (applied iff do_augment)
  int32_t do_augment;
  float gamma;
  float brightness;
  float color[3];
  float depth_scale;    // 1/1000 nyu, 1/256 kitti
};

inline float bilinear_u8(const uint8_t* src, int h, int w, int c, float y,
                         float x, int ch) {
  // zero-fill outside, PIL-style float bilinear on /255 values
  int y0 = (int)std::floor(y);
  int x0 = (int)std::floor(x);
  float fy = y - y0, fx = x - x0;
  float acc = 0.f;
  for (int dy = 0; dy < 2; ++dy) {
    int yy = y0 + dy;
    if (yy < 0 || yy >= h) continue;
    float wy = dy ? fy : 1.f - fy;
    for (int dx = 0; dx < 2; ++dx) {
      int xx = x0 + dx;
      if (xx < 0 || xx >= w) continue;
      float wx = dx ? fx : 1.f - fx;
      acc += wy * wx * (float)src[(yy * w + xx) * c + ch];
    }
  }
  return acc;
}

template <typename T>
inline T nearest_or_zero(const T* src, int h, int w, float y, float x) {
  int yy = (int)std::lround(y);
  int xx = (int)std::lround(x);
  if (yy < 0 || yy >= h || xx < 0 || xx >= w) return (T)0;
  return src[yy * w + xx];
}

// Inverse rotation map matching PIL.Image.rotate(angle, expand=False):
// out (x, y) -> in coords, centered, half-pixel offsets.
struct RotMap {
  float cos_t, sin_t, cx, cy;
  bool identity;
  RotMap(float angle_deg, int h, int w) {
    identity = angle_deg == 0.f;
    float th = angle_deg * (float)M_PI / 180.f;
    cos_t = std::cos(th);
    sin_t = std::sin(th);
    cx = w / 2.f;
    cy = h / 2.f;
  }
  inline void map(float xo, float yo, float* xi, float* yi) const {
    float dx = xo + 0.5f - cx;
    float dy = yo + 0.5f - cy;
    *xi = cos_t * dx - sin_t * dy + cx - 0.5f;
    *yi = sin_t * dx + cos_t * dy + cy - 0.5f;
  }
};

// gamma via a 2049-entry LUT: std::pow per pixel dominates the augment cost;
// the table costs 2k pows once per sample and linear interpolation keeps the
// error < 1e-4, invisible under the jitter noise.
struct GammaLUT {
  static constexpr int kN = 2048;
  float table[kN + 1];
  explicit GammaLUT(float gamma) {
    for (int i = 0; i <= kN; ++i)
      table[i] = std::pow((float)i / kN, gamma);
  }
  inline float operator()(float v) const {
    v = std::min(std::max(v, 0.f), 1.f) * kN;
    int i = (int)v;
    float f = v - i;
    return i >= kN ? table[kN] : table[i] * (1.f - f) + table[i + 1] * f;
  }
};

void augment_one(const uint8_t* rgb, const uint16_t* depth,
                 const int32_t* sem, const int32_t* ilab, const int32_t* iarea,
                 int in_h, int in_w, int out_h, int out_w,
                 const AugParams& p, float* out_img, float* out_depth,
                 int32_t* out_sem, int32_t* out_ilab, int32_t* out_iarea) {
  RotMap rot(p.angle_deg, in_h, in_w);
  GammaLUT gamma_lut(p.do_augment ? p.gamma : 1.0f);

  for (int oy = 0; oy < out_h; ++oy) {
    for (int ox = 0; ox < out_w; ++ox) {
      // flip -> crop -> rotate back to input coords
      int fx = p.do_flip ? (out_w - 1 - ox) : ox;
      float rx = (float)(fx + p.crop_x);
      float ry = (float)(oy + p.crop_y);
      float sx = rx, sy = ry;
      if (!rot.identity) rot.map(rx, ry, &sx, &sy);

      int out_idx = oy * out_w + ox;

      // image: bilinear, /255, photometric, normalize
      for (int ch = 0; ch < 3; ++ch) {
        float v;
        if (rot.identity) {
          int yy = (int)sy, xx = (int)sx;
          v = (yy >= 0 && yy < in_h && xx >= 0 && xx < in_w)
                  ? (float)rgb[(yy * in_w + xx) * 3 + ch]
                  : 0.f;
        } else {
          // PIL re-quantizes the rotated uint8 image; match its round-half-up
          v = std::floor(bilinear_u8(rgb, in_h, in_w, 3, sy, sx, ch) + 0.5f);
        }
        v *= (1.f / 255.f);
        if (p.do_augment) {
          v = gamma_lut(v) * p.brightness * p.color[ch];
          v = std::min(std::max(v, 0.f), 1.f);
        }
        out_img[out_idx * 3 + ch] = (v - kImagenetMean[ch]) / kImagenetStd[ch];
      }

      // depth: nearest + rescale
      uint16_t d = rot.identity
                       ? (((int)sy >= 0 && (int)sy < in_h && (int)sx >= 0 &&
                           (int)sx < in_w)
                              ? depth[(int)sy * in_w + (int)sx]
                              : 0)
                       : nearest_or_zero<uint16_t>(depth, in_h, in_w, sy, sx);
      out_depth[out_idx] = (float)d * p.depth_scale;

      if (sem && out_sem)
        out_sem[out_idx] = nearest_or_zero<int32_t>(sem, in_h, in_w, sy, sx);
      if (ilab && out_ilab)
        out_ilab[out_idx] = nearest_or_zero<int32_t>(ilab, in_h, in_w, sy, sx);
      if (iarea && out_iarea)
        out_iarea[out_idx] = nearest_or_zero<int32_t>(iarea, in_h, in_w, sy, sx);
    }
  }
}

// ------------------------------------------------------------------ files

struct DecodeError {
  std::string message;
};

[[noreturn]] void fail(const std::string& message) { throw DecodeError{message}; }

std::vector<uint8_t> read_file(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) fail(std::string("cannot open ") + path);
  std::vector<uint8_t> data;
  uint8_t buf[1 << 16];
  size_t n;
  while ((n = std::fread(buf, 1, sizeof(buf), f)) > 0) data.insert(data.end(), buf, buf + n);
  bool bad = std::ferror(f);
  std::fclose(f);
  if (bad) fail(std::string("cannot read ") + path);
  return data;
}

// Image kinds of mdeaug_image_info.
constexpr int kJpeg = 1;
constexpr int kPng = 2;

bool is_jpeg(const std::vector<uint8_t>& d) {
  return d.size() >= 3 && d[0] == 0xFF && d[1] == 0xD8 && d[2] == 0xFF;
}

bool is_png(const std::vector<uint8_t>& d) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  return d.size() >= 8 && std::memcmp(d.data(), sig, 8) == 0;
}

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}

inline int be16(const uint8_t* p) { return p[0] << 8 | p[1]; }

// ------------------------------------------------------------------- JPEG

constexpr int kZigzag[64] = {  // zigzag index -> natural (row-major) index
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huffman {
  // jdhuff.c's derived table: maxcode[l] is the largest code of length l
  // (-1 if none), valoffset[l] maps a code of length l to its symbol index;
  // `look` resolves codes of up to kLook bits at once (length << 8 | symbol,
  // 0 when the code is longer).
  static constexpr int kLook = 9;
  int32_t maxcode[18];
  int32_t valoffset[17];
  uint8_t vals[256];
  uint16_t look[1 << kLook];
  bool defined = false;

  void build(const uint8_t* counts, const uint8_t* symbols, int nsym) {
    std::memcpy(vals, symbols, nsym);
    int code = 0, k = 0;
    std::memset(look, 0, sizeof(look));
    for (int l = 1; l <= 16; ++l) {
      valoffset[l] = k - code;
      for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
        if (l <= kLook) {
          int shift = kLook - l;
          for (int j = 0; j < (1 << shift); ++j)
            look[(code << shift) | j] = (uint16_t)(l << 8 | vals[k]);
        }
      }
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      if (code > (1 << l)) fail("JPEG: bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;  // sentinel: ends the search of a bad code
    defined = true;
  }
};

// Entropy-coded data of one scan: bytes with 0xFF00 stuffing; a marker ends
// the data (zeros are read past it, as libjpeg does).
struct BitReader {
  const uint8_t* data;
  size_t pos, end;
  uint64_t acc = 0;
  int bits = 0;

  void fill() {
    while (bits <= 56) {
      uint8_t b = 0;
      if (pos < end) {
        b = data[pos];
        if (b == 0xFF) {
          uint8_t next = pos + 1 < end ? data[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {
            b = 0;  // a marker: leave it, feed zeros
          }
        } else {
          ++pos;
        }
      }
      acc |= (uint64_t)b << (56 - bits);
      bits += 8;
    }
  }
  inline int get(int n) {  // n in [1, 16]
    if (bits < n) fill();
    int v = (int)(acc >> (64 - n));
    acc <<= n;
    bits -= n;
    return v;
  }
  inline int peek(int n) {
    if (bits < n) fill();
    return (int)(acc >> (64 - n));
  }
  inline void skip(int n) {
    acc <<= n;
    bits -= n;
  }
  inline int decode(const Huffman& h) {
    int look = h.look[peek(Huffman::kLook)];
    if (look) {
      skip(look >> 8);
      return look & 0xFF;
    }
    int code = get(Huffman::kLook);
    int l = Huffman::kLook;
    while (code > h.maxcode[l]) {
      code = (code << 1) | get(1);
      if (++l > 16) fail("JPEG: corrupt Huffman code");
    }
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }
  // a restart marker: drop the bits left of the byte, step over RSTn
  void restart() {
    acc = 0;
    bits = 0;
    while (pos + 1 < end && data[pos] == 0xFF && data[pos + 1] == 0xFF) ++pos;
    if (pos + 1 < end && data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)
      pos += 2;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id, h, v, tq;
  int dc_table = 0, ac_table = 0;
  int ds_w = 0, ds_h = 0;        // downsampled size (jdiv_round_up)
  int blocks_w = 0, blocks_h = 0;  // blocks covering ds_w x ds_h
  int stride = 0, rows = 0;      // plane size, padded to whole MCUs
  std::vector<uint8_t> plane;
  int dc_pred = 0;
};

// jidctint.c jpeg_idct_islow: dequantize, 2-D ISLOW IDCT, range limit.
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int32_t descale(int64_t x, int n) { return (int32_t)((x + ((int64_t)1 << (n - 1))) >> n); }

inline uint8_t range_limit(int32_t x) {
  // libjpeg's post-IDCT table: the centred value wraps by & 1023, then
  // clamps to [0, 255] around +128
  int v = ((x + 512) & 1023) - 512 + 128;
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* q = quant + c;
    int32_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    z2 = in[16] * q[16];
    z3 = in[48] * q[48];
    z1 = (z2 + z3) * F0541;
    t2 = z1 + z3 * (-F1847);
    t3 = z1 + z2 * F0765;
    z2 = in[0] * q[0];
    z3 = in[32] * q[32];
    t0 = (z2 + z3) * (1 << kConstBits);
    t1 = (z2 - z3) * (1 << kConstBits);
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    t0 = in[56] * q[56];
    t1 = in[40] * q[40];
    t2 = in[24] * q[24];
    t3 = in[8] * q[8];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    z4 = t1 + t3;
    z5 = (z3 + z4) * F1175;
    t0 *= F0298;
    t1 *= F2053;
    t2 *= F3072;
    t3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    constexpr int n = kConstBits - kPass1Bits;
    ws[c + 0] = descale(t10 + t3, n);
    ws[c + 56] = descale(t10 - t3, n);
    ws[c + 8] = descale(t11 + t2, n);
    ws[c + 48] = descale(t11 - t2, n);
    ws[c + 16] = descale(t12 + t1, n);
    ws[c + 40] = descale(t12 - t1, n);
    ws[c + 24] = descale(t13 + t0, n);
    ws[c + 32] = descale(t13 - t0, n);
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * F0541;
    t2 = z1 + z3 * (-F1847);
    t3 = z1 + z2 * F0765;
    t0 = ((int64_t)w[0] + w[4]) * (1 << kConstBits);
    t1 = ((int64_t)w[0] - w[4]) * (1 << kConstBits);
    t10 = t0 + t3;
    t13 = t0 - t3;
    t11 = t1 + t2;
    t12 = t1 - t2;
    t0 = w[7];
    t1 = w[5];
    t2 = w[3];
    t3 = w[1];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    z4 = t1 + t3;
    z5 = (z3 + z4) * F1175;
    t0 *= F0298;
    t1 *= F2053;
    t2 *= F3072;
    t3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    constexpr int n = kConstBits + kPass1Bits + 3;
    o[0] = range_limit(descale(t10 + t3, n));
    o[7] = range_limit(descale(t10 - t3, n));
    o[1] = range_limit(descale(t11 + t2, n));
    o[6] = range_limit(descale(t11 - t2, n));
    o[2] = range_limit(descale(t12 + t1, n));
    o[5] = range_limit(descale(t12 - t1, n));
    o[3] = range_limit(descale(t13 + t0, n));
    o[4] = range_limit(descale(t13 - t0, n));
  }
}

struct Jpeg {
  int width = 0, height = 0;
  int max_h = 1, max_v = 1;
  int mcus_w = 0, mcus_h = 0;
  int restart_interval = 0;
  bool adobe = false;
  int adobe_transform = -1;
  bool frame = false;
  std::vector<Component> comps;
  uint16_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
};

void read_frame(Jpeg* j, const uint8_t* p, int len) {
  if (len < 6) fail("JPEG: short SOF");
  if (p[0] != 8) fail("JPEG: only 8-bit samples are supported");
  j->height = be16(p + 1);
  j->width = be16(p + 3);
  int n = p[5];
  if (j->height <= 0 || j->width <= 0) fail("JPEG: zero image size");
  if (n != 1 && n != 3) fail("JPEG: only one- and three-component images are supported, found " +
                             std::to_string(n));
  if (len < 6 + 3 * n) fail("JPEG: short SOF");
  j->comps.resize(n);
  for (int i = 0; i < n; ++i) {
    Component& c = j->comps[i];
    c.id = p[6 + 3 * i];
    c.h = p[7 + 3 * i] >> 4;
    c.v = p[7 + 3 * i] & 15;
    c.tq = p[8 + 3 * i] & 3;
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("JPEG: bad sampling factor");
    j->max_h = std::max(j->max_h, c.h);
    j->max_v = std::max(j->max_v, c.v);
  }
  j->mcus_w = (j->width + 8 * j->max_h - 1) / (8 * j->max_h);
  j->mcus_h = (j->height + 8 * j->max_v - 1) / (8 * j->max_v);
  for (Component& c : j->comps) {
    c.ds_w = (int)(((int64_t)j->width * c.h + j->max_h - 1) / j->max_h);
    c.ds_h = (int)(((int64_t)j->height * c.v + j->max_v - 1) / j->max_v);
    c.blocks_w = (c.ds_w + 7) / 8;
    c.blocks_h = (c.ds_h + 7) / 8;
    c.stride = j->mcus_w * c.h * 8;
    c.rows = j->mcus_h * c.v * 8;
  }
  j->frame = true;
}

void decode_block(BitReader* br, Jpeg* j, Component* c, int bx, int by) {
  int16_t coef[64] = {0};
  int s = br->decode(j->dc[c->dc_table]);
  int diff = s ? extend(br->get(s), s) : 0;
  c->dc_pred += diff;
  coef[0] = (int16_t)c->dc_pred;
  const Huffman& ac = j->ac[c->ac_table];
  for (int k = 1; k < 64; ++k) {
    int rs = br->decode(ac);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      if (k > 63) fail("JPEG: corrupt AC run");
      coef[kZigzag[k]] = (int16_t)extend(br->get(s), s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  idct_islow(coef, j->quant[c->tq], c->plane.data() + (size_t)by * 8 * c->stride + bx * 8,
             c->stride);
}

// One sequential scan over `scan` (components of this scan, in order).
void decode_scan(Jpeg* j, const std::vector<Component*>& scan, const uint8_t* data,
                 size_t start, size_t end) {
  for (Component* c : scan) {
    if (!j->dc[c->dc_table].defined || !j->ac[c->ac_table].defined)
      fail("JPEG: scan uses an undefined Huffman table");
    if (!j->quant_defined[c->tq]) fail("JPEG: component uses an undefined quantization table");
    if (c->plane.empty()) c->plane.assign((size_t)c->stride * c->rows, 0);
    c->dc_pred = 0;
  }
  BitReader br{data, start, end};
  int interval = j->restart_interval;
  int todo = interval;
  auto restart_if_due = [&]() {
    if (!interval) return;
    if (todo == 0) {
      br.restart();
      for (Component* c : scan) c->dc_pred = 0;
      todo = interval;
    }
    --todo;
  };
  if (scan.size() == 1) {  // non-interleaved: one block an MCU
    Component* c = scan[0];
    for (int by = 0; by < c->blocks_h; ++by)
      for (int bx = 0; bx < c->blocks_w; ++bx) {
        restart_if_due();
        decode_block(&br, j, c, bx, by);
      }
    return;
  }
  for (int my = 0; my < j->mcus_h; ++my)
    for (int mx = 0; mx < j->mcus_w; ++mx) {
      restart_if_due();
      for (Component* c : scan)
        for (int v = 0; v < c->v; ++v)
          for (int h = 0; h < c->h; ++h) decode_block(&br, j, c, mx * c->h + h, my * c->v + v);
    }
}

// Parses markers up to the first SOF (header_only) or through EOI.
void parse_jpeg(const std::vector<uint8_t>& d, Jpeg* j, bool header_only) {
  if (!is_jpeg(d)) fail("not a JPEG file");
  size_t pos = 2;
  while (true) {
    while (pos < d.size() && d[pos] != 0xFF) ++pos;  // garbage between markers
    while (pos < d.size() && d[pos] == 0xFF) ++pos;  // fill bytes
    if (pos >= d.size()) {
      if (j->frame && !header_only) return;  // truncated after the scans
      fail("JPEG: no frame header");
    }
    int marker = d[pos++];
    if (marker == 0xD9) return;  // EOI
    if (marker >= 0xD0 && marker <= 0xD7) continue;
    if (pos + 2 > d.size()) fail("JPEG: truncated marker");
    int len = be16(&d[pos]);
    if (len < 2 || pos + len > d.size()) fail("JPEG: truncated segment");
    const uint8_t* p = &d[pos + 2];
    int n = len - 2;
    pos += len;
    switch (marker) {
      case 0xC0:
      case 0xC1:
        if (j->frame) fail("JPEG: more than one frame");
        read_frame(j, p, n);
        if (header_only) return;
        break;
      case 0xC2:
      case 0xC6:
      case 0xCA:
      case 0xCE:
        fail("JPEG: progressive JPEG is not supported");
      case 0xC3:
      case 0xC5:
      case 0xC7:
      case 0xC9:
      case 0xCB:
      case 0xCD:
      case 0xCF:
        fail("JPEG: lossless, hierarchical and arithmetic-coded JPEG are not supported");
      case 0xC4: {  // DHT
        int q = 0;
        while (q < n) {
          if (q + 17 > n) fail("JPEG: short DHT");
          int tc = p[q] >> 4, th = p[q] & 15;
          if (tc > 1 || th > 3) fail("JPEG: bad DHT");
          int total = 0;
          for (int i = 0; i < 16; ++i) total += p[q + 1 + i];
          if (total > 256 || q + 17 + total > n) fail("JPEG: bad DHT");
          (tc ? j->ac : j->dc)[th].build(p + q + 1, p + q + 17, total);
          q += 17 + total;
        }
        break;
      }
      case 0xDB: {  // DQT
        int q = 0;
        while (q < n) {
          int pq = p[q] >> 4, tq = p[q] & 15;
          if (tq > 3 || pq > 1 || q + 1 + 64 * (pq + 1) > n) fail("JPEG: bad DQT");
          for (int i = 0; i < 64; ++i)
            j->quant[tq][kZigzag[i]] =
                pq ? (uint16_t)be16(p + q + 1 + 2 * i) : (uint16_t)p[q + 1 + i];
          j->quant_defined[tq] = true;
          q += 1 + 64 * (pq + 1);
        }
        break;
      }
      case 0xDD:  // DRI
        if (n < 2) fail("JPEG: short DRI");
        j->restart_interval = be16(p);
        break;
      case 0xEE:  // APP14: Adobe
        if (n >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
          j->adobe = true;
          j->adobe_transform = p[11];
        }
        break;
      case 0xDA: {  // SOS
        if (!j->frame) fail("JPEG: scan before frame header");
        int ns = p[0];
        if (ns < 1 || ns > 4 || n < 4 + 2 * ns) fail("JPEG: bad SOS");
        std::vector<Component*> scan;
        for (int i = 0; i < ns; ++i) {
          int id = p[1 + 2 * i];
          Component* c = nullptr;
          for (Component& cc : j->comps)
            if (cc.id == id) c = &cc;
          if (!c) fail("JPEG: scan names an unknown component");
          c->dc_table = p[2 + 2 * i] >> 4;
          c->ac_table = p[2 + 2 * i] & 15;
          if (c->dc_table > 3 || c->ac_table > 3) fail("JPEG: bad SOS table");
          scan.push_back(c);
        }
        const uint8_t* tail = p + 1 + 2 * ns;
        if (tail[0] != 0 || tail[1] != 63 || tail[2] != 0)
          fail("JPEG: not a sequential scan");
        size_t start = pos, end = pos;
        while (end + 1 < d.size() &&
               !(d[end] == 0xFF && d[end + 1] != 0 && (d[end + 1] < 0xD0 || d[end + 1] > 0xD7)))
          ++end;
        if (end + 1 >= d.size()) end = d.size();
        decode_scan(j, scan, d.data(), start, end);
        pos = end;
        break;
      }
      default:  // APPn, COM, DNL and the rest: skipped
        break;
    }
  }
}

// jdsample.c's fancy upsamplers, one output row of a component at a time;
// `row(y)` gives the component's row y, clamped to [0, ds_h - 1] (the
// context rows of jdmainct.c repeat the first and the last row).
void upsample_row(const Component& c, int max_h, int max_v, int y, uint8_t* out) {
  auto row = [&](int r) {
    r = std::min(std::max(r, 0), c.ds_h - 1);
    return c.plane.data() + (size_t)r * c.stride;
  };
  const int w = c.ds_w;
  if (c.h == max_h && c.v == max_v) {
    std::memcpy(out, row(y), w);
  } else if (c.h * 2 == max_h && c.v == max_v && w > 2) {  // h2v1
    const uint8_t* in = row(y);
    out[0] = in[0];
    out[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
    for (int x = 1; x < w - 1; ++x) {
      int v = in[x] * 3;
      out[2 * x] = (uint8_t)((v + in[x - 1] + 1) >> 2);
      out[2 * x + 1] = (uint8_t)((v + in[x + 1] + 2) >> 2);
    }
    out[2 * w - 2] = (uint8_t)((in[w - 1] * 3 + in[w - 2] + 1) >> 2);
    out[2 * w - 1] = in[w - 1];
  } else if (c.h == max_h && c.v * 2 == max_v) {  // h1v2
    int r = y / 2;
    bool upper = (y & 1) == 0;
    const uint8_t* in0 = row(r);
    const uint8_t* in1 = row(upper ? r - 1 : r + 1);
    int bias = upper ? 1 : 2;
    for (int x = 0; x < w; ++x) out[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
  } else if (c.h * 2 == max_h && c.v * 2 == max_v && w > 2) {  // h2v2
    int r = y / 2;
    const uint8_t* in0 = row(r);
    const uint8_t* in1 = row((y & 1) == 0 ? r - 1 : r + 1);
    int this_sum = in0[0] * 3 + in1[0];
    int next_sum = in0[1] * 3 + in1[1];
    out[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
    out[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
    int last_sum = this_sum;
    this_sum = next_sum;
    for (int x = 1; x < w - 1; ++x) {
      next_sum = in0[x + 1] * 3 + in1[x + 1];
      out[2 * x] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
      out[2 * x + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
      last_sum = this_sum;
      this_sum = next_sum;
    }
    out[2 * w - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
    out[2 * w - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
  } else if (max_h % c.h == 0 && max_v % c.v == 0) {
    // every other integral ratio, and h2v1 / h2v2 on components too narrow
    // for fancy upsampling: replication (jdsample.c int_upsample)
    const uint8_t* in = row(y * c.v / max_v);
    int fh = max_h / c.h;
    for (int x = 0; x < w * fh; ++x) out[x] = in[x / fh];
  } else {
    fail("JPEG: unsupported chroma sampling");
  }
}

void decode_jpeg(const std::vector<uint8_t>& d, uint8_t* out, int out_h, int out_w) {
  Jpeg j;
  parse_jpeg(d, &j, false);
  if (j.height != out_h || j.width != out_w) fail("JPEG: size differs from its header");
  for (const Component& c : j.comps)
    if (c.plane.empty()) fail("JPEG: a component has no scan");
  const bool gray = j.comps.size() == 1;
  bool rgb = !gray && (j.adobe ? j.adobe_transform == 0
                               : (j.comps[0].id == 'R' && j.comps[1].id == 'G' &&
                                  j.comps[2].id == 'B'));

  // jdcolor.c's fixed-point YCbCr -> RGB tables
  constexpr int kScale = 16;
  constexpr int32_t kHalf = 1 << (kScale - 1);
  auto fix = [](double x) { return (int32_t)(x * (1 << kScale) + 0.5); };
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    int32_t x = i - 128;
    cr_r[i] = (fix(1.40200) * x + kHalf) >> kScale;
    cb_b[i] = (fix(1.77200) * x + kHalf) >> kScale;
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + kHalf;
  }
  auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };

  const int padded = j.mcus_w * j.max_h * 8 + 16;
  std::vector<uint8_t> rows(3 * (size_t)padded);
  for (int y = 0; y < out_h; ++y) {
    for (size_t ci = 0; ci < j.comps.size(); ++ci)
      upsample_row(j.comps[ci], j.max_h, j.max_v, y, rows.data() + ci * padded);
    const uint8_t* c0 = rows.data();
    const uint8_t* c1 = c0 + padded;
    const uint8_t* c2 = c1 + padded;
    uint8_t* o = out + (size_t)y * out_w * 3;
    if (gray) {  // PIL's L -> RGB: the grey in every channel
      for (int x = 0; x < out_w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = c0[x];
      continue;
    }
    if (rgb) {
      for (int x = 0; x < out_w; ++x) {
        o[3 * x] = c0[x];
        o[3 * x + 1] = c1[x];
        o[3 * x + 2] = c2[x];
      }
      continue;
    }
    for (int x = 0; x < out_w; ++x) {
      int yy = c0[x], cb = c1[x], cr = c2[x];
      o[3 * x] = clamp(yy + cr_r[cr]);
      o[3 * x + 1] = clamp(yy + ((cb_g[cb] + cr_g[cr]) >> kScale));
      o[3 * x + 2] = clamp(yy + cb_b[cb]);
    }
  }
}

// -------------------------------------------------------------------- PNG

struct PngInfo {
  int width = 0, height = 0, bit_depth = 0, color_type = 0, channels = 0;
};

PngInfo png_header(const std::vector<uint8_t>& d) {
  if (!is_png(d)) fail("not a PNG file");
  if (d.size() < 33 || std::memcmp(&d[12], "IHDR", 4) != 0) fail("PNG: no IHDR");
  const uint8_t* p = &d[16];
  PngInfo info;
  info.width = (int)be32(p);
  info.height = (int)be32(p + 4);
  info.bit_depth = p[8];
  info.color_type = p[9];
  if (p[10] != 0 || p[11] != 0) fail("PNG: unknown compression or filter method");
  if (p[12] != 0) fail("PNG: interlaced PNG is not supported");
  if (info.width <= 0 || info.height <= 0) fail("PNG: zero image size");
  if (info.color_type == 0 && (info.bit_depth == 8 || info.bit_depth == 16)) {
    info.channels = 1;
  } else if (info.color_type == 2 && info.bit_depth == 8) {
    info.channels = 3;
  } else if (info.color_type == 4 && info.bit_depth == 8) {
    info.channels = 2;
  } else if (info.color_type == 6 && info.bit_depth == 8) {
    info.channels = 4;
  } else {
    fail("PNG: only 8/16-bit grayscale and 8-bit RGB, grey-alpha and RGBA are supported "
         "(bit depth " +
         std::to_string(info.bit_depth) + ", color type " + std::to_string(info.color_type) +
         ")");
  }
  return info;
}

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

// The unfiltered rows of a PNG, (height, width * channels * bytes) bytes.
std::vector<uint8_t> png_rows(const std::vector<uint8_t>& d, const PngInfo& info) {
  std::vector<uint8_t> z;
  size_t pos = 8;
  bool ended = false;
  while (pos + 12 <= d.size()) {
    uint32_t len = be32(&d[pos]);
    if (pos + 12 + (size_t)len > d.size()) fail("PNG: truncated chunk");
    const uint8_t* type = &d[pos + 4];
    if (std::memcmp(type, "IDAT", 4) == 0) z.insert(z.end(), &d[pos + 8], &d[pos + 8] + len);
    if (std::memcmp(type, "IEND", 4) == 0) {
      ended = true;
      break;
    }
    pos += 12 + len;
  }
  if (z.empty()) fail("PNG: no image data");
  if (!ended) fail("PNG: no IEND chunk");
  const int bytes = info.bit_depth / 8;
  const int bpp = info.channels * bytes;
  const size_t rowbytes = (size_t)info.width * bpp;
  std::vector<uint8_t> raw((rowbytes + 1) * info.height);
  uLongf raw_len = raw.size();
  int zrc = uncompress(raw.data(), &raw_len, z.data(), z.size());
  if (zrc != Z_OK || raw_len != raw.size())
    fail("PNG: zlib inflate failed (" + std::to_string(zrc) + ")");

  std::vector<uint8_t> rows(rowbytes * info.height);
  std::vector<uint8_t> zero(rowbytes, 0);
  for (int y = 0; y < info.height; ++y) {
    const uint8_t* src = raw.data() + (rowbytes + 1) * y;
    const uint8_t* prev = y ? rows.data() + rowbytes * (y - 1) : zero.data();
    uint8_t* cur = rows.data() + rowbytes * y;
    int filter = src[0];
    ++src;
    for (size_t i = 0; i < rowbytes; ++i) {
      int a = i >= (size_t)bpp ? cur[i - bpp] : 0;
      int b = prev[i];
      int c = i >= (size_t)bpp ? prev[i - bpp] : 0;
      int x = src[i];
      switch (filter) {
        case 0: break;
        case 1: x += a; break;
        case 2: x += b; break;
        case 3: x += (a + b) >> 1; break;
        case 4: x += paeth(a, b, c); break;
        default: fail("PNG: bad filter type " + std::to_string(filter));
      }
      cur[i] = (uint8_t)x;
    }
  }
  return rows;
}

// Gray -> uint16 (8-bit values widened), RGB -> uint8 (H, W, 3).
void decode_png(const std::vector<uint8_t>& d, void* out, int out_h, int out_w,
                int out_channels) {
  PngInfo info = png_header(d);
  if (info.height != out_h || info.width != out_w || info.channels != out_channels ||
      (out_channels != 1 && out_channels != 3))
    fail("PNG: size or channels differ from its header");
  std::vector<uint8_t> rows = png_rows(d, info);
  if (info.channels == 3) {
    std::memcpy(out, rows.data(), rows.size());
    return;
  }
  const int bytes = info.bit_depth / 8;
  uint16_t* o = (uint16_t*)out;
  for (size_t i = 0, n = (size_t)info.width * info.height; i < n; ++i)
    o[i] = bytes == 2 ? (uint16_t)(rows[2 * i] << 8 | rows[2 * i + 1]) : rows[i];
}

// Any 8-bit JPEG or PNG above to (h, w, 3) uint8 RGB, as PIL's convert("RGB"):
// grey replicated, alpha dropped. A 16-bit grayscale PNG is refused.
void decode_rgb(const std::vector<uint8_t>& d, uint8_t* out, int out_h, int out_w) {
  if (!is_png(d)) {
    decode_jpeg(d, out, out_h, out_w);
    return;
  }
  PngInfo info = png_header(d);
  if (info.height != out_h || info.width != out_w) fail("PNG: size differs from its header");
  if (info.bit_depth != 8) fail("PNG: a 16-bit grayscale PNG has no RGB conversion");
  std::vector<uint8_t> rows = png_rows(d, info);
  const int ch = info.channels;
  const int color = ch >= 3 ? 1 : 0;  // 1: R, G, B in the first three bytes
  for (size_t i = 0, n = (size_t)out_w * out_h; i < n; ++i) {
    const uint8_t* p = rows.data() + i * ch;
    out[3 * i] = p[0];
    out[3 * i + 1] = p[color];
    out[3 * i + 2] = p[2 * color];
  }
}

// kind, height, width, channels of an image from its header.
void image_info(const std::vector<uint8_t>& d, int32_t* info) {
  if (is_png(d)) {
    PngInfo p = png_header(d);
    info[0] = kPng;
    info[1] = p.height;
    info[2] = p.width;
    info[3] = p.channels;
    return;
  }
  Jpeg j;
  parse_jpeg(d, &j, true);
  info[0] = kJpeg;
  info[1] = j.height;
  info[2] = j.width;
  info[3] = (int32_t)j.comps.size();
}

// An RGB frame, JPEG or 8-bit RGB PNG, into `out` (resized).
void decode_rgb_file(const char* path, std::vector<uint8_t>* out, int* h, int* w) {
  std::vector<uint8_t> d = read_file(path);
  int32_t info[4];
  image_info(d, info);
  if (info[3] != 3) fail(std::string("not an RGB image: ") + path);
  *h = info[1];
  *w = info[2];
  out->resize((size_t)(*h) * (*w) * 3);
  if (info[0] == kJpeg)
    decode_jpeg(d, out->data(), *h, *w);
  else
    decode_png(d, out->data(), *h, *w, 3);
}

// A grayscale PNG (8- or 16-bit) into `out` as uint16 (resized).
void decode_gray_png_file(const char* path, std::vector<uint16_t>* out, int* h, int* w) {
  std::vector<uint8_t> d = read_file(path);
  PngInfo p = png_header(d);
  if (p.channels != 1) fail(std::string("not a grayscale PNG: ") + path);
  *h = p.height;
  *w = p.width;
  out->resize((size_t)(*h) * (*w));
  decode_png(d, out->data(), *h, *w, 1);
}

// ---------------------------------------------------------- polygon fill
//
// PIL's Draw.c (ImagingDrawPolygon with a fill, polygon_generic, hline8) on
// one 8-bit (h, w) plane; the arithmetic is PIL's, float32 where it is float.

struct Edge {
  int d;
  int x0, y0;
  int xmin, ymin, xmax, ymax;
  float dx;
};

void add_edge(Edge* e, int x0, int y0, int x1, int y1) {
  if (x0 <= x1) {
    e->xmin = x0, e->xmax = x1;
  } else {
    e->xmin = x1, e->xmax = x0;
  }
  if (y0 <= y1) {
    e->ymin = y0, e->ymax = y1;
  } else {
    e->ymin = y1, e->ymax = y0;
  }
  if (y0 == y1) {
    e->d = 0;
    e->dx = 0.0f;
  } else {
    e->dx = ((float)(x1 - x0)) / (float)(y1 - y0);
    e->d = y0 == e->ymin ? 1 : -1;
  }
  e->x0 = x0;
  e->y0 = y0;
}

inline int round_up(float f) {  // Draw.c ROUND_UP, the float sum as in C
  return (int)(f >= 0.0 ? std::floor((double)(float)(f + 0.5f))
                        : -std::floor((double)(float)(std::fabs(f) + 0.5f)));
}

inline int round_down(float f) {  // Draw.c ROUND_DOWN
  return (int)(f >= 0.0 ? std::ceil((double)(float)(f - 0.5f))
                        : -std::ceil((double)(float)(std::fabs(f) - 0.5f)));
}

void hline(uint8_t* im, int h, int w, int x0, int y0, int x1) {
  if (y0 < 0 || y0 >= h) return;
  if (x0 < 0) {
    x0 = 0;
  } else if (x0 >= w) {
    return;
  }
  if (x1 < 0) {
    return;
  } else if (x1 >= w) {
    x1 = w - 1;
  }
  if (x0 <= x1) std::memset(im + (size_t)y0 * w + x0, 1, x1 - x0 + 1);
}

inline float edge_x(const Edge* e, int y) { return (float)(y - e->y0) * e->dx + (float)e->x0; }

void polygon_fill(uint8_t* im, int h, int w, const std::vector<Edge>& e) {
  const int n = (int)e.size();
  if (n <= 0) return;
  std::vector<const Edge*> table;
  int ymin = h - 1, ymax = 0;
  for (int i = 0; i < n; ++i) {
    ymin = std::min(ymin, e[i].ymin);
    ymax = std::max(ymax, e[i].ymax);
    if (e[i].ymin == e[i].ymax) {
      hline(im, h, w, e[i].xmin, e[i].ymin, e[i].xmax);
      continue;
    }
    table.push_back(&e[i]);
  }
  ymin = std::max(ymin, 0);
  ymax = std::min(ymax, h);
  const int count = (int)table.size();
  std::vector<float> xx(2 * (size_t)std::max(count, 1));
  for (; ymin <= ymax; ymin++) {
    int j = 0;
    for (int i = 0; i < count; i++) {
      const Edge* current = table[i];
      if (ymin < current->ymin || ymin > current->ymax) continue;
      xx[j++] = edge_x(current, ymin);
      if (ymin == current->ymax && ymin < ymax) {
        // needed to draw consistent polygons
        xx[j] = xx[j - 1];
        j++;
      } else if (current->dx != 0 && j % 2 == 1 && std::roundf(xx[j - 1]) == xx[j - 1]) {
        // connect discontiguous corners: another edge on this row, sloped the
        // same way, through the same point
        for (int k = 0; k < count; k++) {
          const Edge* other = table[k];
          if (k == i || (current->dx > 0 && other->dx <= 0) ||
              (current->dx < 0 && other->dx >= 0))
            continue;
          // a corner: both edges end on this row, at the same point
          if ((ymin != current->ymin && ymin != current->ymax) ||
              (ymin != other->ymin && ymin != other->ymax) || xx[j - 1] != edge_x(other, ymin))
            continue;
          // the edges' points on the next row, or on the previous one at the
          // current edge's last row
          int offset = ymin == current->ymax ? -1 : 1;
          if (ymin + offset < other->ymin || ymin + offset > other->ymax) continue;
          float adjacent = edge_x(current, ymin + offset);
          float adjacent_other = edge_x(other, ymin + offset);
          if (xx[j - 1] > adjacent + 1 && xx[j - 1] > adjacent_other + 1) {
            xx[j - 1] = std::roundf((float)std::fmax(adjacent, adjacent_other)) + 1;
          } else if (xx[j - 1] < adjacent - 1 && xx[j - 1] < adjacent_other - 1) {
            xx[j - 1] = std::roundf((float)std::fmin(adjacent, adjacent_other)) - 1;
          }
          break;
        }
      }
    }
    std::sort(xx.begin(), xx.begin() + j);
    for (int i = 1; i < j; i += 2) {
      int x_start = round_up(xx[i - 1]);
      int x_end = round_down(xx[i]);
      if (x_end < x_start) continue;
      hline(im, h, w, x_start, ymin, x_end);
    }
  }
}

// ImagingDrawPolygon with a fill: integer vertices (the coordinates cast to
// int, toward zero, as _imaging.c's _draw_polygon), runs of horizontal edges merged, the polygon closed.
void fill_polygon(uint8_t* im, int h, int w, const double* xy_in, int count) {
  if (count <= 0) return;
  std::vector<int> xy(2 * (size_t)count);
  for (int i = 0; i < 2 * count; ++i) xy[i] = (int)xy_in[i];
  std::vector<Edge> e;
  e.reserve(count);
  int i = 0;
  for (; i < count - 1; i++) {
    int x0 = xy[i * 2], y0 = xy[i * 2 + 1], x1 = xy[i * 2 + 2], y1 = xy[i * 2 + 3];
    if (y0 == y1 && i != 0 && y0 == xy[i * 2 - 1]) {
      // a horizontal line right after another horizontal line
      Edge& last = e.back();
      if (x1 > x0 && x0 > xy[i * 2 - 2]) {  // both increasing in x
        last.xmax = x1;
        continue;
      } else if (x1 < x0 && x0 < xy[i * 2 - 2]) {  // both decreasing in x
        last.xmin = x1;
        continue;
      }
    }
    e.emplace_back();
    add_edge(&e.back(), x0, y0, x1, y1);
  }
  if (xy[i * 2] != xy[0] || xy[i * 2 + 1] != xy[1]) {
    e.emplace_back();
    add_edge(&e.back(), xy[i * 2], xy[i * 2 + 1], xy[0], xy[1]);
  }
  polygon_fill(im, h, w, e);
}

int report(const DecodeError& e, char* err, int errlen) {
  if (err && errlen > 0) {
    std::strncpy(err, e.message.c_str(), errlen - 1);
    err[errlen - 1] = 0;
  }
  return -1;
}

struct CropRect {
  int32_t x, y, w, h;  // pre-augment crop (NYU boundary / KITTI kb)
};

template <typename Work>
void run_parallel(int batch, int num_threads, Work work) {
  if (num_threads <= 1 || batch == 1) {
    for (int b = 0; b < batch; ++b) work(b);
    return;
  }
  std::vector<std::thread> threads;
  std::atomic_int next{0};
  int nt = std::min(num_threads, batch);
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&]() {
      int b;
      while ((b = next.fetch_add(1)) < batch) work(b);
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// info = (kind: 1 JPEG / 2 PNG, height, width, channels), from the header.
int mdeaug_image_info(const char* path, int32_t* info, char* err, int errlen) {
  try {
    image_info(read_file(path), info);
    return 0;
  } catch (const DecodeError& e) {
    return report(e, err, errlen);
  }
}

// A one- or three-component JPEG to (h, w, 3) uint8 RGB.
int mdeaug_decode_jpeg(const char* path, uint8_t* out, int h, int w, char* err, int errlen) {
  try {
    decode_jpeg(read_file(path), out, h, w);
    return 0;
  } catch (const DecodeError& e) {
    return report(e, err, errlen);
  }
}

// A PNG: grayscale (channels 1) to (h, w) uint16, RGB (channels 3) to
// (h, w, 3) uint8.
int mdeaug_decode_png(const char* path, void* out, int h, int w, int channels, char* err,
                      int errlen) {
  try {
    decode_png(read_file(path), out, h, w, channels);
    return 0;
  } catch (const DecodeError& e) {
    return report(e, err, errlen);
  }
}

// Any 8-bit JPEG or PNG kind to (h, w, 3) uint8 RGB, as PIL's convert("RGB").
int mdeaug_decode_rgb(const char* path, uint8_t* out, int h, int w, char* err, int errlen) {
  try {
    decode_rgb(read_file(path), out, h, w);
    return 0;
  } catch (const DecodeError& e) {
    return report(e, err, errlen);
  }
}

// mdeaug_image_info and mdeaug_decode_rgb of an image held in memory.
int mdeaug_image_info_mem(const uint8_t* data, int64_t size, int32_t* info, char* err,
                          int errlen) {
  try {
    image_info(std::vector<uint8_t>(data, data + size), info);
    return 0;
  } catch (const DecodeError& e) {
    return report(e, err, errlen);
  }
}

int mdeaug_decode_rgb_mem(const uint8_t* data, int64_t size, uint8_t* out, int h, int w,
                          char* err, int errlen) {
  try {
    decode_rgb(std::vector<uint8_t>(data, data + size), out, h, w);
    return 0;
  } catch (const DecodeError& e) {
    return report(e, err, errlen);
  }
}

// Fills one polygon of `count` (x, y) vertices into the (h, w) plane `im`
// with 1, as PIL's ImageDraw.polygon(xy, fill=1) on an "L" image.
void mdeaug_fill_polygon(uint8_t* im, int h, int w, const double* xy, int count) {
  fill_polygon(im, h, w, xy, count);
}

// Fused loader: file read + JPEG/PNG decode + pre-crop + rotate/crop/flip/
// jitter/normalize, one thread per sample. Cue maps (npy/npz-parsed in
// Python) arrive decoded at full frame and are cropped with the same rect.
// Returns the number of samples that failed (their outputs are zero-filled);
// the first failure's message goes to `err`.
int mdeaug_load_augment_batch(int batch,
                              const char** rgb_paths, const char** depth_paths,
                              const int32_t** sems, const int32_t** ilabs,
                              const int32_t** iareas,
                              const CropRect* rects, int out_h, int out_w,
                              const AugParams* params, float* out_img,
                              float* out_depth, int32_t* out_sem,
                              int32_t* out_ilab, int32_t* out_iarea,
                              int num_threads, char* err, int errlen) {
  const size_t img_stride = (size_t)out_h * out_w * 3;
  const size_t map_stride = (size_t)out_h * out_w;
  std::atomic_int failures{0};
  std::atomic_flag reported = ATOMIC_FLAG_INIT;
  if (err && errlen > 0) err[0] = 0;

  auto work = [&](int b) {
    std::vector<uint8_t> rgb;
    std::vector<uint16_t> depth;
    int ih = 0, iw = 0, dh = 0, dw = 0;
    try {
      decode_rgb_file(rgb_paths[b], &rgb, &ih, &iw);
      decode_gray_png_file(depth_paths[b], &depth, &dh, &dw);
      if (dh != ih || dw != iw)
        fail(std::string("depth and image sizes differ: ") + depth_paths[b]);
      const CropRect& r = rects[b];
      if (r.w > 0 && (r.x < 0 || r.y < 0 || r.x + r.w > iw || r.y + r.h > ih))
        fail(std::string("crop window outside the frame: ") + rgb_paths[b]);
    } catch (const DecodeError& e) {
      failures.fetch_add(1);
      if (!reported.test_and_set()) report(e, err, errlen);
      std::memset(out_img + b * img_stride, 0, img_stride * sizeof(float));
      std::memset(out_depth + b * map_stride, 0, map_stride * sizeof(float));
      return;
    }
    CropRect r = rects[b];
    if (r.w <= 0) {  // full frame
      r = {0, 0, iw, ih};
    }
    // crop views: build contiguous cropped buffers (small, cache-friendly)
    std::vector<uint8_t> rgb_c((size_t)r.h * r.w * 3);
    std::vector<uint16_t> depth_c((size_t)r.h * r.w);
    for (int y = 0; y < r.h; ++y) {
      std::memcpy(rgb_c.data() + (size_t)y * r.w * 3,
                  rgb.data() + ((size_t)(y + r.y) * iw + r.x) * 3,
                  (size_t)r.w * 3);
      std::memcpy(depth_c.data() + (size_t)y * r.w,
                  depth.data() + (size_t)(y + r.y) * iw + r.x,
                  (size_t)r.w * sizeof(uint16_t));
    }
    std::vector<int32_t> sem_c, ilab_c, iarea_c;
    auto crop_i32 = [&](const int32_t* src, std::vector<int32_t>* dst) {
      dst->resize((size_t)r.h * r.w);
      for (int y = 0; y < r.h; ++y)
        std::memcpy(dst->data() + (size_t)y * r.w,
                    src + (size_t)(y + r.y) * iw + r.x,
                    (size_t)r.w * sizeof(int32_t));
    };
    if (sems && sems[b]) crop_i32(sems[b], &sem_c);
    if (ilabs && ilabs[b]) crop_i32(ilabs[b], &ilab_c);
    if (iareas && iareas[b]) crop_i32(iareas[b], &iarea_c);

    augment_one(rgb_c.data(), depth_c.data(),
                sem_c.empty() ? nullptr : sem_c.data(),
                ilab_c.empty() ? nullptr : ilab_c.data(),
                iarea_c.empty() ? nullptr : iarea_c.data(), r.h, r.w, out_h,
                out_w, params[b], out_img + b * img_stride,
                out_depth + b * map_stride,
                out_sem ? out_sem + b * map_stride : nullptr,
                out_ilab ? out_ilab + b * map_stride : nullptr,
                out_iarea ? out_iarea + b * map_stride : nullptr);
  };
  run_parallel(batch, num_threads, work);
  return failures.load();
}

// Batch entry: arrays of per-sample pointers; null cue pointers are skipped.
// out_img is (B, out_h, out_w, 3) f32 NHWC, out_depth (B, out_h, out_w).
void mdeaug_augment_batch(int batch,
                          const uint8_t** rgbs, const uint16_t** depths,
                          const int32_t** sems, const int32_t** ilabs,
                          const int32_t** iareas,
                          const int32_t* in_hs, const int32_t* in_ws,
                          int out_h, int out_w, const AugParams* params,
                          float* out_img, float* out_depth, int32_t* out_sem,
                          int32_t* out_ilab, int32_t* out_iarea,
                          int num_threads) {
  const size_t img_stride = (size_t)out_h * out_w * 3;
  const size_t map_stride = (size_t)out_h * out_w;
  run_parallel(batch, num_threads, [&](int b) {
    augment_one(rgbs[b], depths[b],
                sems ? sems[b] : nullptr,
                ilabs ? ilabs[b] : nullptr,
                iareas ? iareas[b] : nullptr,
                in_hs[b], in_ws[b], out_h, out_w, params[b],
                out_img + b * img_stride, out_depth + b * map_stride,
                out_sem ? out_sem + b * map_stride : nullptr,
                out_ilab ? out_ilab + b * map_stride : nullptr,
                out_iarea ? out_iarea + b * map_stride : nullptr);
  });
}

}  // extern "C"
