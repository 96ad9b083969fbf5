// Baseline JPEG encoder of the port: what Pillow 12.1 over libjpeg-turbo
// 3.1.3 writes for Image.fromarray(rgb_u8).save(buf, "JPEG", quality=q), byte
// for byte. Built into the host loader's library (loader.cpp) and called
// through ctypes (simplesr_tpu_torch/data/native_loader.py: encode_jpeg).
//
// Pillow's settings for an RGB image with only a quality given: 4:2:0
// sampling, jpeg_set_quality(q, force_baseline=TRUE), the ISLOW forward DCT,
// the standard Huffman tables (no optimisation), no restart markers, a JFIF
// 1.01 APP0 with density 1 x 1 and no unit. The arithmetic is libjpeg-turbo's:
//   - jccolor.c rgb_ycc_convert: 16-bit fixed-point tables, Cb and Cr rounded
//     with 0.5 - epsilon;
//   - jcsample.c h2v2_downsample: 2 x 2 means with the bias 1, 2, 1, 2, ...
//     along each row, the right edge replicated out to whole chroma blocks
//     (expand_right_edge) and an odd last row doubled (jcprepct.c);
//   - jcprepct.c: each plane's bottom edge replicated to a whole iMCU row;
//   - jccoefct.c: dummy luma blocks past the right and bottom edges of the
//     last MCUs, all zero but a DC copied from the block before;
//   - jfdctint.c jpeg_fdct_islow, then jcdctmgr.c's quantisation by
//     reciprocal multiplication (compute_reciprocal, quantize);
//   - jchuff.c: DC differences and AC run lengths, 0xFF bytes stuffed with
//     0x00, the last byte padded with one bits.
// Only RGB uint8 input is taken: the JAX package's campaign encodes nothing
// else.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

extern "C" void ssr_set_last_error(const char* msg);  // loader.cpp

namespace {

constexpr int kMaxDimension = 65500;  // libjpeg's JPEG_MAX_DIMENSION

const int kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                         12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                         35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                         58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// jcparam.c: the JPEG standard's tables (Annex K.1), natural order
const int kLumaQuant[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,
                            58, 60, 55, 14, 13,  16,  24,  40,  57, 69, 56, 14, 17,
                            22, 29, 51, 87, 80,  62,  18,  22,  37, 56, 68, 109, 103,
                            77, 24, 35, 55, 64,  81,  104, 113, 92, 49, 64, 78,  87,
                            103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQuant[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
                              99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                              99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jstdhuff.c: the standard Huffman tables (Annex K.3): counts by length, values
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcValues[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaValues[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaValues[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {
  const uint8_t* bits;
  const uint8_t* values;
  int count;
  uint32_t code[256] = {};
  uint8_t size[256] = {};

  HuffTable(const uint8_t* b, const uint8_t* v, int n) : bits(b), values(v), count(n) {
    // jchuff.c jpeg_make_c_derived_tbl: canonical codes, shortest first
    uint32_t c = 0;
    int k = 0;
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len - 1]; ++i, ++k) {
        code[values[k]] = c++;
        size[values[k]] = uint8_t(len);
      }
      c <<= 1;
    }
  }
};

// jcparam.c jpeg_quality_scaling and jpeg_add_quant_table(force_baseline)
void quant_table(const int* basic, int quality, int* out) {
  int scale = quality <= 0 ? 1 : std::min(quality, 100);
  scale = scale < 50 ? 5000 / scale : 200 - scale * 2;
  for (int i = 0; i < 64; ++i) {
    long temp = (long(basic[i]) * scale + 50L) / 100L;
    out[i] = int(std::clamp(temp, 1L, 255L));
  }
}

// jcdctmgr.c compute_reciprocal for the ISLOW divisor (the table's value x 8),
// with libjpeg-turbo's 16-bit DCTELEM
struct Divisor {
  uint16_t recip, corr;
  int shift;  // the whole right shift of the product
};

Divisor reciprocal(int divisor) {
  int b = 31 - __builtin_clz(unsigned(divisor));  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / unsigned(divisor);
  uint32_t fr = (uint32_t(1) << r) % unsigned(divisor);
  uint32_t c = unsigned(divisor) / 2;
  if (fr == 0) {  // a power of two: fq would not fit 16 bits
    fq >>= 1;
    r--;
  } else if (fr <= unsigned(divisor) / 2) {
    c++;
  } else {
    fq++;
  }
  return {uint16_t(fq), uint16_t(c), r};
}

// jfdctint.c jpeg_fdct_islow, on 16-bit storage as libjpeg-turbo's DCTELEM
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;

inline int32_t descale(int32_t x, int n) { return (x + (int32_t(1) << (n - 1))) >> n; }

void fdct_islow(int16_t* data) {
  constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                    F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069,
                    F2053 = 16819, F2562 = 20995, F3072 = 25172;
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8;    // along a row, then down a column
    const int stride = pass == 0 ? 8 : 1;  // to the next row / column
    for (int line = 0; line < 8; ++line) {
      int16_t* d = data + line * stride;
      int32_t tmp0 = d[0 * step] + d[7 * step], tmp7 = d[0 * step] - d[7 * step];
      int32_t tmp1 = d[1 * step] + d[6 * step], tmp6 = d[1 * step] - d[6 * step];
      int32_t tmp2 = d[2 * step] + d[5 * step], tmp5 = d[2 * step] - d[5 * step];
      int32_t tmp3 = d[3 * step] + d[4 * step], tmp4 = d[3 * step] - d[4 * step];
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int bits = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
      if (pass == 0) {
        d[0] = int16_t((tmp10 + tmp11) * (1 << kPass1Bits));
        d[4 * step] = int16_t((tmp10 - tmp11) * (1 << kPass1Bits));
      } else {
        d[0] = int16_t(descale(tmp10 + tmp11, kPass1Bits));
        d[4 * step] = int16_t(descale(tmp10 - tmp11, kPass1Bits));
      }
      int32_t z1 = (tmp12 + tmp13) * F0541;
      d[2 * step] = int16_t(descale(z1 + tmp13 * F0765, bits));
      d[6 * step] = int16_t(descale(z1 + tmp12 * -F1847, bits));

      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int32_t z5 = (z3 + z4) * F1175;
      tmp4 *= F0298;
      tmp5 *= F2053;
      tmp6 *= F3072;
      tmp7 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 = z3 * -F1961 + z5;
      z4 = z4 * -F0390 + z5;
      d[7 * step] = int16_t(descale(tmp4 + z1 + z3, bits));
      d[5 * step] = int16_t(descale(tmp5 + z2 + z4, bits));
      d[3 * step] = int16_t(descale(tmp6 + z2 + z3, bits));
      d[1 * step] = int16_t(descale(tmp7 + z1 + z4, bits));
    }
  }
}

struct Component {
  int width = 0, height = 0;  // whole blocks x 8
  std::vector<uint8_t> plane;
  Divisor div[64];
  const HuffTable* dc;
  const HuffTable* ac;
  int last_dc = 0;
};

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>* out) : out_(out) {}

  void put(uint32_t code, int size) {
    buffer_ = (buffer_ << size) | (code & ((uint32_t(1) << size) - 1));
    bits_ += size;
    while (bits_ >= 8) {
      bits_ -= 8;
      uint8_t c = uint8_t(buffer_ >> bits_);
      out_->push_back(c);
      if (c == 0xFF) out_->push_back(0);
    }
  }

  void flush() {
    if (bits_) put(0x7F, 8 - bits_);  // the partial byte filled with ones
  }

 private:
  std::vector<uint8_t>* out_;
  uint64_t buffer_ = 0;
  int bits_ = 0;
};

int bit_length(int v) {  // of |v|, 0 for 0
  unsigned a = unsigned(v < 0 ? -v : v);
  return a ? 32 - __builtin_clz(a) : 0;
}

// jchuff.c encode_one_block
void encode_block(BitWriter& bw, const int16_t* block, Component& comp) {
  int diff = block[0] - comp.last_dc;
  comp.last_dc = block[0];
  int nbits = bit_length(diff);
  bw.put(comp.dc->code[nbits], comp.dc->size[nbits]);
  if (nbits) bw.put(uint32_t(diff < 0 ? diff - 1 : diff), nbits);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = block[kZigzag[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(comp.ac->code[0xF0], comp.ac->size[0xF0]);
      run -= 16;
    }
    nbits = bit_length(v);
    int sym = (run << 4) + nbits;
    bw.put(comp.ac->code[sym], comp.ac->size[sym]);
    bw.put(uint32_t(v < 0 ? v - 1 : v), nbits);
    run = 0;
  }
  if (run > 0) bw.put(comp.ac->code[0], comp.ac->size[0]);
}

// forward_DCT_islow of one 8 x 8 block of a plane, then quantize
void transform_block(const Component& comp, int by, int bx, int16_t* coef) {
  int16_t ws[64];
  for (int r = 0; r < 8; ++r) {
    const uint8_t* row = comp.plane.data() + size_t(by * 8 + r) * comp.width + bx * 8;
    for (int c = 0; c < 8; ++c) ws[r * 8 + c] = int16_t(int(row[c]) - 128);
  }
  fdct_islow(ws);
  for (int i = 0; i < 64; ++i) {
    const Divisor& d = comp.div[i];
    int t = ws[i];
    uint32_t mag = uint32_t(t < 0 ? -t : t);
    uint32_t q = ((mag + d.corr) * d.recip) >> d.shift;
    coef[i] = int16_t(t < 0 ? -int(q) : int(q));
  }
}

void put16(std::vector<uint8_t>& out, int v) {
  out.push_back(uint8_t(v >> 8));
  out.push_back(uint8_t(v & 0xFF));
}

void put_dqt(std::vector<uint8_t>& out, int index, const int* table) {
  out.insert(out.end(), {0xFF, 0xDB});
  put16(out, 2 + 1 + 64);
  out.push_back(uint8_t(index));  // 8-bit precision: force_baseline caps at 255
  for (int k = 0; k < 64; ++k) out.push_back(uint8_t(table[kZigzag[k]]));
}

void put_dht(std::vector<uint8_t>& out, int index, const HuffTable& t) {
  out.insert(out.end(), {0xFF, 0xC4});
  put16(out, 2 + 1 + 16 + t.count);
  out.push_back(uint8_t(index));
  out.insert(out.end(), t.bits, t.bits + 16);
  out.insert(out.end(), t.values, t.values + t.count);
}

// jccolor.c's tables: FIX(x) = x * 2^16 rounded
constexpr int kScaleBits = 16;
constexpr int32_t fix(double x) { return int32_t(x * (1 << kScaleBits) + 0.5); }
constexpr int32_t kOneHalf = int32_t(1) << (kScaleBits - 1);
constexpr int32_t kCbCrOffset = int32_t(128) << kScaleBits;

std::vector<uint8_t> encode(const uint8_t* rgb, int h, int w, int quality) {
  int luma_q[64], chroma_q[64];
  quant_table(kLumaQuant, quality, luma_q);
  quant_table(kChromaQuant, quality, chroma_q);
  static const HuffTable dc_luma(kDcLumaBits, kDcValues, 12);
  static const HuffTable dc_chroma(kDcChromaBits, kDcValues, 12);
  static const HuffTable ac_luma(kAcLumaBits, kAcLumaValues, 162);
  static const HuffTable ac_chroma(kAcChromaBits, kAcChromaValues, 162);

  const int mcu_cols = (w + 15) / 16, mcu_rows = (h + 15) / 16;
  const int luma_bw = (w + 7) / 8, luma_bh = (h + 7) / 8;  // the real luma blocks
  Component comp[3];
  comp[0].width = luma_bw * 8;
  comp[0].height = luma_bh * 8;
  for (int c = 1; c < 3; ++c) {
    comp[c].width = mcu_cols * 8;
    comp[c].height = mcu_rows * 8;
  }
  for (int c = 0; c < 3; ++c) {
    comp[c].plane.resize(size_t(comp[c].width) * comp[c].height);
    const int* table = c == 0 ? luma_q : chroma_q;
    for (int i = 0; i < 64; ++i) comp[c].div[i] = reciprocal(table[i] << 3);
    comp[c].dc = c == 0 ? &dc_luma : &dc_chroma;
    comp[c].ac = c == 0 ? &ac_luma : &ac_chroma;
  }

  // Colour conversion of the image, its edges replicated: the luma plane to
  // whole blocks, the full-resolution chroma to whole 2 x 2 chroma blocks
  // across and to an even height down.
  const int wide = mcu_cols * 16, tall = h + (h & 1);
  std::vector<uint8_t> cb(size_t(wide) * tall), cr(size_t(wide) * tall);
  for (int y = 0; y < std::max(tall, comp[0].height); ++y) {
    const uint8_t* src = rgb + size_t(std::min(y, h - 1)) * w * 3;
    for (int x = 0; x < std::max(wide, comp[0].width); ++x) {
      const uint8_t* p = src + size_t(std::min(x, w - 1)) * 3;
      const int32_t r = p[0], g = p[1], b = p[2];
      if (y < comp[0].height && x < comp[0].width)
        comp[0].plane[size_t(y) * comp[0].width + x] =
            uint8_t((fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + kOneHalf) >>
                    kScaleBits);
      if (y < tall && x < wide) {
        const int32_t half = fix(0.50000);
        cb[size_t(y) * wide + x] = uint8_t(
            (-fix(0.16874) * r - fix(0.33126) * g + half * b + kCbCrOffset + kOneHalf - 1) >>
            kScaleBits);
        cr[size_t(y) * wide + x] = uint8_t(
            (half * r - fix(0.41869) * g - fix(0.08131) * b + kCbCrOffset + kOneHalf - 1) >>
            kScaleBits);
      }
    }
  }
  // 2 x 2 means, then the last chroma row replicated to whole blocks
  for (int c = 1; c < 3; ++c) {
    const std::vector<uint8_t>& full = c == 1 ? cb : cr;
    Component& k = comp[c];
    const int rows = tall / 2;
    for (int y = 0; y < k.height; ++y) {
      uint8_t* dst = k.plane.data() + size_t(y) * k.width;
      if (y >= rows) {
        std::memcpy(dst, k.plane.data() + size_t(rows - 1) * k.width, k.width);
        continue;
      }
      const uint8_t* r0 = full.data() + size_t(2 * y) * wide;
      const uint8_t* r1 = r0 + wide;
      for (int x = 0; x < k.width; ++x) {
        const int bias = 1 + (x & 1);
        dst[x] = uint8_t((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
      }
    }
  }

  std::vector<uint8_t> out;
  out.reserve(size_t(w) * h / 2 + 1024);
  out.insert(out.end(), {0xFF, 0xD8});
  // APP0: JFIF 1.01, no density unit, 1 x 1, no thumbnail
  out.insert(out.end(), {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 0x01, 0x01, 0x00,
                         0x00, 0x01, 0x00, 0x01, 0x00, 0x00});
  put_dqt(out, 0, luma_q);
  put_dqt(out, 1, chroma_q);
  out.insert(out.end(), {0xFF, 0xC0});
  put16(out, 17);
  out.push_back(8);
  put16(out, h);
  put16(out, w);
  out.insert(out.end(), {3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1});
  put_dht(out, 0x00, dc_luma);
  put_dht(out, 0x10, ac_luma);
  put_dht(out, 0x01, dc_chroma);
  put_dht(out, 0x11, ac_chroma);
  out.insert(out.end(), {0xFF, 0xDA});
  put16(out, 12);
  out.insert(out.end(), {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0});

  BitWriter bw(&out);
  int16_t block[4][64], chroma[64];
  for (int my = 0; my < mcu_rows; ++my) {
    for (int mx = 0; mx < mcu_cols; ++mx) {
      for (int yi = 0; yi < 2; ++yi) {
        for (int xi = 0; xi < 2; ++xi) {
          int16_t* b = block[yi * 2 + xi];
          const int by = my * 2 + yi, bx = mx * 2 + xi;
          if (by < luma_bh && bx < luma_bw) {
            transform_block(comp[0], by, bx, b);
          } else {  // a dummy block: the DC of the block before, no AC
            std::memset(b, 0, sizeof(block[0]));
            b[0] = by < luma_bh ? block[yi * 2 + xi - 1][0] : block[yi * 2 - 1][0];
          }
          encode_block(bw, b, comp[0]);
        }
      }
      for (int c = 1; c < 3; ++c) {
        transform_block(comp[c], my, mx, chroma);
        encode_block(bw, chroma, comp[c]);
      }
    }
  }
  bw.flush();
  out.insert(out.end(), {0xFF, 0xD9});
  return out;
}

}  // namespace

extern "C" {

// Encode h x w RGB uint8 (rows of 3 * w bytes) as Pillow writes it at this
// quality (0-100; 0 as 1, as libjpeg takes it) into a buffer of malloc's,
// which the caller frees with ssr_free. Returns 0, or 1 with the reason in
// ssr_last_error.
int ssr_encode_jpeg(const uint8_t* rgb, int h, int w, int quality, uint8_t** out, size_t* n) {
  *out = nullptr;
  *n = 0;
  try {
    if (h < 1 || w < 1 || h > kMaxDimension || w > kMaxDimension)
      throw std::invalid_argument("JPEG encode: image of " + std::to_string(w) + " x " +
                                  std::to_string(h) + " pixels; baseline JPEG takes 1 to " +
                                  std::to_string(kMaxDimension) + " on each side");
    if (quality < 0 || quality > 100)
      throw std::invalid_argument("JPEG encode: quality " + std::to_string(quality) +
                                  " is out of range 0-100");
    std::vector<uint8_t> bytes = encode(rgb, h, w, quality);
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(bytes.size()));
    if (!buf) throw std::runtime_error("JPEG encode: out of memory");
    std::memcpy(buf, bytes.data(), bytes.size());
    *out = buf;
    *n = bytes.size();
    return 0;
  } catch (const std::exception& e) {
    ssr_set_last_error(e.what());
    return 1;
  }
}

}  // extern "C"
