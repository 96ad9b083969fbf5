// TIFF decoder of the port: the first image (IFD) of a classic TIFF or a
// little-endian BigTIFF file, to RGB as PIL 12.1 gives it through
// Image.open(...).convert("RGB"), which reads an uncompressed image with its
// own raw decoder and a compressed one through libtiff 4.7.
//
//   - Either byte order; strips or tiles; chunky or planar samples.
//   - Compression none, LZW (libtiff's, codes from 9 bits, one code early),
//     Deflate and Adobe Deflate (zlib), PackBits, and JPEG (7): each strip or
//     tile a JPEG stream after the JPEGTables stream, decoded by loader.cpp's
//     JPEG decoder as libtiff drives libjpeg (YCbCr converted to RGB by
//     libjpeg, as Pillow's JPEGCOLORMODE_RGB asks; other samples as they
//     are). The predictor (horizontal differencing, 8-, 16- and 32-bit
//     samples) applies to LZW and Deflate only: PIL's raw decoder and
//     libtiff's PackBits ignore the tag.
//   - The pixel layouts of PIL's OPEN_INFO table that end in RGB, L, P, CMYK,
//     I, F or LAB: 1-, 2-, 4- and 8-bit grey (min-is-white inverted), 16-bit grey
//     (clipped to 255, as convert("RGB") clips mode I;16, min-is-white read
//     as min-is-black, as PIL reads it), signed 8- and 16-bit grey, grey with
//     alpha, 32-bit integer and float grey (clipped, floats truncated, as
//     convert("L") takes modes I and F), 8- and 16-bit RGB (16 bits to the
//     high byte), RGB with extra samples (associated alpha divided out as
//     PIL's "RGBa" unpacker divides it), 8- and 16-bit CMYK (PIL's
//     cmyk2rgb), 1- to 8-bit palettes (16-bit colormap entries to their high
//     byte), compressed 8-bit YCbCr as libtiff's TIFFRGBAImage converts it
//     (subsampling units, YCbCrCoefficients, ReferenceBlackWhite), and 8-bit
//     CIELab as Pillow converts mode LAB through LittleCMS (LabToSrgb).
//   - The Orientation tag turns the image as PIL's loader turns it
//     (ImageOps.exif_transpose).
//
// Refused naming ROADMAP.md's item: big-endian BigTIFF (PIL reads its header
// as a classic one), old-style JPEG, CCITT fax, fill order 2, old-style
// LZW, YCbCr that is not JPEG-compressed in tiles, planes or with the
// predictor, planar CIELab, the floating-point predictor, the sample
// layouts not listed above, and the ones PIL misreads (16-bit planar
// samples without compression, planes with alpha, compressed big-endian
// signed or 32-bit samples, uncompressed YCbCr). A strip or tile that does not decode to its full size is refused,
// as libtiff refuses it; so is any offset, count or code that leaves the
// file, a JPEG segment whose size, components or sampling libtiff would not
// take, and a tag of a type, count or value that PIL's parser or libtiff
// refuses.

#include <zlib.h>

#include <algorithm>
#include <cmath>
#include <cstring>
#include <map>

#include "formats.h"

namespace ssr {
namespace {

const char* kFmt = "TIFF";

[[noreturn]] void fail(const std::string& msg) { format_fail(kFmt, msg); }
[[noreturn]] void refuse(const std::string& what) {
  fail(what + " is not supported (" + std::string(kFormatsItem) + ")");
}

enum {
  kWidth = 256, kLength = 257, kBits = 258, kCompression = 259, kPhotometric = 262,
  kFillOrder = 266, kStripOffsets = 273, kSamples = 277, kRowsPerStrip = 278,
  kStripByteCounts = 279, kPlanar = 284, kPredictor = 317, kColorMap = 320, kTileWidth = 322,
  kTileLength = 323, kTileOffsets = 324, kTileByteCounts = 325, kExtraSamples = 338,
  kSampleFormat = 339, kJpegTables = 347, kYCbCrCoefficients = 529, kYCbCrSubsampling = 530,
  kReferenceBlackWhite = 532, kOrientation = 274,
};

class Reader {
 public:
  Reader(const uint8_t* d, size_t n, bool big) : d_(d), n_(n), big_(big) {}
  uint32_t u16(size_t at) const {
    check(at, 2);
    return big_ ? (d_[at] << 8) | d_[at + 1] : d_[at] | (d_[at + 1] << 8);
  }
  uint32_t u32(size_t at) const {
    check(at, 4);
    return big_ ? (uint32_t(d_[at]) << 24) | (d_[at + 1] << 16) | (d_[at + 2] << 8) | d_[at + 3]
                : d_[at] | (d_[at + 1] << 8) | (d_[at + 2] << 16) | (uint32_t(d_[at + 3]) << 24);
  }
  uint64_t u64(size_t at) const {
    const uint64_t a = u32(at), b = u32(at + 4);
    return big_ ? (a << 32) | b : (b << 32) | a;
  }
  void check(uint64_t at, uint64_t len) const {
    if (at > n_ || len > n_ - at) fail("an offset or count leaves the file");
  }
  bool big() const { return big_; }

 private:
  const uint8_t* d_;
  size_t n_;
  bool big_;
};

// One IFD entry: its type, count and where its data lies; values for the
// integer types that both PIL's parser and libtiff take for every tag this
// decoder reads as numbers (SHORT, LONG; LONG8 in BigTIFF).
struct Tag {
  uint32_t type = 0;
  uint64_t count = 0;
  size_t at = 0;
  std::vector<uint64_t> values;
};

// The first IFD's tags, of a classic TIFF or a BigTIFF (8-byte counts and
// offsets, 20-byte entries). A tag given twice is refused (libtiff keeps
// the first, PIL the last).
std::map<int, Tag> read_ifd(const Reader& r, uint64_t at, bool bigtiff) {
  std::map<int, Tag> tags;
  const uint64_t count = bigtiff ? r.u64(at) : r.u16(at);
  const size_t entry = bigtiff ? 20 : 12, inline_size = bigtiff ? 8 : 4;
  const size_t first = at + (bigtiff ? 8 : 2);
  if (count > 0xffff) fail("too many tags");
  r.check(first, count * entry);
  for (uint64_t i = 0; i < count; ++i) {
    const size_t e = first + size_t(i) * entry;
    const int tag = int(r.u16(e));
    if (tags.count(tag)) fail("tag " + std::to_string(tag) + " given twice");
    Tag& t = tags[tag];
    t.type = r.u16(e + 2);
    t.count = bigtiff ? r.u64(e + 4) : r.u32(e + 4);
    static const int kSize[19] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8, 4, 0, 0, 8, 8, 8};
    const int size = t.type < 19 ? kSize[t.type] : 0;
    if (!size) continue;
    if (t.count > (uint64_t(1) << 31) / size) fail("tag " + std::to_string(tag) + " too long");
    const size_t bytes = size_t(t.count) * size;
    const size_t value_at = e + (bigtiff ? 12 : 8);
    t.at = bytes <= inline_size ? value_at : size_t(bigtiff ? r.u64(value_at) : r.u32(value_at));
    r.check(t.at, bytes);
    if (!(t.type == 3 || t.type == 4 || (bigtiff && t.type == 16))) continue;
    t.values.resize(size_t(t.count));
    for (uint64_t k = 0; k < t.count; ++k) {
      const size_t p = t.at + size_t(k) * size;
      t.values[k] = size == 2 ? r.u16(p) : size == 4 ? r.u32(p) : r.u64(p);
    }
  }
  return tags;
}

// ----------------------------------------------------------- codecs

// libtiff's LZWDecode: MSB-first codes, 9 to 12 bits, the code size growing
// when the next free entry passes 2^size - 2.
void lzw_decode(const uint8_t* src, size_t n, uint8_t* out, size_t need) {
  if (n >= 2 && src[0] == 0 && (src[1] & 1)) refuse("old-style LZW");
  struct Entry {
    uint16_t prefix;
    uint8_t first, last;
    uint16_t length;
  };
  std::vector<Entry> table(4096 + 1024);
  for (int i = 0; i < 256; ++i) table[i] = Entry{0, uint8_t(i), uint8_t(i), 1};
  const int kClear = 256, kEoi = 257;
  size_t bitpos = 0;
  const size_t total_bits = n * 8;
  int nbits = 9;
  int free_ent = 258;
  int old = -1;
  size_t produced = 0;
  uint64_t acc = 0;  // bits not yet consumed, the next at the top of `have`
  int have = 0;
  size_t byte = 0;
  auto next_code = [&]() -> int {
    if (bitpos + nbits > total_bits) return kEoi;  // libtiff: not terminated with EOI
    while (have < nbits) {
      acc = (acc << 8) | src[byte++];
      have += 8;
    }
    bitpos += nbits;
    have -= nbits;
    return int((acc >> have) & ((1u << nbits) - 1));
  };
  while (produced < need) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      while (code == kClear) {  // consecutive clear codes
        nbits = 9;
        free_ent = 258;
        code = next_code();
      }
      if (code == kEoi) break;
      if (code >= kClear) fail("corrupt LZW data");
      out[produced++] = uint8_t(code);
      old = code;
      continue;
    }
    if (old < 0) fail("LZW data without a clear code");
    if (code > free_ent || free_ent >= int(table.size())) fail("corrupt LZW data");
    // the new entry: the old string and the first byte of this one
    Entry& e = table[free_ent];
    e.prefix = uint16_t(old);
    e.first = table[old].first;
    e.length = uint16_t(table[old].length + 1);
    e.last = code < free_ent ? table[code].first : e.first;
    if (++free_ent > (1 << nbits) - 2) nbits = std::min(nbits + 1, 12);
    // the string of `code`, written backwards; a string past the strip's
    // end is cut there
    const Entry& s = table[code];
    if (s.length == 0) fail("corrupt LZW data");
    const size_t len = s.length, take = std::min(len, need - produced);
    int c = code;
    for (size_t i = len; i-- > 0; c = table[c].prefix)
      if (i < take) out[produced + i] = table[c].last;
    produced += take;
    old = code;
  }
  if (produced < need) fail("not enough LZW data for the strip or tile");
}

void deflate_decode(const uint8_t* src, size_t n, uint8_t* out, size_t need) {
  z_stream zs;
  std::memset(&zs, 0, sizeof zs);
  if (inflateInit(&zs) != Z_OK) fail("zlib failed to start");
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = uInt(std::min<size_t>(n, 0xffffffffu));
  zs.next_out = out;
  zs.avail_out = uInt(need);
  int state = Z_OK;
  while (zs.avail_out > 0) {
    state = inflate(&zs, Z_PARTIAL_FLUSH);
    if (state == Z_STREAM_END) break;
    if (state != Z_OK) break;
  }
  const size_t got = need - zs.avail_out;
  inflateEnd(&zs);
  if (state != Z_OK && state != Z_STREAM_END) fail("corrupt Deflate data");
  if (got < need) fail("not enough Deflate data for the strip or tile");
}

// libtiff's PackBitsDecode over a whole strip or tile.
void packbits_decode(const uint8_t* src, size_t n, uint8_t* out, size_t need) {
  size_t i = 0, o = 0;
  while (o < need && i < n) {
    int c = int8_t(src[i++]);
    if (c < 0) {
      if (c == -128) continue;
      size_t run = size_t(1 - c);
      if (run > need - o) run = need - o;
      if (i >= n) break;
      std::memset(out + o, src[i++], run);
      o += run;
    } else {
      size_t run = size_t(c + 1);
      if (run > need - o) run = need - o;
      if (n - i < run) break;
      std::memcpy(out + o, src + i, run);
      o += run;
      i += run;
    }
  }
  if (o < need) fail("not enough PackBits data for the strip or tile");
}

// Horizontal differencing undone in place on rows of `row_bytes`.
void undo_predictor(uint8_t* buf, size_t rows, size_t row_bytes, int bits, int stride,
                    bool big) {
  const size_t bytes = size_t(bits) / 8, count = row_bytes / bytes;
  auto get = [&](const uint8_t* p) {
    uint32_t v = 0;
    for (size_t i = 0; i < bytes; ++i) v |= uint32_t(p[big ? bytes - 1 - i : i]) << (8 * i);
    return v;
  };
  auto put = [&](uint8_t* p, uint32_t v) {
    for (size_t i = 0; i < bytes; ++i) p[big ? bytes - 1 - i : i] = uint8_t(v >> (8 * i));
  };
  for (size_t y = 0; y < rows; ++y) {
    uint8_t* row = buf + y * row_bytes;
    if (bits == 8) {
      for (size_t i = size_t(stride); i < row_bytes; ++i)
        row[i] = uint8_t(row[i] + row[i - stride]);
      continue;
    }
    for (size_t k = size_t(stride); k < count; ++k)
      put(row + k * bytes, get(row + k * bytes) + get(row + (k - stride) * bytes));
  }
}

// How the samples become RGB.
enum Layout {
  GREY, GREY_SIGNED, RGB_PLAIN, RGB_ASSOCIATED, PALETTE, CMYK, GREY_I32, GREY_F32, CIELAB,
};

// libtiff's TIFFYCbCrToRGB (tif_color.c), in its float arithmetic, from the
// YCbCrCoefficients and ReferenceBlackWhite tags.
struct YCbCrToRgb {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256], y[256];

  YCbCrToRgb(const float luma[3], const float ref[6]) {
    const int kShift = 16;
    const int32_t kHalf = int32_t(1) << (kShift - 1);
    auto fix = [](float x) { return int32_t(double(x * float(1L << 16)) + 0.5); };
    auto clamp = [](float f, float lo, float hi) { return f < lo ? lo : f > hi ? hi : f; };
    auto code2v = [](int c, float rb, float rw, int cr) {
      return (float(c - int32_t(rb)) * float(cr)) / float((rw - rb) != 0 ? (rw - rb) : 1);
    };
    const float f1 = 2 - 2 * luma[0];
    const int32_t d1 = fix(clamp(f1, 0.0F, 2.0F));
    const float f2 = luma[0] * f1 / luma[1];
    const int32_t d2 = -fix(clamp(f2, 0.0F, 2.0F));
    const float f3 = 2 - 2 * luma[2];
    const int32_t d3 = fix(clamp(f3, 0.0F, 2.0F));
    const float f4 = luma[2] * f3 / luma[1];
    const int32_t d4 = -fix(clamp(f4, 0.0F, 2.0F));
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      const int32_t cr = int32_t(clamp(code2v(x, ref[4] - 128.0F, ref[5] - 128.0F, 127),
                                       -128.0F * 32, 128.0F * 32));
      const int32_t cb = int32_t(clamp(code2v(x, ref[2] - 128.0F, ref[3] - 128.0F, 127),
                                       -128.0F * 32, 128.0F * 32));
      cr_r[i] = (d1 * cr + kHalf) >> kShift;
      cb_b[i] = (d3 * cb + kHalf) >> kShift;
      cr_g[i] = d2 * cr;
      cb_g[i] = d4 * cb + kHalf;
      y[i] = int32_t(clamp(code2v(x + 128, ref[0], ref[1], 255), -128.0F * 32, 128.0F * 32));
    }
  }

  void convert(int luma, int cb, int cr, uint8_t* rgb) const {
    auto clip = [](int32_t v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
    rgb[0] = clip(y[luma] + cr_r[cr]);
    rgb[1] = clip(y[luma] + int32_t((int64_t(cb_g[cb]) + cr_g[cr]) >> 16));
    rgb[2] = clip(y[luma] + cb_b[cb]);
  }
};

// Pillow's convert("RGB") of mode LAB: ImageCms's transform from LittleCMS
// 2's built-in Lab profile (D50) to its sRGB profile, perceptual intent.
// LittleCMS optimizes that transform into a 33 x 33 x 33 16-bit table
// sampled from its pipeline (cmsopt.c OptimizeByResampling), which this
// class computes as LittleCMS does, stage by stage in its float and double
// arithmetic (Lab to XYZ, the inverse of the Bradford-adapted sRGB matrix,
// the inverse sRGB curve, cmsxform.c's 16-bit saturation), and it reads the
// table with LittleCMS's tetrahedral interpolation (cmsintrp.c
// Eval3Inputs). Pillow hands LittleCMS the TIFF's a and b bytes offset by
// 128.
class LabToSrgb {
 public:
  static const LabToSrgb& get() {
    static const LabToSrgb instance;
    return instance;
  }

  void convert(uint8_t l, uint8_t a, uint8_t b, uint8_t* rgb) const {
    const int in[3] = {l * 257, (a ^ 128) * 257, (b ^ 128) * 257};
    int f[3], r[3];
    uint32_t base = 0;
    const uint32_t opta[3] = {3 * kN * kN, 3 * kN, 3};  // L slowest, b fastest
    uint32_t step[3];
    for (int i = 0; i < 3; ++i) {
      const int x = in[i] * (kN - 1);
      f[i] = x + (x + 0x7fff) / 0xffff;  // _cmsToFixedDomain
      r[i] = f[i] & 0xffff;
      base += opta[i] * uint32_t(f[i] >> 16);
      step[i] = in[i] == 0xffff ? 0 : opta[i];
    }
    uint32_t X1 = step[0], Y1 = step[1], Z1 = step[2];
    const int rx = r[0], ry = r[1], rz = r[2];
    const uint16_t* t = table_ + base;
    // the six tetrahedra, the vertex offsets and differences of Eval3Inputs
    int kind;
    if (rx >= ry) {
      if (ry >= rz) {
        Y1 += X1; Z1 += Y1; kind = 0;
      } else if (rz >= rx) {
        X1 += Z1; Y1 += X1; kind = 1;
      } else {
        Z1 += X1; Y1 += Z1; kind = 2;
      }
    } else {
      if (rx >= rz) {
        X1 += Y1; Z1 += X1; kind = 3;
      } else if (ry >= rz) {
        Z1 += Y1; X1 += Z1; kind = 4;
      } else {
        Y1 += Z1; X1 += Y1; kind = 5;
      }
    }
    for (int ch = 0; ch < 3; ++ch) {
      const int c0 = t[ch], t1 = t[X1 + ch], t2 = t[Y1 + ch], t3 = t[Z1 + ch];
      int c1, c2, c3;  // the differences along x, y and z
      switch (kind) {
        case 0: c1 = t1 - c0; c2 = t2 - t1; c3 = t3 - t2; break;
        case 1: c1 = t1 - t3; c2 = t2 - t1; c3 = t3 - c0; break;
        case 2: c1 = t1 - c0; c2 = t2 - t3; c3 = t3 - t1; break;
        case 3: c1 = t1 - t2; c2 = t2 - c0; c3 = t3 - t1; break;
        case 4: c1 = t1 - t3; c2 = t2 - c0; c3 = t3 - t2; break;
        default: c1 = t1 - t2; c2 = t2 - t3; c3 = t3 - c0; break;
      }
      const int64_t rest = int64_t(c1) * rx + int64_t(c2) * ry + int64_t(c3) * rz + 0x8001;
      const uint32_t v = uint16_t(uint16_t(c0) + ((rest + (rest >> 16)) >> 16));
      rgb[ch] = uint8_t(((v * 65281u + 8388608u) >> 24) & 0xffu);  // FROM_16_TO_8
    }
  }

 private:
  static constexpr int kN = 33;
  using Mat = double[3][3];

  static void inverse(const Mat a, Mat b) {  // _cmsMAT3inverse
    const double c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1];
    const double c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0];
    const double c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0];
    const double det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2;
    b[0][0] = c0 / det;
    b[0][1] = (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det;
    b[0][2] = (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det;
    b[1][0] = c1 / det;
    b[1][1] = (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det;
    b[1][2] = (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det;
    b[2][0] = c2 / det;
    b[2][1] = (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det;
    b[2][2] = (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det;
  }
  static void multiply(const Mat a, const Mat b, Mat r) {  // _cmsMAT3per
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        r[i][j] = a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j];
  }
  static void eval(const Mat a, const double v[3], double r[3]) {  // _cmsMAT3eval
    for (int i = 0; i < 3; ++i) r[i] = a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2];
  }
  // lcms's floor through the 16.16 magic number (_cmsQuickFloor)
  static int quick_floor(double v) {
    const double t = v + 68719476736.0 * 1.5;
    uint64_t bits;
    std::memcpy(&bits, &t, 8);
    return int32_t(uint32_t(bits)) >> 16;
  }
  static uint16_t saturate_word(double d) {  // _cmsQuickSaturateWord
    d += 0.5;
    if (d <= 0) return 0;
    if (d >= 65535.0) return 0xffff;
    return uint16_t(quick_floor(d - 32767.0) + 32767);
  }
  static double f_1(double t) {  // cmsLab2XYZ's inverse companding
    if (t <= 24.0 / 116.0) return (108.0 / 841.0) * (t - (16.0 / 116.0));
    return t * t * t;
  }

  LabToSrgb() {
    const double d50[3] = {0.9642, 1.0, 0.8249};
    const double max_xyz = 1.0 + 32767.0 / 32768.0;
    // cmsCreate_sRGBProfile: Rec. 709 primaries at D65, adapted to D50 by
    // Bradford (_cmsBuildRGB2XYZtransferMatrix, _cmsAdaptMatrixToD50)
    const double xn = 0.3127, yn = 0.3290;
    const double xr = 0.64, yr = 0.33, xg = 0.30, yg = 0.60, xb = 0.15, yb = 0.06;
    const Mat primaries = {{xr, xg, xb}, {yr, yg, yb}, {1 - xr - yr, 1 - xg - yg, 1 - xb - yb}};
    Mat prim_inv;
    inverse(primaries, prim_inv);
    const double white[3] = {xn / yn, 1.0, (1.0 - xn - yn) / yn};
    double coef[3];
    eval(prim_inv, white, coef);
    const Mat rgb2xyz_d65 = {{coef[0] * xr, coef[1] * xg, coef[2] * xb},
                             {coef[0] * yr, coef[1] * yg, coef[2] * yb},
                             {coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg),
                              coef[2] * (1.0 - xb - yb)}};
    const Mat bradford = {{0.8951, 0.2664, -0.1614}, {-0.7502, 1.7135, 0.0367},
                          {0.0389, -0.0685, 1.0296}};
    Mat bradford_inv;
    inverse(bradford, bradford_inv);
    const double src_white[3] = {(xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0};
    double cone_src[3], cone_dst[3];
    eval(bradford, src_white, cone_src);
    eval(bradford, d50, cone_dst);
    const Mat cone = {{cone_dst[0] / cone_src[0], 0.0, 0.0}, {0.0, cone_dst[1] / cone_src[1], 0.0},
                      {0.0, 0.0, cone_dst[2] / cone_src[2]}};
    Mat tmp, adapt, rgb2xyz, xyz2rgb;
    multiply(cone, bradford, tmp);
    multiply(bradford_inv, tmp, adapt);
    multiply(adapt, rgb2xyz_d65, rgb2xyz);
    inverse(rgb2xyz, xyz2rgb);
    for (auto& row : xyz2rgb)
      for (double& v : row) v *= max_xyz;
    // the inverse sRGB curve (parametric type -4)
    const double g = 2.4, pa = 1. / 1.055, pb = 0.055 / 1.055, pc = 1. / 12.92, pd = 0.04045;
    const double e = pa * pd + pb;
    const double disc = e < 0 ? 0 : std::pow(e, g);
    auto inv_srgb = [&](double r) {
      return r >= disc ? (std::pow(r, 1.0 / g) - pb) / pa : r / pc;
    };
    uint16_t* o = table_;
    for (int i = 0; i < kN; ++i)
      for (int j = 0; j < kN; ++j)
        for (int k = 0; k < kN; ++k) {
          float in[3];
          const int n[3] = {i, j, k};
          for (int c = 0; c < 3; ++c)  // _cmsQuantizeVal, then 16 bits to float
            in[c] = float(int(std::floor(n[c] * 65535.0 / (kN - 1) + 0.5))) / 65535.0F;
          const double lab_l = in[0] * 100.0, lab_a = in[1] * 255.0 - 128.0,
                       lab_b = in[2] * 255.0 - 128.0;
          const double y = (lab_l + 16.0) / 116.0, x = y + 0.002 * lab_a,
                       z = y - 0.005 * lab_b;
          const float xyz[3] = {float(f_1(x) * d50[0] / max_xyz), float(f_1(y) * d50[1] / max_xyz),
                                float(f_1(z) * d50[2] / max_xyz)};
          for (int r = 0; r < 3; ++r) {
            double acc = 0;
            for (int c = 0; c < 3; ++c) acc += double(xyz[c]) * xyz2rgb[r][c];
            const float linear = float(acc);
            const float encoded = float(inv_srgb(double(linear)));
            *o++ = saturate_word(double(encoded) * 65535.0);
          }
        }
  }

  uint16_t table_[kN * kN * kN * 3];
};

// PIL's TIFF loader ends with ImageOps.exif_transpose: the Orientation tag
// (1 to 8) turns the stored image; any other value leaves it.
void orient(const std::vector<uint8_t>& rgb, uint32_t w, uint32_t h, uint32_t orientation,
            RgbImage* out) {
  const bool swap = orientation >= 5 && orientation <= 8;
  const uint32_t ow = swap ? h : w, oh = swap ? w : h;
  out->w = int(ow);
  out->h = int(oh);
  if (orientation < 2 || orientation > 8) {
    out->rgb = rgb;
    return;
  }
  out->rgb.resize(rgb.size());
  for (uint32_t y = 0; y < oh; ++y)
    for (uint32_t x = 0; x < ow; ++x) {
      uint32_t sx, sy;  // the stored pixel that lands at (x, y)
      switch (orientation) {
        case 2: sx = w - 1 - x; sy = y; break;                 // mirrored
        case 3: sx = w - 1 - x; sy = h - 1 - y; break;         // turned 180
        case 4: sx = x; sy = h - 1 - y; break;                 // flipped
        case 5: sx = y; sy = x; break;                         // transposed
        case 6: sx = y; sy = h - 1 - x; break;                 // turned 90 clockwise
        case 7: sx = w - 1 - y; sy = h - 1 - x; break;         // transversed
        default: sx = w - 1 - y; sy = x; break;                // 8: turned 90 anticlockwise
      }
      std::memcpy(&out->rgb[(size_t(y) * ow + x) * 3], &rgb[(size_t(sy) * w + sx) * 3], 3);
    }
}

// Pillow reads a YCbCr TIFF that is not JPEG-compressed through libtiff's
// TIFFRGBAImage (tif_getimage.c), one strip at a time: every pixel of an
// h x v unit takes its own luma and the unit's Cb and Cr.
void decode_ycbcr(const Reader& r, const uint8_t* d, uint32_t width, uint32_t height,
                  uint32_t rows_per_strip, uint32_t sub_h, uint32_t sub_v,
                  const std::vector<uint64_t>& offsets, const std::vector<uint64_t>& counts,
                  uint32_t compression, const YCbCrToRgb& conv, std::vector<uint8_t>* rgb) {
  const size_t across = (size_t(width) + sub_h - 1) / sub_h;
  const size_t unit = size_t(sub_h) * sub_v + 2;
  const size_t unit_row = across * unit;
  rgb->assign(size_t(width) * height * 3, 0);
  std::vector<uint8_t> buf;
  for (size_t strip = 0; strip < offsets.size(); ++strip) {
    const uint32_t y0 = uint32_t(strip * rows_per_strip);
    const uint32_t rows = std::min(rows_per_strip, height - y0);
    const size_t need = (size_t(rows) + sub_v - 1) / sub_v * unit_row;
    r.check(offsets[strip], counts[strip]);
    buf.resize(need);
    const uint8_t* in = d + offsets[strip];
    if (compression == 5)
      lzw_decode(in, counts[strip], buf.data(), need);
    else if (compression == 32773)
      packbits_decode(in, counts[strip], buf.data(), need);
    else
      deflate_decode(in, counts[strip], buf.data(), need);
    for (uint32_t y = 0; y < rows; ++y) {
      const uint8_t* units = buf.data() + size_t(y / sub_v) * unit_row;
      for (uint32_t x = 0; x < width; ++x) {
        const uint8_t* u = units + size_t(x / sub_h) * unit;
        conv.convert(u[(y % sub_v) * sub_h + x % sub_h], u[unit - 2], u[unit - 1],
                     rgb->data() + (size_t(y0 + y) * width + x) * 3);
      }
    }
  }
}

}  // namespace

void pil_lab_to_rgb(uint8_t l, uint8_t a, uint8_t b, uint8_t* rgb) {
  LabToSrgb::get().convert(l, a ^ 128, b ^ 128, rgb);
}

bool is_tiff(const uint8_t* d, size_t n) {
  if (n < 4) return false;
  return (d[0] == 'I' && d[1] == 'I' && (d[2] == 42 || d[2] == 43) && d[3] == 0) ||
         (d[0] == 'M' && d[1] == 'M' && d[2] == 0 && (d[3] == 42 || d[3] == 43));
}

void decode_tiff(const uint8_t* d, size_t n, RgbImage* out) {
  if (!is_tiff(d, n)) fail("not a TIFF file");
  const bool big = d[0] == 'M';
  const bool bigtiff = d[big ? 3 : 2] == 43;
  const Reader r(d, n, big);
  if (n < 8) fail("truncated header");
  uint64_t first_ifd;
  if (bigtiff && big) refuse("big-endian BigTIFF (PIL reads its header as a classic TIFF's)");
  if (bigtiff) {  // the offset size (8) and a zero word, then an 8-byte offset
    if (r.u16(4) != 8 || r.u16(6) != 0) fail("bad BigTIFF header");
    first_ifd = r.u64(8);
  } else {
    first_ifd = r.u32(4);
  }
  auto tags = read_ifd(r, first_ifd, bigtiff);
  // a tag the decoder reads: absent, or of an integer type libtiff accepts
  auto has = [&](int tag) {
    auto it = tags.find(tag);
    if (it == tags.end()) return false;
    if (it->second.values.empty())
      fail("tag " + std::to_string(tag) + " has an unsupported type or no value");
    return true;
  };
  auto list = [&](int tag) -> const std::vector<uint64_t>& {
    has(tag);
    return tags[tag].values;
  };
  auto one = [&](int tag, uint64_t dflt) -> uint64_t {
    if (!has(tag)) return dflt;
    if (tags[tag].values.size() != 1) fail("tag " + std::to_string(tag) + " has several values");
    return tags[tag].values[0];
  };
  // RATIONAL values as libtiff reads them into floats
  auto rationals = [&](int tag, std::vector<float> dflt) {
    auto it = tags.find(tag);
    if (it == tags.end()) return dflt;
    const Tag& t = it->second;
    if (t.type != 5 || t.count != dflt.size())
      fail("tag " + std::to_string(tag) + " has an unsupported type or count");
    for (size_t k = 0; k < dflt.size(); ++k) {
      const uint32_t num = r.u32(t.at + 8 * k), den = r.u32(t.at + 8 * k + 4);
      dflt[k] = den == 0 ? 0.0F : float(num) / float(den);
    }
    return dflt;
  };

  const uint64_t width = one(kWidth, 0), height = one(kLength, 0);
  if (!width || !height) fail("missing or zero image size");
  if (width > 0xffffffffu || height > 0xffffffffu) fail("image size past 32 bits");
  check_image_pixels(kFmt, width, height);
  const uint64_t compression = one(kCompression, 1);
  switch (compression) {
    case 1: case 5: case 7: case 8: case 32946: case 32773: break;
    case 2: case 3: case 4: refuse("CCITT fax compression");
    case 6: refuse("old-style JPEG compression");
    default: refuse("compression " + std::to_string(compression));
  }
  const bool jpeg = compression == 7;
  const uint64_t photometric = one(kPhotometric, 0);
  if (photometric > 8 || photometric == 4 || photometric == 7)
    refuse("photometric " + std::to_string(photometric));
  const uint64_t fill_order = one(kFillOrder, 1);
  if (fill_order == 2) refuse("fill order 2");
  if (fill_order != 1) fail("bad fill order");
  // bits and samples as PIL reconciles them
  std::vector<uint64_t> bps = has(kBits) ? list(kBits) : std::vector<uint64_t>{1};
  if (!has(kSamples) && bps.size() > 1)  // PIL and libtiff would count samples apart
    fail("missing samples per pixel");
  const uint64_t spp = one(kSamples, 1);
  if (spp == 0 || spp > 6) fail("unsupported samples per pixel " + std::to_string(spp));
  if (spp < bps.size()) bps.resize(spp);
  if (spp > bps.size() && bps.size() == 1) bps.assign(spp, bps[0]);
  if (bps.size() != spp) fail("unknown data organization");
  for (uint64_t b : bps)
    if (b != bps[0]) fail("samples of different sizes");
  if (bps[0] > 32) refuse(std::to_string(bps[0]) + "-bit samples");
  const int bits = int(bps[0]);
  std::vector<uint64_t> formats = has(kSampleFormat) ? list(kSampleFormat)
                                                     : std::vector<uint64_t>{1};
  uint64_t format = formats[0];
  for (uint64_t f : formats)
    if (f != format) format = 0;
  const std::vector<uint64_t> extras = has(kExtraSamples) ? list(kExtraSamples)
                                                          : std::vector<uint64_t>{};
  const uint64_t planar_config = one(kPlanar, 1);
  if (planar_config != 1 && planar_config != 2) fail("bad planar configuration");
  const bool planar = planar_config == 2;
  if (jpeg && bits != 8) refuse(std::to_string(bits) + "-bit JPEG-in-TIFF");

  // the layout, for the keys of PIL's OPEN_INFO this decoder reads
  Layout layout;
  if (format == 3 && !(bits == 32 && spp == 1 && extras.empty() && photometric <= 1))
    refuse("floating-point samples in this layout");
  if (format != 1 && format != 3 &&
      !(format == 2 && spp == 1 && photometric == 1 && (bits == 8 || bits == 16 || bits == 32)))
    refuse("this sample format");
  if (bits == 32) {
    // modes I and F: "I;32N" (unsigned, little-endian only), "I;32S",
    // "F;32F", both byte orders; min-is-white floats read as they are
    const bool ok = spp == 1 && extras.empty() &&
                    (format == 3 || (photometric == 1 && (format == 2 || !big)));
    if (!ok) refuse("32-bit samples in this layout");
    layout = format == 3 ? GREY_F32 : GREY_I32;
  } else if (photometric <= 1) {
    const bool ok_bits = bits == 1 || bits == 2 || bits == 4 || bits == 8 ||
                         (bits == 16 && !(big && photometric == 0));
    if (!ok_bits) refuse(std::to_string(bits) + "-bit grey samples");
    if (spp == 2 && !(bits == 8 && photometric == 1 && extras == std::vector<uint64_t>{2}))
      refuse("this grey layout");
    if (spp > 2 || (spp == 1 && !extras.empty())) refuse("this grey layout");
    if (format == 2 && spp != 1) refuse("this grey layout");
    layout = format == 2 && bits == 16 ? GREY_SIGNED : GREY;
  } else if (photometric == 2 || (photometric == 6 && jpeg)) {
    if (bits != 8 && bits != 16) refuse(std::to_string(bits) + "-bit RGB samples");
    const size_t extra = spp - 3;
    if (spp < 3 || (bits == 16 && spp > 4)) refuse("this RGB layout");
    layout = RGB_PLAIN;
    if (photometric == 6 && (spp != 3 || !extras.empty())) refuse("this YCbCr layout");
    if (extra > 0) {
      if (extras.empty()) {
        if (extra != 1) refuse("this RGB layout");  // RGBA without ExtraSamples
      } else {
        if (extras.size() != extra) refuse("this RGB layout");
        for (size_t i = 1; i < extras.size(); ++i)
          if (extras[i] != 0) refuse("this RGB layout");
        const uint64_t e = extras[0];
        if (!(e == 0 || e == 1 || e == 2 || (e == 999 && extra == 1 && bits == 8)))
          refuse("these RGB extra samples");
        if (e == 1) layout = RGB_ASSOCIATED;
      }
    } else if (!extras.empty()) {
      refuse("this RGB layout");
    }
  } else if (photometric == 5) {  // CMYK, "CMYKX", "CMYKXX", "CMYK;16"
    const bool ok = spp >= 4 && extras.size() == spp - 4 &&
                    std::all_of(extras.begin(), extras.end(), [](uint64_t e) { return e == 0; }) &&
                    (bits == 8 || (bits == 16 && spp == 4));
    if (!ok) refuse("this CMYK layout");
    layout = CMYK;
  } else if (photometric == 8) {  // PIL's mode LAB
    if (bits != 8) refuse(std::to_string(bits) + "-bit CIELab samples");
    if (spp != 3 || !extras.empty()) refuse("this CIELab layout");
    if (planar) refuse("planar CIELab samples");
    layout = CIELAB;
  } else if (photometric == 6) {
    if (compression == 1) refuse("uncompressed YCbCr (PIL's raw decoder misreads it)");
    layout = RGB_PLAIN;  // decoded apart, below
  } else {  // palette
    if (!(bits == 1 || bits == 2 || bits == 4 || bits == 8)) refuse("this palette depth");
    if (spp == 2 && !(bits == 8 && extras.size() == 1 && (extras[0] == 0 || extras[0] == 2)))
      refuse("this palette layout");
    if (spp > 2 || (spp == 1 && !extras.empty())) refuse("this palette layout");
    layout = PALETTE;
    if (!has(kColorMap)) fail("palette image without a colour map");
    if (list(kColorMap).size() != size_t(3) << bits) fail("colour map of the wrong size");
  }
  if (planar) {
    // PIL reads an uncompressed plane with one character of the rawmode, and
    // planes with alpha through libtiff's RGBA reader: only these layouts
    // come out as they are stored
    bool ok;
    if (compression == 1)
      ok = bits == 8 ? (spp == 3 && photometric == 2) || (spp == 4 && photometric == 5) ||
                           (spp == 4 && photometric == 2 && extras.size() == 1 && extras[0] == 2) ||
                           (spp == 1 && photometric != 0)
                     : bits == 1 && spp == 1 && photometric == 1;
    else
      ok = photometric != 6 && (spp == 1 || spp == 3 || (spp == 4 && photometric == 5));
    if (!ok) refuse("planar samples in this layout");
  }
  if ((layout == GREY_SIGNED || bits == 32) && big && compression != 1)
    refuse("compressed big-endian " + std::to_string(bits) + "-bit samples");  // PIL swaps them
  const uint64_t predictor = one(kPredictor, 1);
  const bool predicted = compression == 5 || compression == 8 || compression == 32946;
  if (predicted && predictor != 1) {
    if (predictor != 2) refuse("predictor " + std::to_string(predictor));
    if (photometric == 6) refuse("the predictor with YCbCr samples");
    if (bits != 8 && bits != 16 && bits != 32)
      fail("the predictor with " + std::to_string(bits) + "-bit samples");
  }

  // the blocks: strips or tiles, per plane when planar
  const bool tiled = has(kTileOffsets);
  const uint32_t planes = planar ? uint32_t(spp) : 1;
  const uint32_t plane_samples = planar ? 1 : uint32_t(spp);
  uint32_t bw, bh;  // a block's width and height in pixels
  std::vector<uint64_t> offsets, counts;
  if (tiled) {
    const uint64_t tw = one(kTileWidth, 0), tl = one(kTileLength, 0);
    if (!tw || !tl || tw > 0xffffffffu || tl > 0xffffffffu) fail("bad tile size");
    bw = uint32_t(tw);
    bh = uint32_t(tl);
    offsets = list(kTileOffsets);
    if (has(kTileByteCounts)) counts = list(kTileByteCounts);
  } else {
    if (!has(kStripOffsets)) fail("no strips or tiles");
    bw = uint32_t(width);
    bh = uint32_t(std::min(one(kRowsPerStrip, 0xffffffffu), height));
    if (!bh) fail("bad rows per strip");
    offsets = list(kStripOffsets);
    if (has(kStripByteCounts)) counts = list(kStripByteCounts);
  }
  const uint64_t across = (width + bw - 1) / bw, down = (height + bh - 1) / bh;
  if (uint64_t(bw) * bh > (uint64_t(1) << 31)) fail("block too large");
  // Pillow's libtiff decoder sizes its buffer for the tag's rows per strip
  // (all rows when the tag is absent) and refuses one past INT_MAX bytes
  const uint64_t rows_tag = tiled ? bh : one(kRowsPerStrip, 0xffffffffu);
  if (offsets.size() != across * down * planes) fail("wrong number of strip or tile offsets");
  if (compression != 1 && counts.size() != offsets.size()) fail("missing or wrong byte counts");
  const size_t row_bytes = (size_t(bw) * plane_samples * bits + 7) / 8;
  if (compression != 1 && rows_tag != 0xffffffffu && rows_tag * row_bytes > 0x7fffffffu)
    fail("strip or tile past Pillow's buffer limit");
  // every block's bytes lie in the file before anything is allocated
  for (size_t block = 0; block < offsets.size(); ++block) {
    const uint64_t y0 = (block % (across * down)) / across * bh;
    const size_t rows = std::min<uint64_t>(bh, height - y0);
    if (compression == 1) {
      r.check(offsets[block], rows * row_bytes);  // PIL's raw decoder reads no counts
    } else {
      if (counts[block] == 0) fail("empty strip or tile");
      r.check(offsets[block], counts[block]);
    }
  }
  const uint32_t orientation = uint32_t(std::min<uint64_t>(one(kOrientation, 1), 0xffffffffu));

  // YCbCr: the subsampling (libtiff's default 2 x 2), its coefficients and
  // reference black and white (libtiff's defaults)
  uint32_t sub_h = 1, sub_v = 1;
  if (photometric == 6) {
    if (has(kYCbCrSubsampling)) {
      const std::vector<uint64_t>& sub = list(kYCbCrSubsampling);
      if (sub.size() != 2) fail("bad YCbCr subsampling");
      sub_h = uint32_t(std::min<uint64_t>(sub[0], 99));
      sub_v = uint32_t(std::min<uint64_t>(sub[1], 99));
    } else if (!jpeg) {
      sub_h = sub_v = 2;
    } else {
      sub_h = sub_v = 0;  // libtiff takes the JPEG stream's own
    }
  }
  if (photometric == 6 && !jpeg) {
    if (bits != 8 || spp != 3 || !extras.empty()) refuse("this YCbCr layout");
    if (planar) refuse("planar YCbCr samples");
    if (tiled) refuse("tiled YCbCr samples");
    const uint32_t code = (sub_h << 4) | sub_v;
    if (code != 0x11 && code != 0x12 && code != 0x21 && code != 0x22 && code != 0x41 &&
        code != 0x42 && code != 0x44)
      refuse("YCbCr subsampling " + std::to_string(sub_h) + " x " + std::to_string(sub_v));
    if (bh % sub_v && bh < height) refuse("YCbCr strips that split a subsampling unit");
    const std::vector<float> luma = rationals(kYCbCrCoefficients, {0.299F, 0.587F, 0.114F});
    const std::vector<float> ref = rationals(kReferenceBlackWhite,
                                             {0.0F, 255.0F, 128.0F, 255.0F, 128.0F, 255.0F});
    if (luma[1] == 0.0F) fail("bad YCbCr coefficients");
    for (float f : ref)
      if (!(f > float(-0x7FFFFFFF) + 128.0F && f < float(0x7FFFFFFF) - 128.0F))
        fail("bad reference black and white");
    const YCbCrToRgb conv(luma.data(), ref.data());
    std::vector<uint8_t> rgb;
    decode_ycbcr(r, d, uint32_t(width), uint32_t(height), bh, sub_h, sub_v, offsets, counts,
                 uint32_t(compression), conv, &rgb);
    orient(rgb, uint32_t(width), uint32_t(height), orientation, out);
    return;
  }
  const uint8_t* tables = nullptr;
  size_t tables_size = 0;
  if (jpeg && tags.count(kJpegTables)) {
    const Tag& t = tags[kJpegTables];
    if (t.type != 7 && t.type != 1) fail("JPEGTables of an unsupported type");
    tables = d + t.at;
    tables_size = size_t(t.count);
  }

  // samples[y][x][s] as 32-bit values
  std::vector<uint32_t> samples(size_t(width) * height * spp);
  std::vector<uint8_t> buf;
  size_t block = 0;
  for (uint32_t p = 0; p < planes; ++p)
    for (uint64_t by = 0; by < down; ++by)
      for (uint64_t bx = 0; bx < across; ++bx, ++block) {
        const uint32_t x0 = uint32_t(bx * bw), y0 = uint32_t(by * bh);
        // a strip holds the rows left; a tile is whole
        const size_t rows = tiled ? bh : std::min<size_t>(bh, height - y0);
        const size_t need = rows * row_bytes;
        const uint8_t* src;
        const uint8_t* in = d + offsets[block];
        if (compression == 1) {
          src = in;
        } else if (jpeg) {
          // tif_jpeg.c: the segment's size, components and (contiguous)
          // sampling factors must be the ones the tags imply
          JpegSegment seg;
          decode_jpeg_segment(tables, tables_size, in, counts[block], photometric == 6 && !planar,
                              &seg);
          if (uint64_t(seg.w) != bw || uint64_t(seg.h) != rows)
            fail("a JPEG strip or tile of " + std::to_string(seg.w) + " x " +
                 std::to_string(seg.h) + " where libtiff expects " + std::to_string(bw) + " x " +
                 std::to_string(rows));
          if (seg.sampling.size() != plane_samples) fail("a JPEG strip or tile's component count");
          if (!planar) {
            const uint32_t eh = photometric == 6 ? (sub_h ? sub_h : seg.sampling[0].first) : 1;
            const uint32_t ev = photometric == 6 ? (sub_v ? sub_v : seg.sampling[0].second) : 1;
            bool ok = uint32_t(seg.sampling[0].first) == eh &&
                      uint32_t(seg.sampling[0].second) == ev;
            for (size_t c = 1; c < seg.sampling.size(); ++c)
              ok = ok && seg.sampling[c] == std::make_pair(1, 1);
            if (!ok) fail("a JPEG strip or tile's sampling factors differ from the tags");
          }
          buf = std::move(seg.samples);
          src = buf.data();
        } else {
          buf.resize(need);
          if (compression == 5)
            lzw_decode(in, counts[block], buf.data(), need);
          else if (compression == 32773)
            packbits_decode(in, counts[block], buf.data(), need);
          else
            deflate_decode(in, counts[block], buf.data(), need);
          if (predicted && predictor == 2)
            undo_predictor(buf.data(), rows, row_bytes, bits, int(plane_samples), big);
          src = buf.data();
        }
        const uint32_t xs = uint32_t(std::min<uint64_t>(bw, width - x0));
        const uint32_t ys = uint32_t(std::min<uint64_t>(rows, height - y0));
        for (uint32_t y = 0; y < ys; ++y) {
          const uint8_t* row = src + size_t(y) * row_bytes;
          uint32_t* dst = samples.data() + (size_t(y0 + y) * width + x0) * spp + p;
          for (uint32_t x = 0; x < xs; ++x)
            for (uint32_t s = 0; s < plane_samples; ++s) {
              const size_t k = size_t(x) * plane_samples + s;
              uint32_t v;
              if (bits == 32)
                v = big ? (uint32_t(row[4 * k]) << 24) | (row[4 * k + 1] << 16) |
                              (row[4 * k + 2] << 8) | row[4 * k + 3]
                        : row[4 * k] | (row[4 * k + 1] << 8) | (row[4 * k + 2] << 16) |
                              (uint32_t(row[4 * k + 3]) << 24);
              else if (bits == 16)
                v = big ? uint32_t((row[2 * k] << 8) | row[2 * k + 1])
                        : uint32_t(row[2 * k] | (row[2 * k + 1] << 8));
              else if (bits == 8)
                v = row[k];
              else
                v = uint32_t((row[(k * bits) >> 3] >> (8 - bits - ((k * bits) & 7))) &
                             ((1 << bits) - 1));
              dst[size_t(x) * spp + s] = v;
            }
        }
      }

  std::vector<uint8_t> rgb(size_t(width) * height * 3);
  uint8_t* o = rgb.data();
  const int maxv = bits < 32 ? (1 << bits) - 1 : 0;
  uint8_t pal[256 * 3] = {0};
  if (layout == PALETTE) {
    const std::vector<uint64_t>& cm = list(kColorMap);
    const size_t entries = size_t(1) << bits;
    for (size_t i = 0; i < entries; ++i)
      for (int c = 0; c < 3; ++c) pal[3 * i + c] = uint8_t((cm[c * entries + i] & 0xffff) >> 8);
  }
  for (size_t i = 0; i < size_t(width) * height; ++i, o += 3) {
    const uint32_t* s = samples.data() + i * spp;
    switch (layout) {
      case GREY: {
        int v;
        if (bits == 16) {
          v = std::min<int>(int(s[0]), 255);
        } else {
          v = photometric == 0 ? maxv - int(s[0]) : int(s[0]);
          v = v * (255 / maxv);
        }
        o[0] = o[1] = o[2] = uint8_t(v);
        break;
      }
      case GREY_SIGNED: {
        const int v = int16_t(s[0]);
        o[0] = o[1] = o[2] = uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
        break;
      }
      case GREY_I32: {  // mode I to L: clipped
        const int32_t v = int32_t(s[0]);
        o[0] = o[1] = o[2] = uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
        break;
      }
      case GREY_F32: {  // mode F to L: clipped, truncated, NaN to 0
        float f;
        std::memcpy(&f, s, 4);
        const uint8_t v = !(f > 0.0F) ? 0 : f >= 255.0F ? 255 : uint8_t(f);
        o[0] = o[1] = o[2] = v;
        break;
      }
      case RGB_PLAIN:
        for (int c = 0; c < 3; ++c) o[c] = uint8_t(bits == 16 ? s[c] >> 8 : s[c]);
        break;
      case RGB_ASSOCIATED: {
        const int a = int(bits == 16 ? s[3] >> 8 : s[3]);
        for (int c = 0; c < 3; ++c) {
          const int v = int(bits == 16 ? s[c] >> 8 : s[c]);
          o[c] = a == 0 ? 0 : a == 255 ? uint8_t(v) : uint8_t(std::min(v * 255 / a, 255));
        }
        break;
      }
      case CIELAB:
        LabToSrgb::get().convert(uint8_t(s[0]), uint8_t(s[1]), uint8_t(s[2]), o);
        break;
      case CMYK: {
        const int shift = bits == 16 ? 8 : 0;
        pil_cmyk_to_rgb(uint8_t(s[0] >> shift), uint8_t(s[1] >> shift), uint8_t(s[2] >> shift),
                        uint8_t(s[3] >> shift), o);
        break;
      }
      default:
        std::memcpy(o, pal + 3 * s[0], 3);
    }
  }
  orient(rgb, uint32_t(width), uint32_t(height), orientation, out);
}

}  // namespace ssr
