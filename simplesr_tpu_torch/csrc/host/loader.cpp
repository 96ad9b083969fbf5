// Host image loader of the port: PNG and JPEG decoders of its own, a
// byte-bounded LRU cache of decoded images and a thread pool that fills crop
// batches, behind a plain C interface loaded with ctypes
// (simplesr_tpu_torch/data/native_loader.py), which builds it into one
// library with the JPEG encoder (jpeg_encode.cpp) and the WebP, GIF and TIFF
// decoders (webp.cpp, gif.cpp, tiff.cpp; formats.h). No CUDA and no PyTorch
// header is compiled; the only library linked is zlib.
//
// The decoders compute what the JAX package's decoders compute:
//   - PNG as libpng with the JAX loader's transforms (simplesr_tpu/data/
//     _native/loader.cpp): every colour type and depth, Adam7, to 8-bit RGB,
//     alpha and tRNS dropped, 16 bits to the high byte. The one place where
//     PIL's convert("RGB") differs, 16-bit grey, is a mode: the loader's high
//     byte (GREY16_HIGH_BYTE) or PIL's clip to 255 (GREY16_CLIP).
//   - JPEG as libjpeg-turbo 3.1 with PIL's settings: 8-bit baseline,
//     extended and progressive files, Huffman- or arithmetic-coded
//     (jdarith.c), the ISLOW integer IDCT (jidctint.c) as its x86 SIMD code
//     computes it, block smoothing of a progressive file whose scans leave
//     low coefficients unrefined (jdcoefct.c), fancy upsampling
//     (jdsample.c), the fixed-point YCbCr->RGB tables (jdcolor.c); CMYK and
//     YCCK as PIL converts them. Lossless Huffman-coded files (jdlhuff.c,
//     jddiffct.c, jdlossls.c): the seven predictors, the point transform, box
//     upsampling and no colour conversion (libjpeg refuses a lossless file
//     it would have to convert). Refused as PIL and libjpeg refuse them:
//     12-bit, hierarchical and lossless arithmetic-coded files.
//
// Request bodies come from outside the program, so every read is bounded and
// a corrupt file is an error, as the JAX loader's strict mode makes it: where
// libjpeg would warn and fill with grey (a bad Huffman code, data that ends
// inside a scan, restart markers out of order) this decoder refuses. A file
// libjpeg reads with only a warning about extraneous bytes before a marker
// decodes as libjpeg decodes it.

#include <zlib.h>

#include "formats.h"

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <list>
#include <memory>
#include <mutex>
#include <queue>
#include <stdexcept>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr int GREY16_HIGH_BYTE = 0;
constexpr int GREY16_CLIP = 1;

struct DecodeError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw DecodeError(msg); }

using Image = ssr::RgbImage;

using ssr::check_image_pixels;  // PIL's decompression-bomb refusal (formats.h)

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

// ====================================================================== PNG

const uint8_t kPngSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

int png_channels(int colour) {
  switch (colour) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
  }
  return 0;
}

bool png_depth_ok(int colour, int depth) {
  switch (colour) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
  }
  return false;
}

// Undo the five row filters of one (sub)image in place: rows of 1 + stride
// bytes, bpp the filter's byte distance.
void png_unfilter(uint8_t* raw, size_t rows, size_t stride, int bpp, uint8_t* out) {
  std::vector<uint8_t> zero(stride, 0);
  const uint8_t* prev = zero.data();
  for (size_t y = 0; y < rows; ++y) {
    const uint8_t* line = raw + y * (stride + 1);
    uint8_t* cur = out + y * stride;
    int kind = line[0];
    ++line;
    switch (kind) {
      case 0:
        std::memcpy(cur, line, stride);
        break;
      case 1:
        for (size_t i = 0; i < stride; ++i)
          cur[i] = uint8_t(line[i] + (i >= size_t(bpp) ? cur[i - bpp] : 0));
        break;
      case 2:
        for (size_t i = 0; i < stride; ++i) cur[i] = uint8_t(line[i] + prev[i]);
        break;
      case 3:
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
          cur[i] = uint8_t(line[i] + ((a + prev[i]) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
          int b = prev[i];
          int c = i >= size_t(bpp) ? prev[i - bpp] : 0;
          int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = uint8_t(line[i] + pred);
        }
        break;
      default:
        fail("PNG: bad filter type " + std::to_string(kind) + " in row " + std::to_string(y));
    }
    prev = cur;
  }
}

// Sample x of an unfiltered row at `depth` bits.
inline unsigned png_sample(const uint8_t* row, size_t x, int depth) {
  switch (depth) {
    case 8: return row[x];
    case 16: return (unsigned(row[2 * x]) << 8) | row[2 * x + 1];
    default: {
      size_t bit = x * depth;
      unsigned byte = row[bit >> 3];
      int shift = 8 - depth - int(bit & 7);
      return (byte >> shift) & ((1u << depth) - 1);
    }
  }
}

// the passes: (x0, y0, dx, dy) of Adam7, or the whole image
const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                          {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
const int kWhole[1][4] = {{0, 0, 1, 1}};

void png_pass_size(const int pass[4], uint32_t width, uint32_t height, size_t bits_pp,
                   size_t* pw, size_t* ph, size_t* stride) {
  *pw = width > uint32_t(pass[0]) ? (width - pass[0] + pass[2] - 1) / pass[2] : 0;
  *ph = height > uint32_t(pass[1]) ? (height - pass[1] + pass[3] - 1) / pass[3] : 0;
  *stride = (*pw * bits_pp + 7) / 8;
}

// The filtered image data's size: one filter byte per row of each pass.
size_t png_image_bytes(uint32_t width, uint32_t height, int colour, int depth, int interlace) {
  size_t bits_pp = size_t(png_channels(colour)) * depth, total = 0;
  for (int p = 0; p < (interlace ? 7 : 1); ++p) {
    size_t pw, ph, stride;
    png_pass_size(interlace ? kAdam7[p] : kWhole[0], width, height, bits_pp, &pw, &ph, &stride);
    if (pw && ph) total += ph * (stride + 1);
  }
  return total;
}

void decode_png(const uint8_t* data, size_t n, int grey16, Image* out) {
  if (n < 8 || std::memcmp(data, kPngSignature, 8) != 0) fail("PNG: not a PNG file");
  size_t pos = 8;
  bool have_header = false;
  uint32_t width = 0, height = 0;
  int depth = 0, colour = 0, interlace = 0;
  uint8_t palette[256][3];
  std::memset(palette, 0, sizeof palette);
  bool have_palette = false;
  // Chunks up to the end of the image data's zlib stream: the JAX loader
  // (libpng) reads no chunk after it. The image data is inflated as its
  // IDAT chunks come, no further than the header's size.
  std::vector<uint8_t> raw;
  size_t expected = 0;
  z_stream zs;
  std::memset(&zs, 0, sizeof zs);
  bool in_idat = false, stream_end = false;
  struct ZGuard {
    z_stream* zs;
    bool live = false;
    ~ZGuard() { if (live) inflateEnd(zs); }
  } zguard{&zs};
  for (;;) {
    if (in_idat && (pos + 8 > n || std::memcmp(data + pos + 4, "IDAT", 4) != 0))
      fail("PNG: not enough image data");
    if (pos + 8 > n) fail("PNG: truncated file (a chunk header is cut)");
    uint32_t length = be32(data + pos);
    const uint8_t* type = data + pos + 4;
    if (length > 0x7fffffffu) fail("PNG: invalid chunk length");
    for (int i = 0; i < 4; ++i)
      if (!((type[i] >= 'A' && type[i] <= 'Z') || (type[i] >= 'a' && type[i] <= 'z')))
        fail("PNG: invalid chunk type");
    std::string name(reinterpret_cast<const char*>(type), 4);
    if (pos + 12 + size_t(length) > n) fail("PNG: truncated file (chunk " + name + " is cut)");
    const uint8_t* body = data + pos + 8;
    bool critical = !(type[0] & 0x20);
    if (critical) {
      uLong crc = crc32(0L, type, 4 + length);
      if (uint32_t(crc) != be32(body + length)) fail("PNG: CRC error in chunk " + name);
    }
    pos += 12 + size_t(length);
    if (!have_header) {
      if (name != "IHDR") fail("PNG: missing IHDR");
      if (length != 13) fail("PNG: invalid IHDR length");
      width = be32(body);
      height = be32(body + 4);
      depth = body[8];
      colour = body[9];
      interlace = body[12];
      if (width == 0 || height == 0 || width > 0x7fffffffu || height > 0x7fffffffu)
        fail("PNG: invalid image size in IHDR");
      if (!png_depth_ok(colour, depth))
        fail("PNG: invalid colour type " + std::to_string(colour) + " with bit depth " +
             std::to_string(depth));
      if (body[10] != 0 || body[11] != 0 || interlace > 1)
        fail("PNG: invalid compression, filter or interlace method in IHDR");
      check_image_pixels("PNG", width, height);
      have_header = true;
      continue;
    }
    if (name == "IHDR") fail("PNG: duplicate IHDR");
    if (name == "IEND") fail("PNG: no image data before IEND");
    if (name == "PLTE") {
      if (colour == 3) {
        if (length == 0 || length % 3 || length > 768) fail("PNG: invalid palette length");
        std::memset(palette, 0, sizeof palette);
        for (uint32_t i = 0; i < length / 3; ++i)
          for (int c = 0; c < 3; ++c) palette[i][c] = body[3 * i + c];
        have_palette = true;
      }
      continue;
    }
    if (name == "IDAT") {
      if (!in_idat) {
        if (colour == 3 && !have_palette) fail("PNG: missing PLTE before IDAT");
        expected = png_image_bytes(width, height, colour, depth, interlace);
        raw.resize(expected + 1);  // one byte past the header's size tells too long
        if (inflateInit(&zs) != Z_OK) fail("PNG: zlib initialisation failed");
        zguard.live = true;
        zs.next_out = raw.data();
        zs.avail_out = uInt(raw.size());
        in_idat = true;
      }
      zs.next_in = const_cast<uint8_t*>(body);
      zs.avail_in = length;
      while (zs.avail_in > 0 && zs.avail_out > 0) {
        int rc = inflate(&zs, Z_NO_FLUSH);
        if (rc == Z_STREAM_END) {
          stream_end = true;
          break;
        }
        if (rc != Z_OK)
          fail(std::string("PNG: corrupt image data (") + (zs.msg ? zs.msg : "zlib error") + ")");
      }
      if (zs.avail_out == 0)
        fail("PNG: image data inflates past its " + std::to_string(width) + " x " +
             std::to_string(height) + " header");
      if (stream_end) break;
      continue;
    }
    if (critical) fail("PNG: unknown critical chunk " + name);
  }
  if (raw.size() - zs.avail_out != expected) fail("PNG: not enough image data");

  const int(*passes)[4] = interlace ? kAdam7 : kWhole;
  int n_passes = interlace ? 7 : 1;
  int channels = png_channels(colour);
  size_t bits_pp = size_t(channels) * depth;
  int bpp = int(std::max<size_t>(1, bits_pp / 8));
  struct Pass { size_t w, h, stride, offset; };
  std::vector<Pass> geometry;
  size_t offset = 0;
  for (int p = 0; p < n_passes; ++p) {
    size_t pw, ph, stride;
    png_pass_size(passes[p], width, height, bits_pp, &pw, &ph, &stride);
    geometry.push_back({pw, ph, stride, offset});
    if (pw && ph) offset += ph * (stride + 1);
  }

  out->h = int(height);
  out->w = int(width);
  out->rgb.assign(size_t(height) * width * 3, 0);
  std::vector<uint8_t> rows;
  for (int p = 0; p < n_passes; ++p) {
    const Pass& g = geometry[p];
    if (!g.w || !g.h) continue;
    rows.resize(g.h * g.stride);
    png_unfilter(raw.data() + g.offset, g.h, g.stride, bpp, rows.data());
    int x0 = passes[p][0], y0 = passes[p][1], dx = passes[p][2], dy = passes[p][3];
    int scale = depth < 8 ? 255 / ((1 << depth) - 1) : 1;
    for (size_t py = 0; py < g.h; ++py) {
      const uint8_t* row = rows.data() + py * g.stride;
      uint8_t* dst_row = out->rgb.data() + (size_t(y0) + py * dy) * width * 3;
      for (size_t px = 0; px < g.w; ++px) {
        uint8_t* dst = dst_row + (size_t(x0) + px * dx) * 3;
        switch (colour) {
          case 0: case 4: {
            unsigned v = png_sample(row, px * channels, depth);
            uint8_t g8;
            if (depth == 16)
              g8 = (colour == 0 && grey16 == GREY16_CLIP) ? uint8_t(std::min(v, 255u))
                                                           : uint8_t(v >> 8);
            else
              g8 = uint8_t(v * scale);
            dst[0] = dst[1] = dst[2] = g8;
            break;
          }
          case 3: {
            unsigned i = png_sample(row, px, depth);
            dst[0] = palette[i][0];
            dst[1] = palette[i][1];
            dst[2] = palette[i][2];
            break;
          }
          default:  // 2, 6
            for (int c = 0; c < 3; ++c) {
              unsigned v = png_sample(row, px * channels + c, depth);
              dst[c] = uint8_t(depth == 16 ? v >> 8 : v);
            }
        }
      }
    }
  }
}

// ===================================================================== JPEG

// Zigzag to natural order, with libjpeg's 16 extra entries for a corrupt
// run length that points past the block.
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The standard tables (JPEG Annex K.3) as one DHT segment body: libjpeg
// installs them in the slots a file leaves empty (Motion-JPEG frames).
const uint8_t kStdHuffman[] = {
    0x00, 0x00, 0x01, 0x05, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b,
    0x10, 0x00, 0x02, 0x01, 0x03, 0x03, 0x02, 0x04, 0x03, 0x05, 0x05, 0x04, 0x04, 0x00, 0x00,
    0x01, 0x7d, 0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13,
    0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19,
    0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43,
    0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a,
    0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6,
    0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa,
    0x01, 0x00, 0x03, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b,
    0x11, 0x00, 0x02, 0x01, 0x02, 0x04, 0x04, 0x03, 0x04, 0x07, 0x05, 0x04, 0x04, 0x00, 0x01,
    0x02, 0x77, 0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51,
    0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1,
    0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a,
    0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95,
    0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2,
    0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8,
    0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5,
    0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
};

// jdhuff.c's derived table, with a 9-bit lookahead: lookup[bits] is
// (code length << 8) | symbol for the codes of at most 9 bits, else 0.
struct Derived {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t lookup[512];
};

constexpr int kLookahead = 9;

void make_derived(const HuffTable& t, bool is_dc, int index, Derived* d, int max_dc = 15) {
  if (!t.defined)
    fail("JPEG: Huffman table 0x" + std::to_string(is_dc ? index : index + 16) +
         " was not defined");
  char huffsize[257];
  unsigned huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int i = t.bits[l];
    if (p + i > 256) fail("JPEG: bogus Huffman table definition");
    while (i--) huffsize[p++] = char(l);
  }
  huffsize[p] = 0;
  int numsymbols = p;
  unsigned code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      code++;
    }
    if (uint64_t(code) >= (uint64_t(1) << si)) fail("JPEG: bogus Huffman table definition");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (t.bits[l]) {
      d->valoffset[l] = int32_t(p) - int32_t(huffcode[p]);
      p += t.bits[l];
      d->maxcode[l] = int32_t(huffcode[p - 1]);
    } else {
      d->maxcode[l] = -1;
    }
  }
  d->valoffset[17] = 0;
  d->maxcode[17] = 0xFFFFF;
  std::memcpy(d->vals, t.vals, 256);
  std::memset(d->lookup, 0, sizeof d->lookup);
  p = 0;
  for (int l = 1; l <= kLookahead; ++l) {
    for (int i = 1; i <= t.bits[l]; ++i, ++p) {
      int look = int(huffcode[p]) << (kLookahead - l);
      for (int ctr = 1 << (kLookahead - l); ctr > 0; --ctr, ++look)
        d->lookup[look] = uint16_t((l << 8) | t.vals[p]);
    }
  }
  if (is_dc)  // a lossless difference's category goes to 16
    for (int i = 0; i < numsymbols; ++i)
      if (t.vals[i] > max_dc) fail("JPEG: bogus Huffman table definition");
}

// The entropy-coded segment's bits: stuffed bytes undone, ending at the
// first marker. Bits past the marker read as zeros, as libjpeg pads them;
// using one of them is an error (libjpeg's "premature end of data
// segment", after which it fills the rest of the segment with grey).
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos;
  uint64_t buf = 0;
  int nbits = 0;
  int pad = 0;       // zero bits appended after the marker
  int marker = -1;   // the marker that ended the segment, once met

  void reset(size_t at) {
    pos = at;
    buf = 0;
    nbits = pad = 0;
    marker = -1;
  }

  void fill() {
    while (nbits <= 56) {
      if (marker >= 0) {
        buf <<= 8;
        nbits += 8;
        pad += 8;
        continue;
      }
      if (pos >= size) fail("JPEG: truncated file (the data ends inside a scan)");
      int c = data[pos++];
      if (c == 0xFF) {
        do {
          if (pos >= size) fail("JPEG: truncated file (the data ends inside a scan)");
          c = data[pos++];
        } while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          marker = c;
          continue;
        }
      }
      buf = (buf << 8) | unsigned(c);
      nbits += 8;
    }
  }

  inline void consume(int n) {
    if (n > nbits - pad)
      fail("JPEG: corrupt data (premature end of a scan's data segment)");
    nbits -= n;
  }

  inline unsigned bits(int n) {
    if (n == 0) return 0;
    if (nbits < n + 1) fill();
    unsigned v = unsigned(buf >> (nbits - n)) & ((1u << n) - 1);
    consume(n);
    return v;
  }

  inline int decode(const Derived& t) {
    if (nbits < 32) fill();
    unsigned look = unsigned(buf >> (nbits - kLookahead)) & ((1u << kLookahead) - 1);
    unsigned e = t.lookup[look];
    if (e) {
      consume(int(e >> 8));
      return int(e & 0xFF);
    }
    int l = kLookahead + 1;
    int32_t code = int32_t(buf >> (nbits - l)) & ((1 << l) - 1);
    while (l <= 16 && code > t.maxcode[l]) {
      ++l;
      code = int32_t(buf >> (nbits - l)) & ((1 << l) - 1);
    }
    if (l > 16) fail("JPEG: corrupt data (bad Huffman code)");
    consume(l);
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
};

// libjpeg's Table D.2 (jaricom.c): Qe << 16 | next MPS << 8 | switch << 7 |
// next LPS; entry 113 is the fixed estimate of 0.5.
const uint32_t kAriTab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719,
    0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b,
    0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320,
    0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e,
    0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a,
    0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171};

// jdarith.c's decoder: the C and A registers, ct the bits left in C's
// buffer part (-16 before the first two bytes). After a marker it reads
// zeros, as the standard has it; the data running out is an error.
struct ArithReader {
  const uint8_t* data;
  size_t size;
  size_t pos;
  int64_t c = 0, a = 0;
  int ct = -16;
  int marker = -1;

  void reset(size_t at) {
    pos = at;
    c = a = 0;
    ct = -16;
    marker = -1;
  }

  int byte() {
    if (marker >= 0) return 0;
    if (pos >= size) fail("JPEG: truncated file (the data ends inside a scan)");
    int v = data[pos++];
    if (v != 0xFF) return v;
    do {
      if (pos >= size) fail("JPEG: truncated file (the data ends inside a scan)");
      v = data[pos++];
    } while (v == 0xFF);
    if (v == 0) return 0xFF;
    marker = v;
    return 0;
  }

  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // two bytes read at the start
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    const int nl = int(qe & 0xFF), nm = int((qe >> 8) & 0xFF);
    qe >>= 16;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional exchange of MPS and LPS
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

inline int extend(unsigned x, int s) {
  return s == 0 ? 0 : (int(x) < (1 << (s - 1)) ? int(x) + int((~0u) << s) + 1 : int(x));
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int bw = 0, bh = 0;    // blocks covering the component's samples
  int bwp = 0, bhp = 0;  // the coefficient buffer's blocks (padded to whole MCUs)
  int dw = 0, dh = 0;    // downsampled size
  bool latched = false;
  bool scanned = false;  // in a scan yet
  uint16_t quant[64];
  int coef_bits[64];
  std::vector<int16_t> coefs;  // bhp * bwp blocks of 64, natural order
  int16_t* block(int bx, int by) { return coefs.data() + (size_t(by) * bwp + bx) * 64; }
  // lossless files: a block is one sample; the differences over whole MCUs
  // and the samples, bh rows of bw
  std::vector<int32_t> diffs;
  std::vector<uint8_t> samples;
};

// libjpeg's tables for the colour conversion (jdcolor.c) and its clamp of
// the converted samples (jdmaster.c's sample_range_limit).
struct ColourTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  uint8_t limit_store[1024];
  const uint8_t* sample_limit;  // [-256, 768) -> [0, 255]
  ColourTables() {
    const int kScale = 16;
    const int64_t half = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = int((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
    for (int i = 0; i < 1024; ++i) limit_store[i] = uint8_t(std::min(255, std::max(0, i - 256)));
    sample_limit = limit_store + 256;
  }
};

const ColourTables& colour_tables() {
  static const ColourTables tables;
  return tables;
}

// The accurate integer IDCT (ISLOW, jidctint.c) as libjpeg-turbo computes
// it on x86-64, where PIL and the JAX loader run its SSE2/AVX2 version
// (jidctint-sse2.asm): 16-bit lanes. It gives the C file's results for every
// valid file and differs only when a corrupt stream makes values overflow
// 16 bits: the dequantised coefficients wrap (pmullw), the sums z2 + z3 and
// in0 +- in4 wrap (paddw), each pass's outputs saturate (packssdw), a block
// whose AC coefficients are all zero takes the DC shortcut with a 16-bit
// shift (psllw), and the samples saturate to [-128, 127] before the +128.
inline int16_t wrap16(int32_t x) { return int16_t(uint16_t(uint32_t(x))); }
inline int16_t sat16(int32_t x) { return int16_t(std::min(32767, std::max(-32768, x))); }
inline int32_t add32(int32_t a, int32_t b) { return int32_t(uint32_t(a) + uint32_t(b)); }
inline int32_t sub32(int32_t a, int32_t b) { return int32_t(uint32_t(a) - uint32_t(b)); }

// One 1-D pass over 8 values: out[i] = saturate16((x_i + round) >> shift).
inline void idct_1d(const int16_t in[8], int shift, int16_t out[8]) {
  constexpr int32_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433, F_0_765 = 6270,
                    F_0_899 = 7373, F_1_175 = 9633, F_1_501 = 12299, F_1_847 = 15137,
                    F_1_961 = 16069, F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;
  // even part
  int32_t z2 = in[2], z3 = in[6];
  int32_t tmp3 = z2 * (F_0_541 + F_0_765) + z3 * F_0_541;
  int32_t tmp2 = z2 * F_0_541 + z3 * (F_0_541 - F_1_847);
  int32_t tmp0 = int32_t(uint32_t(int32_t(wrap16(in[0] + in[4]))) << 13);
  int32_t tmp1 = int32_t(uint32_t(int32_t(wrap16(in[0] - in[4]))) << 13);
  int32_t tmp10 = add32(tmp0, tmp3), tmp13 = sub32(tmp0, tmp3);
  int32_t tmp11 = add32(tmp1, tmp2), tmp12 = sub32(tmp1, tmp2);
  // odd part
  int32_t t0 = in[7], t1 = in[5], t2 = in[3], t3 = in[1];
  int32_t zz3 = wrap16(t0 + t2), zz4 = wrap16(t1 + t3);
  int32_t z3p = zz3 * (F_1_175 - F_1_961) + zz4 * F_1_175;
  int32_t z4p = zz3 * F_1_175 + zz4 * (F_1_175 - F_0_390);
  int32_t o0 = add32(t0 * (F_0_298 - F_0_899) + t3 * -F_0_899, z3p);
  int32_t o3 = add32(t0 * -F_0_899 + t3 * (F_1_501 - F_0_899), z4p);
  int32_t o1 = add32(t1 * (F_2_053 - F_2_562) + t2 * -F_2_562, z4p);
  int32_t o2 = add32(t1 * -F_2_562 + t2 * (F_3_072 - F_2_562), z3p);
  const int32_t round = 1 << (shift - 1);
  auto descale = [&](int32_t x) { return sat16(add32(x, round) >> shift); };
  out[0] = descale(add32(tmp10, o3));
  out[7] = descale(sub32(tmp10, o3));
  out[1] = descale(add32(tmp11, o2));
  out[6] = descale(sub32(tmp11, o2));
  out[2] = descale(add32(tmp12, o1));
  out[5] = descale(sub32(tmp12, o1));
  out[3] = descale(add32(tmp13, o0));
  out[4] = descale(sub32(tmp13, o0));
}

void idct_islow(const int16_t* coef, const int16_t* quant, uint8_t* out, size_t stride) {
  constexpr int CONST_BITS = 13, PASS1_BITS = 2;
  int16_t dq[64];
  bool ac_zero = true;
  for (int i = 0; i < 64; ++i) {
    dq[i] = wrap16(int32_t(coef[i]) * quant[i]);
    if (i >= 8 && coef[i]) ac_zero = false;
  }
  int16_t ws[64];  // ws[row * 8 + col]
  if (ac_zero) {
    for (int c = 0; c < 8; ++c) {
      int16_t dc = wrap16(int32_t(uint32_t(int32_t(dq[c])) << PASS1_BITS));
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
    }
  } else {
    for (int c = 0; c < 8; ++c) {
      int16_t col[8], res[8];
      for (int r = 0; r < 8; ++r) col[r] = dq[r * 8 + c];
      idct_1d(col, CONST_BITS - PASS1_BITS, res);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = res[r];
    }
  }
  for (int r = 0; r < 8; ++r) {
    int16_t res[8];
    idct_1d(ws + r * 8, CONST_BITS + PASS1_BITS + 3, res);
    uint8_t* o = out + r * stride;
    for (int i = 0; i < 8; ++i) o[i] = uint8_t(std::min(127, std::max(-128, int(res[i]))) + 128);
  }
}

enum ColourSpace { CS_GREY, CS_YCC, CS_RGB, CS_CMYK, CS_YCCK };

class JpegDecoder {
 public:
  JpegDecoder(const uint8_t* data, size_t n) : d_(data), n_(n) {}

  void decode(Image* out) {
    read_stream();
    finish(out);
  }

  // JPEG-in-TIFF (libtiff's tif_jpeg.c): the JPEGTables stream, read first
  // as libjpeg reads a tables-only datastream; its tables stay for the
  // segment.
  void load_tables(const uint8_t* tables, size_t n) {
    const uint8_t* d = d_;
    const size_t len = n_;
    d_ = tables;
    n_ = n;
    tables_only_ = true;
    read_stream();
    tables_only_ = false;
    d_ = d;
    n_ = len;
  }

  // The segment's samples after upsampling, interleaved, with libtiff's
  // colour handling: YCbCr converted to RGB (JPEGCOLORMODE_RGB), or none.
  void decode_samples(bool ycbcr_to_rgb, int* channels, int* w, int* h, std::vector<uint8_t>* out) {
    read_stream();
    const int nc = int(comps_.size());
    *w = width_;
    *h = height_;
    if (ycbcr_to_rgb) {
      if (nc != 3) fail("JPEG-in-TIFF: a YCbCr segment of " + std::to_string(nc) + " components");
      space_ = CS_YCC;
      Image rgb;
      finish(&rgb);
      *channels = 3;
      *out = std::move(rgb.rgb);
      return;
    }
    std::vector<std::vector<uint8_t>> full = planes();
    const size_t npix = size_t(width_) * height_;
    out->resize(npix * nc);
    for (size_t i = 0; i < npix; ++i)
      for (int k = 0; k < nc; ++k) (*out)[i * nc + k] = full[k][i];
    *channels = nc;
  }

  std::vector<std::pair<int, int>> sampling() const {
    std::vector<std::pair<int, int>> s;
    for (const auto& c : comps_) s.emplace_back(c.h, c.v);
    return s;
  }

 private:
  // The markers from SOI to EOI.
  void read_stream() {
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) fail("JPEG: not a JPEG file");
    pos_ = 2;
    // get_soi: what each SOI resets
    restart_interval_ = 0;
    jfif_ = adobe_ = false;
    for (int i = 0; i < 16; ++i) {
      dc_l_[i] = 0;
      dc_u_[i] = 1;
      ac_k_[i] = 5;
    }
    int marker = next_marker();
    bool first_scan = true;
    for (;;) {
      if (tables_only_ && (marker == 0xDA || (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 &&
                                              marker != 0xC8 && marker != 0xCC)))
        fail("JPEG-in-TIFF: the JPEGTables stream holds an image");
      switch (marker) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA:
          read_sof(marker);
          break;
        case 0xC5: case 0xC6: case 0xC7: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
          fail(std::string("JPEG: ") + sof_kind(marker) + " (SOF" +
               std::to_string(marker - 0xC0) + ") is not decoded: libjpeg refuses it (" +
               ssr::kFormatsItem + ")");
        case 0xC8:
          fail("JPEG: unsupported marker JPG (0xC8)");
        case 0xC4:
          read_dht(false, nullptr, 0);
          break;
        case 0xCC:
          read_dac();
          break;
        case 0xDC:  // DNL
          skip_segment();
          break;
        case 0xD8:
          fail("JPEG: invalid structure (two SOI markers)");
        case 0xD9:
          if (first_scan && !tables_only_) fail("JPEG: no image (EOI before any scan)");
          return;
        case 0xDA:
          if (!sof_) fail("JPEG: invalid structure (SOS before SOF)");
          if (first_scan) {
            start_image();
            first_scan = false;
          } else if (single_scan_) {
            fail("JPEG: invalid structure (more than one scan in a sequential file)");
          }
          marker = read_scan();
          continue;
        case 0xDB:
          read_dqt();
          break;
        case 0xDD:
          read_dri();
          break;
        case 0xFE:
          skip_segment();
          break;
        default:
          if (marker >= 0xE0 && marker <= 0xEF) {
            read_app(marker);
          } else if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) {
            // RSTn and TEM carry no parameters
          } else {
            char buf[64];
            std::snprintf(buf, sizeof buf, "JPEG: unsupported marker 0x%02x", marker);
            fail(buf);
          }
      }
      marker = next_marker();
    }
  }

  static const char* sof_kind(int m) {
    switch (m) {
      case 0xC5: case 0xC6: case 0xC7: return "hierarchical JPEG";
      case 0xCB: return "lossless arithmetic-coded JPEG";
      default: return "hierarchical arithmetic-coded JPEG";
    }
  }

  int byte() {
    if (pos_ >= n_) fail("JPEG: truncated file");
    return d_[pos_++];
  }
  int two_bytes() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // libjpeg's next_marker: non-FF bytes before a marker are skipped (it
  // warns of extraneous data), FF fill bytes swallowed.
  int next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do c = byte(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void skip_segment() {
    long length = two_bytes() - 2;
    if (length > 0) {
      if (size_t(length) > n_ - pos_) fail("JPEG: truncated file");
      pos_ += size_t(length);
    }
  }

  void read_app(int marker) {
    long length = two_bytes() - 2;
    unsigned take = length >= 14 ? 14 : (length > 0 ? unsigned(length) : 0);
    uint8_t b[14];
    for (unsigned i = 0; i < take; ++i) b[i] = uint8_t(byte());
    length -= take;
    if (marker == 0xE0 && take >= 14 && std::memcmp(b, "JFIF\0", 5) == 0) jfif_ = true;
    if (marker == 0xEE && take >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
      adobe_ = true;
      adobe_transform_ = b[11];
    }
    if (length > 0) {
      if (size_t(length) > n_ - pos_) fail("JPEG: truncated file");
      pos_ += size_t(length);
    }
  }

  // get_dht; with `body` the segment is read from memory (the standard
  // tables), filling only the empty slots.
  void read_dht(bool only_empty, const uint8_t* body, size_t body_len) {
    size_t bpos = 0;
    auto next = [&]() -> int {
      if (body) {
        return body[bpos++];
      }
      return byte();
    };
    long length = body ? long(body_len) : two_bytes() - 2;
    while (length > 16) {
      int index = next();
      HuffTable t;
      int count = 0;
      for (int i = 1; i <= 16; ++i) {
        t.bits[i] = uint8_t(next());
        count += t.bits[i];
      }
      length -= 17;
      if (count > 256 || count > length) fail("JPEG: bogus Huffman table definition");
      for (int i = 0; i < count; ++i) t.vals[i] = uint8_t(next());
      length -= count;
      t.defined = true;
      HuffTable* slot;
      if (index & 0x10) {
        index -= 0x10;
        if (index >= 4) fail("JPEG: bogus DHT index " + std::to_string(index));
        slot = &ac_[index];
      } else {
        if (index >= 4) fail("JPEG: bogus DHT index " + std::to_string(index));
        slot = &dc_[index];
      }
      if (!only_empty || !slot->defined) *slot = t;
    }
    if (length != 0) fail("JPEG: bogus marker length (DHT)");
  }

  void read_dqt() {
    long length = two_bytes() - 2;
    while (length > 0) {
      int n = byte();
      int prec = n >> 4;
      n &= 0x0F;
      if (n >= 4) fail("JPEG: bogus DQT index " + std::to_string(n));
      for (int i = 0; i < 64; ++i) {
        int v = prec ? two_bytes() : byte();
        qt_[n][kNatural[i]] = uint16_t(v);
      }
      qt_defined_[n] = true;
      length -= 65;
      if (prec) length -= 64;
    }
    if (length != 0) fail("JPEG: bogus marker length (DQT)");
  }

  // get_dac: the arithmetic coder's conditioning, L and U of a DC table,
  // Kx of an AC table
  void read_dac() {
    long length = two_bytes() - 2;
    while (length > 0) {
      int index = byte(), value = byte();
      length -= 2;
      if (index >= 32) fail("JPEG: bogus DAC index " + std::to_string(index));
      if (index >= 16) {
        ac_k_[index - 16] = value;
      } else {
        if ((value & 0x0F) > (value >> 4)) fail("JPEG: bogus DAC value " + std::to_string(value));
        dc_l_[index] = value & 0x0F;
        dc_u_[index] = value >> 4;
      }
    }
    if (length != 0) fail("JPEG: bogus marker length (DAC)");
  }

  void read_dri() {
    if (two_bytes() != 4) fail("JPEG: bogus marker length (DRI)");
    restart_interval_ = two_bytes();
  }

  void read_sof(int marker) {
    long length = two_bytes();
    int precision = byte();
    height_ = two_bytes();
    width_ = two_bytes();
    int nc = byte();
    length -= 8;
    if (sof_) fail("JPEG: invalid structure (two SOF markers)");
    if (height_ <= 0 || width_ <= 0 || nc <= 0) fail("JPEG: empty image");
    if (length != nc * 3) fail("JPEG: bogus marker length (SOF)");
    if (precision != 8)  // PIL's plugin reads only 8-bit frames
      fail("JPEG: " + std::to_string(precision) +
           "-bit samples are not decoded: PIL refuses them (" + ssr::kFormatsItem + ")");
    comps_.assign(nc, Component());
    for (int i = 0; i < nc; ++i) {
      comps_[i].id = byte();
      int c = byte();
      comps_[i].h = (c >> 4) & 15;
      comps_[i].v = c & 15;
      comps_[i].tq = byte();
    }
    progressive_ = marker == 0xC2 || marker == 0xCA;
    arith_ = marker == 0xC9 || marker == 0xCA;
    lossless_ = marker == 0xC3;
    sof_ = true;
  }

  // jdinput.c initial_setup and default_decompress_parms, at the first SOS.
  void start_image() {
    if (width_ > 65500 || height_ > 65500) fail("JPEG: image too big (over 65500 pixels)");
    int nc = int(comps_.size());
    if (nc > 10) fail("JPEG: too many colour components");
    if (nc != 1 && nc != 3 && nc != 4)
      fail("JPEG: " + std::to_string(nc) + "-component images are not decoded");
    check_image_pixels("JPEG", uint64_t(width_), uint64_t(height_));
    maxh_ = maxv_ = 1;
    for (auto& c : comps_) {
      if (c.h <= 0 || c.h > 4 || c.v <= 0 || c.v > 4) fail("JPEG: bogus sampling factors");
      maxh_ = std::max(maxh_, c.h);
      maxv_ = std::max(maxv_, c.v);
    }
    const int unit = lossless_ ? 1 : 8;  // a lossless block is one sample
    mcux_ = (width_ + unit * maxh_ - 1) / (unit * maxh_);
    mcuy_ = (height_ + unit * maxv_ - 1) / (unit * maxv_);
    for (auto& c : comps_) {
      c.bw = int((int64_t(width_) * c.h + unit * maxh_ - 1) / (unit * maxh_));
      c.bh = int((int64_t(height_) * c.v + unit * maxv_ - 1) / (unit * maxv_));
      c.dw = int((int64_t(width_) * c.h + maxh_ - 1) / maxh_);
      c.dh = int((int64_t(height_) * c.v + maxv_ - 1) / maxv_);
      c.bwp = std::max(mcux_ * c.h, c.bw);
      c.bhp = std::max(mcuy_ * c.v, c.bh);
      if (lossless_) {
        c.diffs.assign(size_t(c.bwp) * c.bhp, 0);
        c.samples.assign(size_t(c.bw) * c.bh, 0);
      } else {
        c.coefs.assign(size_t(c.bwp) * c.bhp * 64, 0);
      }
      for (int& b : c.coef_bits) b = -1;
    }
    if (nc == 1) {
      space_ = CS_GREY;
    } else if (nc == 3) {
      if (jfif_) {
        space_ = CS_YCC;
      } else if (adobe_) {
        space_ = adobe_transform_ == 0 ? CS_RGB : CS_YCC;
      } else {
        int a = comps_[0].id, b = comps_[1].id, c = comps_[2].id;
        // libjpeg-turbo 3 takes a lossless file without markers for RGB
        space_ = (a == 82 && b == 71 && c == 66) || lossless_ ? CS_RGB : CS_YCC;
      }
    } else {
      space_ = (adobe_ && adobe_transform_ != 0) ? CS_YCCK : CS_CMYK;
    }
    // the standard Huffman tables in the slots the file left empty
    // (jdhuff.c; libjpeg's lossless decoder installs none)
    if (!lossless_) read_dht(true, kStdHuffman, sizeof kStdHuffman);
  }

  // One scan, from its SOS header; returns the marker that follows it.
  int read_scan() {
    int length = two_bytes();
    int ns = byte();
    if (length != ns * 2 + 6 || ns < 1 || ns > 4) fail("JPEG: bogus marker length (SOS)");
    Component* scan[4];
    for (int i = 0; i < ns; ++i) {
      int cc = byte();
      int c = byte();
      Component* found = nullptr;
      for (auto& comp : comps_)
        if (comp.id == cc) {
          found = &comp;
          break;
        }
      if (!found) fail("JPEG: invalid component ID " + std::to_string(cc) + " in SOS");
      for (int j = 0; j < i; ++j)
        if (scan[j] == found) fail("JPEG: invalid component ID " + std::to_string(cc) + " in SOS");
      found->dc_tbl = (c >> 4) & 15;
      found->ac_tbl = c & 15;
      found->scanned = true;
      scan[i] = found;
    }
    int ss = byte(), se = byte(), a = byte();
    int ah = (a >> 4) & 15, al = a & 15;
    ++scan_number_;
    if (scan_number_ == 1) single_scan_ = !progressive_ && ns == int(comps_.size());
    int blocks = 0;
    for (int i = 0; i < ns; ++i) blocks += ns == 1 ? 1 : scan[i]->h * scan[i]->v;
    if (blocks > 10) fail("JPEG: sampling factors too large for an interleaved scan");
    if (lossless_) return read_lossless_scan(scan, ns, ss, se, ah, al);
    // latch the quantisation tables (jdinput.c latch_quant_tables)
    for (int i = 0; i < ns; ++i) {
      Component* c = scan[i];
      if (c->latched) continue;
      if (c->tq >= 4 || !qt_defined_[c->tq])
        fail("JPEG: quantisation table 0x" + std::to_string(c->tq) + " was not defined");
      std::memcpy(c->quant, qt_[c->tq], sizeof c->quant);
      c->latched = true;
    }

    bool is_dc = ss == 0;
    if (progressive_) {
      bool bad = false;
      if (is_dc) {
        if (se != 0) bad = true;
      } else {
        if (ss > se || se >= 64) bad = true;
        if (ns != 1) bad = true;
      }
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail("JPEG: invalid progressive parameters");
      for (int i = 0; i < ns; ++i)
        for (int k = ss; k <= se; ++k) scan[i]->coef_bits[k] = al;
    } else if (ss != 0 || ah != 0 || al != 0 || (se < 64 && se != 63)) {
      fail("JPEG: a sequential scan with the parameters of another process (libjpeg warns)");
    }
    if (arith_) return read_arith_scan(scan, ns, ss, se, ah, al);

    Derived* dc[4] = {nullptr, nullptr, nullptr, nullptr};
    Derived* ac[4] = {nullptr, nullptr, nullptr, nullptr};
    for (int i = 0; i < ns; ++i) {
      Component* c = scan[i];
      if (!progressive_ || (is_dc && ah == 0)) {
        if (c->dc_tbl >= 4) fail("JPEG: Huffman table was not defined");
        make_derived(dc_[c->dc_tbl], true, c->dc_tbl, &derived_dc_[i]);
        dc[i] = &derived_dc_[i];
      }
      if (!progressive_ || !is_dc) {
        if (c->ac_tbl >= 4) fail("JPEG: Huffman table was not defined");
        make_derived(ac_[c->ac_tbl], false, c->ac_tbl, &derived_ac_[i]);
        ac[i] = &derived_ac_[i];
      }
    }

    BitReader br{d_, n_, pos_};
    br.reset(pos_);
    int last_dc[4] = {0, 0, 0, 0};
    int eobrun = 0;
    for_each_block(scan, ns, [&]() {
      // process_restart: the segment must end with the next RSTn
      int m = br.marker;
      pos_ = br.pos;
      if (m < 0) m = next_marker();
      check_restart(m);
      br.reset(pos_);
      last_dc[0] = last_dc[1] = last_dc[2] = last_dc[3] = 0;
      eobrun = 0;
    }, [&](int i, int16_t* blk) {
      if (!progressive_)
        decode_sequential(br, *dc[i], *ac[i], blk, &last_dc[i]);
      else if (is_dc && ah == 0)
        decode_dc_first(br, *dc[i], blk, &last_dc[i], al);
      else if (is_dc)
        decode_dc_refine(br, blk, al);
      else if (ah == 0)
        decode_ac_first(br, *ac[i], blk, ss, se, al, &eobrun);
      else
        decode_ac_refine(br, *ac[i], blk, ss, se, al, &eobrun);
    });
    pos_ = br.pos;
    if (br.marker >= 0) return br.marker;
    return next_marker();
  }

  // The scan's blocks in MCU order: restart() where an interval ends,
  // block(i, coefficients) for each block of scan component i.
  template <typename Restart, typename Block>
  void for_each_block(Component** scan, int ns, Restart restart, Block block) {
    int mcus_x = ns == 1 ? scan[0]->bw : mcux_, mcus_y = ns == 1 ? scan[0]->bh : mcuy_;
    int restarts_to_go = restart_interval_;
    next_restart_ = 0;
    for (int my = 0; my < mcus_y; ++my) {
      for (int mx = 0; mx < mcus_x; ++mx) {
        if (restart_interval_) {
          if (restarts_to_go == 0) {
            restart();
            restarts_to_go = restart_interval_;
          }
          --restarts_to_go;
        }
        for (int i = 0; i < ns; ++i) {
          Component* c = scan[i];
          int bh = ns == 1 ? 1 : c->v, bwn = ns == 1 ? 1 : c->h;
          for (int y = 0; y < bh; ++y)
            for (int x = 0; x < bwn; ++x)
              block(i, ns == 1 ? c->block(mx, my) : c->block(mx * c->h + x, my * c->v + y));
        }
      }
    }
  }

  // read_restart_marker: the marker must be the next RSTn in sequence
  // (libjpeg resyncs with a warning otherwise)
  void check_restart(int m) {
    if (m != 0xD0 + next_restart_) fail("JPEG: corrupt data (restart marker out of sequence)");
    next_restart_ = (next_restart_ + 1) & 7;
  }

  static void decode_sequential(BitReader& br, const Derived& dc, const Derived& ac,
                                int16_t* blk, int* last_dc) {
    int s = br.decode(dc);
    if (s) s = extend(br.bits(s), s);
    s = int(unsigned(s) + unsigned(*last_dc));
    *last_dc = s;
    blk[0] = int16_t(s);
    for (int k = 1; k < 64; ++k) {
      s = br.decode(ac);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(extend(br.bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  static void decode_dc_first(BitReader& br, const Derived& dc, int16_t* blk, int* last_dc,
                              int al) {
    int s = br.decode(dc);
    if (s) s = extend(br.bits(s), s);
    int64_t sum = int64_t(s) + *last_dc;
    if (sum > INT32_MAX || sum < INT32_MIN) fail("JPEG: corrupt data (DC coefficient overflow)");
    *last_dc = int(sum);
    blk[0] = int16_t(unsigned(sum) << al);
  }

  static void decode_dc_refine(BitReader& br, int16_t* blk, int al) {
    if (br.bits(1)) blk[0] = int16_t(blk[0] | (1 << al));
  }

  static void decode_ac_first(BitReader& br, const Derived& ac, int16_t* blk, int ss, int se,
                              int al, int* eobrun) {
    if (*eobrun > 0) {
      --*eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      int s = br.decode(ac);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(unsigned(extend(br.bits(s), s)) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        int run = 1 << r;
        if (r) run += int(br.bits(r));
        *eobrun = run - 1;
        break;
      }
    }
  }

  static void refine_nonzero(BitReader& br, int16_t* c, int p1, int m1) {
    if (br.bits(1) && (*c & p1) == 0) *c = int16_t(*c >= 0 ? *c + p1 : *c + m1);
  }

  static void decode_ac_refine(BitReader& br, const Derived& ac, int16_t* blk, int ss, int se,
                               int al, int* eobrun) {
    int p1 = 1 << al;
    int m1 = int(~0u << al);
    int k = ss;
    if (*eobrun == 0) {
      for (; k <= se; ++k) {
        int s = br.decode(ac);
        int r = s >> 4;
        s &= 15;
        if (s) {
          if (s != 1) fail("JPEG: corrupt data (bad Huffman code)");
          s = br.bits(1) ? p1 : m1;
        } else if (r != 15) {
          *eobrun = 1 << r;
          if (r) *eobrun += int(br.bits(r));
          break;
        }
        do {
          int16_t* c = blk + kNatural[k];
          if (*c != 0) {
            refine_nonzero(br, c, p1, m1);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (*eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* c = blk + kNatural[k];
        if (*c != 0) refine_nonzero(br, c, p1, m1);
      }
      --*eobrun;
    }
  }

  // ------------------------------------------------------------ arithmetic

  // jdarith.c: statistics bins per table (64 for DC, 256 for AC), reset
  // with the decoder at each restart; the sign of an AC value and the
  // refinement bits use the fixed estimate.
  int read_arith_scan(Component** scan, int ns, int ss, int se, int ah, int al) {
    const bool is_dc = ss == 0;
    const bool dc_stats = !progressive_ || (is_dc && ah == 0), ac_stats = !progressive_ || ss;
    for (int i = 0; i < ns; ++i) {
      if (dc_stats && scan[i]->dc_tbl >= 16) fail("JPEG: arithmetic table was not defined");
      if (ac_stats && scan[i]->ac_tbl >= 16) fail("JPEG: arithmetic table was not defined");
    }
    uint8_t dc_bins[16][64], ac_bins[16][256];
    int last_dc[4] = {0, 0, 0, 0}, context[4] = {0, 0, 0, 0};
    auto reset_stats = [&]() {
      for (int i = 0; i < ns; ++i) {
        if (dc_stats) {
          std::memset(dc_bins[scan[i]->dc_tbl], 0, 64);
          last_dc[i] = context[i] = 0;
        }
        if (ac_stats) std::memset(ac_bins[scan[i]->ac_tbl], 0, 256);
      }
    };
    reset_stats();
    uint8_t fixed = 113;
    ArithReader ar{d_, n_, pos_};
    ar.reset(pos_);
    for_each_block(scan, ns, [&]() {
      int m = ar.marker;
      pos_ = ar.pos;
      if (m < 0) m = next_marker();
      check_restart(m);
      reset_stats();
      ar.reset(pos_);
    }, [&](int i, int16_t* blk) {
      Component* c = scan[i];
      if (!progressive_) {
        arith_dc(ar, dc_bins[c->dc_tbl], c->dc_tbl, &last_dc[i], &context[i]);
        blk[0] = int16_t(last_dc[i]);
        arith_ac_sequential(ar, ac_bins[c->ac_tbl], ac_k_[c->ac_tbl], &fixed, blk);
      } else if (is_dc && ah == 0) {
        arith_dc(ar, dc_bins[c->dc_tbl], c->dc_tbl, &last_dc[i], &context[i]);
        blk[0] = int16_t(unsigned(last_dc[i]) << al);
      } else if (is_dc) {
        if (ar.decode(&fixed)) blk[0] = int16_t(blk[0] | (1 << al));
      } else if (ah == 0) {
        arith_ac_first(ar, ac_bins[c->ac_tbl], ac_k_[c->ac_tbl], &fixed, blk, ss, se, al);
      } else {
        arith_ac_refine(ar, ac_bins[c->ac_tbl], &fixed, blk, ss, se, al);
      }
    });
    pos_ = ar.pos;
    if (ar.marker >= 0) return ar.marker;
    return next_marker();  // bytes the decoder did not need are skipped
  }

  // Figures F.19-F.24 for one DC difference, its context for the next.
  void arith_dc(ArithReader& ar, uint8_t* bins, int tbl, int* last_dc, int* context) {
    uint8_t* st = bins + *context;
    if (ar.decode(st) == 0) {
      *context = 0;
      return;
    }
    const int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m) {
      st = bins + 20;
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) fail("JPEG: corrupt data (bad arithmetic code)");
        ++st;
      }
    }
    if (m < ((1 << dc_l_[tbl]) >> 1))
      *context = 0;
    else if (m > ((1 << dc_u_[tbl]) >> 1))
      *context = 12 + sign * 4;
    else
      *context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    *last_dc = (*last_dc + v) & 0xffff;
  }

  // The magnitude and its bits of a nonzero AC value at index k, st its
  // SE bin (Figures F.21-F.24).
  static int arith_ac_value(ArithReader& ar, uint8_t* bins, uint8_t* st, int k, int kx,
                            uint8_t* fixed) {
    const int sign = ar.decode(fixed);
    st += 2;
    int m = ar.decode(st);
    if (m && ar.decode(st)) {
      m <<= 1;
      st = bins + (k <= kx ? 189 : 217);
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) fail("JPEG: corrupt data (bad arithmetic code)");
        ++st;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  static void arith_ac_sequential(ArithReader& ar, uint8_t* bins, int kx, uint8_t* fixed,
                                  int16_t* blk) {
    int k = 0;
    do {
      uint8_t* st = bins + 3 * k;
      if (ar.decode(st)) break;  // EOB
      for (;;) {
        ++k;
        if (ar.decode(st + 1)) break;
        st += 3;
        if (k >= 63) fail("JPEG: corrupt data (bad arithmetic code)");
      }
      blk[kNatural[k]] = int16_t(arith_ac_value(ar, bins, st, k, kx, fixed));
    } while (k < 63);
  }

  static void arith_ac_first(ArithReader& ar, uint8_t* bins, int kx, uint8_t* fixed,
                             int16_t* blk, int ss, int se, int al) {
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = bins + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) fail("JPEG: corrupt data (bad arithmetic code)");
      }
      blk[kNatural[k]] = int16_t(unsigned(arith_ac_value(ar, bins, st, k, kx, fixed)) << al);
    }
  }

  static void arith_ac_refine(ArithReader& ar, uint8_t* bins, uint8_t* fixed, int16_t* blk,
                              int ss, int se, int al) {
    const int p1 = 1 << al, m1 = int(~0u << al);
    int kex = se;  // the previous stage's end of block
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = bins + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {  // previously nonzero
          if (ar.decode(st + 2)) *coef = int16_t(*coef < 0 ? *coef + m1 : *coef + p1);
          break;
        }
        if (ar.decode(st + 1)) {  // newly nonzero
          *coef = int16_t(ar.decode(fixed) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) fail("JPEG: corrupt data (bad arithmetic code)");
      }
    }
  }

  // -------------------------------------------------------------- lossless

  // jdlhuff.c decodes one difference a sample, jddiffct.c undoes them an
  // iMCU row (v rows of each component) at a time: a restart anywhere in
  // the row sends the row's first line back to the initial predictor.
  int read_lossless_scan(Component** scan, int ns, int ss, int se, int ah, int al) {
    if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8)
      fail("JPEG: invalid lossless scan parameters");
    const int mcus_x = ns == 1 ? scan[0]->bw : mcux_, mcus_y = ns == 1 ? scan[0]->bh : mcuy_;
    if (restart_interval_ % mcus_x)
      fail("JPEG: a lossless restart interval that is not a whole number of MCU rows");
    Derived* dc[4];
    for (int i = 0; i < ns; ++i) {
      if (scan[i]->dc_tbl >= 4) fail("JPEG: Huffman table was not defined");
      make_derived(dc_[scan[i]->dc_tbl], true, scan[i]->dc_tbl, &derived_dc_[i], 16);
      dc[i] = &derived_dc_[i];
    }
    // the iMCU rows whose first line predicts from the initial value: the
    // scan's first and each in which a restart falls (an iMCU row is one
    // MCU row of an interleaved scan, v of a one-component scan)
    const int mcu_rows_per_imcu = ns == 1 ? scan[0]->v : 1;
    std::vector<uint8_t> first(size_t(mcus_y / mcu_rows_per_imcu) + 1, 0);
    first[0] = 1;
    BitReader br{d_, n_, pos_};
    br.reset(pos_);
    const int rows_per_restart = restart_interval_ / mcus_x;
    int rows_to_go = rows_per_restart;
    next_restart_ = 0;
    for (int my = 0; my < mcus_y; ++my) {
      if (restart_interval_) {
        if (rows_to_go == 0) {
          int m = br.marker;
          pos_ = br.pos;
          if (m < 0) m = next_marker();
          check_restart(m);
          br.reset(pos_);
          first[size_t(my / mcu_rows_per_imcu)] = 1;
          rows_to_go = rows_per_restart;
        }
        --rows_to_go;
      }
      for (int mx = 0; mx < mcus_x; ++mx)
        for (int i = 0; i < ns; ++i) {
          Component* c = scan[i];
          const int bh = ns == 1 ? 1 : c->v, bwn = ns == 1 ? 1 : c->h;
          for (int y = 0; y < bh; ++y)
            for (int x = 0; x < bwn; ++x) {
              int s = br.decode(*dc[i]);
              if (s == 16)
                s = 32768;
              else if (s)
                s = extend(br.bits(s), s);
              const size_t row = size_t(ns == 1 ? my : my * c->v + y);
              c->diffs[row * c->bwp + (ns == 1 ? mx : mx * c->h + x)] = s;
            }
        }
    }
    for (int i = 0; i < ns; ++i) undifference(*scan[i], ss, al, first);
    pos_ = br.pos;
    if (br.marker >= 0) return br.marker;
    return next_marker();
  }

  // jdlossls.c: the differences back to samples (16-bit wrap), then the
  // point transform undone into 8 bits.
  void undifference(Component& c, int predictor, int al, const std::vector<uint8_t>& first) {
    std::vector<int32_t> prev(size_t(c.bw)), cur(size_t(c.bw));
    for (int r = 0; r < c.bh; ++r) {
      const int32_t* diff = c.diffs.data() + size_t(r) * c.bwp;
      if (r % c.v == 0 && first[size_t(r / c.v)]) {
        int32_t ra = (diff[0] + (1 << (8 - al - 1))) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < c.bw; ++x) cur[x] = ra = (diff[x] + ra) & 0xFFFF;
      } else {
        int64_t rb = prev[0], ra = (diff[0] + rb) & 0xFFFF, rc;
        cur[0] = int32_t(ra);
        for (int x = 1; x < c.bw; ++x) {
          rc = rb;
          rb = prev[x];
          int64_t p;
          switch (predictor) {
            case 1: p = ra; break;
            case 2: p = rb; break;
            case 3: p = rc; break;
            case 4: p = ra + rb - rc; break;
            case 5: p = ra + ((rb - rc) >> 1); break;
            case 6: p = rb + ((ra - rc) >> 1); break;
            default: p = (ra + rb) >> 1; break;
          }
          ra = (diff[x] + int32_t(p)) & 0xFFFF;
          cur[x] = int32_t(ra);
        }
      }
      uint8_t* out = c.samples.data() + size_t(r) * c.bw;
      for (int x = 0; x < c.bw; ++x) out[x] = uint8_t(unsigned(cur[x]) << al);
      std::swap(prev, cur);
    }
  }

  // ------------------------------------------------------------ the output

  // jdcoefct.c smoothing_ok: libjpeg smooths the blocks of a progressive
  // file whose scans leave low-order coefficients unrefined.
  bool smoothing_applies() const {
    if (!progressive_) return false;
    static const int q_pos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (const auto& c : comps_) {
      if (!c.latched) return false;
      for (int p : q_pos)
        if (c.quant[p] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // Each component's samples at full size: IDCT (or the lossless samples),
  // upsampling.
  std::vector<std::vector<uint8_t>> planes() {
    if (lossless_)
      for (const auto& c : comps_)
        if (!c.scanned) fail("JPEG: a lossless file whose scans leave a component out");
    int nc = int(comps_.size());
    std::vector<std::vector<uint8_t>> full(nc);
    const bool smooth = smoothing_applies();
    for (int ci = 0; ci < nc; ++ci) {
      Component& c = comps_[ci];
      if (lossless_) {  // no fancy upsampling: libjpeg's blocks are one sample
        full[ci] = upsample(c, c.samples, size_t(c.bw), false);
        continue;
      }
      size_t stride = size_t(c.bw) * 8;
      std::vector<uint8_t> plane(stride * size_t(c.bh) * 8);
      int16_t q[64];
      for (int i = 0; i < 64; ++i) q[i] = int16_t(c.quant[i]);
      int16_t ws[64];
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx) {
          const int16_t* blk = c.block(bx, by);
          if (smooth) {
            smooth_block(c, bx, by, ws);
            blk = ws;
          }
          idct_islow(blk, q, plane.data() + size_t(by) * 8 * stride + bx * 8, stride);
        }
      full[ci] = upsample(c, plane, stride, true);
    }
    return full;
  }

  // jdcoefct.c decompress_smooth_data as libjpeg-turbo 2.1+ has it: the
  // still-zero coefficients 1-9 of a block estimated from the 5 x 5 DC
  // neighbourhood (and the DC too when no AC scan reached them), edge blocks
  // repeated. The rows above and below follow libjpeg's indexing, which
  // counts the last iMCU row's block rows as if every iMCU row had as many.
  void smooth_block(Component& c, int bx, int by, int16_t* ws) const {
    const int v = c.v;
    const int total_imcu = (c.bh + v - 1) / v;  // jdinput.c total_iMCU_rows
    const int imcu = by / v, block_row = by % v;
    int block_rows = v;
    if (imcu == total_imcu - 1) {
      block_rows = c.bh % v;
      if (block_rows == 0) block_rows = v;
    }
    const int image_block_row = imcu * block_rows + block_row;
    const int image_block_rows = block_rows * total_imcu;
    const int prev = image_block_row > 0 ? by - 1 : by;
    const int prev_prev = image_block_row > 1 ? by - 2 : prev;
    const int next = image_block_row < image_block_rows - 1 ? by + 1 : by;
    const int next_next = image_block_row < image_block_rows - 2 ? by + 2 : next;
    const int rows[5] = {prev_prev, prev, by, next, next_next};
    const int last_col = c.bw - 1;
    int dc[25];  // DC01..DC25, row by row
    for (int r = 0; r < 5; ++r)
      for (int k = 0; k < 5; ++k) {
        const int col = std::min(std::max(bx + k - 2, 0), last_col);
        dc[r * 5 + k] = c.block(col, rows[r])[0];
      }
    auto DC = [&](int i) -> int64_t { return dc[i - 1]; };
    std::memcpy(ws, c.block(bx, by), 64 * sizeof(int16_t));
    const int* bits = c.coef_bits;
    const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 && bits[4] == -1 &&
                           bits[5] == -1 && bits[6] == -1 && bits[7] == -1 && bits[8] == -1 &&
                           bits[9] == -1;
    const int64_t q00 = c.quant[0];
    auto predict = [&](int coef_bit, int pos, int64_t sum) {
      const int al = bits[coef_bit];
      if (al == 0 || ws[pos] != 0) return;
      const int64_t q = c.quant[pos];
      const int64_t num = q00 * sum;
      int pred;
      if (num >= 0) {
        pred = int(((q << 7) + num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = int(((q << 7) - num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      ws[pos] = int16_t(pred);
    };
    // AC01
    predict(1, 1, change_dc ? -DC(1) - DC(2) + DC(4) + DC(5) - 3 * DC(6) + 13 * DC(7) -
                                  13 * DC(9) + 3 * DC(10) - 3 * DC(11) + 38 * DC(12) -
                                  38 * DC(14) + 3 * DC(15) - 3 * DC(16) + 13 * DC(17) -
                                  13 * DC(19) + 3 * DC(20) - DC(21) - DC(22) + DC(24) + DC(25)
                            : -7 * DC(11) + 50 * DC(12) - 50 * DC(14) + 7 * DC(15));
    // AC10
    predict(2, 8, change_dc ? -DC(1) - 3 * DC(2) - 3 * DC(3) - 3 * DC(4) - DC(5) - DC(6) +
                                  13 * DC(7) + 38 * DC(8) + 13 * DC(9) - DC(10) + DC(16) -
                                  13 * DC(17) - 38 * DC(18) - 13 * DC(19) + DC(20) + DC(21) +
                                  3 * DC(22) + 3 * DC(23) + 3 * DC(24) + DC(25)
                            : -7 * DC(3) + 50 * DC(8) - 50 * DC(18) + 7 * DC(23));
    // AC20
    predict(3, 16, change_dc ? DC(3) + 2 * DC(7) + 7 * DC(8) + 2 * DC(9) - 5 * DC(12) -
                                   14 * DC(13) - 5 * DC(14) + 2 * DC(17) + 7 * DC(18) +
                                   2 * DC(19) + DC(23)
                             : -DC(3) + 13 * DC(8) - 24 * DC(13) + 13 * DC(18) - DC(23));
    // AC11
    predict(4, 9, change_dc ? -DC(1) + DC(5) + 9 * DC(7) - 9 * DC(9) - 9 * DC(17) +
                                  9 * DC(19) + DC(21) - DC(25)
                            : DC(10) + DC(16) - 10 * DC(17) + 10 * DC(19) - DC(2) - DC(20) +
                                  DC(22) - DC(24) + DC(4) - DC(6) + 10 * DC(7) - 10 * DC(9));
    // AC02
    predict(5, 2, change_dc ? 2 * DC(7) - 5 * DC(8) + 2 * DC(9) + DC(11) + 7 * DC(12) -
                                  14 * DC(13) + 7 * DC(14) + DC(15) + 2 * DC(17) - 5 * DC(18) +
                                  2 * DC(19)
                            : -DC(11) + 13 * DC(12) - 24 * DC(13) + 13 * DC(14) - DC(15));
    if (!change_dc) return;
    predict(6, 3, DC(7) - DC(9) + 2 * DC(12) - 2 * DC(14) + DC(17) - DC(19));       // AC03
    predict(7, 10, DC(7) - 3 * DC(8) + DC(9) - DC(17) + 3 * DC(18) - DC(19));       // AC12
    predict(8, 17, DC(7) - DC(9) - 3 * DC(12) + 3 * DC(14) + DC(17) - DC(19));      // AC21
    predict(9, 24, DC(7) + 2 * DC(8) + DC(9) - DC(17) - 2 * DC(18) - DC(19));       // AC30
    const int64_t num =
        q00 * (-2 * DC(1) - 6 * DC(2) - 8 * DC(3) - 6 * DC(4) - 2 * DC(5) - 6 * DC(6) +
               6 * DC(7) + 42 * DC(8) + 6 * DC(9) - 6 * DC(10) - 8 * DC(11) + 42 * DC(12) +
               152 * DC(13) + 42 * DC(14) - 8 * DC(15) - 6 * DC(16) + 6 * DC(17) + 42 * DC(18) +
               6 * DC(19) - 6 * DC(20) - 2 * DC(21) - 6 * DC(22) - 8 * DC(23) - 6 * DC(24) -
               2 * DC(25));
    ws[0] = int16_t(num >= 0 ? ((q00 << 7) + num) / (q00 << 8)
                             : -(((q00 << 7) - num) / (q00 << 8)));
  }

  // The output pass: the planes, colour conversion.
  void finish(Image* out) {
    if (lossless_ && space_ != CS_GREY && space_ != CS_RGB && space_ != CS_CMYK)
      fail(std::string("JPEG: a lossless file in ") + (space_ == CS_YCC ? "YCbCr" : "YCCK") +
           " is not decoded: libjpeg does not convert the colours of a lossless file");
    std::vector<std::vector<uint8_t>> full = planes();
    const ColourTables& tab = colour_tables();
    out->h = height_;
    out->w = width_;
    size_t npix = size_t(width_) * height_;
    out->rgb.resize(npix * 3);
    uint8_t* o = out->rgb.data();
    const uint8_t* lim = tab.sample_limit;
    switch (space_) {
      case CS_GREY:
        for (size_t i = 0; i < npix; ++i) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = full[0][i];
        break;
      case CS_RGB:
        for (size_t i = 0; i < npix; ++i)
          for (int k = 0; k < 3; ++k) o[3 * i + k] = full[k][i];
        break;
      case CS_YCC:
        for (size_t i = 0; i < npix; ++i) {
          int y = full[0][i], cb = full[1][i], cr = full[2][i];
          o[3 * i] = lim[y + tab.cr_r[cr]];
          o[3 * i + 1] = lim[y + int((tab.cb_g[cb] + tab.cr_g[cr]) >> 16)];
          o[3 * i + 2] = lim[y + tab.cb_b[cb]];
        }
        break;
      case CS_CMYK:
      case CS_YCCK:
        for (size_t i = 0; i < npix; ++i) {
          int cmyk[4];
          if (space_ == CS_YCCK) {
            int y = full[0][i], cb = full[1][i], cr = full[2][i];
            cmyk[0] = lim[255 - (y + tab.cr_r[cr])];
            cmyk[1] = lim[255 - (y + int((tab.cb_g[cb] + tab.cr_g[cr]) >> 16))];
            cmyk[2] = lim[255 - (y + tab.cb_b[cb])];
          } else {
            for (int k = 0; k < 3; ++k) cmyk[k] = full[k][i];
          }
          cmyk[3] = full[3][i];
          // PIL reads Adobe's inverted CMYK ("CMYK;I"), then cmyk2rgb
          ssr::pil_cmyk_to_rgb(uint8_t(255 - cmyk[0]), uint8_t(255 - cmyk[1]),
                               uint8_t(255 - cmyk[2]), uint8_t(255 - cmyk[3]), o + 3 * i);
        }
        break;
    }
  }

  // jdsample.c: the component's samples at full size, width_ x height_;
  // box replication where `fancy` is off.
  std::vector<uint8_t> upsample(const Component& c, const std::vector<uint8_t>& plane,
                                size_t stride, bool fancy) const {
    std::vector<uint8_t> out(size_t(width_) * height_);
    int hx = maxh_ / c.h, vx = maxv_ / c.v;
    bool h2 = c.h * 2 == maxh_, v1 = c.v == maxv_, v2 = c.v * 2 == maxv_;
    int dw = c.dw, dh = c.dh;
    auto row = [&](int y) {  // edge rows repeat, as libjpeg's context rows do
      return plane.data() + size_t(std::min(std::max(y, 0), dh - 1)) * stride;
    };
    if (c.h == maxh_ && v1) {
      for (int y = 0; y < height_; ++y)
        std::memcpy(out.data() + size_t(y) * width_, row(y), width_);
      return out;
    }
    std::vector<uint8_t> line(size_t(dw) * 2 + 2);
    if (fancy && h2 && v1 && dw > 2) {  // h2v1 fancy
      for (int y = 0; y < height_; ++y) {
        const uint8_t* in = row(y);
        uint8_t* o = line.data();
        int v = in[0];
        *o++ = uint8_t(v);
        *o++ = uint8_t((v * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          v = in[x] * 3;
          *o++ = uint8_t((v + in[x - 1] + 1) >> 2);
          *o++ = uint8_t((v + in[x + 1] + 2) >> 2);
        }
        v = in[dw - 1];
        *o++ = uint8_t((v * 3 + in[dw - 2] + 1) >> 2);
        *o++ = uint8_t(v);
        std::memcpy(out.data() + size_t(y) * width_, line.data(), width_);
      }
      return out;
    }
    if (fancy && c.h == maxh_ && v2) {  // h1v2 fancy
      for (int y = 0; y < height_; ++y) {
        int r = y >> 1;
        const uint8_t* in0 = row(r);
        const uint8_t* in1 = (y & 1) ? row(r + 1) : row(r - 1);
        int bias = (y & 1) ? 2 : 1;
        uint8_t* o = out.data() + size_t(y) * width_;
        for (int x = 0; x < width_; ++x) o[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
      }
      return out;
    }
    if (fancy && h2 && v2 && dw > 2) {  // h2v2 fancy
      for (int y = 0; y < height_; ++y) {
        int r = y >> 1;
        const uint8_t* in0 = row(r);
        const uint8_t* in1 = (y & 1) ? row(r + 1) : row(r - 1);
        uint8_t* o = line.data();
        int this_sum = in0[0] * 3 + in1[0];
        int next_sum = in0[1] * 3 + in1[1];
        *o++ = uint8_t((this_sum * 4 + 8) >> 4);
        *o++ = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 2; x < dw; ++x) {
          next_sum = in0[x] * 3 + in1[x];
          *o++ = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
          *o++ = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        *o++ = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
        *o++ = uint8_t((this_sum * 4 + 7) >> 4);
        std::memcpy(out.data() + size_t(y) * width_, line.data(), width_);
      }
      return out;
    }
    if (maxh_ % c.h || maxv_ % c.v)
      fail("JPEG: fractional sampling factors are not decoded");
    for (int y = 0; y < height_; ++y) {  // box replication (h2v1, h2v2, int_upsample)
      const uint8_t* in = row(y / vx);
      uint8_t* o = out.data() + size_t(y) * width_;
      for (int x = 0; x < width_; ++x) o[x] = in[x / hx];
    }
    return out;
  }

  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  bool tables_only_ = false;
  HuffTable dc_[4], ac_[4];
  Derived derived_dc_[4], derived_ac_[4];
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  int dc_l_[16], dc_u_[16], ac_k_[16];  // DAC conditioning
  int restart_interval_ = 0, next_restart_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = 0;
  bool sof_ = false, progressive_ = false, arith_ = false, lossless_ = false;
  bool single_scan_ = false;
  int scan_number_ = 0;
  int width_ = 0, height_ = 0, maxh_ = 1, maxv_ = 1, mcux_ = 0, mcuy_ = 0;
  std::vector<Component> comps_;
  ColourSpace space_ = CS_YCC;
};

// ================================================================ dispatch

// The kinds the library decodes, in the order of PIL's Image.ID (TGA, which
// has no magic, last); the numbers are ssr_image_kind's.
enum Kind { kNone, kPng, kJpeg, kWebp, kGif, kTiff, kPcx, kDcx, kDds, kQoi, kSgi, kTga, kPsd };

Kind image_kind(const uint8_t* data, size_t n) {
  if (n >= 8 && std::memcmp(data, kPngSignature, 8) == 0) return kPng;
  if (n >= 2 && data[0] == 0xFF && data[1] == 0xD8) return kJpeg;
  if (ssr::is_webp(data, n)) return kWebp;
  if (ssr::is_gif(data, n)) return kGif;
  if (ssr::is_tiff(data, n)) return kTiff;
  if (ssr::pcx_claims(data, n)) return kPcx;
  if (ssr::dcx_claims(data, n)) return kDcx;
  if (ssr::dds_claims(data, n)) return kDds;
  if (ssr::psd_claims(data, n)) return kPsd;
  if (ssr::qoi_claims(data, n)) return kQoi;
  if (ssr::sgi_claims(data, n)) return kSgi;
  if (ssr::tga_claims(data, n)) return kTga;
  return kNone;
}

void decode_bytes(const uint8_t* data, size_t n, int grey16, Image* out) {
  switch (image_kind(data, n)) {
    case kPng: decode_png(data, n, grey16, out); break;
    case kJpeg:
      // PIL identifies a JPEG file by FF D8 FF
      if (n < 3 || data[2] != 0xFF) fail("JPEG: not a JPEG file (no marker after SOI)");
      JpegDecoder(data, n).decode(out);
      break;
    case kWebp: ssr::decode_webp(data, n, out); break;
    case kGif: ssr::decode_gif(data, n, out); break;
    case kTiff: ssr::decode_tiff(data, n, out); break;
    case kPcx: ssr::decode_pcx(data, n, out); break;
    case kDcx: ssr::decode_dcx(data, n, out); break;
    case kDds: ssr::decode_dds(data, n, out); break;
    case kPsd: ssr::decode_psd(data, n, out); break;
    case kQoi: ssr::decode_qoi(data, n, out); break;
    case kSgi: ssr::decode_sgi(data, n, out); break;
    case kTga: ssr::decode_tga(data, n, out); break;
    default: fail("not a PNG, JPEG, WebP, GIF or TIFF file, nor a DDS, PSD, TGA, QOI, PCX, DCX or SGI one");
  }
}

void decode_file(const std::string& path, int grey16, Image* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) fail("could not open " + path);
  std::vector<uint8_t> data;
  uint8_t chunk[1 << 16];
  size_t got;
  while ((got = std::fread(chunk, 1, sizeof chunk, f)) > 0)
    data.insert(data.end(), chunk, chunk + got);
  bool err = std::ferror(f);
  std::fclose(f);
  if (err) fail("could not read " + path);
  decode_bytes(data.data(), data.size(), grey16, out);
}

thread_local std::string last_error;

// ---------------------------------------------------------------- threadpool

class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> task;
          {
            std::unique_lock<std::mutex> lock(mu_);
            cv_.wait(lock, [this] { return stop_ || !tasks_.empty(); });
            if (stop_ && tasks_.empty()) return;
            task = std::move(tasks_.front());
            tasks_.pop();
          }
          task();
        }
      });
    }
  }
  ~ThreadPool() {
    {
      std::lock_guard<std::mutex> lock(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void submit(std::function<void()> task) {
    {
      std::lock_guard<std::mutex> lock(mu_);
      tasks_.push(std::move(task));
    }
    cv_.notify_one();
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> tasks_;
  std::mutex mu_;
  std::condition_variable cv_;
  bool stop_;
};

// -------------------------------------------------------------------- loader

class Loader {
 public:
  Loader(int threads, size_t cache_bytes)
      : pool_(threads > 0 ? threads : int(std::max(2u, std::thread::hardware_concurrency()))),
        cache_limit_(cache_bytes) {}

  // The decoded image, from the cache or decoded now (16-bit grey as the
  // JAX loader reads it); nullptr with `error` set when it cannot be read.
  std::shared_ptr<Image> get(const std::string& path, std::string* error) {
    {
      std::lock_guard<std::mutex> lock(mu_);
      auto it = cache_.find(path);
      if (it != cache_.end()) {
        lru_.splice(lru_.begin(), lru_, it->second.second);
        return it->second.first;
      }
    }
    auto img = std::make_shared<Image>();
    try {
      decode_file(path, GREY16_HIGH_BYTE, img.get());
    } catch (const std::exception& e) {
      *error = e.what();
      return nullptr;
    }
    std::lock_guard<std::mutex> lock(mu_);
    auto it = cache_.find(path);
    if (it != cache_.end()) return it->second.first;  // raced; keep the first
    lru_.push_front(path);
    cache_[path] = {img, lru_.begin()};
    cache_bytes_ += img->bytes();
    while (cache_bytes_ > cache_limit_ && lru_.size() > 1) {
      const std::string& victim = lru_.back();
      auto vit = cache_.find(victim);
      cache_bytes_ -= vit->second.first->bytes();
      cache_.erase(vit);
      lru_.pop_back();
    }
    return img;
  }

  size_t cached_images() {
    std::lock_guard<std::mutex> lock(mu_);
    return cache_.size();
  }

  // Fill out[n, ph, pw, 3] with crop windows in parallel: T is float
  // (converted) or uint8_t (row copies). Returns the number of failures;
  // the first one's reason is in last_error.
  template <typename T>
  int load_crops(const char** paths, const int* tops, const int* lefts, int n, int ph, int pw,
                 T* out) {
    // Every task holds the batch's state, and counts itself done under its
    // lock, so the caller cannot return and free the state while a task
    // still touches it.
    struct Batch {
      std::mutex mu;
      std::condition_variable cv;
      int remaining;
      int failures = 0;
      std::string first_error;
    };
    auto batch = std::make_shared<Batch>();
    batch->remaining = n;
    for (int i = 0; i < n; ++i) {
      std::string path = paths[i];
      int top = tops[i], left = lefts[i];
      T* dst = out + size_t(i) * ph * pw * 3;
      pool_.submit([this, path, top, left, ph, pw, dst, batch] {
        std::string error;
        auto img = get(path, &error);
        if (img && (top < 0 || left < 0 || top + ph > img->h || left + pw > img->w))
          error = "crop (" + std::to_string(top) + ", " + std::to_string(left) + ") of " +
                  std::to_string(ph) + " x " + std::to_string(pw) + " lies outside the " +
                  std::to_string(img->h) + " x " + std::to_string(img->w) + " image " + path;
        if (error.empty()) {
          for (int y = 0; y < ph; ++y) {
            const uint8_t* src = img->rgb.data() + (size_t(top + y) * img->w + left) * 3;
            copy(src, dst + size_t(y) * pw * 3, size_t(pw) * 3);
          }
        }
        std::lock_guard<std::mutex> lock(batch->mu);
        if (!error.empty()) {
          ++batch->failures;
          if (batch->first_error.empty()) batch->first_error = error;
        }
        if (--batch->remaining == 0) batch->cv.notify_all();
      });
    }
    std::unique_lock<std::mutex> lock(batch->mu);
    batch->cv.wait(lock, [&batch] { return batch->remaining == 0; });
    last_error = batch->first_error;
    return batch->failures;
  }

  int image_size(const char* path, int* h, int* w) {
    std::string error;
    auto img = get(path, &error);
    if (!img) {
      last_error = error;
      return 1;
    }
    *h = img->h;
    *w = img->w;
    return 0;
  }

  template <typename T>
  int load_image(const char* path, T* out) {
    std::string error;
    auto img = get(path, &error);
    if (!img) {
      last_error = error;
      return 1;
    }
    copy(img->rgb.data(), out, img->rgb.size());
    return 0;
  }

 private:
  static void copy(const uint8_t* src, float* dst, size_t n) {
    for (size_t i = 0; i < n; ++i) dst[i] = float(src[i]);
  }
  static void copy(const uint8_t* src, uint8_t* dst, size_t n) { std::memcpy(dst, src, n); }

  ThreadPool pool_;
  size_t cache_limit_;
  size_t cache_bytes_ = 0;
  std::mutex mu_;
  std::list<std::string> lru_;
  std::unordered_map<std::string,
                     std::pair<std::shared_ptr<Image>, std::list<std::string>::iterator>>
      cache_;
};

}  // namespace

namespace ssr {

void decode_jpeg_segment(const uint8_t* tables, size_t tables_size, const uint8_t* d, size_t n,
                         bool ycbcr_to_rgb, JpegSegment* out) {
  try {
    JpegDecoder dec(d, n);
    if (tables_size) dec.load_tables(tables, tables_size);
    dec.decode_samples(ycbcr_to_rgb, &out->channels, &out->w, &out->h, &out->samples);
    out->sampling = dec.sampling();
  } catch (const DecodeError& e) {
    throw FormatError(std::string("TIFF: JPEG-in-TIFF: ") + e.what());
  }
}

}  // namespace ssr

extern "C" {

// the JAX loader's interface (simplesr_tpu/data/_native/loader.cpp)

void* ssr_create_loader(int num_threads, size_t cache_bytes) {
  return new Loader(num_threads, cache_bytes ? cache_bytes : (2ull << 30));
}

void ssr_destroy_loader(void* loader) { delete static_cast<Loader*>(loader); }

int ssr_image_size(void* loader, const char* path, int* h, int* w) {
  return static_cast<Loader*>(loader)->image_size(path, h, w);
}

int ssr_load_image(void* loader, const char* path, float* out) {
  return static_cast<Loader*>(loader)->load_image(path, out);
}

int ssr_load_crops(void* loader, const char** paths, const int* tops, const int* lefts, int n,
                   int ph, int pw, float* out) {
  return static_cast<Loader*>(loader)->load_crops(paths, tops, lefts, n, ph, pw, out);
}

int ssr_load_image_u8(void* loader, const char* path, uint8_t* out) {
  return static_cast<Loader*>(loader)->load_image(path, out);
}

int ssr_load_crops_u8(void* loader, const char** paths, const int* tops, const int* lefts,
                      int n, int ph, int pw, uint8_t* out) {
  return static_cast<Loader*>(loader)->load_crops(paths, tops, lefts, n, ph, pw, out);
}

// the port's additions

size_t ssr_cached_images(void* loader) { return static_cast<Loader*>(loader)->cached_images(); }

// Why the calling thread's last failed call failed.
const char* ssr_last_error(void) { return last_error.c_str(); }

// The encoder's refusals (jpeg_encode.cpp) go where ssr_last_error reads.
void ssr_set_last_error(const char* msg) { last_error = msg; }

// The kind of image bytes as decode_bytes reads them (the Kind numbers).
int ssr_image_kind(const uint8_t* data, size_t n) {
  try {
    return image_kind(data, n);
  } catch (const std::exception&) {  // the claims tests do not throw; were one to, no kind
    return kNone;
  }
}

// Decode PNG, JPEG, WebP, GIF, TIFF, PCX, DCX, DDS, QOI, SGI or TGA bytes to
// uint8 RGB in a buffer of malloc's, which the caller frees with ssr_free.
// grey16: 0 the loader's high byte, 1 PIL's clip.
// Returns 0, or 1 with the reason in ssr_last_error.
int ssr_decode_image(const uint8_t* data, size_t n, int grey16, int* h, int* w,
                     uint8_t** out) {
  *out = nullptr;
  try {
    Image img;
    decode_bytes(data, n, grey16, &img);
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(std::max<size_t>(img.rgb.size(), 1)));
    if (!buf) fail("out of memory");
    std::memcpy(buf, img.rgb.data(), img.rgb.size());
    *h = img.h;
    *w = img.w;
    *out = buf;
    return 0;
  } catch (const std::exception& e) {
    last_error = e.what();
    return 1;
  }
}

void ssr_free(uint8_t* p) { std::free(p); }

}  // extern "C"
