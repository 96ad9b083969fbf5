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
//   - JPEG as libjpeg-turbo with PIL's settings: Huffman-coded baseline,
//     extended and progressive 8-bit files, the ISLOW integer IDCT
//     (jidctint.c) as its x86 SIMD code computes it, fancy upsampling
//     (jdsample.c), the fixed-point YCbCr->RGB tables (jdcolor.c); CMYK and
//     YCCK as PIL converts them.
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
const char* kUnsupportedItem = "ROADMAP.md, Queue 1, JPEG variants";

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

void make_derived(const HuffTable& t, bool is_dc, int index, Derived* d) {
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
  if (is_dc)
    for (int i = 0; i < numsymbols; ++i)
      if (t.vals[i] > 15) fail("JPEG: bogus Huffman table definition");
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
  uint16_t quant[64];
  int coef_bits[64];
  std::vector<int16_t> coefs;  // bhp * bwp blocks of 64, natural order
  int16_t* block(int bx, int by) { return coefs.data() + (size_t(by) * bwp + bx) * 64; }
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
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) fail("JPEG: not a JPEG file");
    pos_ = 2;
    int marker = next_marker();
    bool first_scan = true;
    for (;;) {
      switch (marker) {
        case 0xC0: case 0xC1: case 0xC2:
          read_sof(marker == 0xC2);
          break;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC9: case 0xCA: case 0xCB:
        case 0xCD: case 0xCE: case 0xCF:
          fail(std::string("JPEG: ") + sof_kind(marker) + " (SOF" +
               std::to_string(marker - 0xC0) + ") is not decoded (" + kUnsupportedItem + ")");
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
          if (first_scan) fail("JPEG: no image (EOI before any scan)");
          finish(out);
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

 private:
  static const char* sof_kind(int m) {
    switch (m) {
      case 0xC3: return "lossless JPEG";
      case 0xC5: case 0xC6: case 0xC7: return "hierarchical JPEG";
      case 0xCB: return "lossless arithmetic-coded JPEG";
      case 0xCD: case 0xCE: case 0xCF: return "hierarchical arithmetic-coded JPEG";
      default: return "arithmetic-coded JPEG";
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

  // get_dac: arithmetic-coding conditioning, validated and unused
  void read_dac() {
    long length = two_bytes() - 2;
    while (length > 0) {
      int index = byte(), value = byte();
      length -= 2;
      if (index >= 32) fail("JPEG: bogus DAC index " + std::to_string(index));
      if (index < 16 && (value & 0x0F) > (value >> 4))
        fail("JPEG: bogus DAC value " + std::to_string(value));
    }
    if (length != 0) fail("JPEG: bogus marker length (DAC)");
  }

  void read_dri() {
    if (two_bytes() != 4) fail("JPEG: bogus marker length (DRI)");
    restart_interval_ = two_bytes();
  }

  void read_sof(bool progressive) {
    long length = two_bytes();
    int precision = byte();
    height_ = two_bytes();
    width_ = two_bytes();
    int nc = byte();
    length -= 8;
    if (sof_) fail("JPEG: invalid structure (two SOF markers)");
    if (height_ <= 0 || width_ <= 0 || nc <= 0) fail("JPEG: empty image");
    if (length != nc * 3) fail("JPEG: bogus marker length (SOF)");
    if (precision == 12)
      fail(std::string("JPEG: 12-bit samples are not decoded (") + kUnsupportedItem + ")");
    if (precision != 8) fail("JPEG: unsupported data precision " + std::to_string(precision));
    comps_.assign(nc, Component());
    for (int i = 0; i < nc; ++i) {
      comps_[i].id = byte();
      int c = byte();
      comps_[i].h = (c >> 4) & 15;
      comps_[i].v = c & 15;
      comps_[i].tq = byte();
    }
    progressive_ = progressive;
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
    mcux_ = (width_ + 8 * maxh_ - 1) / (8 * maxh_);
    mcuy_ = (height_ + 8 * maxv_ - 1) / (8 * maxv_);
    for (auto& c : comps_) {
      c.bw = int((int64_t(width_) * c.h + 8 * maxh_ - 1) / (8 * maxh_));
      c.bh = int((int64_t(height_) * c.v + 8 * maxv_ - 1) / (8 * maxv_));
      c.dw = int((int64_t(width_) * c.h + maxh_ - 1) / maxh_);
      c.dh = int((int64_t(height_) * c.v + maxv_ - 1) / maxv_);
      c.bwp = std::max(mcux_ * c.h, c.bw);
      c.bhp = std::max(mcuy_ * c.v, c.bh);
      c.coefs.assign(size_t(c.bwp) * c.bhp * 64, 0);
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
        space_ = (a == 82 && b == 71 && c == 66) ? CS_RGB : CS_YCC;
      }
    } else {
      space_ = (adobe_ && adobe_transform_ != 0) ? CS_YCCK : CS_CMYK;
    }
    // the standard Huffman tables in the slots the file left empty
    read_dht(true, kStdHuffman, sizeof kStdHuffman);
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
      scan[i] = found;
    }
    int ss = byte(), se = byte(), a = byte();
    int ah = (a >> 4) & 15, al = a & 15;
    ++scan_number_;
    if (scan_number_ == 1) single_scan_ = !progressive_ && ns == int(comps_.size());
    // latch the quantisation tables (jdinput.c latch_quant_tables)
    for (int i = 0; i < ns; ++i) {
      Component* c = scan[i];
      if (c->latched) continue;
      if (c->tq >= 4 || !qt_defined_[c->tq])
        fail("JPEG: quantisation table 0x" + std::to_string(c->tq) + " was not defined");
      std::memcpy(c->quant, qt_[c->tq], sizeof c->quant);
      c->latched = true;
    }
    int blocks = 0;
    for (int i = 0; i < ns; ++i) blocks += ns == 1 ? 1 : scan[i]->h * scan[i]->v;
    if (blocks > 10) fail("JPEG: sampling factors too large for an interleaved scan");

    Derived* dc[4] = {nullptr, nullptr, nullptr, nullptr};
    Derived* ac[4] = {nullptr, nullptr, nullptr, nullptr};
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
    }
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

    int mcus_x, mcus_y;
    if (ns == 1) {
      mcus_x = scan[0]->bw;
      mcus_y = scan[0]->bh;
    } else {
      mcus_x = mcux_;
      mcus_y = mcuy_;
    }
    BitReader br{d_, n_, pos_};
    br.reset(pos_);
    int last_dc[4] = {0, 0, 0, 0};
    int eobrun = 0;
    int restarts_to_go = restart_interval_;
    int next_restart = 0;
    for (int my = 0; my < mcus_y; ++my) {
      for (int mx = 0; mx < mcus_x; ++mx) {
        if (restart_interval_) {
          if (restarts_to_go == 0) {
            // process_restart: the segment must end with the next RSTn
            int m = br.marker;
            if (m < 0) {
              pos_ = br.pos;
              m = next_marker();
            } else {
              pos_ = br.pos;
            }
            if (m != 0xD0 + next_restart)
              fail("JPEG: corrupt data (restart marker out of sequence)");
            next_restart = (next_restart + 1) & 7;
            br.reset(pos_);
            last_dc[0] = last_dc[1] = last_dc[2] = last_dc[3] = 0;
            eobrun = 0;
            restarts_to_go = restart_interval_;
          }
          --restarts_to_go;
        }
        for (int i = 0; i < ns; ++i) {
          Component* c = scan[i];
          int bh = ns == 1 ? 1 : c->v, bwn = ns == 1 ? 1 : c->h;
          for (int y = 0; y < bh; ++y)
            for (int x = 0; x < bwn; ++x) {
              int16_t* blk = ns == 1 ? c->block(mx, my) : c->block(mx * c->h + x, my * c->v + y);
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
            }
        }
      }
    }
    pos_ = br.pos;
    if (br.marker >= 0) return br.marker;
    return next_marker();
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

  // The output pass: IDCT, upsampling, colour conversion.
  void finish(Image* out) {
    if (smoothing_applies())
      fail(std::string("JPEG: a progressive file whose scans leave coefficients unrefined "
                       "(libjpeg's block smoothing) is not decoded (") + kUnsupportedItem + ")");
    const ColourTables& tab = colour_tables();
    int nc = int(comps_.size());
    std::vector<std::vector<uint8_t>> full(nc);
    for (int ci = 0; ci < nc; ++ci) {
      Component& c = comps_[ci];
      size_t stride = size_t(c.bw) * 8;
      std::vector<uint8_t> plane(stride * size_t(c.bh) * 8);
      int16_t q[64];
      for (int i = 0; i < 64; ++i) q[i] = int16_t(c.quant[i]);
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(c.block(bx, by), q, plane.data() + size_t(by) * 8 * stride + bx * 8, stride);
      full[ci] = upsample(c, plane, stride);
    }
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
          int nk = cmyk[3];  // 255 - (255 - k)
          for (int k = 0; k < 3; ++k) {
            int inv = 255 - cmyk[k];
            int t = inv * nk + 128;
            int v = nk - (((t >> 8) + t) >> 8);
            o[3 * i + k] = uint8_t(std::min(255, std::max(0, v)));
          }
        }
        break;
    }
  }

  // jdsample.c: the component's samples at full size, width_ x height_.
  std::vector<uint8_t> upsample(const Component& c, const std::vector<uint8_t>& plane,
                                size_t stride) const {
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
    if (h2 && v1 && dw > 2) {  // h2v1 fancy
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
    if (c.h == maxh_ && v2) {  // h1v2 fancy
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
    if (h2 && v2 && dw > 2) {  // h2v2 fancy
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
  HuffTable dc_[4], ac_[4];
  Derived derived_dc_[4], derived_ac_[4];
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  int restart_interval_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = 0;
  bool sof_ = false, progressive_ = false, single_scan_ = false;
  int scan_number_ = 0;
  int width_ = 0, height_ = 0, maxh_ = 1, maxv_ = 1, mcux_ = 0, mcuy_ = 0;
  std::vector<Component> comps_;
  ColourSpace space_ = CS_YCC;
};

// ================================================================ dispatch

void decode_bytes(const uint8_t* data, size_t n, int grey16, Image* out) {
  if (n >= 8 && std::memcmp(data, kPngSignature, 8) == 0) {
    decode_png(data, n, grey16, out);
  } else if (n >= 2 && data[0] == 0xFF && data[1] == 0xD8) {
    JpegDecoder(data, n).decode(out);
  } else if (ssr::is_webp(data, n)) {
    ssr::decode_webp(data, n, out);
  } else if (ssr::is_gif(data, n)) {
    ssr::decode_gif(data, n, out);
  } else if (ssr::is_tiff(data, n)) {
    ssr::decode_tiff(data, n, out);
  } else {
    fail("not a PNG, JPEG, WebP, GIF or TIFF file");
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

// Decode PNG, JPEG, WebP, GIF or TIFF bytes to uint8 RGB in a buffer of
// malloc's, which the caller frees with ssr_free. grey16: 0 the loader's high
// byte, 1 PIL's clip.
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
