// DDS decoder of the port: the first surface (mip 0, the first face or array
// slice) of a DirectDraw Surface file, to RGB as PIL 12.1 gives it through
// Image.open(...).convert("RGB") (DdsImagePlugin.py, and for the block
// formats Pillow's BcnDecode.c).
//
//   - Uncompressed RGB and RGBA with any masks, each channel scaled as PIL's
//     DdsRgbDecoder scales it (the field over its largest value, times 255,
//     truncated); a surface that ends early reads zeros, as that decoder
//     reads it. Luminance (L, LA) and 8-bit palettes (an RGBA palette of 256
//     entries after the header).
//   - The FourCC formats DXT1, DXT3, DXT5, BC4 (BC4U, ATI1), BC5 (BC5U, ATI2)
//     and BC5S, and the DX10 header's R8G8B8A8, BC1 to BC5, BC6H (UF16, SF16)
//     and BC7, as BcnDecode.c decodes them: BC1's three-colour mode with
//     black, BC2 and BC3 colour blocks always in four-colour mode, BC4 and BC5
//     channels through the BC3 alpha ramp (BC5S's signed bytes moved up by
//     128), BC5's blue 0 (BC5S's 128), BC6H's endpoints unquantized and
//     interpolated as integers, then each half float cut to [0, 1] and times
//     255 truncated, BC7's eight modes with their partitions, anchors,
//     p-bits, rotations and index selection. Reserved BC6H modes and BC7's
//     empty mode read black. Two of BcnDecode.c's readings of the signed
//     BC6H format are kept, found against PIL on seeded random blocks: the
//     transformed modes' endpoints stay unsigned after the deltas are added
//     (so a negative one reads as bright), and the 16-bit mode's endpoints
//     are unquantized as the unsigned 16 bits they are stored in.
//
// What PIL refuses is refused; what PIL's open-time checks reject as "not a
// DDS file" (a file of fewer than 8 bytes, a DX10 header cut short, an empty
// image) is not claimed (dds_claims), so that loader.cpp's dispatch goes on
// as Image.open does.

#include <cstring>

#include "formats.h"

namespace ssr {
namespace {

const char* kFmt = "DDS";

[[noreturn]] void fail(const std::string& msg) { format_fail(kFmt, msg); }

uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24);
}

constexpr uint32_t fourcc(const char* s) {
  return uint32_t(uint8_t(s[0])) | (uint32_t(uint8_t(s[1])) << 8) |
         (uint32_t(uint8_t(s[2])) << 16) | (uint32_t(uint8_t(s[3])) << 24);
}

// DDPF flags, in the order PIL tests them
constexpr uint32_t kAlphaPixels = 0x1, kFourCC = 0x4, kPalette8 = 0x20, kRgb = 0x40,
                   kLuminance = 0x20000;
constexpr size_t kHeader = 128, kDx10Header = 20;

enum class Layout { kMasks, kL, kLA, kPalette, kRgba8, kBcn };

struct Header {
  uint32_t width = 0, height = 0;
  Layout layout = Layout::kMasks;
  int bcn = 0;          // 1 to 7, PIL's n
  bool sign = false;    // BC5S, BC6H SF16
  uint32_t bitcount = 0;
  uint32_t masks[4] = {0, 0, 0, 0};
  int mask_count = 0;
  size_t data = kHeader;  // where the surface begins
};

// Parses the header as DdsImageFile._open does. Returns false where PIL's
// open raises an error that Image.open takes as "not this format".
bool parse(const uint8_t* d, size_t n, Header* h) {
  if (n < 8 || std::memcmp(d, "DDS ", 4) != 0) return false;
  const uint32_t header_size = le32(d + 4);
  if (header_size != 124) fail("unsupported header size " + std::to_string(header_size));
  if (n < kHeader) fail("incomplete header");
  h->height = le32(d + 12);
  h->width = le32(d + 16);
  const uint32_t pfflags = le32(d + 80), code = le32(d + 84);
  h->bitcount = le32(d + 88);
  if (pfflags & kRgb) {
    h->layout = Layout::kMasks;
    h->mask_count = (pfflags & kAlphaPixels) ? 4 : 3;
    for (int i = 0; i < h->mask_count; ++i) h->masks[i] = le32(d + 92 + 4 * i);
  } else if (pfflags & kLuminance) {
    if (h->bitcount == 8)
      h->layout = Layout::kL;
    else if (h->bitcount == 16 && (pfflags & kAlphaPixels))
      h->layout = Layout::kLA;
    else
      fail("unsupported luminance bit count " + std::to_string(h->bitcount));
  } else if (pfflags & kPalette8) {
    h->layout = Layout::kPalette;
    h->data = kHeader + std::min<size_t>(1024, n - kHeader);
  } else if (pfflags & kFourCC) {
    h->layout = Layout::kBcn;
    if (code == fourcc("DXT1")) {
      h->bcn = 1;
    } else if (code == fourcc("DXT3")) {
      h->bcn = 2;
    } else if (code == fourcc("DXT5")) {
      h->bcn = 3;
    } else if (code == fourcc("BC4U") || code == fourcc("ATI1")) {
      h->bcn = 4;
    } else if (code == fourcc("BC5S")) {
      h->bcn = 5, h->sign = true;
    } else if (code == fourcc("BC5U") || code == fourcc("ATI2")) {
      h->bcn = 5;
    } else if (code == fourcc("DX10")) {
      if (n < kHeader + 4) return false;  // PIL's struct.error
      const uint32_t dxgi = le32(d + kHeader);
      h->data = kHeader + kDx10Header;
      switch (dxgi) {
        case 70: case 71: h->bcn = 1; break;                   // BC1
        case 73: case 74: h->bcn = 2; break;                   // BC2
        case 76: case 77: h->bcn = 3; break;                   // BC3
        case 79: case 80: h->bcn = 4; break;                   // BC4
        case 82: case 83: h->bcn = 5; break;                   // BC5
        case 84: h->bcn = 5, h->sign = true; break;            // BC5_SNORM
        case 95: h->bcn = 6; break;                            // BC6H_UF16
        case 96: h->bcn = 6, h->sign = true; break;            // BC6H_SF16
        case 97: case 98: case 99: h->bcn = 7; break;          // BC7
        case 27: case 28: case 29: h->layout = Layout::kRgba8; break;  // R8G8B8A8
        default:
          fail("DXGI format " + std::to_string(dxgi) + " is not supported (PIL refuses it "
               "too)");
      }
    } else {
      std::string name;
      for (int i = 0; i < 4; ++i) {
        const char c = char((code >> (8 * i)) & 0xFF);
        name += (c >= 32 && c < 127) ? std::string(1, c) : "\\x" + std::to_string(int(c));
      }
      fail("pixel format '" + name + "' (" + std::to_string(code) +
           ") is not supported (PIL refuses it too)");
    }
  } else {
    fail("unknown pixel format flags " + std::to_string(pfflags) + " (PIL refuses them too)");
  }
  return h->width > 0 && h->height > 0;  // an empty image is not PIL's DDS
}

// ------------------------------------------------------------ BC1 to BC5

struct Rgba {
  uint8_t r, g, b, a;
};

Rgba decode_565(uint16_t x) {
  int r = (x & 0xf800) >> 8, g = (x & 0x7e0) >> 3, b = (x & 0x1f) << 3;
  return {uint8_t(r | (r >> 5)), uint8_t(g | (g >> 6)), uint8_t(b | (b >> 5)), 255};
}

void bc1_colour(Rgba* col, const uint8_t* s, bool four_colour) {
  const uint16_t c0 = s[0] | (s[1] << 8), c1 = s[2] | (s[3] << 8);
  const uint32_t lut = le32(s + 4);
  Rgba p[4] = {decode_565(c0), decode_565(c1), {}, {}};
  const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || four_colour) {
    p[2] = {uint8_t((2 * r0 + r1) / 3), uint8_t((2 * g0 + g1) / 3), uint8_t((2 * b0 + b1) / 3),
            255};
    p[3] = {uint8_t((r0 + 2 * r1) / 3), uint8_t((g0 + 2 * g1) / 3), uint8_t((b0 + 2 * b1) / 3),
            255};
  } else {
    p[2] = {uint8_t((r0 + r1) / 2), uint8_t((g0 + g1) / 2), uint8_t((b0 + b1) / 2), 255};
    p[3] = {0, 0, 0, 0};
  }
  for (int i = 0; i < 16; ++i) col[i] = p[(lut >> (2 * i)) & 3];
}

// BC3's alpha ramp into byte `o` of each 4-byte pixel; signed endpoints (BC5S)
// are moved up by 128 first.
void bc3_ramp(uint8_t* dst, int stride, const uint8_t* s, bool sign) {
  int a0 = s[0], a1 = s[1];
  if (sign) a0 = int8_t(s[0]) + 128, a1 = int8_t(s[1]) + 128;
  int a[8] = {a0, a1};
  if (a0 > a1) {
    for (int k = 1; k <= 6; ++k) a[k + 1] = ((7 - k) * a0 + k * a1) / 7;
  } else {
    for (int k = 1; k <= 4; ++k) a[k + 1] = ((5 - k) * a0 + k * a1) / 5;
    a[6] = 0, a[7] = 255;
  }
  const uint32_t lut1 = s[2] | (s[3] << 8) | (s[4] << 16), lut2 = s[5] | (s[6] << 8) |
                                                                (s[7] << 16);
  for (int i = 0; i < 8; ++i) dst[stride * i] = uint8_t(a[(lut1 >> (3 * i)) & 7]);
  for (int i = 0; i < 8; ++i) dst[stride * (8 + i)] = uint8_t(a[(lut2 >> (3 * i)) & 7]);
}

// ------------------------------------------------------------------ BC7

uint32_t get_bits(const uint8_t* s, int bit, int count) {
  if (!count) return 0;
  const int by = bit >> 3;
  bit &= 7;
  const uint32_t x = (bit + count <= 8) ? s[by] : (s[by] | (s[by + 1] << 8));
  return (x >> bit) & ((1u << count) - 1);
}

// the subset of each pixel: two subsets as bit masks, three as rows
const uint16_t kPartition2[64] = {
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80, 0xC800, 0xFFEC, 0xFE80,
    0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000, 0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310,
    0x3100, 0x8CCE, 0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C, 0xAAAA,
    0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A, 0x73CE, 0x13C8, 0x324C, 0x3BDC,
    0x6996, 0xC33C, 0x9966, 0x0660, 0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6,
    0x639C, 0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22};

const char* const kPartition3[64] = {
    "0011001102212222", "0001001122112221", "0000200122112211", "0222002200110111",
    "0000000011221122", "0011001100220022", "0022002211111111", "0011001122112211",
    "0000000011112222", "0000111111112222", "0000111122222222", "0012001200120012",
    "0112011201120112", "0122012201220122", "0011011211221222", "0011200122002220",
    "0001001101121122", "0111001120012200", "0000112211221122", "0022002200221111",
    "0111011102220222", "0001000122212221", "0000001101220122", "0000110022102210",
    "0122012200110000", "0012001211222222", "0110122112210110", "0000011012211221",
    "0022110211020022", "0110011020022222", "0011012201220011", "0000200022112221",
    "0000000211221222", "0222002200120011", "0011001200220222", "0120012001200120",
    "0000111122220000", "0120120120120120", "0120201212010120", "0011220011220011",
    "0011112222000011", "0101010122222222", "0000000021212121", "0022112200221122",
    "0022001100220011", "0220122102201221", "0101222222220101", "0000212121212121",
    "0101010101012222", "0222011102220111", "0002111200021112", "0000211221122112",
    "0222011101110222", "0002111211120002", "0110011001102222", "0000000021122112",
    "0110011022222222", "0022001100110022", "0022112211220022", "0000000000002112",
    "0002000100020001", "0222122202221222", "0101222222222222", "0111201122012220"};

const uint8_t kAnchor2[64] = {15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
                              15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
                              15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
                              6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t kAnchor3a[64] = {3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
                               3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
                               8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
                               3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t kAnchor3b[64] = {15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
                               15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
                               15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
                               15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};

int subset(int ns, int partition, int i) {
  if (ns == 2) return (kPartition2[partition] >> i) & 1;
  if (ns == 3) return kPartition3[partition][i] - '0';
  return 0;
}

const int kWeights2[4] = {0, 21, 43, 64};
const int kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const int kWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const int* weights(int bits) {
  return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4;
}

struct Bc7Mode {
  int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode kBc7[8] = {{3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
                         {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
                         {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
                         {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

int expand_quantized(int v, int bits) {
  v = (v << (8 - bits)) & 0xFF;
  return v | (v >> bits);
}

bool is_anchor(int ns, int partition, int i) {
  if (i == 0) return true;
  if (ns == 2) return i == kAnchor2[partition];
  if (ns == 3) return i == kAnchor3a[partition] || i == kAnchor3b[partition];
  return false;
}

void bc7_block(Rgba* col, const uint8_t* s) {
  if (!s[0]) {  // no mode bit: PIL's black
    for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 255};
    return;
  }
  int mode = 0;
  while (!(s[0] & (1 << mode))) ++mode;
  int bit = mode + 1;
  const Bc7Mode& m = kBc7[mode];
  auto load = [&](int count) {
    const uint32_t v = get_bits(s, bit, count);
    bit += count;
    return int(v);
  };
  const int partition = load(m.pb), rotation = load(m.rb), index_sel = load(m.isb);
  const int numep = m.ns * 2;
  int ep[6][4];
  for (int c = 0; c < 3; ++c)
    for (int i = 0; i < numep; ++i) ep[i][c] = load(m.cb);
  for (int i = 0; i < numep; ++i) ep[i][3] = m.ab ? load(m.ab) : 255;
  int cb = m.cb, ab = m.ab;
  if (m.epb) {
    ++cb;
    if (ab) ++ab;
    for (int i = 0; i < numep; ++i) {
      const int p = load(1);
      for (int c = 0; c < (m.ab ? 4 : 3); ++c) ep[i][c] = ((ep[i][c] << 1) | p) & 0xFF;
    }
  }
  if (m.spb) {
    ++cb;
    if (ab) ++ab;
    for (int i = 0; i < numep; i += 2) {
      const int p = load(1);
      for (int j = 0; j < 2; ++j)
        for (int c = 0; c < (m.ab ? 4 : 3); ++c) ep[i + j][c] = ((ep[i + j][c] << 1) | p) & 0xFF;
    }
  }
  for (int i = 0; i < numep; ++i) {
    for (int c = 0; c < 3; ++c) ep[i][c] = expand_quantized(ep[i][c], cb);
    if (ab) ep[i][3] = expand_quantized(ep[i][3], ab);
  }
  const int* cw = weights(m.ib);
  const int* aw = weights((m.ab && m.ib2) ? m.ib2 : m.ib);
  int cibit = bit, aibit = bit + 16 * m.ib - m.ns;
  for (int i = 0; i < 16; ++i) {
    const int* e0 = ep[subset(m.ns, partition, i) * 2];
    const int* e1 = e0 + 4;
    const int ib = m.ib - is_anchor(m.ns, partition, i);
    const int i0 = int(get_bits(s, cibit, ib));
    cibit += ib;
    int sc = cw[i0], sa = cw[i0];
    if (m.ab && m.ib2) {
      const int ib2 = m.ib2 - (i == 0);
      const int i1 = int(get_bits(s, aibit, ib2));
      aibit += ib2;
      if (index_sel)
        sc = aw[i1], sa = cw[i0];
      else
        sc = cw[i0], sa = aw[i1];
    }
    uint8_t v[4];
    for (int c = 0; c < 4; ++c) {
      const int w = c < 3 ? sc : sa;
      v[c] = uint8_t(((64 - w) * e0[c] + w * e1[c] + 32) >> 6);
    }
    if (rotation) std::swap(v[rotation - 1], v[3]);
    col[i] = {v[0], v[1], v[2], v[3]};
  }
}

// ----------------------------------------------------------------- BC6H

// the fields of the endpoints: w, x (subset 0), y, z (subset 1), each r g b
enum { RW, GW, BW, RX, GX, BX, RY, GY, BY, RZ, GZ, BZ };

struct Bc6Mode {
  int ns, tr, epb, rb, gb, bb;
  // the header's bits after the mode, as runs {field, first bit, last bit}
  // in stream order (a run counts down where first > last)
  int runs[40][3];
};

// clang-format off
const Bc6Mode kBc6[14] = {
    {2, 1, 10, 5, 5, 5, {{GY, 4, 4}, {BY, 4, 4}, {BZ, 4, 4}, {RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9},
     {RX, 0, 4}, {GZ, 4, 4}, {GY, 0, 3}, {GX, 0, 4}, {BZ, 0, 0}, {GZ, 0, 3}, {BX, 0, 4},
     {BZ, 1, 1}, {BY, 0, 3}, {RY, 0, 4}, {BZ, 2, 2}, {RZ, 0, 4}, {BZ, 3, 3}, {-1}}},
    {2, 1, 7, 6, 6, 6, {{GY, 5, 5}, {GZ, 4, 5}, {RW, 0, 6}, {BZ, 0, 1}, {BY, 4, 4}, {GW, 0, 6},
     {BY, 5, 5}, {BZ, 2, 2}, {GY, 4, 4}, {BW, 0, 6}, {BZ, 3, 3}, {BZ, 5, 5}, {BZ, 4, 4},
     {RX, 0, 5}, {GY, 0, 3}, {GX, 0, 5}, {GZ, 0, 3}, {BX, 0, 5}, {BY, 0, 3}, {RY, 0, 5},
     {RZ, 0, 5}, {-1}}},
    {2, 1, 11, 5, 4, 4, {{RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 4}, {RW, 10, 10},
     {GY, 0, 3}, {GX, 0, 3}, {GW, 10, 10}, {BZ, 0, 0}, {GZ, 0, 3}, {BX, 0, 3}, {BW, 10, 10},
     {BZ, 1, 1}, {BY, 0, 3}, {RY, 0, 4}, {BZ, 2, 2}, {RZ, 0, 4}, {BZ, 3, 3}, {-1}}},
    {2, 1, 11, 4, 5, 4, {{RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 3}, {RW, 10, 10},
     {GZ, 4, 4}, {GY, 0, 3}, {GX, 0, 4}, {GW, 10, 10}, {GZ, 0, 3}, {BX, 0, 3}, {BW, 10, 10},
     {BZ, 1, 1}, {BY, 0, 3}, {RY, 0, 3}, {BZ, 0, 0}, {BZ, 2, 2}, {RZ, 0, 3}, {GY, 4, 4},
     {BZ, 3, 3}, {-1}}},
    {2, 1, 11, 4, 4, 5, {{RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 3}, {RW, 10, 10},
     {BY, 4, 4}, {GY, 0, 3}, {GX, 0, 3}, {GW, 10, 10}, {BZ, 0, 0}, {GZ, 0, 3}, {BX, 0, 4},
     {BW, 10, 10}, {BY, 0, 3}, {RY, 0, 3}, {BZ, 1, 2}, {RZ, 0, 3}, {BZ, 4, 4}, {BZ, 3, 3},
     {-1}}},
    {2, 1, 9, 5, 5, 5, {{RW, 0, 8}, {BY, 4, 4}, {GW, 0, 8}, {GY, 4, 4}, {BW, 0, 8}, {BZ, 4, 4},
     {RX, 0, 4}, {GZ, 4, 4}, {GY, 0, 3}, {GX, 0, 4}, {BZ, 0, 0}, {GZ, 0, 3}, {BX, 0, 4},
     {BZ, 1, 1}, {BY, 0, 3}, {RY, 0, 4}, {BZ, 2, 2}, {RZ, 0, 4}, {BZ, 3, 3}, {-1}}},
    {2, 1, 8, 6, 5, 5, {{RW, 0, 7}, {GZ, 4, 4}, {BY, 4, 4}, {GW, 0, 7}, {BZ, 2, 2}, {GY, 4, 4},
     {BW, 0, 7}, {BZ, 3, 4}, {RX, 0, 5}, {GY, 0, 3}, {GX, 0, 4}, {BZ, 0, 0}, {GZ, 0, 3},
     {BX, 0, 4}, {BZ, 1, 1}, {BY, 0, 3}, {RY, 0, 5}, {RZ, 0, 5}, {-1}}},
    {2, 1, 8, 5, 6, 5, {{RW, 0, 7}, {BZ, 0, 0}, {BY, 4, 4}, {GW, 0, 7}, {GY, 5, 5}, {GY, 4, 4},
     {BW, 0, 7}, {GZ, 5, 5}, {BZ, 4, 4}, {RX, 0, 4}, {GZ, 4, 4}, {GY, 0, 3}, {GX, 0, 5},
     {GZ, 0, 3}, {BX, 0, 4}, {BZ, 1, 1}, {BY, 0, 3}, {RY, 0, 4}, {BZ, 2, 2}, {RZ, 0, 4},
     {BZ, 3, 3}, {-1}}},
    {2, 1, 8, 5, 5, 6, {{RW, 0, 7}, {BZ, 1, 1}, {BY, 4, 4}, {GW, 0, 7}, {BY, 5, 5}, {GY, 4, 4},
     {BW, 0, 7}, {BZ, 5, 5}, {BZ, 4, 4}, {RX, 0, 4}, {GZ, 4, 4}, {GY, 0, 3}, {GX, 0, 4},
     {BZ, 0, 0}, {GZ, 0, 3}, {BX, 0, 5}, {BY, 0, 3}, {RY, 0, 4}, {BZ, 2, 2}, {RZ, 0, 4},
     {BZ, 3, 3}, {-1}}},
    {2, 0, 6, 6, 6, 6, {{RW, 0, 5}, {GZ, 4, 4}, {BZ, 0, 1}, {BY, 4, 4}, {GW, 0, 5}, {GY, 5, 5},
     {BY, 5, 5}, {BZ, 2, 2}, {GY, 4, 4}, {BW, 0, 5}, {GZ, 5, 5}, {BZ, 3, 3}, {BZ, 5, 5},
     {BZ, 4, 4}, {RX, 0, 5}, {GY, 0, 3}, {GX, 0, 5}, {GZ, 0, 3}, {BX, 0, 5}, {BY, 0, 3},
     {RY, 0, 5}, {RZ, 0, 5}, {-1}}},
    {1, 0, 10, 10, 10, 10, {{RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 9}, {GX, 0, 9},
     {BX, 0, 9}, {-1}}},
    {1, 1, 11, 9, 9, 9, {{RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 8}, {RW, 10, 10},
     {GX, 0, 8}, {GW, 10, 10}, {BX, 0, 8}, {BW, 10, 10}, {-1}}},
    {1, 1, 12, 8, 8, 8, {{RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 7}, {RW, 11, 10},
     {GX, 0, 7}, {GW, 11, 10}, {BX, 0, 7}, {BW, 11, 10}, {-1}}},
    {1, 1, 16, 4, 4, 4, {{RW, 0, 9}, {GW, 0, 9}, {BW, 0, 9}, {RX, 0, 3}, {RW, 15, 10},
     {GX, 0, 3}, {GW, 15, 10}, {BX, 0, 3}, {BW, 15, 10}, {-1}}},
};
// clang-format on

int sign_extend(int v, int bits) {
  v &= (1 << bits) - 1;
  return (v & (1 << (bits - 1))) ? v - (1 << bits) : v;
}

int bc6_unquantize(int v, int bits, bool sign) {
  if (!sign) {
    if (bits >= 15) return v;
    if (v == 0) return 0;
    if (v == (1 << bits) - 1) return 0xFFFF;
    return ((v << 16) + 0x8000) >> bits;
  }
  if (bits >= 16) return v & 0xFFFF;  // BcnDecode.c returns the stored 16 bits unsigned
  int x = v, s = 0;
  if (x < 0) s = 1, x = -x;
  if (x) x = (x >= (1 << (bits - 1)) - 1) ? 0x7FFF : ((x << 15) + 0x4000) >> (bits - 1);
  return s ? -x : x;
}

float half_to_float(uint16_t h) {  // as BcnDecode.c: by a multiply of the float bits
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000u;
  o.u = uint32_t(h & 0x7FFF) << 13;
  o.f *= m.f;
  m.u = 0x47800000u;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= uint32_t(h & 0x8000) << 16;
  return o.f;
}

uint8_t bc6_channel(int v, bool sign) {
  float f;
  if (sign)
    f = v < 0 ? half_to_float(uint16_t(0x8000 | ((-v) * 31 / 32))) : half_to_float(uint16_t(v * 31 / 32));
  else
    f = half_to_float(uint16_t(v * 31 / 64));
  if (f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return uint8_t(f * 255.0f);
}

void bc6_block(Rgba* col, const uint8_t* s, bool sign) {
  int mode = s[0] & 0x1F, bit;
  if ((mode & 3) < 2) {
    mode &= 3, bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2), bit = 5;
  } else {
    mode = 10 + (mode >> 2), bit = 5;
  }
  if (mode >= 14) {  // reserved: PIL's black
    for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 0};
    return;
  }
  const Bc6Mode& m = kBc6[mode];
  int ep[12] = {0};
  for (const auto& run : m.runs) {
    if (run[0] < 0) break;
    const int step = run[2] >= run[1] ? 1 : -1;
    for (int b = run[1];; b += step) {
      ep[run[0]] |= int(get_bits(s, bit++, 1)) << b;
      if (b == run[2]) break;
    }
  }
  const int ib = m.ns == 2 ? 3 : 4;
  const int partition = int(get_bits(s, bit, m.ns == 2 ? 5 : 0));
  bit += m.ns == 2 ? 5 : 0;
  const int numep = m.ns * 6, mask = (1 << m.epb) - 1;
  const int delta_bits[3] = {m.rb, m.gb, m.bb};
  if (sign)
    for (int c = 0; c < 3; ++c) ep[c] = sign_extend(ep[c], m.epb);
  if (sign || m.tr)
    for (int i = 3; i < numep; ++i) ep[i] = sign_extend(ep[i], delta_bits[i % 3]);
  if (m.tr)  // BcnDecode.c leaves the sums unsigned, even in the signed format
    for (int i = 3; i < numep; ++i) ep[i] = (ep[i] + ep[i % 3]) & mask;
  int u[12];
  for (int i = 0; i < numep; ++i) u[i] = bc6_unquantize(ep[i], m.epb, sign);
  const int* cw = weights(ib);
  for (int i = 0; i < 16; ++i) {
    const int* e0 = u + subset(m.ns, partition, i) * 6;
    const int* e1 = e0 + 3;
    const int bits = ib - is_anchor(m.ns, partition, i);
    const int w = cw[get_bits(s, bit, bits)];
    bit += bits;
    uint8_t v[3];
    for (int c = 0; c < 3; ++c) v[c] = bc6_channel((e0[c] * (64 - w) + e1[c] * w) >> 6, sign);
    col[i] = {v[0], v[1], v[2], 255};
  }
}

// ------------------------------------------------------------- surfaces

void decode_blocks(const Header& h, const uint8_t* d, size_t n, RgbImage* out) {
  const size_t bw = (h.width + 3) / 4, bh = (h.height + 3) / 4;
  const size_t block = (h.bcn == 1 || h.bcn == 4) ? 8 : 16;
  if (h.data > n || (n - h.data) / block / bw < bh) fail("the surface ends before its last block");
  Rgba col[16];
  for (size_t by = 0; by < bh; ++by) {
    for (size_t bx = 0; bx < bw; ++bx) {
      const uint8_t* s = d + h.data + (by * bw + bx) * block;
      std::memset(col, 0, sizeof col);
      switch (h.bcn) {
        case 1: bc1_colour(col, s, false); break;
        case 2: bc1_colour(col, s + 8, true); break;
        case 3: bc1_colour(col, s + 8, true); break;
        case 4: bc3_ramp(&col[0].r, 4, s, false); break;
        case 5:
          bc3_ramp(&col[0].r, 4, s, h.sign);
          bc3_ramp(&col[0].g, 4, s + 8, h.sign);
          if (h.sign)
            for (auto& c : col) c.b = 128;
          break;
        case 6: bc6_block(col, s, h.sign); break;
        default: bc7_block(col, s); break;
      }
      for (int j = 0; j < 4; ++j) {
        const size_t y = by * 4 + j;
        if (y >= h.height) break;
        for (int i = 0; i < 4; ++i) {
          const size_t x = bx * 4 + i;
          if (x >= h.width) break;
          uint8_t* o = out->rgb.data() + (y * h.width + x) * 3;
          const Rgba& c = col[j * 4 + i];
          if (h.bcn == 4)
            o[0] = o[1] = o[2] = c.r;  // mode L
          else
            o[0] = c.r, o[1] = c.g, o[2] = c.b;
        }
      }
    }
  }
}

void decode_masks(const Header& h, const uint8_t* d, size_t n, RgbImage* out) {
  int offsets[4];
  uint32_t totals[4];
  for (int i = 0; i < h.mask_count; ++i) {  // DdsRgbDecoder's padding and scale
    const uint32_t mask = h.masks[i];
    int off = 0;
    if (mask)
      while (off < 31 && ((uint64_t(mask) >> (off + 1)) << (off + 1)) == mask) ++off;
    offsets[i] = off;
    totals[i] = uint32_t(uint64_t(mask) >> off);
  }
  const size_t bytecount = h.bitcount / 8, pixels = size_t(h.width) * h.height;
  size_t pos = h.data;
  for (size_t p = 0; p < pixels; ++p) {
    uint32_t value = 0;  // a read past the end gives fewer bytes, then none; the
    for (size_t k = 0; k < bytecount && pos < n; ++k, ++pos)  // masks take 32 bits
      if (k < 4) value |= uint32_t(d[pos]) << (8 * k);
    for (int c = 0; c < 3; ++c) {
      const uint32_t field = (value & h.masks[c]) >> offsets[c];
      out->rgb[p * 3 + c] =
          totals[c] ? uint8_t(int((double(field) / double(totals[c])) * 255.0)) : 0;
    }
  }
}

void decode_raw(const Header& h, const uint8_t* d, size_t n, RgbImage* out) {
  const size_t pixels = size_t(h.width) * h.height;
  const size_t bpp = h.layout == Layout::kL || h.layout == Layout::kPalette ? 1
                     : h.layout == Layout::kLA                             ? 2
                                                                           : 4;
  if (h.data > n || (n - h.data) / bpp < pixels) fail("the surface is truncated");
  const uint8_t* s = d + h.data;
  const uint8_t* palette = d + kHeader;
  for (size_t p = 0; p < pixels; ++p) {
    uint8_t* o = out->rgb.data() + p * 3;
    if (h.layout == Layout::kPalette) {
      // the palette is read as it stands; the surface follows 1024 bytes
      // of it, so a full surface means a full palette
      std::memcpy(o, palette + 4 * s[p], 3);
    } else if (h.layout == Layout::kRgba8) {
      std::memcpy(o, s + 4 * p, 3);
    } else {
      o[0] = o[1] = o[2] = s[p * bpp];
    }
  }
}

}  // namespace

bool dds_claims(const uint8_t* d, size_t n) {
  Header h;
  try {
    return parse(d, n, &h);
  } catch (const FormatError&) {
    return true;  // PIL's DDS plugin takes the file and refuses it
  }
}

void decode_dds(const uint8_t* d, size_t n, RgbImage* out) {
  Header h;
  if (!parse(d, n, &h)) fail("not a DDS file");
  check_image_pixels(kFmt, h.width, h.height);
  out->w = int(h.width);
  out->h = int(h.height);
  out->rgb.assign(size_t(h.width) * h.height * 3, 0);
  if (h.layout == Layout::kBcn)
    decode_blocks(h, d, n, out);
  else if (h.layout == Layout::kMasks)
    decode_masks(h, d, n, out);
  else
    decode_raw(h, d, n, out);
}

}  // namespace ssr
