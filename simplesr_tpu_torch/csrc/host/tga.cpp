// TGA decoder of the port: a Targa file to RGB as PIL 12.1 gives it through
// Image.open(...).convert("RGB") (TgaImagePlugin.py, Pillow's raw unpackers
// and TgaRleDecode.c).
//
//   - TGA has no magic. PIL tries it after every plugin before it in
//     Image.ID, on any file, and takes it where the 18-byte header passes
//     its test (tga_claims): a colour-map type of 0 or 1, a non-zero size, a
//     depth of 1, 8, 16, 24 or 32, an image type of 1, 2, 3, 9, 10 or 11 and,
//     with a colour map, an entry size of 16, 24 or 32 bits.
//   - Image types 1, 2, 3 and their RLE forms 9, 10, 11: grey (1-bit, 8-bit,
//     grey with alpha), colour-mapped 8-bit and true colour of 16 (5-5-5, each
//     field times 255 over 31), 24 and 32 bits (BGR; alpha dropped).
//   - The colour map is read when its type is 1, after the image ID, as
//     `first entry` zero entries then the file's; an index past it reads
//     black. A grey image with a colour map reads through it, as PIL's
//     putpalette turns mode L into P. 32-bit entries, more than 256 entries,
//     and a map on a true-colour or 1-bit image are refused, as PIL refuses
//     them.
//   - Rows bottom-up unless the descriptor's bit 5 is set; bit 4 mirrors the
//     rows (PIL's FLIP_LEFT_RIGHT).
//   - RLE as TgaRleDecode.c: a run packet must end within its row (PIL
//     refuses it otherwise), a raw packet may run on into the next rows, and
//     the unit is depth / 8 bytes, so that PIL never completes (and refuses)
//     a 1-bit RLE image.
//
// Anything that ends early is refused, as PIL refuses a truncated file.

#include <cstring>

#include "formats.h"

namespace ssr {
namespace {

const char* kFmt = "TGA";

[[noreturn]] void fail(const std::string& msg) { format_fail(kFmt, msg); }

uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }

uint8_t scale5(int v) { return uint8_t(v * 255 / 31); }

struct Header {
  int id_len, map_type, type, map_start, map_len, map_depth, width, height, depth, flags;
};

bool parse(const uint8_t* d, size_t n, Header* h) {
  if (n < 18) return false;
  *h = {d[0], d[1], d[2], int(le16(d + 3)), int(le16(d + 5)), d[7], int(le16(d + 12)),
        int(le16(d + 14)), d[16], d[17]};
  if (h->map_type > 1 || h->width <= 0 || h->height <= 0) return false;
  if (h->depth != 1 && h->depth != 8 && h->depth != 16 && h->depth != 24 && h->depth != 32)
    return false;
  const int base = h->type & ~8;
  if ((h->type & ~11) || base < 1 || base > 3) return false;  // types 1-3, 9-11
  if (h->map_type && h->map_depth != 16 && h->map_depth != 24 && h->map_depth != 32)
    return false;
  return true;
}

}  // namespace

bool tga_claims(const uint8_t* d, size_t n) {
  Header h;
  return parse(d, n, &h);
}

void decode_tga(const uint8_t* d, size_t n, RgbImage* out) {
  Header h;
  if (!parse(d, n, &h)) fail("not a TGA file");
  check_image_pixels(kFmt, uint64_t(h.width), uint64_t(h.height));
  const int base = h.type & 7;
  // PIL's raw mode: bytes per row and how a pixel reads
  enum { kOne, kGrey, kGreyAlpha, kBgr15, kBgr, kBgra } layout;
  if (base == 3 && h.depth == 1)
    layout = kOne;
  else if ((base == 3 || base == 1) && h.depth == 8)
    layout = kGrey;
  else if (base == 3 && h.depth == 16)
    layout = kGreyAlpha;
  else if (base == 2 && h.depth == 16)
    layout = kBgr15;
  else if (base == 2 && h.depth == 24)
    layout = kBgr;
  else if (base == 2 && h.depth == 32)
    layout = kBgra;
  else
    fail("image type " + std::to_string(h.type) + " at " + std::to_string(h.depth) +
         " bits is not decodable (PIL refuses it too)");
  if (base == 1 && !h.map_type)
    fail("a colour-mapped image without a colour map (PIL refuses it too)");
  size_t pos = 18 + size_t(h.id_len);
  // the colour map: RGB of each entry, zeros for the first `map_start`
  std::vector<uint8_t> palette;
  size_t entries = 0;
  if (h.map_type) {
    if (base == 2 || layout == kOne)
      fail("a colour map on a " + std::string(base == 2 ? "true-colour" : "1-bit") +
           " image (PIL refuses it too)");
    if (h.map_depth == 32) fail("32-bit colour-map entries (PIL refuses them too)");
    entries = size_t(h.map_start) + h.map_len;
    if (entries > 256) fail("a colour map of more than 256 entries (PIL refuses it too)");
    const size_t bytes = size_t(h.map_depth / 8) * h.map_len;
    if (pos > n || n - pos < bytes) fail("the colour map is truncated");
    palette.assign(entries * 3, 0);
    for (int i = 0; i < h.map_len; ++i) {
      uint8_t* o = palette.data() + 3 * (size_t(h.map_start) + i);
      if (h.map_depth == 16) {
        const uint32_t v = le16(d + pos + 2 * i);
        o[0] = scale5((v >> 10) & 31), o[1] = scale5((v >> 5) & 31), o[2] = scale5(v & 31);
      } else {
        const uint8_t* s = d + pos + 3 * i;
        o[0] = s[2], o[1] = s[1], o[2] = s[0];
      }
    }
    pos += bytes;
  }
  const int bpp = layout == kOne ? 0 : layout == kGrey ? 1 : (layout <= kBgr15 ? 2 : h.depth / 8);
  const size_t row_bytes = layout == kOne ? (size_t(h.width) + 7) / 8 : size_t(h.width) * bpp;
  const size_t rows = size_t(h.height);
  std::vector<uint8_t> raw(row_bytes * rows);
  if (h.type & 8) {
    // TgaRleDecode.c: the unit is depth / 8 bytes
    const size_t unit = size_t(h.depth / 8);
    if (!unit) fail("RLE of 1-bit pixels never completes in PIL (it refuses the file)");
    size_t x = 0, y = 0;
    while (y < rows) {
      if (pos >= n) fail("the RLE data is truncated");
      const uint8_t head = d[pos];
      const size_t count = unit * ((head & 0x7F) + 1);
      if (head & 0x80) {
        if (n - pos < 1 + unit) fail("the RLE data is truncated");
        if (x + count > row_bytes) fail("an RLE run crosses the end of a row (PIL refuses it)");
        for (size_t i = 0; i < count; i += unit)
          std::memcpy(raw.data() + y * row_bytes + x + i, d + pos + 1, unit);
        pos += 1 + unit;
        x += count;
        if (x >= row_bytes) x = 0, ++y;
      } else {
        if (n - pos < 1 + count) fail("the RLE data is truncated");
        const uint8_t* s = d + pos + 1;
        pos += 1 + count;
        for (size_t left = count; left && y < rows;) {  // raw bytes run on into the next rows
          const size_t take = std::min(left, row_bytes - x);
          std::memcpy(raw.data() + y * row_bytes + x, s, take);
          s += take, left -= take, x += take;
          if (x >= row_bytes) x = 0, ++y;
        }
      }
    }
  } else {
    if (pos > n || (n - pos) / row_bytes < rows) fail("the image data is truncated");
    std::memcpy(raw.data(), d + pos, raw.size());
  }
  const bool top_down = h.flags & 0x20, mirror = h.flags & 0x10;
  out->w = h.width;
  out->h = h.height;
  out->rgb.assign(size_t(h.width) * rows * 3, 0);
  for (size_t r = 0; r < rows; ++r) {
    const uint8_t* s = raw.data() + r * row_bytes;
    uint8_t* row = out->rgb.data() + (top_down ? r : rows - 1 - r) * h.width * 3;
    for (int x = 0; x < h.width; ++x) {
      uint8_t* o = row + size_t(mirror ? h.width - 1 - x : x) * 3;
      if (layout == kOne) {
        o[0] = o[1] = o[2] = ((s[x >> 3] >> (7 - (x & 7))) & 1) ? 255 : 0;
      } else if (layout == kGrey || layout == kGreyAlpha) {
        const uint8_t v = s[size_t(x) * bpp];
        if (h.map_type) {
          if (v < entries)
            std::memcpy(o, palette.data() + 3 * v, 3);  // else black
        } else {
          o[0] = o[1] = o[2] = v;
        }
      } else if (layout == kBgr15) {
        const uint32_t v = le16(s + 2 * x);
        o[0] = scale5((v >> 10) & 31), o[1] = scale5((v >> 5) & 31), o[2] = scale5(v & 31);
      } else {
        const uint8_t* p = s + size_t(x) * bpp;
        o[0] = p[2], o[1] = p[1], o[2] = p[0];
      }
    }
  }
}

}  // namespace ssr
