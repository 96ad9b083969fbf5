// SGI decoder of the port: an SGI image file to RGB as PIL 12.1 gives it
// through Image.open(...).convert("RGB") (SgiImagePlugin.py, its SGI16
// decoder, and Pillow's SgiRleDecode.c).
//
//   - 1 or 2 bytes a channel; grey (1 or 2 dimensions, one channel), RGB and
//     RGBA (3 dimensions, 3 or 4 channels), alpha dropped. 16-bit samples read
//     as their high byte, as PIL's "L;16B" unpacking takes them.
//   - Rows are stored bottom-up, channel after channel (verbatim) or as RLE
//     rows found through the offset and length tables.
//   - RLE as SgiRleDecode.c reads it: a row's decoder takes at most as many
//     packets as its length says bytes; a zero count ends the row, a row that
//     produces fewer pixels than the width keeps the previous row's values
//     past them (one buffer serves every row); a last packet that is not the
//     terminator ends the whole decode there, the rows not yet reached left
//     black; a row whose table entry leaves the file or whose packets overrun
//     the width is refused. For 2-byte samples the count is the low byte of
//     each 16-bit packet header.
//   - Other compression values decode nothing, and PIL refuses them.
//
// A file of fewer than 12 bytes is not claimed (PIL's struct.error); an
// empty size neither.

#include <cstring>

#include "formats.h"

namespace ssr {
namespace {

const char* kFmt = "SGI";
constexpr size_t kHeader = 512;

[[noreturn]] void fail(const std::string& msg) { format_fail(kFmt, msg); }

uint32_t be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }
uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

// SgiRleDecode.c's expandrow (bpc 1) and expandrow2 (bpc 2), with their
// bounds against the buffer's last byte `end`: -1 overrun, 1 stop the whole
// decode, 0 the row is done.
int expand_row(uint8_t* dest, const uint8_t* src, const uint8_t* end, long n, int z, int xsize,
               int bpc) {
  int x = 0;
  for (; n > 0; --n) {
    if (src + (bpc - 1) > end) return -1;
    const uint8_t pixel = src[bpc - 1];
    src += bpc;
    if (n == 1 && pixel != 0) return 1;
    const int count = pixel & 0x7F;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {  // copy
      if (src + bpc * count > end) return -1;
      for (int i = 0; i < count; ++i, src += bpc, dest += z * bpc) std::memcpy(dest, src, bpc);
    } else {  // run
      if (src + (bpc - 1) * 2 > end) return -1;
      for (int i = 0; i < count; ++i, dest += z * bpc) std::memcpy(dest, src, bpc);
      src += bpc;
    }
  }
  return 0;
}

struct Header {
  int compression, bpc, dimension, xsize, ysize, zsize, bands;
};

bool parse(const uint8_t* d, size_t n, Header* h) {
  if (n < 12 || be16(d) != 474) return false;
  *h = {d[2], d[3], int(be16(d + 4)), int(be16(d + 6)), int(be16(d + 8)), int(be16(d + 10)), 0};
  const bool grey = (h->dimension == 1 || h->dimension == 2) && h->zsize == 1;
  const bool colour = h->dimension == 3 && (h->zsize == 3 || h->zsize == 4);
  if ((h->bpc != 1 && h->bpc != 2) || !(grey || colour)) return true;  // refused, not passed on
  h->bands = h->zsize;
  return h->xsize > 0 && h->ysize > 0;
}

}  // namespace

bool sgi_claims(const uint8_t* d, size_t n) {
  Header h;
  return parse(d, n, &h);
}

void decode_sgi(const uint8_t* d, size_t n, RgbImage* out) {
  Header h;
  if (!parse(d, n, &h)) fail("not an SGI file");
  if (!h.bands)
    fail(std::to_string(h.bpc) + " bytes a sample in " + std::to_string(h.dimension) +
         " dimensions and " + std::to_string(h.zsize) +
         " channels is not an SGI layout PIL reads (it refuses it too)");
  if (h.compression > 1)
    fail("compression " + std::to_string(h.compression) + " (PIL decodes nothing and refuses it)");
  check_image_pixels(kFmt, uint64_t(h.xsize), uint64_t(h.ysize));
  const int w = h.xsize, rows = h.ysize, z = h.bands, bpc = h.bpc;
  out->w = w;
  out->h = rows;
  out->rgb.assign(size_t(w) * rows * 3, 0);
  // the sample of channel c (its high byte) at file row r (bottom-up) goes to
  // the output's row rows - 1 - r
  auto put = [&](int r, int x, int c, uint8_t v) {
    uint8_t* o = out->rgb.data() + (size_t(rows - 1 - r) * w + x) * 3;
    if (z == 1)
      o[0] = o[1] = o[2] = v;
    else if (c < 3)
      o[c] = v;
  };
  if (h.compression == 0) {
    const size_t page = size_t(w) * rows * bpc;
    if (n < kHeader || (n - kHeader) / page < size_t(z)) fail("the image data is truncated");
    for (int c = 0; c < z; ++c)
      for (int r = 0; r < rows; ++r) {
        const uint8_t* s = d + kHeader + c * page + size_t(r) * w * bpc;
        for (int x = 0; x < w; ++x) put(r, x, c, s[size_t(x) * bpc]);
      }
    return;
  }
  if (n < kHeader) fail("the offset table is truncated");
  const size_t bufsize = n - kHeader, tablen = size_t(z) * rows;
  if (bufsize / 8 < tablen) fail("the offset and length tables are truncated");
  const uint8_t* ptr = d + kHeader;
  const uint8_t* end = ptr + bufsize - 1;
  std::vector<uint8_t> row(size_t(w) * z * 2, 0);
  for (int r = 0; r < rows; ++r) {
    for (int c = 0; c < z; ++c) {
      uint32_t offset = be32(ptr + 4 * (size_t(r) + size_t(c) * rows));
      const uint32_t length = be32(ptr + 4 * (tablen + size_t(r) + size_t(c) * rows));
      if (offset < kHeader) fail("a row's offset points into the header");
      offset -= kHeader;
      if (uint64_t(offset) + length > bufsize) fail("a row leaves the file");
      const int status = expand_row(row.data() + c * bpc, ptr + offset, end, long(length), z, w,
                                    bpc);
      if (status == -1) fail("a row's RLE data overruns the row or the file");
      if (status == 1) return;  // SgiRleDecode.c stops here; the rest stays black
    }
    for (int x = 0; x < w; ++x)
      for (int c = 0; c < z; ++c) put(r, x, c, row[(size_t(x) * z + c) * bpc]);
  }
}

}  // namespace ssr
