// PCX decoder of the port, and DCX (Intel's container of PCX pages, the first
// page): to RGB as PIL 12.1 gives it through Image.open(...).convert("RGB")
// (PcxImagePlugin.py, DcxImagePlugin.py, Pillow's PcxDecode.c and unpackers).
//
//   - The layouts PIL reads: 1 bit in one plane (1 white), 1 bit in 2 or 4
//     planes (an index into the header's 16-colour palette), 8 bits in one
//     plane (version 5: through the 256-colour palette that follows a 0x0C
//     byte 769 bytes before the end of the file, else grey) and 8 bits in
//     three planes (version 5: RGB).
//   - Bytes per line as PIL takes them: the width's bytes, one more when the
//     header's count differs and the width's is odd. A line is that many
//     bytes a plane; a run may not leave it (PIL refuses that).
//   - PIL's reading of padded planes is kept: 1-bit planes are read at the
//     line's stride; the RGB planes at the width, after PcxDecode.c moves the
//     planes together only where the line's length is not a multiple of the
//     width (so a line of width 1 with padding reads its pad byte as green).
//   - A DCX reads its first page at the first offset of its directory; an
//     8-bit page takes its palette from the end of the container, as PIL's
//     seek from the end of the file does.
//
// An 8-bit file of fewer than 769 bytes is refused: PIL's seek to 769 bytes
// before the end fails on a file (a request body in memory would seek to the
// start). A header that PIL's open rejects (fewer than 68 bytes, an empty box,
// a DCX directory cut short or empty) is not claimed.

#include <cstring>

#include "formats.h"

namespace ssr {
namespace {

const char* kPcx = "PCX";
const char* kDcx = "DCX";

uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24);
}

// PcxImageFile._open's header test at `at`
bool pcx_header(const uint8_t* d, size_t n, size_t at) {
  if (at > n || n - at < 68) return false;
  const uint8_t* s = d + at;
  if (s[0] != 10 || !(s[1] == 0 || s[1] == 2 || s[1] == 3 || s[1] == 5)) return false;
  return le16(s + 8) + 1 > le16(s + 4) && le16(s + 10) + 1 > le16(s + 6);
}

// the offset of a DCX's first page, or 0 where PIL's open rejects the file
size_t dcx_first_page(const uint8_t* d, size_t n) {
  if (n < 4 || le32(d) != 0x3ADE68B1u) return 0;
  if (n < 8) return 0;  // PIL's struct.error on the directory
  const uint32_t first = le32(d + 4);
  if (!first) return 0;  // no page: PIL's seek(0) raises EOFError
  for (size_t i = 1; i < 1024; ++i) {  // the rest of the directory must be readable
    if (n < 8 + 4 * i) return 0;
    if (!le32(d + 4 + 4 * i)) break;
  }
  return pcx_header(d, n, first) ? first : 0;
}

void decode_page(const char* fmt, const uint8_t* d, size_t n, size_t at, RgbImage* out) {
  auto fail = [fmt](const std::string& msg) { format_fail(fmt, msg); };
  const uint8_t* s = d + at;
  const int version = s[1], bits = s[3], planes = s[65];
  const uint32_t width = le16(s + 8) + 1 - le16(s + 4), height = le16(s + 10) + 1 - le16(s + 6);
  const uint32_t provided = le16(s + 66);
  const uint8_t* palette = nullptr;  // 8-bit: RGB entries, or grey without one
  if (bits == 1 && planes == 1) {
  } else if (bits == 1 && (planes == 2 || planes == 4)) {
    palette = s + 16;
  } else if (version == 5 && bits == 8 && planes == 1) {
    if (n < 769)
      fail("an 8-bit image in a file of fewer than 769 bytes (PIL's seek to its palette fails)");
    if (d[n - 769] == 12) palette = d + n - 768;
  } else if (version == 5 && bits == 8 && planes == 3) {
  } else {
    fail("version " + std::to_string(version) + " with " + std::to_string(bits) + " bits in " +
         std::to_string(planes) + " planes is not a PCX layout PIL reads (it refuses it too)");
  }
  check_image_pixels(fmt, width, height);
  size_t stride = (size_t(width) * bits + 7) / 8;
  if (provided != stride) stride += stride % 2;
  const size_t line = size_t(planes) * stride;
  std::vector<uint8_t> buf(line);
  out->w = int(width);
  out->h = int(height);
  out->rgb.assign(size_t(width) * height * 3, 0);
  size_t pos = at + 128;
  for (uint32_t y = 0; y < height; ++y) {
    for (size_t x = 0; x < line;) {  // PcxDecode.c's RLE
      if (pos >= n) fail("the image data is truncated");
      const uint8_t b = d[pos];
      if ((b & 0xC0) == 0xC0) {
        if (n - pos < 2) fail("the image data is truncated");
        const size_t count = b & 0x3F;
        if (x + count > line) fail("an RLE run overruns the line (PIL refuses it)");
        std::memset(buf.data() + x, d[pos + 1], count);
        x += count;
        pos += 2;
      } else {
        buf[x++] = b;
        ++pos;
      }
    }
    uint8_t* o = out->rgb.data() + size_t(y) * width * 3;
    if (bits == 8 && planes == 3) {
      if (line % width && line > width) {  // PcxDecode.c moves the planes together
        const size_t bands = line / width, band = line / bands;
        for (size_t i = 1; i < bands; ++i)
          std::memmove(buf.data() + i * width, buf.data() + i * band, width);
      }
      for (uint32_t x = 0; x < width; ++x)
        for (int c = 0; c < 3; ++c) o[3 * x + c] = buf[x + c * size_t(width)];
    } else if (bits == 8) {
      for (uint32_t x = 0; x < width; ++x) {
        if (palette)
          std::memcpy(o + 3 * x, palette + 3 * buf[x], 3);
        else
          o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = buf[x];
      }
    } else {
      for (uint32_t x = 0; x < width; ++x) {
        int v = 0;
        for (int p = 0; p < planes; ++p)
          v |= ((buf[p * stride + x / 8] >> (7 - x % 8)) & 1) << p;
        if (palette)
          std::memcpy(o + 3 * x, palette + 3 * v, 3);
        else
          o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = v ? 255 : 0;
      }
    }
  }
}

}  // namespace

bool pcx_claims(const uint8_t* d, size_t n) { return pcx_header(d, n, 0); }

bool dcx_claims(const uint8_t* d, size_t n) { return dcx_first_page(d, n) != 0; }

void decode_pcx(const uint8_t* d, size_t n, RgbImage* out) {
  if (!pcx_header(d, n, 0)) format_fail(kPcx, "not a PCX file");
  decode_page(kPcx, d, n, 0, out);
}

void decode_dcx(const uint8_t* d, size_t n, RgbImage* out) {
  const size_t first = dcx_first_page(d, n);
  if (!first) format_fail(kDcx, "not a DCX file");
  decode_page(kDcx, d, n, first, out);
}

}  // namespace ssr
