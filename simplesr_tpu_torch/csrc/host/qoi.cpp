// QOI decoder of the port: a "Quite OK Image" file to RGB as PIL 12.1 gives it
// through Image.open(...).convert("RGB") (QoiImagePlugin.py's QoiDecoder).
//
// The operations of the format, as that decoder reads them: QOI_OP_RGB keeps
// the previous alpha; QOI_OP_INDEX of a slot that no pixel has filled yet
// gives (0, 0, 0, 0) and, like every operation but QOI_OP_RUN, stores its
// pixel at the pixel's own hash (so such an index overwrites slot 0); a run
// may overshoot the image, the rest dropped. The header's channel count only
// says whether alpha is kept, which RGB does not show; the colour space is
// not read. A stream that ends before the image is complete is refused, as
// PIL refuses it. A file of fewer than 13 bytes, or with an empty size, is
// not claimed: PIL's open rejects it as not a QOI file.

#include <cstring>

#include "formats.h"

namespace ssr {
namespace {

const char* kFmt = "QOI";

[[noreturn]] void fail(const std::string& msg) { format_fail(kFmt, msg); }

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

}  // namespace

bool qoi_claims(const uint8_t* d, size_t n) {
  return n >= 13 && std::memcmp(d, "qoif", 4) == 0 && be32(d + 4) > 0 && be32(d + 8) > 0;
}

void decode_qoi(const uint8_t* d, size_t n, RgbImage* out) {
  if (!qoi_claims(d, n)) fail("not a QOI file");
  const uint32_t width = be32(d + 4), height = be32(d + 8);
  check_image_pixels(kFmt, width, height);
  const size_t pixels = size_t(width) * height;
  out->w = int(width);
  out->h = int(height);
  out->rgb.assign(pixels * 3, 0);
  uint8_t seen[64][4] = {};
  uint8_t prev[4] = {0, 0, 0, 255};
  size_t pos = 14, done = 0;
  auto need = [&](size_t k) {
    if (n < pos || n - pos < k) fail("the data ends before the image is complete");
  };
  while (done < pixels) {
    need(1);
    const uint8_t b = d[pos++];
    uint8_t v[4];
    if (b == 0xFE) {  // QOI_OP_RGB
      need(3);
      v[0] = d[pos], v[1] = d[pos + 1], v[2] = d[pos + 2], v[3] = prev[3];
      pos += 3;
    } else if (b == 0xFF) {  // QOI_OP_RGBA
      need(4);
      std::memcpy(v, d + pos, 4);
      pos += 4;
    } else if ((b >> 6) == 0) {  // QOI_OP_INDEX (an empty slot holds zeros)
      std::memcpy(v, seen[b & 63], 4);
    } else if ((b >> 6) == 1) {  // QOI_OP_DIFF
      v[0] = uint8_t(prev[0] + ((b >> 4) & 3) - 2);
      v[1] = uint8_t(prev[1] + ((b >> 2) & 3) - 2);
      v[2] = uint8_t(prev[2] + (b & 3) - 2);
      v[3] = prev[3];
    } else if ((b >> 6) == 2) {  // QOI_OP_LUMA
      need(1);
      const int dg = (b & 63) - 32, second = d[pos++];
      v[0] = uint8_t(prev[0] + dg + ((second >> 4) & 15) - 8);
      v[1] = uint8_t(prev[1] + dg);
      v[2] = uint8_t(prev[2] + dg + (second & 15) - 8);
      v[3] = prev[3];
    } else {  // QOI_OP_RUN: the previous pixel again, not stored
      const size_t run = std::min<size_t>((b & 63) + 1, pixels - done);
      for (size_t k = 0; k < run; ++k) std::memcpy(out->rgb.data() + (done + k) * 3, prev, 3);
      done += run;
      continue;
    }
    std::memcpy(prev, v, 4);
    std::memcpy(seen[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64], v, 4);
    std::memcpy(out->rgb.data() + done * 3, v, 3);
    ++done;
  }
}

}  // namespace ssr
