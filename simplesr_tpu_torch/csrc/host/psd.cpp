// PSD decoder of the port: the merged image of an Adobe Photoshop file, to
// RGB as PIL 12.1's PsdImagePlugin reads it and convert("RGB") converts it.
//
//   - The header: "8BPS", version 1 (PSB, version 2, is refused by name: PIL
//     does not open it), the channel count, height, width, depth and colour
//     mode. PIL's MODES table sets what is read: bitmap at 1 bit (mode "1"),
//     grey (colour mode 0 or 1), multichannel and duotone at 8 bits (the
//     first channel, "L"), indexed at 8 bits ("P"), RGB at 8 bits (RGBA
//     with exactly 4 channels, else the first 3), CMYK at 8 bits (the first
//     4, each inverted) and Lab at 8 bits. Any other mode or depth is
//     refused by name, as is a file with fewer channels than its mode needs.
//   - The colour-mode data: a palette for indexed images when it is 768
//     bytes (256 reds, then greens, then blues); an indexed image without
//     one reads black, as PIL's palette does. The image resources are walked
//     as PIL walks them (its position may end past the section's end, and
//     the layer section is read from there); the layer and mask section is
//     skipped by its length.
//   - The image data: raw (compression 0), each channel's plane after the
//     last; or PackBits (1), where PIL reads the row byte counts of only the
//     channels it needs and decodes each channel as one stream from where
//     its counts put it, rows filled as PIL's PackBits decoder fills them (a
//     run past a row's end is cut, 0x80 is a no-op). With more channels in
//     the file than it needs, the first stream so begins inside the count
//     table, as in PIL. ZIP compression (2 and 3) is refused by name: PIL
//     makes no tile of it and does not load the image.
//   - To RGB as convert("RGB"): "1" as 0 or 255 per bit (a set bit is
//     white), grey, the palette, RGB(A) without alpha, PIL's cmyk2rgb, and
//     Lab through the LittleCMS transform that tiff.cpp computes.
//
// A file that ends before its image is whole is refused, as PIL refuses it
// ("image file is truncated").

#include <cstring>

#include "formats.h"

namespace ssr {
namespace {

const char* kFmt = "PSD";

[[noreturn]] void fail(const std::string& msg) { format_fail(kFmt, msg); }
[[noreturn]] void refuse(const std::string& what) {
  fail(what + " is not supported: PIL does not read it either (" + kFormatsItem + ")");
}

uint32_t be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }
uint32_t be32(const uint8_t* p) { return (be16(p) << 16) | be16(p + 2); }

// A reader of the file in memory, reading as PIL's file object: a read past
// the end returns what is there, a seek may go past the end.
struct Reader {
  const uint8_t* d;
  size_t n, at = 0;
  uint32_t u16(const char* what) {
    if (at > n || n - at < 2) fail(std::string("truncated ") + what);
    at += 2;
    return be16(d + at - 2);
  }
  uint32_t u32(const char* what) {
    if (at > n || n - at < 4) fail(std::string("truncated ") + what);
    at += 4;
    return be32(d + at - 4);
  }
  uint8_t u8(const char* what) {
    if (at >= n) fail(std::string("truncated ") + what);
    return d[at++];
  }
  size_t skip(uint64_t count) {  // returns how many bytes were there
    const size_t got = at >= n ? 0 : size_t(std::min<uint64_t>(count, n - at));
    at += size_t(count);
    return got;
  }
};

// One channel's band, decoded from `at` on: `row_bytes` bytes a row, `h`
// rows, raw or PackBits as PIL's decoders read them.
std::vector<uint8_t> read_band(const uint8_t* d, size_t n, size_t at, size_t row_bytes, int h,
                               bool packbits) {
  const size_t want = row_bytes * size_t(h);
  if (!packbits) {  // checked before the band is allocated
    if (at > n || n - at < want) fail("truncated image data");
    return std::vector<uint8_t>(d + at, d + at + want);
  }
  std::vector<uint8_t> out(want);
  size_t row = 0, x = 0;
  const auto need = [&](size_t k) {
    if (at > n || n - at < k) fail("truncated PackBits image data");
  };
  while (row < size_t(h)) {
    need(1);
    const uint8_t c = d[at];
    if (c == 0x80) {
      ++at;
      continue;
    }
    if (c & 0x80) {  // a run: cut at the row's end
      need(2);
      for (int k = 257 - c; k > 0 && x < row_bytes; --k) out[row * row_bytes + x++] = d[at + 1];
      at += 2;
    } else {  // a literal of c + 1 bytes: cut at the row's end
      need(size_t(c) + 2);
      for (int k = 1; k <= c + 1 && x < row_bytes; ++k) out[row * row_bytes + x++] = d[at + k];
      at += size_t(c) + 2;
    }
    if (x >= row_bytes) {
      x = 0;
      ++row;
    }
  }
  return out;
}

}  // namespace

bool psd_claims(const uint8_t* d, size_t n) { return n >= 4 && std::memcmp(d, "8BPS", 4) == 0; }

void decode_psd(const uint8_t* d, size_t n, RgbImage* out) {
  if (!psd_claims(d, n)) fail("not a PSD file");
  if (n < 26) fail("truncated header");
  const uint32_t version = be16(d + 4);
  if (version == 2) refuse("PSB (a large-document PSD, version 2)");
  if (version != 1) fail("not a PSD file (version " + std::to_string(version) + ")");
  const uint32_t file_channels = be16(d + 12), h = be32(d + 14), w = be32(d + 18);
  const uint32_t depth = be16(d + 22), mode = be16(d + 24);
  // PIL's MODES: (colour mode, depth) -> the mode it reads, the channels it needs
  enum Band { BIT, GREY, PALETTE, RGB, CMYK, LAB };
  Band kind;
  uint32_t channels;
  if (mode == 0 && depth == 1) {
    kind = BIT, channels = 1;
  } else if (depth == 8 && (mode == 0 || mode == 1 || mode == 7 || mode == 8)) {
    kind = GREY, channels = 1;
  } else if (depth == 8 && mode == 2) {
    kind = PALETTE, channels = 1;
  } else if (depth == 8 && mode == 3) {
    kind = RGB, channels = 3;
  } else if (depth == 8 && mode == 4) {
    kind = CMYK, channels = 4;
  } else if (depth == 8 && mode == 9) {
    kind = LAB, channels = 3;
  } else {
    static const char* names[] = {"bitmap", "greyscale", "indexed", "RGB", "CMYK", "",
                                  "", "multichannel", "duotone", "Lab"};
    const std::string name = mode < 10 && names[mode][0] ? names[mode]
                                                         : "colour mode " + std::to_string(mode);
    refuse("a " + std::to_string(depth) + "-bit " + name + " image");
  }
  if (channels > file_channels)
    refuse("a file with fewer channels (" + std::to_string(file_channels) +
           ") than its colour mode needs");
  if (kind == RGB && file_channels == 4) channels = 4;  // RGBA: alpha read, then dropped
  if (w == 0 || h == 0) fail("empty image");

  Reader r{d, n, 26};
  const uint32_t color_size = r.u32("colour mode data");
  const uint8_t* palette = nullptr;
  if (color_size) {
    if (kind == PALETTE && color_size == 768 && r.at + 768 <= n) palette = d + r.at;
    r.skip(color_size);
  }
  const uint32_t resources = r.u32("image resources");
  if (resources) {
    const size_t end = r.at + resources;
    while (r.at < end) {
      r.skip(4);  // the signature
      r.u16("image resource");
      const uint8_t name = r.u8("image resource name");
      const size_t got = r.skip(name);
      if (!(got & 1)) r.skip(1);
      const size_t data = r.skip(r.u32("image resource size"));
      if (data & 1) r.skip(1);
    }
  }
  const uint32_t layers = r.u32("layer and mask section");
  if (layers) {
    const size_t end = r.at + layers;
    r.u32("layer section");
    r.at = end;
  }
  const uint32_t compression = r.u16("image data");
  if (compression == 2 || compression == 3)
    refuse(std::string("ZIP compression of the image data") +
           (compression == 3 ? " with prediction" : ""));
  if (compression > 1) refuse("image data compression " + std::to_string(compression));
  check_image_pixels(kFmt, w, h);

  const size_t row_bytes = kind == BIT ? (size_t(w) + 7) / 8 : size_t(w);
  std::vector<size_t> offsets(channels);
  if (compression == 0) {
    for (uint32_t c = 0; c < channels; ++c) offsets[c] = r.at + size_t(c) * w * h;
  } else {
    const size_t table = r.at;
    if (table > n || (n - table) / 2 < size_t(channels) * h) fail("truncated row byte counts");
    size_t offset = table + size_t(channels) * h * 2;
    for (uint32_t c = 0; c < channels; ++c) {
      offsets[c] = offset;
      for (uint32_t y = 0; y < h; ++y) offset += be16(d + table + 2 * (size_t(c) * h + y));
    }
  }
  std::vector<std::vector<uint8_t>> bands;
  for (uint32_t c = 0; c < channels; ++c)
    bands.push_back(read_band(d, n, offsets[c], row_bytes, int(h), compression == 1));

  out->w = int(w);
  out->h = int(h);
  out->rgb.resize(size_t(w) * h * 3);
  uint8_t* o = out->rgb.data();
  for (uint32_t y = 0; y < h; ++y) {
    for (uint32_t x = 0; x < w; ++x, o += 3) {
      const size_t i = size_t(y) * row_bytes + x;
      switch (kind) {
        case BIT: {
          const uint8_t v = (bands[0][size_t(y) * row_bytes + x / 8] >> (7 - x % 8)) & 1 ? 255 : 0;
          o[0] = o[1] = o[2] = v;
          break;
        }
        case GREY:
          o[0] = o[1] = o[2] = bands[0][i];
          break;
        case PALETTE:
          for (int k = 0; k < 3; ++k) o[k] = palette ? palette[256 * k + bands[0][i]] : 0;
          break;
        case RGB:
          for (int k = 0; k < 3; ++k) o[k] = bands[k][i];
          break;
        case CMYK:
          pil_cmyk_to_rgb(255 - bands[0][i], 255 - bands[1][i], 255 - bands[2][i],
                          255 - bands[3][i], o);
          break;
        case LAB:
          pil_lab_to_rgb(bands[0][i], bands[1][i], bands[2][i], o);
          break;
      }
    }
  }
}

}  // namespace ssr
