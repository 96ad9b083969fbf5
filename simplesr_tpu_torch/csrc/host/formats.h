// The host decoders of the formats that the JAX package opens through PIL
// beside PNG and JPEG: WebP (webp.cpp), GIF (gif.cpp), TIFF (tiff.cpp), DDS
// (dds.cpp), PSD (psd.cpp), TGA (tga.cpp), QOI (qoi.cpp), PCX and DCX
// (pcx.cpp) and SGI (sgi.cpp). Each decodes the first image of a file in
// memory to 8-bit RGB as PIL 12.1's Image.open(...).convert("RGB") gives it,
// and throws FormatError, naming the format, for a file it refuses.
// loader.cpp dispatches to them in the order of PIL's Image.ID: by magic
// bytes, and for the formats after slice 14 by the `*_claims` tests, which
// say whether PIL's plugin opens the file or rejects it at open time in a
// way that lets Image.open try the next plugin (a SyntaxError, IndexError,
// TypeError, KeyError, EOFError or struct.error, or an empty size). TGA has
// no magic: it comes last.
//
// Every length, offset and code read from the file is checked against the
// buffer before it is used: request bodies come from outside the program.

#pragma once

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

namespace ssr {

// PIL's refusal (DecompressionBombError): twice its MAX_IMAGE_PIXELS, as in
// simplesr_tpu_torch/data/png.py.
constexpr uint64_t kMaxPixels = 2ull * (1024ull * 1024 * 1024 / 4 / 3);

// Where the refused variants are queued.
constexpr const char* kFormatsItem = "ROADMAP.md, Queue 1, item 3";

struct FormatError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] inline void format_fail(const char* fmt, const std::string& msg) {
  throw FormatError(std::string(fmt) + ": " + msg);
}

inline void check_image_pixels(const char* fmt, uint64_t w, uint64_t h) {
  if ((w ? w : 1) * (h ? h : 1) > kMaxPixels)
    format_fail(fmt, "image of " + std::to_string(w) + " x " + std::to_string(h) +
                         " pixels exceeds the limit of " + std::to_string(kMaxPixels) +
                         " pixels (a decompression bomb?)");
}

struct RgbImage {
  int h = 0, w = 0;
  std::vector<uint8_t> rgb;  // h * w * 3
  size_t bytes() const { return rgb.size(); }
};

// PIL's cmyk2rgb (Convert.c) of one pixel of mode CMYK.
inline void pil_cmyk_to_rgb(uint8_t c, uint8_t m, uint8_t y, uint8_t k, uint8_t* rgb) {
  const int nk = 255 - k;
  const uint8_t in[3] = {c, m, y};
  for (int i = 0; i < 3; ++i) {
    const int t = in[i] * nk + 128;
    rgb[i] = uint8_t(std::min(255, std::max(0, nk - (((t >> 8) + t) >> 8))));
  }
}

// Pillow's convert("RGB") of one pixel of mode LAB, its a and b bands as
// PIL holds them (128 is 0): LittleCMS's Lab to sRGB transform (tiff.cpp).
void pil_lab_to_rgb(uint8_t l, uint8_t a, uint8_t b, uint8_t* rgb);

// One strip or tile of a JPEG-compressed TIFF, decoded by loader.cpp's JPEG
// decoder as libtiff's tif_jpeg.c drives libjpeg: the JPEGTables stream
// (tables, may be empty) read first, then the segment; YCbCr converted to
// RGB (Pillow's JPEGCOLORMODE_RGB) or the samples left as they are,
// upsampled.
struct JpegSegment {
  int w = 0, h = 0, channels = 0;
  std::vector<std::pair<int, int>> sampling;  // (h, v) of each component
  std::vector<uint8_t> samples;               // h * w * channels
};
void decode_jpeg_segment(const uint8_t* tables, size_t tables_size, const uint8_t* d, size_t n,
                         bool ycbcr_to_rgb, JpegSegment* out);

bool is_webp(const uint8_t* d, size_t n);
bool is_gif(const uint8_t* d, size_t n);
bool is_tiff(const uint8_t* d, size_t n);
bool pcx_claims(const uint8_t* d, size_t n);
bool dcx_claims(const uint8_t* d, size_t n);
bool dds_claims(const uint8_t* d, size_t n);
bool psd_claims(const uint8_t* d, size_t n);
bool qoi_claims(const uint8_t* d, size_t n);
bool sgi_claims(const uint8_t* d, size_t n);
bool tga_claims(const uint8_t* d, size_t n);

void decode_webp(const uint8_t* d, size_t n, RgbImage* out);
void decode_gif(const uint8_t* d, size_t n, RgbImage* out);
void decode_tiff(const uint8_t* d, size_t n, RgbImage* out);
void decode_pcx(const uint8_t* d, size_t n, RgbImage* out);
void decode_dcx(const uint8_t* d, size_t n, RgbImage* out);
void decode_dds(const uint8_t* d, size_t n, RgbImage* out);
void decode_psd(const uint8_t* d, size_t n, RgbImage* out);
void decode_qoi(const uint8_t* d, size_t n, RgbImage* out);
void decode_sgi(const uint8_t* d, size_t n, RgbImage* out);
void decode_tga(const uint8_t* d, size_t n, RgbImage* out);

}  // namespace ssr
