// GIF decoder of the port: the first image of a GIF87a or GIF89a file, to RGB
// as PIL 12.1 gives frame 0 through Image.open(...).convert("RGB").
//
//   - Blocks before the first image descriptor are read as PIL reads them:
//     extensions are skipped block by block (the last graphic control
//     extension with its flag set gives the transparency index), stray bytes
//     are skipped, and the file must not end before an image.
//   - The canvas is the logical screen, grown to hold a frame that reaches
//     past it. Outside the frame it holds the transparency index, else 0.
//   - Colours: the local table unless it is the grey ramp (entry i = i, i, i),
//     else the global table unless it is the ramp, else the index itself as
//     grey (PIL's mode "L"); an index past the table reads black.
//   - LZW as PIL's GifDecode.c: codes LSB first across sub-blocks, the code
//     size grows when entry 2^size - 1 is added, no entries past 4096, the
//     first code after a clear a literal, and interlaced rows in four passes.
//
// Where PIL reads on past a damaged stream (an end code or an empty
// sub-block before the image is complete, a code size PIL mangles) this
// decoder refuses the file.

#include <algorithm>
#include <cstring>

#include "formats.h"

namespace ssr {
namespace {

const char* kFmt = "GIF";

[[noreturn]] void fail(const std::string& msg) { format_fail(kFmt, msg); }

uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }

// PIL reads a colour table that is the grey ramp as no table at all.
bool is_ramp(const uint8_t* p, int entries) {
  for (int i = 0; i < entries; ++i)
    if (p[3 * i] != i || p[3 * i + 1] != i || p[3 * i + 2] != i) return false;
  return true;
}

class LzwReader {
 public:
  LzwReader(const uint8_t* d, size_t n, size_t pos) : d_(d), n_(n), pos_(pos) {}
  int code(int size) {
    while (bitcount_ < size) {
      if (block_left_ > 0) {
        bitbuf_ |= uint32_t(d_[pos_++]) << bitcount_;
        bitcount_ += 8;
        --block_left_;
      } else {
        if (pos_ >= n_) fail("truncated image data");
        const int c = d_[pos_];
        if (c == 0) fail("the image data ends before the image is complete");
        if (n_ - pos_ - 1 < size_t(c)) fail("truncated image data");
        block_left_ = c;
        ++pos_;
      }
    }
    const int c = int(bitbuf_ & ((1u << size) - 1));
    bitbuf_ >>= size;
    bitcount_ -= size;
    return c;
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_;
  int block_left_ = 0, bitcount_ = 0;
  uint32_t bitbuf_ = 0;
};

}  // namespace

bool is_gif(const uint8_t* d, size_t n) {
  return n >= 6 && (std::memcmp(d, "GIF87a", 6) == 0 || std::memcmp(d, "GIF89a", 6) == 0);
}

void decode_gif(const uint8_t* d, size_t n, RgbImage* out) {
  if (!is_gif(d, n)) fail("not a GIF file");
  if (n < 13) fail("truncated header");
  int width = int(le16(d + 6)), height = int(le16(d + 8));
  size_t pos = 13;
  const uint8_t* global = nullptr;
  int global_entries = 0;
  if (d[10] & 0x80) {
    global_entries = 1 << ((d[10] & 7) + 1);
    if (n - pos < size_t(3 * global_entries)) fail("truncated global colour table");
    if (!is_ramp(d + pos, global_entries)) global = d + pos;
    pos += 3 * global_entries;
  }
  check_image_pixels(kFmt, uint64_t(width), uint64_t(height));
  // blocks up to the first image descriptor
  int transparency = -1;
  for (;;) {
    if (pos >= n || d[pos] == ';') fail("no image in the file");
    const uint8_t s = d[pos++];
    if (s == ',') break;
    if (s != '!') continue;  // PIL skips a stray byte
    if (pos >= n) fail("truncated extension");
    const uint8_t label = d[pos++];
    bool first = true;
    for (;;) {  // the extension's sub-blocks, up to an empty one
      if (pos >= n) fail("truncated extension");
      const size_t len = d[pos++];
      if (len == 0) break;
      if (n - pos < len) fail("truncated extension");
      if (first && label == 0xF9) {
        if (len < 3 || ((d[pos] & 1) && len < 4)) fail("bad graphic control extension");
        if (d[pos] & 1) transparency = d[pos + 3];
      }
      first = false;
      pos += len;
    }
  }
  if (n - pos < 9) fail("truncated image descriptor");
  const int x0 = int(le16(d + pos)), y0 = int(le16(d + pos + 2));
  const int fw = int(le16(d + pos + 4)), fh = int(le16(d + pos + 6));
  const uint8_t flags = d[pos + 8];
  pos += 9;
  if (fw == 0 || fh == 0) fail("empty frame");
  width = std::max(width, x0 + fw);
  height = std::max(height, y0 + fh);
  check_image_pixels(kFmt, uint64_t(width), uint64_t(height));
  const uint8_t* table = global;
  int entries = global_entries;
  if (flags & 0x80) {
    const int local_entries = 1 << ((flags & 7) + 1);
    if (n - pos < size_t(3 * local_entries)) fail("truncated local colour table");
    if (!is_ramp(d + pos, local_entries)) {
      table = d + pos;
      entries = local_entries;
    }
    pos += 3 * local_entries;
  }
  if (pos >= n) fail("truncated image data");
  const int bits = d[pos++];
  if (bits < 2 || bits > 8)  // PIL's decoder mangles these
    fail("LZW code size " + std::to_string(bits) + " is not supported (" +
         std::string(kFormatsItem) + ")");

  // the canvas of palette indices, filled as PIL fills it
  std::vector<uint8_t> index(size_t(width) * height, uint8_t(transparency >= 0 ? transparency : 0));
  const int clear = 1 << bits, end = clear + 1;
  uint8_t data[4096];
  uint16_t link[4096];
  uint8_t stack[4096];
  int next = clear + 2, size = bits + 1, mask = (1 << size) - 1;
  int lastcode = 0, lastdata = 0;
  bool fresh = true;  // the next code follows a clear (or the start)
  int x = 0, y = 0, step = 8, pass = 1;
  const bool interlace = flags & 0x40;
  if (!interlace) {
    step = 1;
    pass = 0;
  }
  bool done = false;
  auto emit = [&](uint8_t v) {
    index[size_t(y0 + y) * width + x0 + x] = v;
    if (++x < fw) return;
    x = 0;
    y += step;
    while (y >= fh) {
      switch (pass) {
        case 1: y = 4; pass = 2; break;
        case 2: y = 2; step = 4; pass = 3; break;
        case 3: y = 1; step = 2; pass = 0; break;
        default: done = true; return;
      }
    }
  };
  LzwReader br(d, n, pos);
  while (!done) {
    int c = br.code(size);
    if (c == clear) {
      next = clear + 2;
      size = bits + 1;
      mask = (1 << size) - 1;
      fresh = true;
      continue;
    }
    if (c == end) fail("the image data ends before the image is complete");
    if (fresh) {
      if (c > clear) fail("corrupt LZW data");
      lastdata = lastcode = c;
      fresh = false;
      emit(uint8_t(c));
      continue;
    }
    const int thiscode = c;
    if (c > next) fail("corrupt LZW data");
    int top = 4096;
    if (c == next) {
      stack[--top] = uint8_t(lastdata);
      c = lastcode;
    }
    while (c >= clear) {
      if (top <= 0 || c >= 4096) fail("corrupt LZW data");
      stack[--top] = data[c];
      c = link[c];
    }
    lastdata = c;
    if (next < 4096) {
      data[next] = uint8_t(c);
      link[next] = uint16_t(lastcode);
      if (next == mask && size < 12) {
        ++size;
        mask = (1 << size) - 1;
      }
      ++next;
    }
    lastcode = thiscode;
    emit(uint8_t(c));
    for (int i = top; i < 4096 && !done; ++i) emit(stack[i]);
  }

  out->w = width;
  out->h = height;
  out->rgb.resize(index.size() * 3);
  uint8_t lut[256 * 3] = {0};
  for (int i = 0; i < 256; ++i) {
    if (!table) {
      lut[3 * i] = lut[3 * i + 1] = lut[3 * i + 2] = uint8_t(i);
    } else if (i < entries) {
      std::memcpy(lut + 3 * i, table + 3 * i, 3);
    }
  }
  uint8_t* o = out->rgb.data();
  for (const uint8_t v : index) {
    std::memcpy(o, lut + 3 * v, 3);
    o += 3;
  }
}

}  // namespace ssr
