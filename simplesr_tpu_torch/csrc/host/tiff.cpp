// TIFF decoder of the port: the first image (IFD) of a classic TIFF file, to
// RGB as PIL 12.1 gives it through Image.open(...).convert("RGB"), which reads
// an uncompressed image with its own raw decoder and a compressed one through
// libtiff 4.7.
//
//   - Either byte order; strips or tiles; chunky or planar samples.
//   - Compression none, LZW (libtiff's, codes from 9 bits, one code early),
//     Deflate and Adobe Deflate (zlib), PackBits. The predictor (horizontal
//     differencing, 8- and 16-bit samples) applies to LZW and Deflate only:
//     PIL's raw decoder and libtiff's PackBits ignore the tag.
//   - The pixel layouts of PIL's OPEN_INFO table that end in RGB, L or P:
//     1-, 2-, 4- and 8-bit grey (min-is-white inverted), 16-bit grey
//     (clipped to 255, as convert("RGB") clips mode I;16, min-is-white read
//     as min-is-black, as PIL reads it), signed 8- and 16-bit grey, grey with
//     alpha, 8- and 16-bit RGB (16 bits to the high byte), RGB with extra
//     samples (associated alpha divided out as PIL's "RGBa" unpacker divides
//     it), and 1- to 8-bit palettes (16-bit colormap entries to their high
//     byte).
//   - The Orientation tag turns the image as PIL's loader turns it
//     (ImageOps.exif_transpose).
//
// Refused naming ROADMAP.md's item: BigTIFF, JPEG-in-TIFF, CCITT fax,
// floating-point samples, fill order 2, the CMYK, YCbCr and CIELab
// photometrics, old-style LZW, the sample layouts not listed above, and the
// ones PIL misreads (16-bit planar samples without compression, planes with
// alpha, compressed big-endian signed samples). A strip or tile that does
// not decode to its full size is refused, as libtiff refuses it; so is any
// offset, count or code that leaves the file, and a tag of a type, count or
// value that PIL's parser or libtiff refuses.

#include <zlib.h>

#include <algorithm>
#include <cstring>
#include <map>

#include "formats.h"

namespace ssr {
namespace {

const char* kFmt = "TIFF";

[[noreturn]] void fail(const std::string& msg) { format_fail(kFmt, msg); }
[[noreturn]] void refuse(const std::string& what) {
  fail(what + " is not supported (" + std::string(kFormatsItem) + ")");
}

enum {
  kWidth = 256, kLength = 257, kBits = 258, kCompression = 259, kPhotometric = 262,
  kFillOrder = 266, kStripOffsets = 273, kSamples = 277, kRowsPerStrip = 278,
  kStripByteCounts = 279, kPlanar = 284, kPredictor = 317, kColorMap = 320, kTileWidth = 322,
  kTileLength = 323, kTileOffsets = 324, kTileByteCounts = 325, kExtraSamples = 338,
  kSampleFormat = 339, kOrientation = 274,
};

class Reader {
 public:
  Reader(const uint8_t* d, size_t n, bool big) : d_(d), n_(n), big_(big) {}
  uint32_t u16(size_t at) const {
    check(at, 2);
    return big_ ? (d_[at] << 8) | d_[at + 1] : d_[at] | (d_[at + 1] << 8);
  }
  uint32_t u32(size_t at) const {
    check(at, 4);
    return big_ ? (uint32_t(d_[at]) << 24) | (d_[at + 1] << 16) | (d_[at + 2] << 8) | d_[at + 3]
                : d_[at] | (d_[at + 1] << 8) | (d_[at + 2] << 16) | (uint32_t(d_[at + 3]) << 24);
  }
  void check(size_t at, size_t len) const {
    if (at > n_ || len > n_ - at) fail("an offset or count leaves the file");
  }
  bool big() const { return big_; }

 private:
  const uint8_t* d_;
  size_t n_;
  bool big_;
};

// The first IFD's tags. Values are read for SHORT and LONG, the types that
// both PIL's parser and libtiff take for every tag this decoder reads (PIL
// reads BYTE as bytes); a tag of another type keeps no values. A tag given
// twice is refused (libtiff keeps the first, PIL the last).
std::map<int, std::vector<uint32_t>> read_ifd(const Reader& r, size_t at) {
  std::map<int, std::vector<uint32_t>> tags;
  const uint32_t count = r.u16(at);
  r.check(at + 2, size_t(count) * 12);
  for (uint32_t i = 0; i < count; ++i) {
    const size_t e = at + 2 + size_t(i) * 12;
    const int tag = int(r.u16(e));
    if (tags.count(tag)) fail("tag " + std::to_string(tag) + " given twice");
    std::vector<uint32_t>& values = tags[tag];
    const uint32_t type = r.u16(e + 2);
    const int size = type == 3 ? 2 : type == 4 ? 4 : 0;
    if (!size) continue;
    const uint32_t n = r.u32(e + 4);
    if (uint64_t(n) * size > (uint64_t(1) << 31)) fail("tag " + std::to_string(tag) + " too long");
    const size_t bytes = size_t(n) * size;
    const size_t where = bytes <= 4 ? e + 8 : r.u32(e + 8);
    r.check(where, bytes);
    values.resize(n);
    for (uint32_t k = 0; k < n; ++k) {
      const size_t p = where + size_t(k) * size;
      values[k] = size == 2 ? r.u16(p) : r.u32(p);
    }
  }
  return tags;
}

// ----------------------------------------------------------- codecs

// libtiff's LZWDecode: MSB-first codes, 9 to 12 bits, the code size growing
// when the next free entry passes 2^size - 2.
void lzw_decode(const uint8_t* src, size_t n, uint8_t* out, size_t need) {
  if (n >= 2 && src[0] == 0 && (src[1] & 1)) refuse("old-style LZW");
  struct Entry {
    uint16_t prefix;
    uint8_t first, last;
    uint16_t length;
  };
  std::vector<Entry> table(4096 + 1024);
  for (int i = 0; i < 256; ++i) table[i] = Entry{0, uint8_t(i), uint8_t(i), 1};
  const int kClear = 256, kEoi = 257;
  size_t bitpos = 0;
  const size_t total_bits = n * 8;
  int nbits = 9;
  int free_ent = 258;
  int old = -1;
  size_t produced = 0;
  uint64_t acc = 0;  // bits not yet consumed, the next at the top of `have`
  int have = 0;
  size_t byte = 0;
  auto next_code = [&]() -> int {
    if (bitpos + nbits > total_bits) return kEoi;  // libtiff: not terminated with EOI
    while (have < nbits) {
      acc = (acc << 8) | src[byte++];
      have += 8;
    }
    bitpos += nbits;
    have -= nbits;
    return int((acc >> have) & ((1u << nbits) - 1));
  };
  while (produced < need) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      while (code == kClear) {  // consecutive clear codes
        nbits = 9;
        free_ent = 258;
        code = next_code();
      }
      if (code == kEoi) break;
      if (code >= kClear) fail("corrupt LZW data");
      out[produced++] = uint8_t(code);
      old = code;
      continue;
    }
    if (old < 0) fail("LZW data without a clear code");
    if (code > free_ent || free_ent >= int(table.size())) fail("corrupt LZW data");
    // the new entry: the old string and the first byte of this one
    Entry& e = table[free_ent];
    e.prefix = uint16_t(old);
    e.first = table[old].first;
    e.length = uint16_t(table[old].length + 1);
    e.last = code < free_ent ? table[code].first : e.first;
    if (++free_ent > (1 << nbits) - 2) nbits = std::min(nbits + 1, 12);
    // the string of `code`, written backwards; a string past the strip's
    // end is cut there
    const Entry& s = table[code];
    if (s.length == 0) fail("corrupt LZW data");
    const size_t len = s.length, take = std::min(len, need - produced);
    int c = code;
    for (size_t i = len; i-- > 0; c = table[c].prefix)
      if (i < take) out[produced + i] = table[c].last;
    produced += take;
    old = code;
  }
  if (produced < need) fail("not enough LZW data for the strip or tile");
}

void deflate_decode(const uint8_t* src, size_t n, uint8_t* out, size_t need) {
  z_stream zs;
  std::memset(&zs, 0, sizeof zs);
  if (inflateInit(&zs) != Z_OK) fail("zlib failed to start");
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = uInt(std::min<size_t>(n, 0xffffffffu));
  zs.next_out = out;
  zs.avail_out = uInt(need);
  int state = Z_OK;
  while (zs.avail_out > 0) {
    state = inflate(&zs, Z_PARTIAL_FLUSH);
    if (state == Z_STREAM_END) break;
    if (state != Z_OK) break;
  }
  const size_t got = need - zs.avail_out;
  inflateEnd(&zs);
  if (state != Z_OK && state != Z_STREAM_END) fail("corrupt Deflate data");
  if (got < need) fail("not enough Deflate data for the strip or tile");
}

// libtiff's PackBitsDecode over a whole strip or tile.
void packbits_decode(const uint8_t* src, size_t n, uint8_t* out, size_t need) {
  size_t i = 0, o = 0;
  while (o < need && i < n) {
    int c = int8_t(src[i++]);
    if (c < 0) {
      if (c == -128) continue;
      size_t run = size_t(1 - c);
      if (run > need - o) run = need - o;
      if (i >= n) break;
      std::memset(out + o, src[i++], run);
      o += run;
    } else {
      size_t run = size_t(c + 1);
      if (run > need - o) run = need - o;
      if (n - i < run) break;
      std::memcpy(out + o, src + i, run);
      o += run;
      i += run;
    }
  }
  if (o < need) fail("not enough PackBits data for the strip or tile");
}

// Horizontal differencing undone in place on rows of `row_bytes`.
void undo_predictor(uint8_t* buf, size_t rows, size_t row_bytes, int bits, int stride,
                    bool big) {
  for (size_t y = 0; y < rows; ++y) {
    uint8_t* row = buf + y * row_bytes;
    if (bits == 8) {
      for (size_t i = size_t(stride); i < row_bytes; ++i)
        row[i] = uint8_t(row[i] + row[i - stride]);
    } else {
      const size_t count = row_bytes / 2;
      auto get = [&](size_t k) {
        return big ? uint16_t((row[2 * k] << 8) | row[2 * k + 1])
                   : uint16_t(row[2 * k] | (row[2 * k + 1] << 8));
      };
      auto put = [&](size_t k, uint16_t v) {
        row[2 * k + (big ? 0 : 1)] = uint8_t(v >> 8);
        row[2 * k + (big ? 1 : 0)] = uint8_t(v);
      };
      for (size_t k = size_t(stride); k < count; ++k) put(k, uint16_t(get(k) + get(k - stride)));
    }
  }
}

// How the samples become RGB.
enum Layout { GREY, GREY_SIGNED, RGB_PLAIN, RGB_ASSOCIATED, PALETTE };

// PIL's TIFF loader ends with ImageOps.exif_transpose: the Orientation tag
// (1 to 8) turns the stored image; any other value leaves it.
void orient(const std::vector<uint8_t>& rgb, uint32_t w, uint32_t h, uint32_t orientation,
            RgbImage* out) {
  const bool swap = orientation >= 5 && orientation <= 8;
  const uint32_t ow = swap ? h : w, oh = swap ? w : h;
  out->w = int(ow);
  out->h = int(oh);
  if (orientation < 2 || orientation > 8) {
    out->rgb = rgb;
    return;
  }
  out->rgb.resize(rgb.size());
  for (uint32_t y = 0; y < oh; ++y)
    for (uint32_t x = 0; x < ow; ++x) {
      uint32_t sx, sy;  // the stored pixel that lands at (x, y)
      switch (orientation) {
        case 2: sx = w - 1 - x; sy = y; break;                 // mirrored
        case 3: sx = w - 1 - x; sy = h - 1 - y; break;         // turned 180
        case 4: sx = x; sy = h - 1 - y; break;                 // flipped
        case 5: sx = y; sy = x; break;                         // transposed
        case 6: sx = y; sy = h - 1 - x; break;                 // turned 90 clockwise
        case 7: sx = w - 1 - y; sy = h - 1 - x; break;         // transversed
        default: sx = w - 1 - y; sy = x; break;                // 8: turned 90 anticlockwise
      }
      std::memcpy(&out->rgb[(size_t(y) * ow + x) * 3], &rgb[(size_t(sy) * w + sx) * 3], 3);
    }
}

}  // namespace

bool is_tiff(const uint8_t* d, size_t n) {
  if (n < 4) return false;
  return (d[0] == 'I' && d[1] == 'I' && (d[2] == 42 || d[2] == 43) && d[3] == 0) ||
         (d[0] == 'M' && d[1] == 'M' && d[2] == 0 && (d[3] == 42 || d[3] == 43));
}

void decode_tiff(const uint8_t* d, size_t n, RgbImage* out) {
  if (!is_tiff(d, n)) fail("not a TIFF file");
  const bool big = d[0] == 'M';
  if (d[big ? 3 : 2] == 43) refuse("BigTIFF");
  const Reader r(d, n, big);
  if (n < 8) fail("truncated header");
  auto tags = read_ifd(r, r.u32(4));
  // a tag the decoder reads: absent, or of an integer type libtiff accepts
  auto has = [&](int tag) {
    auto it = tags.find(tag);
    if (it == tags.end()) return false;
    if (it->second.empty())
      fail("tag " + std::to_string(tag) + " has an unsupported type or no value");
    return true;
  };
  auto list = [&](int tag) -> const std::vector<uint32_t>& {
    has(tag);
    return tags[tag];
  };
  auto one = [&](int tag, uint32_t dflt) -> uint32_t {
    if (!has(tag)) return dflt;
    if (tags[tag].size() != 1) fail("tag " + std::to_string(tag) + " has several values");
    return tags[tag][0];
  };

  const uint32_t width = one(kWidth, 0), height = one(kLength, 0);
  if (!width || !height) fail("missing or zero image size");
  check_image_pixels(kFmt, width, height);
  const uint32_t compression = one(kCompression, 1);
  switch (compression) {
    case 1: case 5: case 8: case 32946: case 32773: break;
    case 2: case 3: case 4: refuse("CCITT fax compression");
    case 6: case 7: refuse("JPEG-in-TIFF");
    default: refuse("compression " + std::to_string(compression));
  }
  const uint32_t photometric = one(kPhotometric, 0);
  if (photometric == 5) refuse("the CMYK photometric");
  if (photometric == 6) refuse("the YCbCr photometric");
  if (photometric == 8) refuse("the CIELab photometric");
  if (photometric > 3) refuse("photometric " + std::to_string(photometric));
  const uint32_t fill_order = one(kFillOrder, 1);
  if (fill_order == 2) refuse("fill order 2");
  if (fill_order != 1) fail("bad fill order");
  // bits and samples as PIL reconciles them
  std::vector<uint32_t> bps = has(kBits) ? list(kBits) : std::vector<uint32_t>{1};
  if (!has(kSamples) && bps.size() > 1)  // PIL and libtiff would count samples apart
    fail("missing samples per pixel");
  const uint32_t spp = one(kSamples, 1);
  if (spp == 0 || spp > 6) fail("unsupported samples per pixel " + std::to_string(spp));
  if (spp < bps.size()) bps.resize(spp);
  if (spp > bps.size() && bps.size() == 1) bps.assign(spp, bps[0]);
  if (bps.size() != spp) fail("unknown data organization");
  for (uint32_t b : bps)
    if (b != bps[0]) fail("samples of different sizes");
  const int bits = int(bps[0]);
  std::vector<uint32_t> formats = has(kSampleFormat) ? list(kSampleFormat)
                                                     : std::vector<uint32_t>{1};
  uint32_t format = formats[0];
  for (uint32_t f : formats)
    if (f != format) format = 0;
  if (format == 3) refuse("floating-point samples");
  if (format != 1 && !(format == 2 && spp == 1 && photometric == 1 && (bits == 8 || bits == 16)))
    refuse("this sample format");
  const std::vector<uint32_t> extras = has(kExtraSamples) ? list(kExtraSamples)
                                                          : std::vector<uint32_t>{};
  const uint32_t planar_config = one(kPlanar, 1);
  if (planar_config != 1 && planar_config != 2) fail("bad planar configuration");
  const bool planar = planar_config == 2;

  // the layout, for the keys of PIL's OPEN_INFO this decoder reads
  Layout layout;
  if (photometric <= 1) {
    const bool ok_bits = bits == 1 || bits == 2 || bits == 4 || bits == 8 ||
                         (bits == 16 && !(big && photometric == 0));
    if (!ok_bits) refuse(std::to_string(bits) + "-bit grey samples");
    if (spp == 2 && !(bits == 8 && photometric == 1 && extras == std::vector<uint32_t>{2}))
      refuse("this grey layout");
    if (spp > 2 || (spp == 1 && !extras.empty())) refuse("this grey layout");
    if (format == 2 && spp != 1) refuse("this grey layout");
    layout = format == 2 && bits == 16 ? GREY_SIGNED : GREY;
  } else if (photometric == 2) {
    if (bits != 8 && bits != 16) refuse(std::to_string(bits) + "-bit RGB samples");
    const size_t extra = spp - 3;
    if (spp < 3 || (bits == 16 && spp > 4)) refuse("this RGB layout");
    layout = RGB_PLAIN;
    if (extra > 0) {
      if (extras.empty()) {
        if (extra != 1) refuse("this RGB layout");  // RGBA without ExtraSamples
      } else {
        if (extras.size() != extra) refuse("this RGB layout");
        for (size_t i = 1; i < extras.size(); ++i)
          if (extras[i] != 0) refuse("this RGB layout");
        const uint32_t e = extras[0];
        if (!(e == 0 || e == 1 || e == 2 || (e == 999 && extra == 1 && bits == 8)))
          refuse("these RGB extra samples");
        if (e == 1) layout = RGB_ASSOCIATED;
      }
    } else if (!extras.empty()) {
      refuse("this RGB layout");
    }
  } else {  // palette
    if (!(bits == 1 || bits == 2 || bits == 4 || bits == 8)) refuse("this palette depth");
    if (spp == 2 && !(bits == 8 && extras.size() == 1 && (extras[0] == 0 || extras[0] == 2)))
      refuse("this palette layout");
    if (spp > 2 || (spp == 1 && !extras.empty())) refuse("this palette layout");
    layout = PALETTE;
    if (!has(kColorMap)) fail("palette image without a colour map");
    if (list(kColorMap).size() != size_t(3) << bits) fail("colour map of the wrong size");
  }
  if (planar) {
    // PIL reads an uncompressed plane with one character of the rawmode, and
    // planes with alpha through libtiff's RGBA reader: only these layouts
    // come out as they are stored
    bool ok;
    if (compression == 1)
      ok = bits == 8 ? spp == 3 || (spp == 4 && extras.size() == 1 && extras[0] == 2) ||
                           (spp == 1 && photometric != 0)
                     : bits == 1 && spp == 1 && photometric == 1;
    else
      ok = spp == 1 || spp == 3;
    if (!ok) refuse("planar samples in this layout");
  }
  if (layout == GREY_SIGNED && big && compression != 1)
    refuse("compressed big-endian signed samples");  // PIL swaps their bytes
  const uint32_t predictor = one(kPredictor, 1);
  const bool predicted = compression == 5 || compression == 8 || compression == 32946;
  if (predicted && predictor != 1) {
    if (predictor != 2) refuse("predictor " + std::to_string(predictor));
    if (bits != 8 && bits != 16)
      fail("the predictor with " + std::to_string(bits) + "-bit samples");
  }

  // the blocks: strips or tiles, per plane when planar
  const bool tiled = has(kTileOffsets);
  const uint32_t planes = planar ? spp : 1;
  const uint32_t plane_samples = planar ? 1 : spp;
  uint32_t bw, bh;  // a block's width and height in pixels
  std::vector<uint32_t> offsets, counts;
  if (tiled) {
    bw = one(kTileWidth, 0);
    bh = one(kTileLength, 0);
    if (!bw || !bh) fail("bad tile size");
    offsets = list(kTileOffsets);
    if (has(kTileByteCounts)) counts = list(kTileByteCounts);
  } else {
    if (!has(kStripOffsets)) fail("no strips or tiles");
    bw = width;
    bh = std::min(one(kRowsPerStrip, 0xffffffffu), height);
    if (!bh) fail("bad rows per strip");
    offsets = list(kStripOffsets);
    if (has(kStripByteCounts)) counts = list(kStripByteCounts);
  }
  const uint64_t across = (uint64_t(width) + bw - 1) / bw, down = (uint64_t(height) + bh - 1) / bh;
  if (uint64_t(bw) * bh > (uint64_t(1) << 31)) fail("block too large");
  // Pillow's libtiff decoder sizes its buffer for the tag's rows per strip
  // (all rows when the tag is absent) and refuses one past INT_MAX bytes
  const uint64_t rows_tag = tiled ? bh : one(kRowsPerStrip, 0xffffffffu);
  if (offsets.size() != across * down * planes) fail("wrong number of strip or tile offsets");
  if (compression != 1 && counts.size() != offsets.size()) fail("missing or wrong byte counts");
  const size_t row_bytes = (size_t(bw) * plane_samples * bits + 7) / 8;
  if (compression != 1 && rows_tag != 0xffffffffu && rows_tag * row_bytes > 0x7fffffffu)
    fail("strip or tile past Pillow's buffer limit");
  // every block's bytes lie in the file before anything is allocated
  for (size_t block = 0; block < offsets.size(); ++block) {
    const uint64_t y0 = (block % (across * down)) / across * bh;
    const size_t rows = std::min<uint64_t>(bh, height - y0);
    if (compression == 1) {
      r.check(offsets[block], rows * row_bytes);  // PIL's raw decoder reads no counts
    } else {
      if (counts[block] == 0) fail("empty strip or tile");
      r.check(offsets[block], counts[block]);
    }
  }

  // samples[y][x][s] as 16-bit values
  std::vector<uint16_t> samples(size_t(width) * height * spp);
  std::vector<uint8_t> buf;
  size_t block = 0;
  for (uint32_t p = 0; p < planes; ++p)
    for (uint64_t by = 0; by < down; ++by)
      for (uint64_t bx = 0; bx < across; ++bx, ++block) {
        const uint32_t x0 = uint32_t(bx * bw), y0 = uint32_t(by * bh);
        // a strip holds the rows left; a tile is whole
        const size_t rows = tiled ? bh : std::min<size_t>(bh, height - y0);
        const size_t need = rows * row_bytes;
        const uint8_t* src;
        if (compression == 1) {
          src = d + offsets[block];
        } else {
          buf.resize(need);
          const uint8_t* in = d + offsets[block];
          if (compression == 5)
            lzw_decode(in, counts[block], buf.data(), need);
          else if (compression == 32773)
            packbits_decode(in, counts[block], buf.data(), need);
          else
            deflate_decode(in, counts[block], buf.data(), need);
          if (predicted && predictor == 2)
            undo_predictor(buf.data(), rows, row_bytes, bits, int(plane_samples), big);
          src = buf.data();
        }
        const uint32_t xs = std::min(bw, width - x0);
        const uint32_t ys = uint32_t(std::min<size_t>(rows, height - y0));
        for (uint32_t y = 0; y < ys; ++y) {
          const uint8_t* row = src + size_t(y) * row_bytes;
          uint16_t* dst = samples.data() + (size_t(y0 + y) * width + x0) * spp + p;
          for (uint32_t x = 0; x < xs; ++x)
            for (uint32_t s = 0; s < plane_samples; ++s) {
              const size_t k = size_t(x) * plane_samples + s;
              uint16_t v;
              if (bits == 16)
                v = big ? uint16_t((row[2 * k] << 8) | row[2 * k + 1])
                        : uint16_t(row[2 * k] | (row[2 * k + 1] << 8));
              else if (bits == 8)
                v = row[k];
              else
                v = uint16_t((row[(k * bits) >> 3] >> (8 - bits - ((k * bits) & 7))) &
                             ((1 << bits) - 1));
              dst[size_t(x) * spp + s] = v;
            }
        }
      }

  std::vector<uint8_t> rgb(size_t(width) * height * 3);
  uint8_t* o = rgb.data();
  const int maxv = (1 << bits) - 1;
  uint8_t pal[256 * 3] = {0};
  if (layout == PALETTE) {
    const std::vector<uint32_t>& cm = list(kColorMap);
    const size_t entries = size_t(1) << bits;
    for (size_t i = 0; i < entries; ++i)
      for (int c = 0; c < 3; ++c) pal[3 * i + c] = uint8_t((cm[c * entries + i] & 0xffff) >> 8);
  }
  for (size_t i = 0; i < size_t(width) * height; ++i, o += 3) {
    const uint16_t* s = samples.data() + i * spp;
    switch (layout) {
      case GREY: {
        int v;
        if (bits == 16) {
          v = std::min<int>(s[0], 255);
        } else {
          v = photometric == 0 ? maxv - s[0] : s[0];
          v = v * (255 / maxv);
        }
        o[0] = o[1] = o[2] = uint8_t(v);
        break;
      }
      case GREY_SIGNED: {
        const int v = int16_t(s[0]);
        o[0] = o[1] = o[2] = uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
        break;
      }
      case RGB_PLAIN:
        for (int c = 0; c < 3; ++c) o[c] = uint8_t(bits == 16 ? s[c] >> 8 : s[c]);
        break;
      case RGB_ASSOCIATED: {
        const int a = bits == 16 ? s[3] >> 8 : s[3];
        for (int c = 0; c < 3; ++c) {
          const int v = bits == 16 ? s[c] >> 8 : s[c];
          o[c] = a == 0 ? 0 : a == 255 ? uint8_t(v) : uint8_t(std::min(v * 255 / a, 255));
        }
        break;
      }
      default:
        std::memcpy(o, pal + 3 * s[0], 3);
    }
  }
  orient(rgb, width, height, one(kOrientation, 1), out);
}

}  // namespace ssr
