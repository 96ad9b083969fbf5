// WebP decoder of the port: the RIFF container, VP8 (lossy) and VP8L
// (lossless), to RGB as PIL 12.1 gives a WebP through libwebp 1.6's
// demuxer and animation decoder (RGBA output, alpha then dropped by
// convert("RGB")): a still image, or an animation's first frame.
//
//   - The container is checked as WebPDemux checks it: the RIFF size, chunk
//     sizes and padding inside it, VP8X first with only its defined flags.
//     A still image is one image (an ALPH chunk, then VP8 or VP8L) whose
//     size is the canvas. An animation (the VP8X animation flag) has ANIM,
//     then ANMF frames, each an optional ALPH and one VP8 or VP8L at an
//     offset inside the canvas; every frame is parsed and checked, the
//     first is decoded onto a transparent black canvas at its offset, as
//     WebPAnimDecoder gives it (frame 1 is a key frame: no background colour
//     and no blending). ICCP, EXIF, XMP and unknown chunks are skipped.
//   - VP8 follows RFC 6386 as libwebp decodes it: the boolean decoder,
//     segments, quantisers, intra prediction into a work buffer with
//     libwebp's borders (127 above, 129 to the left, the top-right of the
//     macroblock above-right for every 4x4 row), the inverse WHT and DCT,
//     then the simple or normal loop filter over the frame, then libwebp's
//     fancy chroma upsampling and its fixed-point YUV->RGB (yuv.h). All of
//     it is integer code, and the output is bit-equal.
//   - VP8L decodes the prefix codes (simple and normal, with the code-length
//     code), LZ77 with the 120-entry distance map, the colour cache, the
//     predictor, cross-colour, subtract-green and colour-indexing transforms
//     (pixel bundling included), and meta prefix codes.
//   - The alpha plane is not kept, but an ALPH chunk that libwebp would use
//     (a still image's with the VP8X alpha flag set, any animation frame's)
//     is decoded to check it, since libwebp fails the whole image when its
//     alpha fails.
//
// libwebp fails a file that reads past the end of a partition or of the
// lossless stream; so does this decoder.

#include <algorithm>
#include <cstring>

#include "formats.h"

namespace ssr {
namespace {

const char* kFmt = "WebP";

[[noreturn]] void fail(const std::string& msg) { format_fail(kFmt, msg); }

uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }
uint32_t le32(const uint8_t* p) { return le24(p) | (uint32_t(p[3]) << 24); }
bool tag_is(const uint8_t* p, const char* tag) { return std::memcmp(p, tag, 4) == 0; }

// ================================================================ VP8 tables

// RFC 6386's tables: the quantiser steps, the default coefficient
// probabilities and their update probabilities, and the 4x4 mode
// probabilities by the modes above and to the left.

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// Intra modes, numbered as libwebp numbers them (kBModesProba's order).
enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED,
  B_VL_PRED, B_HD_PRED, B_HU_PRED,
  DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED,
  DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6,
};
const int8_t kYModesIntra4[18] = {
    -B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6, -B_HE_PRED, 5,
    -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7, -B_VL_PRED, 8, -B_HD_PRED, -B_HU_PRED};

// ======================================================== boolean decoder

// libwebp's VP8BitReader, loading a byte at a time: range_ holds the range
// minus one, bits_ the bits held beyond the current eight. eof_ is set when
// the decoder needs bits past the end of its partition.
class BoolReader {
 public:
  void init(const uint8_t* p, size_t n) {
    p_ = p;
    end_ = p + n;
    value_ = 0;
    range_ = 255 - 1;
    bits_ = -8;
    eof_ = false;
    load();
  }
  int bit(int prob) {
    uint32_t range = range_;
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = (range * uint32_t(prob)) >> 8;
    const uint32_t value = uint32_t(value_ >> pos);
    int b;
    if (value > split) {
      range -= split;
      value_ -= uint64_t(split + 1) << pos;
      b = 1;
    } else {
      range = split + 1;
      b = 0;
    }
    const int shift = 7 ^ (31 - __builtin_clz(range));
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return b;
  }
  uint32_t value(int nbits) {
    uint32_t v = 0;
    while (nbits-- > 0) v |= uint32_t(bit(0x80)) << nbits;
    return v;
  }
  int signed_value(int nbits) {
    const int v = int(value(nbits));
    return value(1) ? -v : v;
  }
  bool eof() const { return eof_; }

 private:
  void load() {
    if (p_ < end_) {
      bits_ += 8;
      value_ = (value_ << 8) | *p_++;
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }
  const uint8_t* p_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  uint32_t range_ = 254;
  int bits_ = -8;
  bool eof_ = false;
};

// ============================================================ VP8 (lossy)

constexpr int BPS = 32;  // the work buffer's stride, as libwebp's
constexpr int kYOff = BPS * 1 + 8;
constexpr int kUOff = kYOff + BPS * 16 + BPS;
constexpr int kVOff = kUOff + 16;
constexpr int kWorkSize = BPS * 17 + BPS * 9;

inline uint8_t clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : uint8_t(v); }
inline uint8_t avg3(int a, int b, int c) { return uint8_t((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

// ----------------------------------------------------------- predictors

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip255(top[x] + left - tl);
    dst += BPS;
  }
}

void fill_block(uint8_t* dst, int size, int v) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

void predict_luma16(int mode, uint8_t* dst) {
  int dc;
  switch (mode) {
    case DC_PRED:
      dc = 16;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill_block(dst, 16, dc >> 5);
      break;
    case TM_PRED:
      true_motion(dst, 16);
      break;
    case V_PRED:
      for (int j = 0; j < 16; ++j) std::memcpy(dst + j * BPS, dst - BPS, 16);
      break;
    case H_PRED:
      for (int j = 0; j < 16; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], 16);
      break;
    case DC_NOTOP:
      dc = 8;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
      fill_block(dst, 16, dc >> 4);
      break;
    case DC_NOLEFT:
      dc = 8;
      for (int i = 0; i < 16; ++i) dc += dst[i - BPS];
      fill_block(dst, 16, dc >> 4);
      break;
    default:
      fill_block(dst, 16, 0x80);
  }
}

void predict_chroma8(int mode, uint8_t* dst) {
  int dc;
  switch (mode) {
    case DC_PRED:
      dc = 8;
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill_block(dst, 8, dc >> 4);
      break;
    case TM_PRED:
      true_motion(dst, 8);
      break;
    case V_PRED:
      for (int j = 0; j < 8; ++j) std::memcpy(dst + j * BPS, dst - BPS, 8);
      break;
    case H_PRED:
      for (int j = 0; j < 8; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], 8);
      break;
    case DC_NOTOP:
      dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[-1 + i * BPS];
      fill_block(dst, 8, dc >> 3);
      break;
    case DC_NOLEFT:
      dc = 4;
      for (int i = 0; i < 8; ++i) dc += dst[i - BPS];
      fill_block(dst, 8, dc >> 3);
      break;
    default:
      fill_block(dst, 8, 0x80);
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void predict_luma4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill_block(dst, 4, int(dc >> 3));
      break;
    }
    case B_TM_PRED:
      true_motion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED:
      std::memset(dst + 0 * BPS, avg3(X, I, J), 4);
      std::memset(dst + 1 * BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // B_HU_PRED
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
  }
}

#undef DST

// ----------------------------------------------------------- transforms

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// The inverse DCT of one 4x4 block added to dst (libwebp's TransformOne).
void transform_add(const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    ++in;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip255(dst[0] + ((a + d) >> 3));
    dst[1] = clip255(dst[1] + ((b + c) >> 3));
    dst[2] = clip255(dst[2] + ((b - c) >> 3));
    dst[3] = clip255(dst[3] + ((a - d) >> 3));
    ++tmp;
    dst += BPS;
  }
}

// Add a block's residual unless all its coefficients are zero (adding a zero
// block changes nothing, as libwebp's skipped transforms show).
void add_residual(const int16_t* in, uint8_t* dst) {
  for (int i = 0; i < 16; ++i)
    if (in[i]) {
      transform_add(in, dst);
      return;
    }
}

// The inverse Walsh-Hadamard transform of the 16 luma DCs, into the DC of
// each block (libwebp's TransformWHT).
void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

// ----------------------------------------------------------- loop filter

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020,1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112,112]

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip255(p0 + a2);
  p[0] = clip255(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip255(p1 + a3);
  p[-step] = clip255(p0 + a2);
  p[0] = clip255(q0 - a1);
  p[step] = clip255(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip255(p2 + a3);
  p[-2 * step] = clip255(p1 + a2);
  p[-step] = clip255(p0 + a1);
  p[0] = clip255(q0 - a1);
  p[step] = clip255(q1 - a2);
  p[2 * step] = clip255(q2 - a3);
}

inline int absd(int a, int b) { return a > b ? a - b : b - a; }

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return absd(p1, p0) > thresh || absd(q1, q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * absd(p0, q0) + absd(p1, q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * absd(p0, q0) + absd(p1, q1) > t) return false;
  return absd(p3, p2) <= it && absd(p2, p1) <= it && absd(p1, p0) <= it &&
         absd(q3, q2) <= it && absd(q2, q1) <= it && absd(q1, q0) <= it;
}

void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (needs_filter(p + i * vstride, hstride, thresh2)) do_filter2(p + i * vstride, hstride);
}

// The normal filter along one edge of `size` pixels: `mb` picks the
// macroblock-edge form (6 taps) over the inner-edge form (4 taps).
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_thresh, bool mb) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh))
        do_filter2(p, hstride);
      else if (mb)
        do_filter6(p, hstride);
      else
        do_filter4(p, hstride);
    }
    p += vstride;
  }
}

struct FilterInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

// ----------------------------------------------------------- YUV -> RGB

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) { return (v & ~16383) == 0 ? uint8_t(v >> 6) : v < 0 ? 0 : 255; }

inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  const int yy = mult_hi(y, 19077);
  rgb[0] = yuv_clip8(yy + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(yy + mult_hi(u, 33050) - 17685);
}

// libwebp's fancy upsampler (UPSAMPLE_FUNC): one or two output rows from
// two rows of chroma, each chroma sample weighted 9-3-3-1.
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  auto load = [](int u, int v) { return uint32_t(u) | (uint32_t(v) << 16); };
  const int last_pair = (len - 1) >> 1;
  uint32_t tl_uv = load(top_u[0], top_v[0]);
  uint32_t l_uv = load(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_rgb(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
  }
  if (bottom_y) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_rgb(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
  }
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t_uv = load(top_u[x], top_v[x]);
    const uint32_t uv = load(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_rgb(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, top_dst + (2 * x - 1) * 3);
      yuv_to_rgb(top_y[2 * x], uv1 & 0xff, uv1 >> 16, top_dst + (2 * x) * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_rgb(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (2 * x - 1) * 3);
      yuv_to_rgb(bottom_y[2 * x], uv1 & 0xff, uv1 >> 16, bottom_dst + (2 * x) * 3);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_rgb(top_y[len - 1], uv0 & 0xff, uv0 >> 16, top_dst + (len - 1) * 3);
    }
    if (bottom_y) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_rgb(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (len - 1) * 3);
    }
  }
}

// ----------------------------------------------------------- the decoder

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};

struct MbData {
  int16_t coeffs[384];
  uint8_t is_i4x4, imodes[16], uvmode, segment, skip;
};

class Vp8Decoder {
 public:
  // data: the VP8 payload and what follows it in the frame (libwebp hands
  // the decoder the chunk's padding byte too); chunk: the payload's size.
  Vp8Decoder(const uint8_t* data, size_t size, size_t chunk)
      : d_(data), n_(size), chunk_(chunk) {}

  // The frame header (VP8GetInfo): width and height, 0 if it is not a
  // valid key frame.
  static bool info(const uint8_t* d, size_t n, size_t chunk, int* w, int* h) {
    if (n < 10 || d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a) return false;
    const uint32_t bits = le24(d);
    if (bits & 1) return false;                                  // not a key frame
    if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= chunk) return false;
    *w = int(le16(d + 6) & 0x3fff);
    *h = int(le16(d + 8) & 0x3fff);
    return *w && *h;
  }

  void decode(RgbImage* out) {
    if (!info(d_, n_, chunk_, &width_, &height_)) fail("bad VP8 frame header");
    check_image_pixels(kFmt, uint64_t(width_), uint64_t(height_));
    parse_headers();
    mb_w_ = (width_ + 15) >> 4;
    mb_h_ = (height_ + 15) >> 4;
    y_stride_ = size_t(mb_w_) * 16;
    uv_stride_ = size_t(mb_w_) * 8;
    Y_.assign(y_stride_ * size_t(mb_h_) * 16, 0);
    U_.assign(uv_stride_ * size_t(mb_h_) * 8, 0);
    V_.assign(U_.size(), 0);
    finfo_.assign(size_t(mb_w_) * mb_h_, FilterInfo());
    decode_frame();
    if (filter_type_ > 0) filter_frame();
    emit_rgb(out);
  }

 private:
  void parse_headers() {
    const uint32_t part_len = le24(d_) >> 5;
    const uint8_t* buf = d_ + 10;
    size_t buf_size = n_ - 10;
    if (part_len > buf_size) fail("bad VP8 partition length");
    br_.init(buf, part_len);
    buf += part_len;
    buf_size -= part_len;
    br_.value(1);  // colour space
    br_.value(1);  // clamping type: libwebp always clamps
    // segment header
    use_segment_ = br_.value(1);
    if (use_segment_) {
      update_map_ = br_.value(1);
      if (br_.value(1)) {
        absolute_delta_ = br_.value(1);
        for (int s = 0; s < 4; ++s) quantizer_[s] = br_.value(1) ? br_.signed_value(7) : 0;
        for (int s = 0; s < 4; ++s) filter_strength_[s] = br_.value(1) ? br_.signed_value(6) : 0;
      }
      if (update_map_)
        for (int s = 0; s < 3; ++s) seg_proba_[s] = br_.value(1) ? uint8_t(br_.value(8)) : 255;
    }
    if (br_.eof()) fail("cannot parse the VP8 segment header");
    // filter header
    simple_ = br_.value(1);
    level_ = int(br_.value(6));
    sharpness_ = int(br_.value(3));
    use_lf_delta_ = br_.value(1);
    if (use_lf_delta_ && br_.value(1)) {
      for (int i = 0; i < 4; ++i)
        if (br_.value(1)) ref_lf_delta_[i] = br_.signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br_.value(1)) mode_lf_delta_[i] = br_.signed_value(6);
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
    if (br_.eof()) fail("cannot parse the VP8 filter header");
    // token partitions
    const size_t last = (size_t(1) << br_.value(2)) - 1;
    num_parts_m1_ = int(last);
    if (buf_size < 3 * last) fail("cannot read the VP8 partition sizes");
    const uint8_t* part = buf + 3 * last;
    size_t left = buf_size - 3 * last;
    for (size_t p = 0; p < last; ++p) {
      size_t psize = le24(buf + 3 * p);
      if (psize > left) psize = left;
      parts_[p].init(part, psize);
      part += psize;
      left -= psize;
    }
    parts_[last].init(part, left);
    if (left == 0) fail("truncated VP8 partitions");
    parse_quant();
    br_.value(1);  // refresh entropy probabilities, not used for one frame
    parse_proba();
    precompute_filter_strengths();
  }

  void parse_quant() {
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    const int base_q0 = int(br_.value(7));
    const int dqy1_dc = br_.value(1) ? br_.signed_value(4) : 0;
    const int dqy2_dc = br_.value(1) ? br_.signed_value(4) : 0;
    const int dqy2_ac = br_.value(1) ? br_.signed_value(4) : 0;
    const int dquv_dc = br_.value(1) ? br_.signed_value(4) : 0;
    const int dquv_ac = br_.value(1) ? br_.signed_value(4) : 0;
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment_) {
        q = quantizer_[i];
        if (!absolute_delta_) q += base_q0;
      } else if (i > 0) {
        dqm_[i] = dqm_[0];
        continue;
      } else {
        q = base_q0;
      }
      QuantMatrix& m = dqm_[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;  // x * 155 / 100
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }

  void parse_proba() {
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba_[t][b][c][p] = br_.bit(kCoeffsUpdateProba[t][b][c][p])
                                     ? uint8_t(br_.value(8))
                                     : kCoeffsProba0[t][b][c][p];
    use_skip_proba_ = br_.value(1);
    if (use_skip_proba_) skip_p_ = int(br_.value(8));
  }

  void precompute_filter_strengths() {
    if (filter_type_ == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base = level_;
      if (use_segment_) {
        base = filter_strength_[s];
        if (!absolute_delta_) base += level_;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FilterInfo& info = fstrengths_[s][i4x4];
        int level = base;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4x4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = uint8_t(ilevel);
          info.limit = uint8_t(2 * level + ilevel);
          info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = uint8_t(i4x4);
      }
    }
  }

  // ------------------------------------------------------------- parsing

  void parse_intra_mode(int mb_x, MbData* block) {
    uint8_t* top = intra_t_.data() + 4 * mb_x;
    uint8_t* left = intra_l_;
    if (update_map_) {
      block->segment = !br_.bit(seg_proba_[0]) ? uint8_t(br_.bit(seg_proba_[1]))
                                               : uint8_t(br_.bit(seg_proba_[2]) + 2);
    } else {
      block->segment = 0;
    }
    if (use_skip_proba_) block->skip = uint8_t(br_.bit(skip_p_));
    block->is_i4x4 = !br_.bit(145);
    if (!block->is_i4x4) {
      const int ymode =
          br_.bit(156) ? (br_.bit(128) ? TM_PRED : H_PRED) : (br_.bit(163) ? V_PRED : DC_PRED);
      block->imodes[0] = uint8_t(ymode);
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = block->imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba[top[x]][ymode];
          int i = kYModesIntra4[br_.bit(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br_.bit(prob[i])];
          ymode = -i;
          top[x] = uint8_t(ymode);
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = uint8_t(ymode);
      }
    }
    block->uvmode = !br_.bit(142) ? DC_PRED
                    : !br_.bit(114) ? V_PRED
                    : br_.bit(183) ? TM_PRED
                                   : H_PRED;
  }

  int large_value(BoolReader& br, const uint8_t* p) {
    int v;
    if (!br.bit(p[3])) {
      v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
    } else if (!br.bit(p[6])) {
      if (!br.bit(p[7])) {
        v = 5 + br.bit(159);
      } else {
        v = 7 + 2 * br.bit(165);
        v += br.bit(145);
      }
    } else {
      const int bit1 = br.bit(p[8]);
      const int bit0 = br.bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // The coefficients of one block from position n on, dequantised into out
  // at their raster positions; returns the position after the last non-zero.
  int coeffs(BoolReader& br, int type, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.bit(p[0])) return n;
      while (!br.bit(p[1])) {
        p = proba_[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      const uint8_t(*p_ctx)[11] = proba_[type][kBands[n + 1]];
      int v;
      if (!br.bit(p[2])) {
        v = 1;
        p = p_ctx[1];
      } else {
        v = large_value(br, p);
        p = p_ctx[2];
      }
      const int s = br.bit(0x80) ? -v : v;
      out[kZigzag[n]] = int16_t(s * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
    return nz_coeffs;
  }

  // libwebp's ParseResiduals: returns whether every coefficient is zero.
  bool parse_residuals(BoolReader& br, int mb_x, MbData* block) {
    const QuantMatrix& q = dqm_[block->segment];
    int16_t* dst = block->coeffs;
    std::memset(dst, 0, sizeof(block->coeffs));
    uint8_t& top_nz = nz_t_[mb_x];
    uint8_t& top_dc = nz_dc_t_[mb_x];
    int first, type;
    if (!block->is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = top_dc + nz_dc_l_;
      const int nz = coeffs(br, 1, ctx, q.y2, 0, dc);
      top_dc = nz_dc_l_ = (nz > 0);
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = int16_t(dc0);
      }
      first = 1;
      type = 0;
    } else {
      first = 0;
      type = 3;
    }
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    uint32_t tnz = top_nz & 0x0f;
    uint32_t lnz = nz_l_ & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = coeffs(br, type, ctx, q.y1, first, dst);
        l = (nz > first);
        tnz = (tnz >> 1) | (uint32_t(l) << 7);
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (lnz >> 1) | (uint32_t(l) << 7);
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz;
    uint32_t out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = top_nz >> (4 + ch);
      lnz = nz_l_ >> (4 + ch);
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = coeffs(br, 2, ctx, q.uv, 0, dst);
          l = (nz > 0);
          tnz = (tnz >> 1) | (uint32_t(l) << 3);
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (lnz >> 1) | (uint32_t(l) << 5);
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= (tnz << 4) << ch;
      out_l_nz |= (lnz & 0xf0) << ch;
    }
    top_nz = uint8_t(out_t_nz);
    nz_l_ = uint8_t(out_l_nz);
    return !(non_zero_y | non_zero_uv);
  }

  // ------------------------------------------------------- reconstruction

  void reconstruct_row(int mb_y) {
    uint8_t* const y_dst = work_ + kYOff;
    uint8_t* const u_dst = work_ + kUOff;
    uint8_t* const v_dst = work_ + kVOff;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(u_dst - BPS - 1, 127, 8 + 1);
      std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      const MbData& block = row_[mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j) std::memcpy(y_dst + j * BPS - 4, y_dst + j * BPS + 12, 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(u_dst + j * BPS - 4, u_dst + j * BPS + 4, 4);
          std::memcpy(v_dst + j * BPS - 4, v_dst + j * BPS + 4, 4);
        }
      }
      uint8_t* top_y = top_y_.data() + 16 * size_t(mb_x);
      uint8_t* top_u = top_u_.data() + 8 * size_t(mb_x);
      uint8_t* top_v = top_v_.data() + 8 * size_t(mb_x);
      if (mb_y > 0) {
        std::memcpy(y_dst - BPS, top_y, 16);
        std::memcpy(u_dst - BPS, top_u, 8);
        std::memcpy(v_dst - BPS, top_v, 8);
      }
      const int16_t* coeffs = block.coeffs;
      if (block.is_i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w_ - 1)
            std::memset(top_right, top_y[15], 4);
          else
            std::memcpy(top_right, top_y + 16, 4);
        }
        for (int r = 1; r <= 3; ++r) std::memcpy(top_right + 4 * r * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          predict_luma4(block.imodes[n], dst);
          add_residual(coeffs + n * 16, dst);
        }
      } else {
        predict_luma16(check_mode(mb_x, mb_y, block.imodes[0]), y_dst);
        for (int n = 0; n < 16; ++n)
          add_residual(coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
      }
      const int uv_mode = check_mode(mb_x, mb_y, block.uvmode);
      predict_chroma8(uv_mode, u_dst);
      predict_chroma8(uv_mode, v_dst);
      for (int n = 0; n < 4; ++n) {
        const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
        add_residual(coeffs + (16 + n) * 16, u_dst + off);
        add_residual(coeffs + (20 + n) * 16, v_dst + off);
      }
      if (mb_y < mb_h_ - 1) {
        std::memcpy(top_y, y_dst + 15 * BPS, 16);
        std::memcpy(top_u, u_dst + 7 * BPS, 8);
        std::memcpy(top_v, v_dst + 7 * BPS, 8);
      }
      uint8_t* Y = Y_.data() + size_t(mb_y) * 16 * y_stride_ + size_t(mb_x) * 16;
      for (int j = 0; j < 16; ++j) std::memcpy(Y + j * y_stride_, y_dst + j * BPS, 16);
      uint8_t* U = U_.data() + size_t(mb_y) * 8 * uv_stride_ + size_t(mb_x) * 8;
      uint8_t* V = V_.data() + size_t(mb_y) * 8 * uv_stride_ + size_t(mb_x) * 8;
      for (int j = 0; j < 8; ++j) {
        std::memcpy(U + j * uv_stride_, u_dst + j * BPS, 8);
        std::memcpy(V + j * uv_stride_, v_dst + j * BPS, 8);
      }
    }
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode != DC_PRED) return mode;
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : DC_PRED;
  }

  void decode_frame() {
    intra_t_.assign(4 * size_t(mb_w_), B_DC_PRED);
    nz_t_.assign(mb_w_, 0);
    nz_dc_t_.assign(mb_w_, 0);
    top_y_.assign(16 * size_t(mb_w_) + 4, 0);  // + the top-right of the last macroblock
    top_u_.assign(8 * size_t(mb_w_), 0);
    top_v_.assign(8 * size_t(mb_w_), 0);
    row_.assign(mb_w_, MbData());
    std::memset(work_, 0, sizeof(work_));
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      std::memset(intra_l_, B_DC_PRED, sizeof(intra_l_));
      nz_l_ = nz_dc_l_ = 0;
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) parse_intra_mode(mb_x, &row_[mb_x]);
      if (br_.eof()) fail("premature end of VP8 partition 0");
      BoolReader& token_br = parts_[mb_y & num_parts_m1_];
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        MbData& block = row_[mb_x];
        bool skip = use_skip_proba_ ? block.skip : false;
        if (!skip) {
          skip = parse_residuals(token_br, mb_x, &block);
        } else {
          nz_l_ = nz_t_[mb_x] = 0;
          if (!block.is_i4x4) nz_dc_l_ = nz_dc_t_[mb_x] = 0;
          std::memset(block.coeffs, 0, sizeof(block.coeffs));
        }
        if (filter_type_ > 0) {
          FilterInfo& f = finfo_[size_t(mb_y) * mb_w_ + mb_x];
          f = fstrengths_[block.segment][block.is_i4x4];
          f.inner |= uint8_t(!skip);
        }
        if (token_br.eof()) fail("premature end of VP8 data");
      }
      reconstruct_row(mb_y);
    }
  }

  void filter_frame() {
    const int ys = int(y_stride_), uvs = int(uv_stride_);
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        const FilterInfo& f = finfo_[size_t(mb_y) * mb_w_ + mb_x];
        const int limit = f.limit;
        if (limit == 0) continue;
        const int ilevel = f.ilevel, hev_t = f.hev_thresh;
        uint8_t* y = Y_.data() + size_t(mb_y) * 16 * y_stride_ + size_t(mb_x) * 16;
        if (filter_type_ == 1) {
          if (mb_x > 0) simple_filter(y, 1, ys, limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k) simple_filter(y + 4 * k, 1, ys, limit);
          if (mb_y > 0) simple_filter(y, ys, 1, limit + 4);
          if (f.inner)
            for (int k = 1; k <= 3; ++k) simple_filter(y + 4 * k * ys, ys, 1, limit);
          continue;
        }
        uint8_t* u = U_.data() + size_t(mb_y) * 8 * uv_stride_ + size_t(mb_x) * 8;
        uint8_t* v = V_.data() + size_t(mb_y) * 8 * uv_stride_ + size_t(mb_x) * 8;
        if (mb_x > 0) {
          filter_loop(y, 1, ys, 16, limit + 4, ilevel, hev_t, true);
          filter_loop(u, 1, uvs, 8, limit + 4, ilevel, hev_t, true);
          filter_loop(v, 1, uvs, 8, limit + 4, ilevel, hev_t, true);
        }
        if (f.inner) {
          for (int k = 1; k <= 3; ++k)
            filter_loop(y + 4 * k, 1, ys, 16, limit, ilevel, hev_t, false);
          filter_loop(u + 4, 1, uvs, 8, limit, ilevel, hev_t, false);
          filter_loop(v + 4, 1, uvs, 8, limit, ilevel, hev_t, false);
        }
        if (mb_y > 0) {
          filter_loop(y, ys, 1, 16, limit + 4, ilevel, hev_t, true);
          filter_loop(u, uvs, 1, 8, limit + 4, ilevel, hev_t, true);
          filter_loop(v, uvs, 1, 8, limit + 4, ilevel, hev_t, true);
        }
        if (f.inner) {
          for (int k = 1; k <= 3; ++k)
            filter_loop(y + 4 * k * ys, ys, 1, 16, limit, ilevel, hev_t, false);
          filter_loop(u + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t, false);
          filter_loop(v + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t, false);
        }
      }
    }
  }

  // libwebp's EmitFancyRGB over the whole frame.
  void emit_rgb(RgbImage* out) {
    const int w = width_, h = height_;
    out->w = w;
    out->h = h;
    out->rgb.assign(size_t(w) * h * 3, 0);
    const size_t stride = size_t(w) * 3;
    uint8_t* rgb = out->rgb.data();
    auto yrow = [&](int y) { return Y_.data() + size_t(y) * y_stride_; };
    auto urow = [&](int y) { return U_.data() + size_t(y) * uv_stride_; };
    auto vrow = [&](int y) { return V_.data() + size_t(y) * uv_stride_; };
    upsample_pair(yrow(0), nullptr, urow(0), vrow(0), urow(0), vrow(0), rgb, nullptr, w);
    int y = 0;
    for (; y + 2 < h; y += 2) {
      const int k = y / 2;
      upsample_pair(yrow(y + 1), yrow(y + 2), urow(k), vrow(k), urow(k + 1), vrow(k + 1),
                    rgb + (y + 1) * stride, rgb + (y + 2) * stride, w);
    }
    if (!(h & 1)) {
      const int k = (h - 1) / 2;
      upsample_pair(yrow(h - 1), nullptr, urow(k), vrow(k), urow(k), vrow(k),
                    rgb + size_t(h - 1) * stride, nullptr, w);
    }
  }

  const uint8_t* d_;
  size_t n_, chunk_;
  int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0;
  size_t y_stride_ = 0, uv_stride_ = 0;
  BoolReader br_;
  BoolReader parts_[8];
  int num_parts_m1_ = 0;
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int quantizer_[4] = {0, 0, 0, 0}, filter_strength_[4] = {0, 0, 0, 0};
  uint8_t seg_proba_[3] = {255, 255, 255};
  bool simple_ = false, use_lf_delta_ = false;
  int level_ = 0, sharpness_ = 0, filter_type_ = 0;
  int ref_lf_delta_[4] = {0, 0, 0, 0}, mode_lf_delta_[4] = {0, 0, 0, 0};
  QuantMatrix dqm_[4];
  uint8_t proba_[4][8][3][11];
  bool use_skip_proba_ = false;
  int skip_p_ = 0;
  FilterInfo fstrengths_[4][2];
  std::vector<uint8_t> intra_t_, nz_t_, nz_dc_t_, top_y_, top_u_, top_v_;
  uint8_t intra_l_[4];
  uint8_t nz_l_ = 0, nz_dc_l_ = 0;
  std::vector<MbData> row_;
  uint8_t work_[kWorkSize];
  std::vector<uint8_t> Y_, U_, V_;
  std::vector<FilterInfo> finfo_;
};

// ========================================================= VP8L (lossless)

// Bits read least significant first; reading past the end of the data sets
// eos, which fails the image (libwebp's VP8LIsEndOfStream).
class LBitReader {
 public:
  LBitReader(const uint8_t* d, size_t n) : d_(d), n_(n) { fill(); }
  uint32_t peek(int nbits) const { return uint32_t(buf_) & ((1u << nbits) - 1); }
  void skip(int nbits) {
    buf_ >>= nbits;
    avail_ -= nbits;
    consumed_ += uint64_t(nbits);
    if (avail_ < 32) fill();
  }
  uint32_t read(int nbits) {
    const uint32_t v = peek(nbits);
    skip(nbits);
    return v;
  }
  bool eos() const { return consumed_ > 8 * uint64_t(n_); }

 private:
  void fill() {
    while (avail_ <= 56) {
      const uint64_t b = pos_ < n_ ? d_[pos_] : 0;
      ++pos_;
      buf_ |= b << avail_;
      avail_ += 8;
    }
  }
  const uint8_t* d_;
  size_t n_, pos_ = 0;
  uint64_t buf_ = 0, consumed_ = 0;
  int avail_ = 0;
};

constexpr int kRootBits = 8;
// A cap on the decode tables of one image: real files use a small fraction;
// a hostile header cannot make the decoder allocate gigabytes.
constexpr size_t kMaxTableEntries = size_t(1) << 25;

// A canonical prefix code: a root table indexed by the next 8 bits, and for
// longer codes a second-level table per root entry.
struct PrefixCode {
  struct Entry {
    uint16_t value;  // the symbol, or the second-level table's offset
    uint8_t bits;    // the code's length; in a root entry over 8: 8 + the sub-table's bits
  };
  std::vector<Entry> table;

  // false for a code libwebp's BuildHuffmanTable refuses: no symbol, or an
  // incomplete or over-subscribed set of lengths other than one symbol.
  bool build(const int* lengths, int n) {
    int count[16] = {0};
    int nonzero = 0, only = 0;
    for (int s = 0; s < n; ++s) {
      if (lengths[s] < 0 || lengths[s] > 15) return false;
      ++count[lengths[s]];
      if (lengths[s]) {
        ++nonzero;
        only = s;
      }
    }
    if (nonzero == 0) return false;
    if (nonzero == 1) {
      table.assign(1 << kRootBits, Entry{uint16_t(only), 0});
      return true;
    }
    int left = 1;
    for (int len = 1; len <= 15; ++len) {
      left = (left << 1) - count[len];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    int next[16];
    next[1] = 0;
    for (int len = 2; len <= 15; ++len) next[len] = (next[len - 1] + count[len - 1]) << 1;
    std::vector<uint32_t> rev(n, 0);
    int max_len_for_root[1 << kRootBits] = {0};
    for (int s = 0; s < n; ++s) {
      const int len = lengths[s];
      if (!len) continue;
      uint32_t code = uint32_t(next[len]++), r = 0;
      for (int i = 0; i < len; ++i) r |= ((code >> i) & 1) << (len - 1 - i);
      rev[s] = r;
      if (len > kRootBits) {
        int& m = max_len_for_root[r & ((1 << kRootBits) - 1)];
        m = std::max(m, len);
      }
    }
    size_t size = 1 << kRootBits;
    std::vector<uint32_t> sub_offset(1 << kRootBits, 0);
    for (int r = 0; r < (1 << kRootBits); ++r)
      if (max_len_for_root[r]) {
        sub_offset[r] = uint32_t(size);
        size += size_t(1) << (max_len_for_root[r] - kRootBits);
      }
    if (size > 65535) return false;
    table.assign(size, Entry{0, 0});
    for (int r = 0; r < (1 << kRootBits); ++r)
      if (max_len_for_root[r])
        table[r] = Entry{uint16_t(sub_offset[r]), uint8_t(max_len_for_root[r])};
    for (int s = 0; s < n; ++s) {
      const int len = lengths[s];
      if (!len) continue;
      if (len <= kRootBits) {
        for (uint32_t i = rev[s]; i < (1u << kRootBits); i += 1u << len)
          table[i] = Entry{uint16_t(s), uint8_t(len)};
      } else {
        const uint32_t root = rev[s] & ((1 << kRootBits) - 1);
        const int sub_bits = max_len_for_root[root] - kRootBits;
        const uint32_t base = sub_offset[root];
        for (uint32_t i = rev[s] >> kRootBits; i < (1u << sub_bits); i += 1u << (len - kRootBits))
          table[base + i] = Entry{uint16_t(s), uint8_t(len - kRootBits)};
      }
    }
    return true;
  }

  int read(LBitReader& br) const {
    const Entry& e = table[br.peek(kRootBits)];
    if (e.bits <= kRootBits) {
      br.skip(e.bits);
      return e.value;
    }
    br.skip(kRootBits);
    const Entry& s = table[e.value + br.peek(e.bits - kRootBits)];
    br.skip(s.bits);
    return s.value;
  }
};

struct HTreeGroup {
  PrefixCode codes[5];  // green (+ lengths + cache), red, blue, alpha, distance
};

enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

const uint8_t kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};

// (dx, dy) of the 120 short distance codes, as the specification lists them.
const int8_t kDistanceMap[120][2] = {
    {0, 1}, {1, 0}, {1, 1}, {-1, 1}, {0, 2}, {2, 0}, {1, 2}, {-1, 2}, {2, 1}, {-2, 1}, {2, 2},
    {-2, 2}, {0, 3}, {3, 0}, {1, 3}, {-1, 3}, {3, 1}, {-3, 1}, {2, 3}, {-2, 3}, {3, 2}, {-3, 2},
    {0, 4}, {4, 0}, {1, 4}, {-1, 4}, {4, 1}, {-4, 1}, {3, 3}, {-3, 3}, {2, 4}, {-2, 4}, {4, 2},
    {-4, 2}, {0, 5}, {3, 4}, {-3, 4}, {4, 3}, {-4, 3}, {5, 0}, {1, 5}, {-1, 5}, {5, 1}, {-5, 1},
    {2, 5}, {-2, 5}, {5, 2}, {-5, 2}, {4, 4}, {-4, 4}, {3, 5}, {-3, 5}, {5, 3}, {-5, 3}, {0, 6},
    {6, 0}, {1, 6}, {-1, 6}, {6, 1}, {-6, 1}, {2, 6}, {-2, 6}, {6, 2}, {-6, 2}, {4, 5}, {-4, 5},
    {5, 4}, {-5, 4}, {3, 6}, {-3, 6}, {6, 3}, {-6, 3}, {0, 7}, {7, 0}, {1, 7}, {-1, 7}, {5, 5},
    {-5, 5}, {7, 1}, {-7, 1}, {4, 6}, {-4, 6}, {6, 4}, {-6, 4}, {2, 7}, {-2, 7}, {7, 2}, {-7, 2},
    {3, 7}, {-3, 7}, {7, 3}, {-7, 3}, {5, 6}, {-5, 6}, {6, 5}, {-6, 5}, {8, 0}, {4, 7}, {-4, 7},
    {7, 4}, {-7, 4}, {8, 1}, {8, 2}, {6, 6}, {-6, 6}, {8, 3}, {5, 7}, {-5, 7}, {7, 5}, {-7, 5},
    {8, 4}, {6, 7}, {-6, 7}, {7, 6}, {-7, 6}, {8, 5}, {7, 7}, {-7, 7}, {8, 6}, {8, 7}};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}

inline int clip255i(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }

inline uint32_t clamp_add_subtract_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= uint32_t(clip255i(int((a >> s) & 0xff) + int((b >> s) & 0xff) - int((c >> s) & 0xff)))
           << s;
  return out;
}

inline uint32_t clamp_add_subtract_half(uint32_t a, uint32_t b) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int x = int((a >> s) & 0xff), y = int((b >> s) & 0xff);
    out |= uint32_t(clip255i(x + (x - y) / 2)) << s;
  }
  return out;
}

inline uint32_t select_pred(uint32_t t, uint32_t l, uint32_t tl) {
  int pa_minus_pb = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = int((t >> s) & 0xff), b = int((l >> s) & 0xff), c = int((tl >> s) & 0xff);
    pa_minus_pb += std::abs(b - c) - std::abs(a - c);
  }
  return pa_minus_pb <= 0 ? t : l;
}

uint32_t predict(int mode, uint32_t L, const uint32_t* top, int x) {
  const uint32_t T = top[x], TL = top[x - 1], TR = top[x + 1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select_pred(T, L, TL);
    case 12: return clamp_add_subtract_full(L, T, TL);
    case 13: return clamp_add_subtract_half(average2(L, T), TL);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp reads them
  }
}

class Vp8lDecoder {
 public:
  Vp8lDecoder(const uint8_t* d, size_t n) : br_(d, n) {}

  // The VP8L header (VP8LGetInfo): signature, size, alpha hint, version.
  static bool info(const uint8_t* d, size_t n, int* w, int* h) {
    if (n < 5 || d[0] != 0x2f || (d[4] >> 5) != 0) return false;
    LBitReader br(d, n);
    br.read(8);
    *w = int(br.read(14)) + 1;
    *h = int(br.read(14)) + 1;
    br.read(1);
    return br.read(3) == 0 && !br.eos();
  }

  void decode(RgbImage* out) {
    int w, h;
    br_.read(8);
    w = int(br_.read(14)) + 1;
    h = int(br_.read(14)) + 1;
    br_.read(1);
    if (br_.read(3) != 0) fail("bad VP8L version");
    check_image_pixels(kFmt, uint64_t(w), uint64_t(h));
    const std::vector<uint32_t> argb = decode_stream(w, h, true);
    out->w = w;
    out->h = h;
    out->rgb.resize(size_t(w) * h * 3);
    uint8_t* o = out->rgb.data();
    for (const uint32_t p : argb) {
      *o++ = uint8_t(p >> 16);
      *o++ = uint8_t(p >> 8);
      *o++ = uint8_t(p);
    }
  }

  // An ALPH chunk's lossless stream: the image stream without its header.
  void decode_alpha(int w, int h) { decode_stream(w, h, true); }

 private:
  struct Transform {
    int type, bits, xsize, ysize;
    std::vector<uint32_t> data;
  };

  void need(bool ok, const char* what) {
    if (!ok || br_.eos()) fail(std::string("corrupt VP8L data (") + what + ")");
  }

  // DecodeImageStream: a level-0 stream reads transforms and may use meta
  // prefix codes; a sub-image stream does neither.
  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0) {
    std::vector<Transform> transforms;
    int txsize = xsize;
    if (level0) {
      unsigned seen = 0;
      while (br_.read(1)) {
        need(transforms.size() < 4, "transforms");
        Transform t;
        t.type = int(br_.read(2));
        need(!(seen & (1u << t.type)), "a repeated transform");
        seen |= 1u << t.type;
        t.xsize = txsize;
        t.ysize = ysize;
        t.bits = 0;
        if (t.type == PREDICTOR || t.type == CROSS_COLOR) {
          t.bits = int(br_.read(3)) + 2;
          t.data = decode_stream(subsample(t.xsize, t.bits), subsample(t.ysize, t.bits), false);
        } else if (t.type == COLOR_INDEXING) {
          const int num_colors = int(br_.read(8)) + 1;
          t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
          txsize = subsample(t.xsize, t.bits);
          std::vector<uint32_t> pal = decode_stream(num_colors, 1, false);
          t.data.assign(size_t(1) << (8 >> t.bits), 0);
          t.data[0] = pal[0];
          for (int i = 1; i < num_colors; ++i) t.data[i] = add_pixels(pal[i], t.data[i - 1]);
        }
        transforms.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br_.read(1)) {
      cache_bits = int(br_.read(4));
      need(cache_bits >= 1 && cache_bits <= 11, "colour cache size");
    }
    read_codes(txsize, ysize, cache_bits, level0);
    std::vector<uint32_t> data = decode_data(txsize, ysize, cache_bits);
    for (auto t = transforms.rbegin(); t != transforms.rend(); ++t) inverse(*t, &data);
    return data;
  }

  void read_codes(int xsize, int ysize, int cache_bits, bool allow_meta) {
    meta_bits_ = 0;
    meta_xsize_ = 0;
    meta_.clear();
    int num_groups = 1;
    if (allow_meta && br_.read(1)) {
      const int bits = int(br_.read(3)) + 2;
      const int mx = subsample(xsize, bits), my = subsample(ysize, bits);
      std::vector<uint32_t> image = decode_stream(mx, my, false);
      meta_bits_ = bits;
      meta_xsize_ = mx;
      meta_.resize(image.size());
      for (size_t i = 0; i < image.size(); ++i) {
        meta_[i] = (image[i] >> 8) & 0xffff;
        num_groups = std::max(num_groups, int(meta_[i]) + 1);
      }
    }
    groups_.assign(num_groups, HTreeGroup());
    size_t entries = 0;
    static const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};
    std::vector<int> lengths;
    for (HTreeGroup& g : groups_) {
      for (int j = 0; j < 5; ++j) {
        const int size = kAlphabet[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0);
        read_code(size, &lengths);
        need(g.codes[j].build(lengths.data(), size), "prefix code");
        entries += g.codes[j].table.size();
        need(entries <= kMaxTableEntries, "too many prefix codes");
      }
    }
  }

  void read_code(int alphabet, std::vector<int>* lengths) {
    lengths->assign(std::max(alphabet, 256), 0);
    if (br_.read(1)) {  // simple code: one or two symbols
      const int num = int(br_.read(1)) + 1;
      const int first = int(br_.read(br_.read(1) ? 8 : 1));
      (*lengths)[first] = 1;
      if (num == 2) (*lengths)[br_.read(8)] = 1;
      need(true, "simple code");
      return;
    }
    int cl_lengths[19] = {0};
    const int num_codes = int(br_.read(4)) + 4;
    for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthOrder[i]] = int(br_.read(3));
    PrefixCode cl;
    need(cl.build(cl_lengths, 19), "code-length code");
    int max_symbol = alphabet;
    if (br_.read(1)) {
      const int nbits = 2 + 2 * int(br_.read(3));
      max_symbol = 2 + int(br_.read(nbits));
      need(max_symbol <= alphabet, "code lengths");
    }
    int prev = 8;
    int symbol = 0;
    while (symbol < alphabet) {
      if (max_symbol-- == 0) break;
      const int code = cl.read(br_);
      if (code < 16) {
        (*lengths)[symbol++] = code;
        if (code) prev = code;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        const int slot = code - 16;
        const int repeat = int(br_.read(kExtra[slot])) + kOffset[slot];
        need(symbol + repeat <= alphabet, "code lengths");
        const int len = slot == 0 ? prev : 0;
        for (int i = 0; i < repeat; ++i) (*lengths)[symbol++] = len;
      }
      need(true, "code lengths");
    }
  }

  int copy_value(int symbol) {
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + int(br_.read(extra)) + 1;
  }

  std::vector<uint32_t> decode_data(int xsize, int ysize, int cache_bits) {
    const size_t total = size_t(xsize) * size_t(ysize);
    std::vector<uint32_t> data(total);
    std::vector<uint32_t> cache(cache_bits ? size_t(1) << cache_bits : 0, 0);
    const int cache_shift = 32 - cache_bits;
    size_t pos = 0, cached = 0;
    int col = 0, row = 0;
    const int len_limit = 256 + 24;
    const int cache_limit = len_limit + int(cache.size());
    auto group_at = [&](int x, int y) -> const HTreeGroup& {
      if (!meta_bits_) return groups_[0];
      return groups_[meta_[size_t(y >> meta_bits_) * meta_xsize_ + (x >> meta_bits_)]];
    };
    auto insert = [&]() {
      if (cache_bits)
        for (; cached < pos; ++cached)
          cache[(0x1e35a7bdu * data[cached]) >> cache_shift] = data[cached];
    };
    while (pos < total) {
      const HTreeGroup& g = group_at(col, row);
      const int code = g.codes[0].read(br_);
      if (code < 256) {
        const uint32_t red = uint32_t(g.codes[1].read(br_));
        const uint32_t blue = uint32_t(g.codes[2].read(br_));
        const uint32_t alpha = uint32_t(g.codes[3].read(br_));
        need(true, "literal");
        data[pos] = (alpha << 24) | (red << 16) | (uint32_t(code) << 8) | blue;
      } else if (code < len_limit) {
        const int length = copy_value(code - 256);
        const int dist_symbol = g.codes[4].read(br_);
        const int dist_code = copy_value(dist_symbol);
        size_t dist;
        if (dist_code > 120) {
          dist = size_t(dist_code - 120);
        } else {
          const int d = kDistanceMap[dist_code - 1][0] + kDistanceMap[dist_code - 1][1] * xsize;
          dist = d >= 1 ? size_t(d) : 1;
        }
        need(pos >= dist && total - pos >= size_t(length), "backward reference");
        for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
        col += length;
        while (col >= xsize) {
          col -= xsize;
          ++row;
        }
        insert();
        continue;
      } else {
        need(code < cache_limit, "symbol");
        insert();
        data[pos] = cache[code - len_limit];
      }
      ++pos;
      if (++col >= xsize) {
        col = 0;
        ++row;
      }
      insert();
    }
    need(true, "image data");
    return data;
  }

  void inverse(const Transform& t, std::vector<uint32_t>* data) {
    const int w = t.xsize, h = t.ysize;
    uint32_t* d = data->data();
    switch (t.type) {
      case PREDICTOR: {
        const int tiles = subsample(w, t.bits);
        d[0] = add_pixels(d[0], 0xff000000u);
        for (int x = 1; x < w; ++x) d[x] = add_pixels(d[x], d[x - 1]);
        for (int y = 1; y < h; ++y) {
          uint32_t* row = d + size_t(y) * w;
          const uint32_t* top = row - w;
          const uint32_t* modes = t.data.data() + size_t(y >> t.bits) * tiles;
          row[0] = add_pixels(row[0], top[0]);
          for (int x = 1; x < w; ++x) {
            const int mode = int((modes[x >> t.bits] >> 8) & 0xf);
            row[x] = add_pixels(row[x], predict(mode, row[x - 1], top, x));
          }
        }
        break;
      }
      case CROSS_COLOR: {
        const int tiles = subsample(w, t.bits);
        for (int y = 0; y < h; ++y) {
          uint32_t* row = d + size_t(y) * w;
          const uint32_t* codes = t.data.data() + size_t(y >> t.bits) * tiles;
          for (int x = 0; x < w; ++x) {
            const uint32_t code = codes[x >> t.bits];
            const int g2r = int8_t(code & 0xff), g2b = int8_t((code >> 8) & 0xff);
            const int r2b = int8_t((code >> 16) & 0xff);
            const uint32_t argb = row[x];
            const int green = int8_t((argb >> 8) & 0xff);
            int red = int((argb >> 16) & 0xff);
            int blue = int(argb & 0xff);
            red = (red + ((g2r * green) >> 5)) & 0xff;
            blue += (g2b * green) >> 5;
            blue += (r2b * int8_t(red)) >> 5;
            blue &= 0xff;
            row[x] = (argb & 0xff00ff00u) | (uint32_t(red) << 16) | uint32_t(blue);
          }
        }
        break;
      }
      case SUBTRACT_GREEN:
        for (size_t i = 0; i < data->size(); ++i) {
          const uint32_t g = (d[i] >> 8) & 0xff;
          const uint32_t rb = ((d[i] & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
          d[i] = (d[i] & 0xff00ff00u) | rb;
        }
        break;
      default: {  // COLOR_INDEXING
        const int packed = subsample(w, t.bits);
        std::vector<uint32_t> out(size_t(w) * h);
        const int bits_per_pixel = 8 >> t.bits;
        const uint32_t mask = (1u << bits_per_pixel) - 1;
        const int count_mask = (1 << t.bits) - 1;
        for (int y = 0; y < h; ++y) {
          const uint32_t* src = d + size_t(y) * packed;
          uint32_t* dst = out.data() + size_t(y) * w;
          uint32_t bundle = 0;
          for (int x = 0; x < w; ++x) {
            if ((x & count_mask) == 0) bundle = (*src++ >> 8) & 0xff;
            dst[x] = t.data[bundle & mask];
            bundle >>= bits_per_pixel;
          }
        }
        *data = std::move(out);
      }
    }
  }

  LBitReader br_;
  std::vector<HTreeGroup> groups_;
  std::vector<uint32_t> meta_;
  int meta_bits_ = 0, meta_xsize_ = 0;
};

// ============================================================= container

struct Chunk {
  size_t offset;   // of the chunk header
  uint32_t size;   // the payload's
  size_t padded;   // the payload and its pad byte
};

// The chunk at `at`, checked as the demuxer checks it: a whole header, and a
// payload with its padding inside the RIFF that ends at `end`.
Chunk read_chunk(const uint8_t* d, size_t at, size_t end, std::string* tag) {
  if (end - at < 8) fail("truncated chunk header");
  const uint32_t size = le32(d + at + 4);
  if (size > 0xfffffff6u) fail("chunk size too large");
  const size_t padded = size_t(size) + (size & 1);
  if (padded > end - at - 8) fail("chunk extends past the RIFF");
  tag->assign(reinterpret_cast<const char*>(d + at), 4);
  return Chunk{at, size, padded};
}

// A VP8 or VP8L image's size from its header (WebPGetFeatures), failing as
// the demuxer fails a frame whose features it cannot read.
void image_size(const uint8_t* d, const Chunk& image, bool lossless, int* w, int* h) {
  const uint8_t* payload = d + image.offset + 8;
  const bool ok = lossless ? Vp8lDecoder::info(payload, image.padded, w, h)
                           : Vp8Decoder::info(payload, image.padded, image.size, w, h);
  if (!ok) fail(lossless ? "bad VP8L header" : "bad VP8 frame header");
}

// One image as libwebp decodes it: the VP8 or VP8L payload and its pad byte;
// with an ALPH chunk beside a VP8 image, its alpha is decoded to check it,
// since libwebp fails the image when its alpha fails.
void decode_image(const uint8_t* d, const Chunk& image, bool lossless, const Chunk* alph,
                  RgbImage* out) {
  int w = 0, h = 0;
  image_size(d, image, lossless, &w, &h);
  check_image_pixels(kFmt, uint64_t(w), uint64_t(h));
  const uint8_t* payload = d + image.offset + 8;
  if (lossless) {
    Vp8lDecoder(payload, image.padded).decode(out);
    return;
  }
  if (alph) {
    const uint8_t* a = d + alph->offset + 8;
    const size_t an = alph->size;
    if (an <= 1) fail("ALPH chunk too small");
    const int method = a[0] & 3, pre = (a[0] >> 4) & 3, rsrv = (a[0] >> 6) & 3;
    if (method > 1 || pre > 1 || rsrv != 0) fail("bad ALPH header");
    if (method == 0) {
      if (an - 1 < size_t(w) * h) fail("truncated ALPH data");
    } else {
      Vp8lDecoder(a + 1, an - 1).decode_alpha(w, h);
    }
  }
  Vp8Decoder(payload, image.padded, image.size).decode(out);
}

// An animation's frames as WebPDemux parses them, from the chunk after VP8X
// on: ANIM before the first ANMF; in each ANMF, after its 16-byte header
// (offset / 2, size - 1, duration, flags), an optional ALPH then one VP8 or
// VP8L chunk, read as the demuxer reads them (up to the first other chunk,
// where parsing of the file goes on); no image chunk outside an ANMF. Each
// frame, at its image's size, must lie inside the canvas.
struct Frame {
  int x = 0, y = 0, w = 0, h = 0;
  Chunk image{}, alph{};
  bool lossless = false, has_alph = false;
};

std::vector<Frame> animation_frames(const uint8_t* d, size_t at, size_t end, int canvas_w,
                                    int canvas_h) {
  std::vector<Frame> frames;
  bool anim = false;
  while (at < end) {
    std::string tag;
    const Chunk c = read_chunk(d, at, end, &tag);
    if (tag == "ANIM") {
      if (c.padded < 6) fail("ANIM chunk too small");
      anim = true;
    } else if (tag == "ANMF") {
      if (!anim) fail("ANMF chunk before the ANIM chunk");
      if (c.padded < 16) fail("ANMF chunk too small");
      const uint8_t* p = d + at + 8;
      Frame f;
      f.x = 2 * int(le24(p));
      f.y = 2 * int(le24(p + 3));
      if (uint64_t(le24(p + 6) + 1) * (le24(p + 9) + 1) >= (uint64_t(1) << 32))
        fail("ANMF frame too large");
      const size_t first = at + 8 + 16;
      size_t sub = first;
      bool image = false;
      while (sub < end) {
        std::string sub_tag;
        const Chunk s = read_chunk(d, sub, end, &sub_tag);
        if (sub_tag == "ALPH" && !f.has_alph) {
          if (image) fail("ALPH chunk after its frame's image");
          f.alph = s;
          f.has_alph = true;
        } else if ((sub_tag == "VP8 " || sub_tag == "VP8L") && !image) {
          f.lossless = sub_tag == "VP8L";
          if (f.lossless && f.has_alph) fail("ALPH chunk before a VP8L image");
          f.image = s;
          image_size(d, s, f.lossless, &f.w, &f.h);
          image = true;
        } else {
          break;  // the frame ends here; the file's chunks go on from it
        }
        sub += 8 + s.padded;
      }
      if (sub - first > c.padded - 16) fail("frame data extends past its ANMF chunk");
      if (!image) fail("ANMF frame without an image");
      if (f.x + f.w > canvas_w || f.y + f.h > canvas_h) fail("frame outside the canvas");
      frames.push_back(f);
      at = sub;
      continue;
    } else if (tag == "ALPH" || tag == "VP8 " || tag == "VP8L") {
      fail("image chunk outside an ANMF chunk in an animation");
    } else if (tag == "VP8X") {
      fail("misplaced VP8X chunk");
    }
    at += 8 + c.padded;  // ICCP, EXIF, XMP and unknown chunks
  }
  if (frames.empty()) fail("animation without frames");
  return frames;
}

}  // namespace

bool is_webp(const uint8_t* d, size_t n) {
  return n >= 12 && tag_is(d, "RIFF") && tag_is(d + 8, "WEBP");
}

void decode_webp(const uint8_t* d, size_t n, RgbImage* out) {
  if (!is_webp(d, n)) fail("not a WebP file");
  const uint32_t riff = le32(d + 4);
  if (riff < 12) fail("RIFF size too small");
  if (riff > 0xfffffff6u) fail("RIFF size too large");
  if (size_t(riff) + 8 > n) fail("truncated file (RIFF size exceeds the data)");
  const size_t end = size_t(riff) + 8;  // bytes past the RIFF are ignored
  if (end == 12) fail("no chunks");
  std::string tag;
  const Chunk head = read_chunk(d, 12, end, &tag);
  int canvas_w = 0, canvas_h = 0;
  bool extended = false, alpha_flag = false;
  size_t at = 12;
  if (tag == "VP8X") {
    if (head.size < 10) fail("VP8X chunk too small");
    const uint8_t* p = d + head.offset + 8;
    const uint8_t flags = p[0];
    if (flags & ~0x3e) fail("reserved VP8X flags are set");
    alpha_flag = flags & 0x10;
    canvas_w = int(le24(p + 4)) + 1;
    canvas_h = int(le24(p + 7)) + 1;
    if (uint64_t(canvas_w) * uint64_t(canvas_h) >= (uint64_t(1) << 32)) fail("canvas too large");
    extended = true;
    at = 12 + 8 + head.padded;
    if (flags & 0x02) {
      // WebPAnimDecoder's first frame: a key frame, so the canvas starts
      // transparent black (neither the ANIM background nor blending
      // applies) and the frame is decoded at its offset; alpha is dropped.
      const std::vector<Frame> frames = animation_frames(d, at, end, canvas_w, canvas_h);
      check_image_pixels(kFmt, uint64_t(canvas_w), uint64_t(canvas_h));
      const Frame& f = frames[0];
      RgbImage frame;
      decode_image(d, f.image, f.lossless, f.has_alph ? &f.alph : nullptr, &frame);
      out->w = canvas_w;
      out->h = canvas_h;
      out->rgb.assign(size_t(canvas_w) * canvas_h * 3, 0);
      for (int y = 0; y < frame.h; ++y)
        std::memcpy(out->rgb.data() + (size_t(f.y + y) * canvas_w + f.x) * 3,
                    frame.rgb.data() + size_t(y) * frame.w * 3, size_t(frame.w) * 3);
      return;
    }
  }
  // a still image: one image (an ALPH chunk, then VP8 or VP8L) whose size is
  // the canvas; ALPH is used only with the alpha flag. An ANIM chunk may
  // follow the image; an ANMF needs an ANIM before it and is not a frame.
  Chunk alph{}, image{};
  bool have_alph = false, have_image = false, lossless = false, anim = false;
  for (bool first = true; at < end; first = false) {
    const Chunk c = read_chunk(d, at, end, &tag);
    at += 8 + c.padded;
    if (tag == "ANIM") {
      if (c.padded < 6) fail("ANIM chunk too small");
      anim = true;
      continue;
    }
    if (tag == "ANMF") {
      if (!anim) fail("ANMF chunk before the ANIM chunk");
      continue;
    }
    if (tag == "VP8X") fail("misplaced VP8X chunk");
    if (tag != "ALPH" && tag != "VP8 " && tag != "VP8L") continue;
    if (have_image) fail("more than one image");
    if (anim) fail("image chunk after an ANIM chunk in a still WebP");
    if (!extended && !first) fail("misplaced image chunk");
    if (tag == "ALPH") {  // the demuxer takes it only right before its image
      if (!extended) fail("ALPH chunk without VP8X");
      std::string next;
      if (have_alph || at >= end || (read_chunk(d, at, end, &next), next != "VP8 "))
        fail("misplaced ALPH chunk");
      alph = c;
      have_alph = true;
      continue;
    }
    if (tag == "VP8L" && have_alph) fail("ALPH chunk before a VP8L image");
    image = c;
    have_image = true;
    lossless = tag == "VP8L";
  }
  if (!have_image) fail("no image data");
  int w = 0, h = 0;
  image_size(d, image, lossless, &w, &h);
  if (extended && (w != canvas_w || h != canvas_h))
    fail("the image's size differs from the canvas");
  decode_image(d, image, lossless, have_alph && alpha_flag ? &alph : nullptr, out);
}

}  // namespace ssr
