"""A small baseline JPEG writer in numpy for the image-input tests: any
sampling factors (Pillow writes only 4:4:4, 4:2:2 and 4:2:0), one, three
or four components, JFIF or Adobe markers (Pillow writes no YCCK), the
standard Huffman tables and an optional restart interval. Its fidelity does
not matter: the tests hold the port's decoder to PIL's decode of the same
bytes."""

import numpy as np

# the standard Huffman tables (JPEG Annex K.3): (bits[1..16], values)
_DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_DC_CHROMA_BITS = [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]
_DC_VALS = list(range(12))
_AC_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
_AC_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a"
    "25262728292a3435363738393a434445464748494a535455565758595a636465666768696a73747576777879"
    "7a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
    "cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")
_AC_CHROMA_BITS = [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]
_AC_CHROMA_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f117"
    "18191a262728292a35363738393a434445464748494a535455565758595a636465666768696a737475767778"
    "797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")
_ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40,
                    48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29,
                    22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
                    47, 55, 62, 63])
_DCT = np.array([[np.sqrt((1 if k == 0 else 2) / 8) * np.cos((2 * n + 1) * k * np.pi / 16)
                  for n in range(8)] for k in range(8)])


def _codes(bits, vals):
    """symbol -> (code, length) of a canonical Huffman table."""
    table, code, k = {}, 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            table[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return table


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, length):
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _segment(marker, body):
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _magnitude(v):
    size = int(abs(v)).bit_length()
    return size, (v if v >= 0 else v + (1 << size) - 1)


def write_jpeg(planes, sampling, quality_step=6, restart_interval=0, adobe_transform=None):
    """Baseline JPEG bytes of ``planes`` (1, 3 or 4 full-size uint8 arrays
    of one shape) with ``sampling`` [(h, v), ...] per component; a JFIF
    marker, or Adobe's APP14 with ``adobe_transform`` (0: RGB / CMYK, 1:
    YCbCr, 2: YCCK). Components are subsampled by picking, quantised by one
    flat step."""
    height, width = planes[0].shape
    maxh = max(h for h, _ in sampling)
    maxv = max(v for _, v in sampling)
    mcux, mcuy = -(-width // (8 * maxh)), -(-height // (8 * maxv))
    n = len(planes)
    quant = np.full(64, quality_step, np.int64)
    tables = [(_codes(_DC_BITS, _DC_VALS), _codes(_AC_BITS, _AC_VALS)),
              (_codes(_DC_CHROMA_BITS, _DC_VALS), _codes(_AC_CHROMA_BITS, _AC_CHROMA_VALS))]
    blocks = []
    for plane, (h, v) in zip(planes, sampling):
        dw, dh = -(-width * h // maxh), -(-height * v // maxv)
        ys = np.minimum(np.arange(mcuy * v * 8) * maxv // v, height - 1)
        xs = np.minimum(np.arange(mcux * h * 8) * maxh // h, width - 1)
        sub = plane[ys[:, None], xs[None, :]].astype(np.float64)
        sub[dh:] = sub[dh - 1]
        sub[:, dw:] = sub[:, dw - 1:dw]
        grid = sub.reshape(mcuy * v, 8, mcux * h, 8).transpose(0, 2, 1, 3) - 128.0
        coefs = np.einsum("ki,abij,lj->abkl", _DCT, grid, _DCT).reshape(mcuy * v, mcux * h, 64)
        blocks.append(np.round(coefs / quant).astype(np.int64))
    bits, last_dc, mcu_count = _Bits(), [0] * n, 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart_interval and mcu_count and mcu_count % restart_interval == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + (mcu_count // restart_interval - 1) % 8])
                last_dc = [0] * n
            mcu_count += 1
            for ci, (h, v) in enumerate(sampling):
                dc_codes, ac_codes = tables[min(ci, 1)]
                for y in range(v):
                    for x in range(h):
                        zz = blocks[ci][my * v + y, mx * h + x][_ZIGZAG]
                        size, value = _magnitude(int(zz[0]) - last_dc[ci])
                        last_dc[ci] = int(zz[0])
                        bits.put(*dc_codes[size])
                        bits.put(value, size)
                        run = 0
                        for k in range(1, 64):
                            if zz[k] == 0:
                                run += 1
                                continue
                            while run > 15:
                                bits.put(*ac_codes[0xF0])
                                run -= 16
                            size, value = _magnitude(int(zz[k]))
                            bits.put(*ac_codes[(run << 4) | size])
                            bits.put(value, size)
                            run = 0
                        if run:
                            bits.put(*ac_codes[0x00])
    bits.flush()
    if adobe_transform is None:
        out = b"\xff\xd8" + _segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    else:
        out = b"\xff\xd8" + _segment(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([adobe_transform]))
    out += _segment(0xDB, bytes([0]) + bytes(quant[_ZIGZAG].astype(np.uint8)))
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") + bytes([n])
    for ci, (h, v) in enumerate(sampling):
        sof += bytes([ci + 1, (h << 4) | v, 0])
    out += _segment(0xC0, sof)
    for cls_index, bits_, vals in ((0x00, _DC_BITS, _DC_VALS), (0x10, _AC_BITS, _AC_VALS),
                                   (0x01, _DC_CHROMA_BITS, _DC_VALS),
                                   (0x11, _AC_CHROMA_BITS, _AC_CHROMA_VALS)):
        out += _segment(0xC4, bytes([cls_index]) + bytes(bits_) + bytes(vals))
    if restart_interval:
        out += _segment(0xDD, restart_interval.to_bytes(2, "big"))
    sos = bytes([n])
    for ci in range(n):
        sos += bytes([ci + 1, 0x00 if ci == 0 else 0x11])
    out += _segment(0xDA, sos + bytes([0, 63, 0]))
    return out + bytes(bits.out) + b"\xff\xd9"
