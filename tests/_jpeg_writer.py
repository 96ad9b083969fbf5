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


def _header(adobe_transform):
    if adobe_transform is None:
        return b"\xff\xd8" + _segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    return b"\xff\xd8" + _segment(0xEE, b"Adobe\0\x64\0\0\0\0" + bytes([adobe_transform]))


def _sof(marker, precision, height, width, sampling, ids=None):
    body = bytes([precision]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
    body += bytes([len(sampling)])
    for ci, (h, v) in enumerate(sampling):
        body += bytes([ids[ci] if ids else ci + 1, (h << 4) | v, 0])
    return _segment(marker, body)


def _blocks(planes, sampling, quant):
    """Each component's quantised DCT blocks, (block rows, block columns,
    64) in natural order over the whole MCUs; samples are picked, not
    filtered, and the padding repeats the edge."""
    height, width = planes[0].shape
    maxh = max(h for h, _ in sampling)
    maxv = max(v for _, v in sampling)
    mcux, mcuy = -(-width // (8 * maxh)), -(-height // (8 * maxv))
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
    return blocks, (mcux, mcuy)


def write_jpeg(planes, sampling, quality_step=6, restart_interval=0, adobe_transform=None):
    """Baseline JPEG bytes of ``planes`` (1, 3 or 4 full-size uint8 arrays
    of one shape) with ``sampling`` [(h, v), ...] per component; a JFIF
    marker, or Adobe's APP14 with ``adobe_transform`` (0: RGB / CMYK, 1:
    YCbCr, 2: YCCK). Components are subsampled by picking, quantised by one
    flat step."""
    height, width = planes[0].shape
    n = len(planes)
    quant = np.full(64, quality_step, np.int64)
    tables = [(_codes(_DC_BITS, _DC_VALS), _codes(_AC_BITS, _AC_VALS)),
              (_codes(_DC_CHROMA_BITS, _DC_VALS), _codes(_AC_CHROMA_BITS, _AC_CHROMA_VALS))]
    blocks, (mcux, mcuy) = _blocks(planes, sampling, quant)
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
    out = _header(adobe_transform)
    out += _segment(0xDB, bytes([0]) + bytes(quant[_ZIGZAG].astype(np.uint8)))
    out += _sof(0xC0, 8, height, width, sampling)
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


# ------------------------------------------------------------- arithmetic

# libjpeg's Table D.2 (jaricom.c): Qe << 16 | next MPS << 8 | switch << 7 |
# next LPS; entry 113 is the fixed estimate of 0.5
_ARITAB = [
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171]


class _Arith:
    """jcarith.c's coder: the C and A registers, stacked 0xFF bytes (sc) and
    pending zero bytes (zc) dropped at the end."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _zeros(self):
        self.out += bytes(self.zc)
        self.zc = 0

    def _byte(self, b):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def _carry(self):
        if self.buffer >= 0:
            self._zeros()
            self._byte(self.buffer + 1)
        self.zc += self.sc
        self.sc = 0

    def _settle(self):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self._byte(self.buffer)
        if self.sc:
            self._zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def encode(self, st, i, val):
        sv = st[i]
        qe = _ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._settle()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._settle()
        if self.c & 0x7FFF800:
            self._zeros()
            self._byte((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)
        self.reset()


def _arith_value(coder, st, base, v, k_stats, fixed, dc):
    """Figures F.6-F.9: a nonzero value after its EOB / zero decisions; for
    DC the sign is coded in st[base + 1], for AC in the fixed bin."""
    if dc:
        coder.encode(st, base + 1, int(v < 0))
        i = base + (3 if v < 0 else 2)
    else:
        coder.encode(fixed, 0, int(v < 0))
        i = base + 2
    v = abs(v) - 1
    m = 0
    if v:
        coder.encode(st, i, 1)
        m, v2 = 1, v
        if dc:
            i = 20
            while v2 >> 1:
                v2 >>= 1
                coder.encode(st, i, 1)
                m <<= 1
                i += 1
        elif v2 >> 1:
            v2 >>= 1
            coder.encode(st, i, 1)
            m <<= 1
            i = k_stats
            while v2 >> 1:
                v2 >>= 1
                coder.encode(st, i, 1)
                m <<= 1
                i += 1
    coder.encode(st, i, 0)
    category = m
    i += 14
    while m >> 1:
        m >>= 1
        coder.encode(st, i, int(bool(m & v)))
    return category


def write_jpeg_arith(planes, sampling, quality_step=6, restart_interval=0, scans=None,
                     dac=(), adobe_transform=None, quant=None):
    """Arithmetic-coded JPEG bytes (jcarith.c's coder) of ``planes`` as in
    ``write_jpeg``: sequential (SOF9) when ``scans`` is None, else
    progressive (SOF10) with the scan script ``scans`` [(components, Ss, Se,
    Ah, Al), ...]; ``dac`` [(Tc << 4 | Tb, value), ...] is written as a DAC
    segment (DC: U << 4 | L; AC: Kx). Component 0 codes with tables 0, the
    others with tables 1. ``quant`` (64 steps, natural order) replaces the
    flat step."""
    height, width = planes[0].shape
    n = len(planes)
    quant = np.full(64, quality_step, np.int64) if quant is None else np.asarray(quant)
    blocks, (mcux, mcuy) = _blocks(planes, sampling, quant)
    maxh = max(h for h, _ in sampling)
    maxv = max(v for _, v in sampling)
    dc_l, dc_u, ac_k = [0] * 16, [1] * 16, [5] * 16
    for index, value in dac:
        if index >= 16:
            ac_k[index - 16] = value
        else:
            dc_l[index], dc_u[index] = value & 15, value >> 4
    progressive = scans is not None
    if scans is None:
        scans = [(tuple(range(n)), 0, 63, 0, 0)]
    out = _header(adobe_transform)
    out += _segment(0xDB, bytes([0]) + bytes(quant[_ZIGZAG].astype(np.uint8)))
    out += _sof(0xCA if progressive else 0xC9, 8, height, width, sampling)
    if dac:
        out += _segment(0xCC, b"".join(bytes(e) for e in dac))
    if restart_interval:
        out += _segment(0xDD, restart_interval.to_bytes(2, "big"))
    for comps, ss, se, ah, al in scans:
        sos = bytes([len(comps)])
        for ci in comps:
            sos += bytes([ci + 1, 0x00 if ci == 0 else 0x11])
        out += _segment(0xDA, sos + bytes([ss, se, (ah << 4) | al]))
        out += _arith_scan(blocks, sampling, comps, ss, se, ah, al, progressive,
                           restart_interval, (dc_l, dc_u, ac_k),
                           (mcux, mcuy) if len(comps) > 1 else None,
                           (width, height, maxh, maxv))
    return out + b"\xff\xd9"


def _arith_scan(blocks, sampling, comps, ss, se, ah, al, progressive, restart_interval,
                conditioning, mcus, size):
    dc_l, dc_u, ac_k = conditioning
    width, height, maxh, maxv = size
    coder = _Arith()
    tables = {ci: min(ci, 1) for ci in comps}
    dc_stats = {t: bytearray(64) for t in set(tables.values())}
    ac_stats = {t: bytearray(256) for t in set(tables.values())}
    fixed = bytearray([113])
    last_dc, context = {ci: 0 for ci in comps}, {ci: 0 for ci in comps}

    def order():
        """(component, block row, block column) per MCU."""
        if mcus is None:
            (ci,) = comps
            h, v = sampling[ci]
            bw = -(-(-(-width * h // maxh)) // 8)
            bh = -(-(-(-height * v // maxv)) // 8)
            for by in range(bh):
                for bx in range(bw):
                    yield [(ci, by, bx)]
        else:
            for my in range(mcus[1]):
                for mx in range(mcus[0]):
                    yield [(ci, my * sampling[ci][1] + y, mx * sampling[ci][0] + x)
                           for ci in comps for y in range(sampling[ci][1])
                           for x in range(sampling[ci][0])]

    def code_dc(ci, value):
        t = tables[ci]
        st = dc_stats[t]
        base = context[ci]
        diff = value - last_dc[ci]
        if diff == 0:
            coder.encode(st, base, 0)
            context[ci] = 0
            return
        last_dc[ci] = value
        coder.encode(st, base, 1)
        m = _arith_value(coder, st, base, diff, 0, fixed, True)
        if m < (1 << dc_l[t]) >> 1:
            context[ci] = 0
        elif m > (1 << dc_u[t]) >> 1:
            context[ci] = 12 + 4 * (diff < 0)
        else:
            context[ci] = 4 + 4 * (diff < 0)

    def shifted(zz, k, shift):
        v = int(zz[k])
        return v >> shift if v >= 0 else -((-v) >> shift)

    def code_ac(ci, zz, first, last, shift, refine_from=None):
        t = tables[ci]
        st = ac_stats[t]
        ke = last
        while ke > 0 and shifted(zz, ke, shift) == 0:
            ke -= 1
        kex = ke
        if refine_from is not None:
            while kex > 0 and shifted(zz, kex, refine_from) == 0:
                kex -= 1
        k = first
        while k <= ke:
            if refine_from is None or k > kex:
                coder.encode(st, 3 * (k - 1), 0)
            while True:
                v = shifted(zz, k, shift)
                if v:
                    break
                coder.encode(st, 3 * (k - 1) + 1, 0)
                k += 1
            if refine_from is not None and shifted(zz, k, refine_from):
                coder.encode(st, 3 * (k - 1) + 2, abs(v) & 1)
            elif refine_from is not None:
                coder.encode(st, 3 * (k - 1) + 1, 1)
                coder.encode(fixed, 0, int(v < 0))
            else:
                coder.encode(st, 3 * (k - 1) + 1, 1)
                _arith_value(coder, st, 3 * (k - 1), v, 189 if k <= ac_k[t] else 217,
                             fixed, False)
            k += 1
        if k <= last:
            coder.encode(st, 3 * (k - 1), 1)

    count, restart = 0, 0
    for mcu in order():
        if restart_interval and count and count % restart_interval == 0:
            coder.finish()
            coder.out += bytes([0xFF, 0xD0 + restart % 8])
            restart += 1
            for t in dc_stats:
                dc_stats[t][:] = bytes(64)
                ac_stats[t][:] = bytes(256)
            for ci in comps:
                last_dc[ci] = context[ci] = 0
        count += 1
        for ci, by, bx in mcu:
            zz = blocks[ci][by, bx][_ZIGZAG]
            if not progressive:
                code_dc(ci, int(zz[0]))
                code_ac(ci, zz, 1, 63, 0)
            elif ss == 0 and ah == 0:
                code_dc(ci, int(zz[0]) >> al)
            elif ss == 0:
                coder.encode(fixed, 0, (int(zz[0]) >> al) & 1)
            elif ah == 0:
                code_ac(ci, zz, ss, se, al)
            else:
                code_ac(ci, zz, ss, se, al, refine_from=ah)
    coder.finish()
    return bytes(coder.out)


# --------------------------------------------------------------- lossless

def write_jpeg_lossless(planes, predictor, pt=0, restart_interval=0, sampling=None,
                        marker="jfif", ids=None, separate_scans=False):
    """Lossless Huffman-coded JPEG bytes (SOF3) of uint8 ``planes`` with the
    predictor ``predictor`` (1 to 7) and point transform ``pt``;
    ``sampling`` picks the subsampled samples as ``write_jpeg`` does;
    ``marker`` is "jfif", "adobe0", "adobe1" or None; ``ids`` the component
    ids (1, 2, 3 by default); ``separate_scans`` codes one scan a
    component. Differences follow Annex H: the first row of the scan and of
    each restart interval predicts from 2^(7 - pt), then from the left;
    other rows start from the sample above."""
    height, width = planes[0].shape
    n = len(planes)
    sampling = sampling or [(1, 1)] * n
    maxh = max(h for h, _ in sampling)
    maxv = max(v for _, v in sampling)
    mcux, mcuy = -(-width // maxh), -(-height // maxv)
    comps = []
    for plane, (h, v) in zip(planes, sampling):
        dw, dh = -(-width * h // maxh), -(-height * v // maxv)
        ys = np.minimum(np.arange(dh) * maxv // v, height - 1)
        xs = np.minimum(np.arange(dw) * maxh // h, width - 1)
        comps.append(plane[ys[:, None], xs[None, :]].astype(np.int64) >> pt)
    dc_codes = [_codes(_DC_BITS, _DC_VALS), _codes(_DC_CHROMA_BITS, _DC_VALS)]
    head = {"jfif": _header(None), "adobe0": _header(0), "adobe1": _header(1),
            None: b"\xff\xd8"}[marker]
    out = head + _sof(0xC3, 8, height, width, sampling, ids)
    out += _segment(0xC4, bytes([0x00]) + bytes(_DC_BITS) + bytes(_DC_VALS))
    out += _segment(0xC4, bytes([0x01]) + bytes(_DC_CHROMA_BITS) + bytes(_DC_VALS))
    if restart_interval:
        out += _segment(0xDD, restart_interval.to_bytes(2, "big"))
    groups = [[ci] for ci in range(n)] if separate_scans else [list(range(n))]
    for group in groups:
        sos = bytes([len(group)])
        for ci in group:
            sos += bytes([(ids[ci] if ids else ci + 1), 0x00 if ci == 0 else 0x10])
        out += _segment(0xDA, sos + bytes([predictor, 0, pt]))
        diffs = [_differences(comps[ci], predictor, pt, restart_interval,
                              mcux if len(group) > 1 else comps[ci].shape[1],
                              sampling[ci][1] if len(group) > 1 else 1) for ci in group]
        bits = _Bits()
        rows = mcuy if len(group) > 1 else comps[group[0]].shape[0]
        cols = mcux if len(group) > 1 else comps[group[0]].shape[1]
        count = 0
        for my in range(rows):
            for mx in range(cols):
                if restart_interval and count and count % restart_interval == 0:
                    bits.flush()
                    bits.out += bytes([0xFF, 0xD0 + (count // restart_interval - 1) % 8])
                count += 1
                for k, ci in enumerate(group):
                    h, v = sampling[ci] if len(group) > 1 else (1, 1)
                    d = diffs[k]
                    for y in range(v):
                        for x in range(h):
                            r, c = my * v + y, mx * h + x
                            value = int(d[r, c]) if r < d.shape[0] and c < d.shape[1] else 0
                            size, bits_ = _magnitude(value)
                            bits.put(*dc_codes[min(ci, 1)][size])
                            bits.put(bits_, size)
        bits.flush()
        out += bytes(bits.out)
    return out + b"\xff\xd9"


def _differences(x, predictor, pt, restart_interval, mcus_per_row, rows_per_mcu):
    """Annex H differences of one component's samples (after the point
    transform), wrapped to -32767..32768 as the decoder reads them."""
    h, w = x.shape
    restart_rows = restart_interval // mcus_per_row * rows_per_mcu if restart_interval else 0
    d = np.zeros_like(x)
    for r in range(h):
        first = r == 0 or (restart_rows and r % restart_rows == 0)
        for c in range(w):
            if first:
                p = (1 << (7 - pt)) if c == 0 else x[r, c - 1]
            elif c == 0:
                p = x[r - 1, c]
            else:
                ra, rb, rc = x[r, c - 1], x[r - 1, c], x[r - 1, c - 1]
                p = [None, ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
                     (ra + rb) >> 1][predictor]
            v = (int(x[r, c]) - int(p)) & 0xFFFF
            d[r, c] = v - 0x10000 if v > 0x8000 else v
    return d


def drop_scans(data, keep):
    """A multi-scan JPEG with only the scans whose indexes are in ``keep``:
    the frame header and tables stay, the file ends after the last scan
    kept."""
    head_end = data.index(b"\xff\xda")
    out, pos, index = bytearray(data[:head_end]), head_end, 0
    while pos < len(data) and data[pos:pos + 2] != b"\xff\xd9":
        nxt = pos + 2
        while True:  # the next marker that is not stuffing or a restart
            nxt = data.index(b"\xff", nxt)
            if data[nxt + 1] not in (0, 0xFF) and not 0xD0 <= data[nxt + 1] <= 0xD7:
                break
            nxt += 1
        if data[pos + 1] == 0xDA:
            if index in keep:
                out += data[pos:nxt]
            index += 1
        else:
            out += data[pos:nxt]
        pos = nxt
    return bytes(out) + b"\xff\xd9"
