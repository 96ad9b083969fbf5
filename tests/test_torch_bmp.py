"""The port's BMP decoder (``data/bmp.py``) against PIL's ``convert("RGB")``,
what the JAX package's ``read_img`` and daemon read BMP through: bit-equal
on files PIL writes (24-bit, 32-bit, palette, grey, 1-bit, odd widths) and
on files written here that PIL reads but does not write (top-down rows,
BI_BITFIELDS, 16-bit, 4-bit palettes, the OS/2 core header); RLE refused
by name; the committed stand-in fixture equal to its gallery PNG."""

import io
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from simplesr_tpu_torch.data.bmp import decode_bmp
from simplesr_tpu_torch.data.image import decode_image, read_img, read_rgb_u8
from simplesr_tpu_torch.tools.serve import decode_image as serve_decode

ROOT = Path(__file__).resolve().parents[1]


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _saved(img, **kw):
    buf = io.BytesIO()
    img.save(buf, "BMP", **kw)
    return buf.getvalue()


def _bmp(width, height, bits, rows, compression=0, masks=None, header=40, top_down=False,
         palette=b""):
    """A BMP file from raw rows (top row first for top_down, else bottom row
    first), each padded to 4 bytes; ``masks`` go after a 40-byte header or
    into a longer one."""
    stride = ((width * bits + 31) >> 3) & ~3
    body = b"".join(r + b"\0" * (stride - len(r)) for r in rows)
    extra = b""
    if header == 12:
        head = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        head = struct.pack("<IiiHHIIiiII", header, width, -height if top_down else height, 1,
                           bits, compression, len(body), 2835, 2835, 0, 0)
        if header > 40:
            head += struct.pack("<4I", *(list(masks or ()) + [0] * 4)[:4])
            head += b"\0" * (header - 56)
        elif masks:
            extra = struct.pack(f"<{len(masks)}I", *masks)
    offset = 14 + len(head) + len(extra) + len(palette)
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + head + extra
            + palette + body)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P", "1"])
@pytest.mark.parametrize("size", [(1, 1), (7, 5), (13, 4), (65, 33)])
def test_bit_equal_to_pil_on_files_pil_writes(mode, size):
    rng = np.random.default_rng(len(mode) * 100 + size[0])
    img = Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8))
    img = {"RGBA": lambda: img.convert("RGBA"), "L": lambda: img.convert("L"),
           "1": lambda: img.convert("1"), "P": lambda: img.quantize(13),
           "RGB": lambda: img}[mode]()
    data = _saved(img)
    got = decode_bmp(data)
    assert got.dtype == np.uint8 and got.shape == (size[1], size[0], 3)
    np.testing.assert_array_equal(got, _pil(data))


MASKS = [(16, None), (16, (0xF800, 0x7E0, 0x1F)), (16, (0x7C00, 0x3E0, 0x1F)),
         (24, (0xFF0000, 0xFF00, 0xFF)), (32, None), (32, (0xFF0000, 0xFF00, 0xFF, 0)),
         (32, (0xFF000000, 0xFF0000, 0xFF00, 0)), (32, (0xFF000000, 0xFF00, 0xFF, 0)),
         (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)), (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
         (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)), (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)),
         (32, (0, 0, 0, 0))]


# BI_RGB (masks None) has a 40-byte header only: it has no masks to place
LAYOUTS = [(b, m, h) for b, m in MASKS for h in (40, 56, 124) if m is not None or h == 40]


@pytest.mark.parametrize("bits,masks,header", LAYOUTS,
                         ids=[f"{b}-{m}-{h}" for b, m, h in LAYOUTS])
@pytest.mark.parametrize("top_down", [False, True])
def test_bitfields_and_row_order_as_pil_reads_them(bits, masks, header, top_down):
    """Every bitfield layout PIL accepts, with the masks after a 40-byte
    header (3 of them, as PIL reads it there) or inside a longer one; a
    layout PIL refuses is refused too."""
    rng = np.random.default_rng(bits + header)
    width, height = 7, 5
    rows = [rng.integers(0, 256, width * bits // 8, dtype=np.uint8).tobytes()
            for _ in range(height)]
    data = _bmp(width, height, bits, rows, compression=3 if masks else 0,
                masks=masks[:3] if masks and header == 40 else masks, header=header,
                top_down=top_down)
    try:
        want = _pil(data)
    except OSError:
        with pytest.raises(ValueError, match="bitfields"):
            decode_bmp(data)
        return
    np.testing.assert_array_equal(decode_bmp(data), want)


def test_four_bit_palette_and_core_header():
    rng = np.random.default_rng(4)
    palette = rng.integers(0, 256, (16, 4), dtype=np.uint8).tobytes()
    rows = [rng.integers(0, 256, 5, dtype=np.uint8).tobytes() for _ in range(6)]
    data = _bmp(9, 6, 4, rows, palette=palette)
    np.testing.assert_array_equal(decode_bmp(data), _pil(data))
    palette3 = rng.integers(0, 256, (256, 3), dtype=np.uint8).tobytes()
    rows = [rng.integers(0, 256, 11, dtype=np.uint8).tobytes() for _ in range(4)]
    data = _bmp(11, 4, 8, rows, header=12, palette=palette3)
    np.testing.assert_array_equal(decode_bmp(data), _pil(data))
    rows = [rng.integers(0, 256, 33, dtype=np.uint8).tobytes() for _ in range(4)]
    data = _bmp(11, 4, 24, rows, header=12)
    np.testing.assert_array_equal(decode_bmp(data), _pil(data))


@pytest.mark.parametrize("kind,name", [(1, "RLE8"), (2, "RLE4")])
def test_rle_is_refused_by_name(kind, name):
    """PIL reads RLE; the port refuses it with the roadmap item that holds
    it."""
    bits = 8 if kind == 1 else 4
    palette = np.random.default_rng(kind).integers(0, 256, (1 << bits, 4),
                                                   dtype=np.uint8).tobytes()
    rle = bytes([4, 1, 0, 0, 4, 2, 0, 1])  # two rows of 4 pixels, end of bitmap
    head = struct.pack("<IiiHHIIiiII", 40, 4, 2, 1, bits, kind, len(rle), 0, 0, 0, 0)
    offset = 14 + len(head) + len(palette)
    data = b"BM" + struct.pack("<IHHI", offset + len(rle), 0, 0, offset) + head + palette + rle
    assert _pil(data).shape == (2, 4, 3)
    with pytest.raises(ValueError, match=f"{name} compression.*Queue 1, item 3"):
        decode_bmp(data)


def test_bad_files_are_refused():
    data = _saved(Image.new("RGB", (5, 4), (1, 2, 3)))
    with pytest.raises(ValueError, match="truncated"):
        decode_bmp(data[:-8])
    with pytest.raises(ValueError, match="header size"):
        decode_bmp(data[:14] + struct.pack("<I", 20) + data[18:])
    with pytest.raises(ValueError, match="not a BMP"):
        decode_bmp(b"GIF89a" + data[6:])


def test_dispatch_reads_bmp_as_pil(tmp_path):
    """``read_rgb_u8``, ``read_img``, ``decode_image`` and the daemon's
    decoder read a BMP by its magic bytes."""
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    path = tmp_path / "a.bmp"
    Image.fromarray(img).save(path)
    np.testing.assert_array_equal(read_rgb_u8(path), img)
    np.testing.assert_array_equal(read_img(path), img.astype(np.float32))
    np.testing.assert_array_equal(decode_image(path.read_bytes()), img)
    np.testing.assert_array_equal(serve_decode(path.read_bytes()), img)
    with pytest.raises(ValueError, match="PNG, JPEG or BMP"):
        decode_image(b"GIF89a" + bytes(16))


def test_committed_stand_in_fixture_equals_its_png():
    """data/corpus/bmp/gt_6.bmp is gt_6.png as PIL writes a 24-bit BMP; the
    card has no PIL, so its standard-benchmark stand-in reads this file."""
    bmp = ROOT / "data/corpus/bmp/gt_6.bmp"
    png = ROOT / "data/corpus/gallery/gt_6.png"
    np.testing.assert_array_equal(read_rgb_u8(bmp), read_rgb_u8(png))
    np.testing.assert_array_equal(read_rgb_u8(bmp), _pil(bmp.read_bytes()))
