"""Rendering without PIL, as simplesr_tpu.eval.rendering: single images,
SR | interpolated half-splits, and annotated comparison grids, written as
PNGs by ``data/png.py``.

Canvas sizes, tile positions and every pixel outside the tag boxes are the
JAX package's: per-image min/max scaling as Keras' ``array_to_img``
(``tensor_to_img``), rows per model and columns per sample, labels
bottom-left, PSNR bottom-right with SSIM stacked above it (``∞`` for inf,
``N/A`` for -1), LR rows padded and centred, the rotated row-label gutter.
The JAX package draws its tags with a TrueType font, which needs FreeType;
the port draws them with the 5 x 7 bitmap font below, in the same black
boxes at the same anchors (the boxes' sizes follow the font). An image
resized for a half-split or an ``original`` goes through the port's bicubic
resize, not PIL's.
"""

import os

import numpy as np
import torch

from simplesr_tpu_torch.data.image import read_rgb_u8
from simplesr_tpu_torch.data.png import write_png

__all__ = ["tensor_to_img", "save_single", "combine_halfs", "prepare_image_grid"]

_TAG_INSET = 5
_GREEN, _RED, _MAGENTA = (0, 255, 0), (255, 0, 0), (255, 0, 255)
_DIVIDER = (128, 0, 0)  # PIL's fill=128 on an RGB image

# 5 x 7 glyphs: seven rows of five bits (the high bit leftmost), in hex
_GLYPHS = {
    " ": "00000000000000", "0": "0e11131519110e", "1": "040c040404040e",
    "2": "0e11010204081f", "3": "1f02040201110e", "4": "02060a121f0202",
    "5": "1f101e0101110e", "6": "0608101e11110e", "7": "1f010204080808",
    "8": "0e11110e11110e", "9": "0e11110f01020c", "A": "0e11111f111111",
    "B": "1e11111e11111e", "C": "0e11101010110e", "D": "1c12111111121c",
    "E": "1f10101e10101f", "F": "1f10101e101010", "G": "0e11101711110f",
    "H": "1111111f111111", "I": "0e04040404040e", "J": "0702020202120c",
    "K": "11121418141211", "L": "1010101010101f", "M": "111b1515111111",
    "N": "11111915131111", "O": "0e11111111110e", "P": "1e11111e101010",
    "Q": "0e11111115120d", "R": "1e11111e141211", "S": "0f10100e01011e",
    "T": "1f040404040404", "U": "1111111111110e", "V": "11111111110a04",
    "W": "1111111515150a", "X": "11110a040a1111", "Y": "1111110a040404",
    "Z": "1f01020408101f", "a": "00000e010f110f", "b": "10101619111e1e",
    "c": "00000e1010110e", "d": "01010d1311110f", "e": "00000e111f100e",
    "f": "0609081c080808", "g": "000f11110f010e", "h": "10101619111111",
    "i": "04000c0404040e", "j": "0200060202120c", "k": "10101214181412",
    "l": "0c04040404040e", "m": "00001a15151111", "n": "00001619111111",
    "o": "00000e1111110e", "p": "00001e111e1010", "q": "00000d130f0101",
    "r": "00001619101010", "s": "00000e100e011e", "t": "08081c08080906",
    "u": "0000111111130d", "v": "00001111110a04", "w": "0000111115150a",
    "x": "0000110a040a11", "y": "000011110f010e", "z": "00001f0204081f",
    ".": "0000000000000c", ":": "000c0c000c0c00", "-": "0000001f000000",
    "_": "0000000000001f", "/": "00010204081000", "(": "02040808080402",
    ")": "08040202020408", "%": "18190204081303", "+": "0004041f040400",
    ",": "000000000c0408", "=": "00001f001f0000", "∞": "00000a15150a00",
    "?": "0e110102040004",
}


def _glyph(ch):
    rows = _GLYPHS.get(ch, _GLYPHS["?"])
    bits = [int(rows[i:i + 2], 16) for i in range(0, 14, 2)]
    return np.array([[(b >> (4 - c)) & 1 for c in range(5)] for b in bits], bool)


def _font_scale(canvas_width):
    """Tags scale with the tile they land on, as the JAX package's font
    size does (16 px at 1024 wide and above, 6 px at least)."""
    size = max(6, 16 - 1024 // max(canvas_width, 1))
    return 2 if size >= 14 else 1


def _text_mask(text, scale):
    """The text's ink as a (7 s, 6 s n - s) bool mask."""
    if not text:
        return np.zeros((7 * scale, 0), bool)
    cols = []
    for i, ch in enumerate(text):
        if i:
            cols.append(np.zeros((7, 1), bool))
        cols.append(_glyph(ch))
    mask = np.concatenate(cols, axis=1)
    return mask.repeat(scale, axis=0).repeat(scale, axis=1)


def _fill(img, y0, x0, y1, x1, colour):
    """Fill img[y0:y1, x0:x1], clipped to the image."""
    y0, x0 = max(y0, 0), max(x0, 0)
    y1, x1 = min(y1, img.shape[0]), min(x1, img.shape[1])
    if y0 < y1 and x0 < x1:
        img[y0:y1, x0:x1] = colour


def _draw_text(img, text, x, y, colour, scale):
    mask = _text_mask(text, scale)
    h, w = mask.shape
    y0, x0 = max(y, 0), max(x, 0)
    y1, x1 = min(y + h, img.shape[0]), min(x + w, img.shape[1])
    if y0 < y1 and x0 < x1:
        region = img[y0:y1, x0:x1]
        region[mask[y0 - y:y1 - y, x0 - x:x1 - x]] = colour


def _stamp(img, text, colour, *, right=False, stack=0):
    """Stamp a boxed text tag onto ``img`` (H, W, 3) uint8, in place: labels
    at the bottom left, metric values at the bottom right, ``stack`` tags up.
    Returns the box (y0, x0, y1, x1), ends exclusive."""
    scale = _font_scale(img.shape[1])
    mask = _text_mask(text, scale)
    th, tw = mask.shape
    x = _TAG_INSET if not right else img.shape[1] - tw - _TAG_INSET
    y = img.shape[0] - (th + _TAG_INSET) * (stack + 1)
    _fill(img, y, x, y + th + 1, x + tw + 1, (0, 0, 0))  # PIL's rectangle includes its ends
    _draw_text(img, text, x, y, colour, scale)
    return y, x, y + th + 1, x + tw + 1


def _as_numpy(tensor):
    if isinstance(tensor, torch.Tensor):
        return tensor.detach().to("cpu", torch.float32).numpy()
    return np.asarray(tensor, dtype=np.float32)


def tensor_to_img(tensor):
    """HWC (or 1HWC) values -> uint8 (H, W, 3), scaled per image by its
    min and max (Keras ``array_to_img``)."""
    x = _as_numpy(tensor)
    if x.ndim == 4 and x.shape[0] == 1:
        x = x[0]
    if x.ndim != 3:
        raise ValueError("tensor must be rank 3 (or rank-4 singleton)")
    x = x - x.min()
    mx = x.max()
    if mx > 0:
        x = x / mx
    img = (x * 255.0).round().astype(np.uint8)
    return np.repeat(img, 3, axis=2) if img.shape[2] == 1 else img


def _resized(img, hw):
    """A uint8 image resized to ``hw`` with the port's bicubic resize."""
    if img.shape[:2] == tuple(hw):
        return img
    from simplesr_tpu_torch.ops.resize import resize as _resize
    out = _resize(torch.from_numpy(img.astype(np.float32)), hw, method="bicubic")
    return out.round().clamp(0, 255).to(torch.uint8).numpy()


def save_single(tensor, save_dir, fname, label=None):
    """Save rank-3 or rank-4 values as PNGs."""
    x = _as_numpy(tensor)
    if x.ndim < 3 or x.ndim > 4:
        raise ValueError("Tensor must be of rank 3 or rank 4")
    os.makedirs(save_dir, exist_ok=True)
    items = [x] if x.ndim == 3 else list(x)
    for idx, t in enumerate(items):
        img = tensor_to_img(t)
        if label is not None:
            _stamp(img, label, _GREEN)
        suffix = "" if x.ndim == 3 else f"_{idx}"
        write_png(os.path.join(save_dir, f"{fname}{suffix}.png"), img)


def combine_halfs(left_tensor, right_tensor, left_label, save_dir, fname,
                  right_label="interpolated", grid=False):
    """The left half of one image and the right half of another, with a
    divider line (SR against bicubic, typically)."""
    left = _as_numpy(left_tensor)
    right = _as_numpy(right_tensor)
    if left.ndim == 3:
        left, right = left[None], right[None]
    if left.shape[0] != right.shape[0]:
        raise ValueError("number of sr and lr images does not match")
    if grid and (left.shape[0] % 2 != 0 or left.shape[0] < 4):
        raise ValueError("can only prepare image grid for an even number of at least 4 images")

    os.makedirs(save_dir, exist_ok=True)
    imgs = []
    for idx, (l, r) in enumerate(zip(left, right)):
        l_img = tensor_to_img(l)
        _stamp(l_img, left_label, _GREEN)
        r_img = _resized(tensor_to_img(r), l_img.shape[:2])
        _stamp(r_img, right_label, _RED, right=True)
        half = l_img.shape[1] // 2
        main = np.concatenate([l_img[:, :half], r_img[:, half:]], axis=1)
        main[:, half] = _DIVIDER
        imgs.append(main)
        write_png(os.path.join(save_dir, f"{fname}_{idx}.png"), main)

    if grid:
        cols = 4
        rows = (len(imgs) + cols - 1) // cols
        h, w = imgs[0].shape[:2]
        grid_img = np.full((rows * h, cols * w, 3), 255, np.uint8)
        for idx, img in enumerate(imgs):
            _paste(grid_img, img, (idx % cols) * w, (idx // cols) * h)
        write_png(os.path.join(save_dir, f"{fname}_grid.png"), grid_img)


def _paste(canvas, img, x, y):
    """Paste ``img`` with its top left at (x, y), clipped to the canvas."""
    h, w = img.shape[:2]
    y0, x0 = max(y, 0), max(x, 0)
    y1, x1 = min(y + h, canvas.shape[0]), min(x + w, canvas.shape[1])
    if y0 < y1 and x0 < x1:
        canvas[y0:y1, x0:x1] = img[y0 - y:y1 - y, x0 - x:x1 - x]


def _pad_image_batch(x, height, width):
    """Centre-pad each HWC image to (height, width), then resize exactly."""
    from simplesr_tpu_torch.ops.resize import resize as _resize

    out = []
    for t in x:
        hp = max(0, (height - t.shape[0]) // 2)
        wp = max(0, (width - t.shape[1]) // 2)
        padded = np.pad(t, [[hp, hp], [wp, wp], [0, 0]])
        if padded.shape[:2] != (height, width):
            padded = _resize(torch.from_numpy(padded), (height, width)).numpy()
        out.append(padded)
    return np.stack(out)


def _metric_string(values, idx):
    v = np.asarray(values[idx]).reshape(-1)[0]
    if np.isinf(v):
        return "∞"
    if v == -1:
        return "N/A"
    return f"{float(v):.2f}"


def prepare_image_grid(save_dir, fname, low_res_key=None, original=None,
                       psnr=None, ssim=None, **kwargs):
    """An annotated comparison grid. ``kwargs`` maps row labels to rank-4
    (or rank-3) images, the same number in every row; "ground truth" and
    "hr" rows do not size the grid, and "ground truth" is resized to it.
    Returns the PNG's path."""
    from simplesr_tpu_torch.ops.resize import resize as _resize

    tensors = {}
    num_imgs = -1
    for label, t in kwargs.items():
        x = _as_numpy(t)
        if x.ndim == 3:
            x = x[None]
        if num_imgs == -1:
            num_imgs = x.shape[0]
        elif x.shape[0] != num_imgs:
            raise ValueError("received differing amount of images per supplied model - "
                             "can't produce grid")
        tensors[label] = x

    for metric in (psnr, ssim):
        if metric is not None and len(metric) != len(tensors):
            raise ValueError("did not receive metric values for every supplied model result")

    max_h = max_w = num_cols = 0
    for label, x in tensors.items():
        if label not in ("hr", "ground truth"):
            num_cols = max(num_cols, x.shape[0])
            max_h = max(max_h, x.shape[1])
            max_w = max(max_w, x.shape[2])
    if "ground truth" in tensors:
        tensors["ground truth"] = _resize(torch.from_numpy(tensors["ground truth"]),
                                          (max_h, max_w), method="bicubic").numpy()

    num_rows = len(tensors)

    def _tile(label, x, idx, inline_label):
        img = tensor_to_img(x[idx])
        if inline_label:
            _stamp(img, label, _GREEN)
        if psnr and psnr.get(label) is not None:
            _stamp(img, f"psnr: {_metric_string(psnr[label], idx)}", _RED, right=True)
        if ssim and ssim.get(label) is not None:
            _stamp(img, f"ssim: {_metric_string(ssim[label], idx)}", _RED, right=True,
                   stack=1)
        return img

    if num_cols == 1:
        # one sample: the models side by side in one row, labels inline
        grid_w, grid_h = num_rows * max_w, max_h
        grid_img = np.full((grid_h, grid_w, 3), 255, np.uint8)
        for col, (label, x) in enumerate(tensors.items()):
            if label == low_res_key:
                x = _pad_image_batch(x, max_h, max_w)
            _paste(grid_img, _tile(label, x, 0, inline_label=True), col * max_w, 0)
    else:
        # one row per model, samples as columns, row labels in a gutter on
        # the left unless an original image goes there
        column_label_width = 0 if original is not None else int(num_cols * max_w * 0.05)
        grid_w = num_cols * max_w + column_label_width
        grid_h = num_rows * max_h
        grid_img = np.full((grid_h, grid_w, 3), 255, np.uint8)
        for row, (label, x) in enumerate(tensors.items()):
            if label == low_res_key:
                x = _pad_image_batch(x, max_h, max_w)
            gutter = original is None and column_label_width > 0
            if gutter:
                _paste(grid_img, _row_label_strip(label, column_label_width, max_h, _GREEN,
                                                  grid_w), 0, row * max_h)
            for idx in range(x.shape[0]):
                _paste(grid_img, _tile(label, x, idx, inline_label=not gutter),
                       column_label_width + max_w * idx, row * max_h)

    if original is not None:
        origin = read_rgb_u8(original) if isinstance(original, (str, os.PathLike)) \
            else tensor_to_img(original)
        oh = grid_img.shape[0]
        ow = max(1, int(origin.shape[1] / origin.shape[0] * oh))
        origin = _resized(origin, (oh, ow))
        _stamp(origin, "original", _MAGENTA)
        combined = np.full((grid_h, grid_w + ow, 3), 255, np.uint8)
        _paste(combined, origin, 0, 0)
        _paste(combined, grid_img, ow, 0)
        grid_img = combined

    os.makedirs(save_dir, exist_ok=True)
    out_path = os.path.join(save_dir, f"{fname}.png")
    write_png(out_path, grid_img)
    return out_path


def _row_label_strip(text, strip_w, strip_h, colour, grid_width):
    """A black (strip_h, strip_w) band carrying the row label, reading
    bottom to top: typeset on a sideways canvas, turned 90 degrees
    counter-clockwise."""
    sideways = np.zeros((strip_w, strip_h, 3), np.uint8)
    scale = _font_scale(grid_width)
    _draw_text(sideways, text, _TAG_INSET, strip_w - 7 * scale - _TAG_INSET, colour, scale)
    return np.ascontiguousarray(np.rot90(sideways, 1))
