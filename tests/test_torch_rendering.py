"""The port's rendering (no PIL) against simplesr_tpu.eval.rendering (PIL).

``tensor_to_img`` is compared exactly. Grids and half-splits are compared
twice: with the tags switched off in both packages, every pixel must be
equal (canvas size, tile positions, padding, the gutter, the divider); with
the port's tags on, its pixels may differ from its untagged canvas only
inside the boxes that its ``_stamp`` reports and the row-label gutter. The
JAX package's tags are TrueType text, which the port does not rasterise.
"""

import numpy as np
import pytest
from PIL import Image

from simplesr_tpu.eval import rendering as jax_rendering
from simplesr_tpu_torch.data.png import read_png
from simplesr_tpu_torch.eval import rendering


def _images(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


@pytest.mark.parametrize("shape,lo,hi", [((12, 10, 3), -1, 1), ((1, 7, 9, 3), 0, 1),
                                         ((5, 5, 3), 0, 255), ((4, 4, 3), 0.5, 0.5)])
def test_tensor_to_img_matches_jax(shape, lo, hi):
    x = _images(shape, 1, lo, hi)
    np.testing.assert_array_equal(rendering.tensor_to_img(x),
                                  np.asarray(jax_rendering.tensor_to_img(x)))


@pytest.fixture
def untagged(monkeypatch):
    """Both packages with their tags (text and boxes) switched off; the
    row-label gutter stays, as an empty black band."""
    for module in (rendering, jax_rendering):
        strip = module._row_label_strip
        monkeypatch.setattr(module, "_stamp", lambda *a, **k: None)
        monkeypatch.setattr(module, "_row_label_strip",
                            lambda text, *a, _strip=strip: _strip("", *a))


def _grid_args(num, lr_hw=(6, 8), sr_hw=(24, 32), seed=0):
    return dict(
        LR=_images((num,) + lr_hw + (3,), seed, 0, 1),
        resnet=_images((num,) + sr_hw + (3,), seed + 1),
        bicubic=_images((num,) + sr_hw + (3,), seed + 2),
        **{"ground truth": _images((num,) + sr_hw + (3,), seed + 3)})


def _metrics(num):
    psnr = {"LR": np.full(num, -1.0), "resnet": np.linspace(20, 30, num),
            "bicubic": np.linspace(18, 25, num), "ground truth": np.full(num, np.inf)}
    ssim = {k: np.clip(v / 40, -1, 1) for k, v in psnr.items()}
    return psnr, ssim


@pytest.mark.parametrize("num", [1, 3])
def test_grid_matches_jax_outside_tags(tmp_path, untagged, num):
    psnr, ssim = _metrics(num)
    args = _grid_args(num)
    got = read_png(rendering.prepare_image_grid(str(tmp_path / "t"), "g", low_res_key="LR",
                                                psnr=psnr, ssim=ssim, **args))
    jax_rendering.prepare_image_grid(str(tmp_path / "j"), "g", low_res_key="LR",
                                     psnr=psnr, ssim=ssim, **args)
    ref = np.asarray(Image.open(tmp_path / "j" / "g.png"))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_half_split_matches_jax_outside_tags(tmp_path, untagged):
    left, right = _images((2, 16, 22, 3), 4), _images((2, 16, 22, 3), 5)
    rendering.combine_halfs(left, right, "resnet", str(tmp_path / "t"), "h", grid=False)
    jax_rendering.combine_halfs(left, right, "resnet", str(tmp_path / "j"), "h", grid=False)
    for idx in range(2):
        got = read_png(tmp_path / "t" / f"h_{idx}.png")
        ref = np.asarray(Image.open(tmp_path / "j" / f"h_{idx}.png"))
        np.testing.assert_array_equal(got, ref)


def test_single_matches_jax(tmp_path):
    x = _images((2, 9, 11, 3), 6)
    rendering.save_single(x, str(tmp_path / "t"), "s")
    jax_rendering.save_single(x, str(tmp_path / "j"), "s")
    for idx in range(2):
        np.testing.assert_array_equal(read_png(tmp_path / "t" / f"s_{idx}.png"),
                                      np.asarray(Image.open(tmp_path / "j" / f"s_{idx}.png")))


@pytest.mark.parametrize("num", [1, 3])
def test_tags_stay_inside_their_boxes(tmp_path, monkeypatch, num):
    psnr, ssim = _metrics(num)
    args = _grid_args(num, lr_hw=(12, 16), sr_hw=(48, 64))
    boxes = []
    stamp = rendering._stamp

    def recording(img, *a, **k):
        boxes.append((img.copy(), stamp(img, *a, **k)))
        return boxes[-1][1]

    monkeypatch.setattr(rendering, "_stamp", recording)
    tagged = read_png(rendering.prepare_image_grid(str(tmp_path / "a"), "g", low_res_key="LR",
                                                   psnr=psnr, ssim=ssim, **args))
    assert len(boxes) == 3 * num * 4 - (0 if num == 1 else 4 * num)
    monkeypatch.setattr(rendering, "_stamp", lambda *a, **k: None)
    strip = rendering._row_label_strip
    monkeypatch.setattr(rendering, "_row_label_strip", lambda t, *a: strip("", *a))
    plain = read_png(rendering.prepare_image_grid(str(tmp_path / "b"), "g", low_res_key="LR",
                                                  psnr=psnr, ssim=ssim, **args))
    changed = np.argwhere((tagged != plain).any(axis=2))
    assert len(changed) > 0
    # each changed pixel lies in a tag box of its tile, or in the gutter
    gutter = 0 if num == 1 else int(num * 64 * 0.05)
    for y, x in changed:
        if x < gutter:
            continue
        ty, tx = y % 48, (x - gutter) % 64
        assert any(y0 <= ty < y1 and x0 <= tx < x1 for _, (y0, x0, y1, x1) in boxes), (y, x)
    # the boxes are black around the ink, as in the JAX package
    img = np.zeros((48, 64, 3), np.uint8) + 200
    y0, x0, y1, x1 = stamp(img, "psnr: 23.45", (255, 0, 0), right=True)
    box = img[y0:y1, x0:x1]
    assert x1 == 64 - 5 + 1 and y1 == 48 - 5 + 1
    assert ((box == 0).all(axis=2) | (box == (255, 0, 0)).all(axis=2)).all()
    assert (box == (255, 0, 0)).all(axis=2).any()
