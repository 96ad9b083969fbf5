"""The port's resize, crops and geometric augmentations against
simplesr_tpu's, on the same arrays and the same offsets."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplesr_tpu.ops import augment as jax_augment
from simplesr_tpu.ops import crop as jax_crop
from simplesr_tpu.ops.resize import resize as jax_resize
from simplesr_tpu_torch.data.image import read_img
from simplesr_tpu_torch.ops import augment, crop
from simplesr_tpu_torch.ops.resize import resize

GALLERY = sorted((Path(__file__).resolve().parents[1] / "data/corpus/gallery").glob("*.png"))


@pytest.mark.parametrize("src,dst", [((96, 96), (24, 24)), ((97, 61), (24, 15)),
                                     ((24, 15), (97, 61))])
@pytest.mark.parametrize("method,antialias", [("bicubic", True), ("bicubic", False),
                                              ("bilinear", True), ("lanczos3", True),
                                              ("area", True), ("nearest", False)])
def test_resize_matches_jax(src, dst, method, antialias):
    img = read_img(GALLERY[4])[:src[0], :src[1]] / 255.0
    got = resize(torch.from_numpy(img)[None], dst, method=method, antialias=antialias).numpy()
    ref = np.asarray(jax_resize(jnp.asarray(img)[None], dst, method=method,
                                antialias=antialias))
    assert got.shape == ref.shape == (1, *dst, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)  # float32 sums, another order


def test_resize_keeps_integer_dtype_and_refuses_unknown_methods():
    img = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (16, 16, 3), np.uint8))
    out = resize(img, (8, 8), method="bicubic")
    ref = jax_resize(jnp.asarray(img.numpy()), (8, 8), method="bicubic")
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        resize(img.float(), (8, 8), method="mitchell")


def test_crops_at_the_same_offsets_are_equal():
    img = read_img(GALLERY[0])
    for top, left, ph, pw in [(0, 0, 24, 24), (100, 37, 96, 96), (400, 700, 96, 96),
                              (-5, 3, 10, 12), (-900, -4, 8, 8)]:  # clamped, negative
        got = crop.crop_at(torch.from_numpy(img), top, left, ph, pw).numpy()
        ref = np.asarray(jax_crop.crop_at(jnp.asarray(img), top, left, ph, pw))
        np.testing.assert_array_equal(got, ref)


def test_random_crops_are_crops_at_their_offsets():
    img = torch.from_numpy(read_img(GALLERY[1]))
    gen = torch.Generator().manual_seed(0)
    tops, lefts = crop.random_offsets(gen, img, 5, (32, 40))
    gen = torch.Generator().manual_seed(0)
    crops = crop.random_crops(gen, img, 5, (32, 40))
    assert crops.shape == (5, 32, 40, 3)
    for c, t, l in zip(crops, tops, lefts):
        np.testing.assert_array_equal(
            c.numpy(), np.asarray(jax_crop.crop_at(jnp.asarray(img.numpy()), int(t), int(l),
                                                   32, 40)))
    batch = crop.batch_random_crops(gen, [img, img[:100, :90]], 3, (24, 24))
    assert batch.shape == (6, 24, 24, 3)
    with pytest.raises(ValueError):
        crop.random_crops(gen, img[:10], 1, (24, 24))
    keys = jax.random.split(jax.random.key(0), 2)
    assert jax_crop.batch_random_crops(keys[0], jnp.stack([jnp.asarray(img.numpy())] * 2),
                                       3, (24, 24)).shape == batch.shape


@pytest.mark.parametrize("name", ["flip_along_x", "flip_along_y"])
def test_flips_match_jax(name):
    x = np.random.default_rng(1).uniform(0, 255, (2, 7, 9, 3)).astype(np.float32)
    got = getattr(augment, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(getattr(jax_augment, name)(jnp.asarray(x))))


@pytest.mark.parametrize("k", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("shape", [(8, 8, 3), (2, 6, 9, 3)])
def test_rotations_match_jax(k, shape):
    x = np.random.default_rng(k).uniform(0, 255, shape).astype(np.float32)
    got = augment.rotate90_by(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_augment.rotate90_by(jnp.asarray(x), k)))
    np.testing.assert_array_equal(augment.rotate90(None, torch.from_numpy(x), k).numpy(), got)


def test_random_rotation_turns_by_90_or_180():
    gen = torch.Generator().manual_seed(3)
    x = torch.arange(2 * 3 * 3 * 1, dtype=torch.float32).reshape(2, 3, 3, 1)
    seen = set()
    for _ in range(20):
        out = augment.rotate90(gen, x)
        seen.add(next(k for k in (1, 2) if torch.equal(out, augment.rotate90_by(x, k))))
    assert seen == {1, 2}
    wide = torch.zeros(4, 6, 3)
    assert torch.equal(augment.rotate90(gen, wide), augment.rotate90_by(wide, 2))
