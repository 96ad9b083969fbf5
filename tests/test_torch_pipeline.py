"""The port's DataPipeline and its ops against simplesr_tpu's.

Tolerances: HR batches bit-equal (numpy draws the same file order, shuffle
and crops; flips are exact; the normalisation rounds as XLA's fused one);
LR within 1e-5 on [0, 1] (the resize's float32 sums in another order). The
colour cores within 1e-5 of JAX on [0, 1] values. The JPEG round trip: the
two libraries' float32 DCTs can round a quantised coefficient at a .5
boundary one step apart; measured on random and gallery images at
qualities 10, 50 and 90, 5e-5 of the output values differed, each by one
level, so the bound is: at most 1e-3 of the values differ, none by more
than one level (1/255), mean abs < 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import sklearn.model_selection
import torch
from pathlib import Path

from simplesr_tpu.data import DataPipeline as JaxDataPipeline
from simplesr_tpu.ops import augment as jax_augment
from simplesr_tpu.ops import crop as jax_crop
from simplesr_tpu.ops import jpeg as jax_jpeg
from simplesr_tpu_torch.data import DataPipeline, train_test_split
from simplesr_tpu_torch.data.png import read_png
from simplesr_tpu_torch.ops import augment, crop, jpeg

ROOT = Path(__file__).resolve().parents[1]
GALLERY = str(ROOT / "data/corpus/gallery")
LR_TOL = 1e-5
LEVEL = 1.0 / 255.0


@pytest.mark.parametrize("n", [1, 2, 7, 16, 33])
@pytest.mark.parametrize("fraction", [0.05, 0.1, 0.25, 0.5])
@pytest.mark.parametrize("seed", [0, 3, 12345, None])
def test_split_equals_sklearn(n, fraction, seed):
    items = [f"f{i}" for i in range(n)]
    if not 0 < int(np.ceil(fraction * n)) < n:
        with pytest.raises(ValueError):
            train_test_split(items, fraction, seed)
        return
    if seed is None:
        np.random.seed(7)
        got = train_test_split(items, fraction, None)
        np.random.seed(7)
        ref = sklearn.model_selection.train_test_split(items, test_size=fraction)
    else:
        got = train_test_split(items, fraction, seed)
        ref = sklearn.model_selection.train_test_split(items, test_size=fraction,
                                                       random_state=seed)
    assert [list(part) for part in got] == [list(ref[0]), list(ref[1])]


def _pair(**kw):
    base = dict(hr_img_path=GALLERY, scale=4, train_val_split=0.1, batch_size=5,
                augmentations=["flip_along_x", "flip_along_y"], crop_size=(32, 32, 3),
                num_crops=2, random_seed=3, minimum_variation_patch=30.0)
    base.update(kw)
    return JaxDataPipeline(use_native=False, **base), DataPipeline(device="cpu", **base)


def _compare(ref_batches, got_batches, lr_max_abs=LR_TOL):
    assert len(ref_batches) == len(got_batches) > 0
    for (rl, rh), (gl, gh) in zip(ref_batches, got_batches):
        np.testing.assert_array_equal(gh.numpy(), np.asarray(rh))
        diff = np.abs(gl.numpy() - np.asarray(rl))
        assert gl.shape == rl.shape and diff.max() <= lr_max_abs, diff.max()


@pytest.mark.parametrize("naive", [True, False])
@pytest.mark.parametrize("resident", ["auto", False])
def test_batches_match_jax(naive, resident):
    ref, got = _pair(crop_naive=naive, device_resident=resident)
    assert got.train_imgs == ref.train_imgs and got.val_imgs == ref.val_imgs
    for epoch in range(2):
        _compare(list(ref.train_batch_generator()), list(got.train_batch_generator()))
        _compare(list(ref.validation_batch_generator()),
                 list(got.validation_batch_generator()))


def test_jpeg_noise_batches_match_jax():
    ref, got = _pair(jpg_noise=True, jpg_noise_level=50, batch_size=8)
    r, g = list(ref.train_batch_generator()), list(got.train_batch_generator())
    for (rl, rh), (gl, gh) in zip(r, g):
        np.testing.assert_array_equal(gh.numpy(), np.asarray(rh))
        diff = np.abs(gl.numpy() - np.asarray(rl))
        assert diff.max() <= LEVEL + LR_TOL and (diff > LR_TOL).mean() <= 1e-3


def test_whole_images_and_test_batches_match_jax():
    ref, got = _pair(crop=False, augmentations=None, batch_size=2,
                     test_img_paths=[GALLERY])
    _compare(list(ref.validation_batch_generator()), list(got.validation_batch_generator()))
    for (rx, rp), (gx, gp) in zip(ref.test_batch_generator(3), got.test_batch_generator(3)):
        assert rp == gp
        np.testing.assert_array_equal(gx.numpy(), np.asarray(rx))


@pytest.mark.parametrize("augs", [["flip_along_x", "rotate90"],
                                  ["adjust_hue", "adjust_contrast", "adjust_jpg_quality"]])
def test_pooled_and_host_paths_give_identical_batches(augs):
    kw = dict(hr_img_path=GALLERY, scale=4, batch_size=6, augmentations=augs,
              crop_size=(24, 24, 3), num_crops=2, random_seed=5, jpg_noise=True,
              jpg_noise_level=(10, 60), device="cpu")
    pooled = DataPipeline(device_resident=True, **kw)
    host = DataPipeline(device_resident=False, num_workers=3, **kw)
    for _ in range(2):
        for (pl, ph), (hl, hh) in zip(pooled.train_batch_generator(),
                                      host.train_batch_generator()):
            assert torch.equal(pl, hl) and torch.equal(ph, hh)


def test_colour_cores_match_jax():
    x = np.random.default_rng(0).uniform(0, 1, (3, 9, 11, 3)).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(augment.rgb_to_hsv(t).numpy(),
                               np.asarray(jax_augment.rgb_to_hsv(jnp.asarray(x))), atol=1e-5)
    hsv = np.array(jax_augment.rgb_to_hsv(jnp.asarray(x)))
    np.testing.assert_allclose(augment.hsv_to_rgb(torch.from_numpy(hsv)).numpy(),
                               np.asarray(jax_augment.hsv_to_rgb(jnp.asarray(hsv))), atol=1e-5)
    factors = {"hue": [-0.07, 0.03, 0.07], "saturation": [0.4, 1.1, 2.0],
               "brightness": [0.05, 0.1, 0.2], "contrast": [0.5, 1.3, 2.5],
               "gamma": [0.5, 0.9, 1.5]}
    for name, values in factors.items():
        core = getattr(augment, f"adjust_{name}_by")
        jax_core = getattr(jax_augment, f"adjust_{name}_by")
        per_image = core(t, torch.tensor(values)).numpy()
        for i, f in enumerate(values):
            ref = np.asarray(jax_core(jnp.asarray(x[i]), f))
            np.testing.assert_allclose(core(t[i], f).numpy(), ref, atol=1e-5, err_msg=name)
            np.testing.assert_allclose(per_image[i], ref, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("quality", [10, 50, 90])
def test_jpeg_degrade_within_the_measured_bound(quality):
    rng = np.random.default_rng(quality)
    gallery = read_png(ROOT / "data/corpus/gallery/gt_3.png")[:61, :77].astype(np.float32)
    for x in (rng.uniform(0, 1, (3, 37, 45, 3)).astype(np.float32), gallery[None] / 255.0):
        ref = np.asarray(jax_jpeg.jpeg_degrade(jnp.asarray(x), quality))
        got = jpeg.jpeg_degrade(torch.from_numpy(x), quality).numpy()
        diff = np.abs(got - ref)
        assert diff.max() <= LEVEL + 1e-6 and (diff > 0).mean() <= 1e-3 and diff.mean() < 1e-5
    qs = np.array([10, 50, 90], np.float32)
    x = rng.uniform(0, 1, (3, 16, 24, 3)).astype(np.float32)
    per_image = jpeg.jpeg_degrade(torch.from_numpy(x), torch.from_numpy(qs)).numpy()
    ref = np.asarray(jax.vmap(jax_jpeg.jpeg_degrade)(jnp.asarray(x), jnp.asarray(qs)))
    assert np.abs(per_image - ref).max() <= LEVEL + 1e-6
    for i, q in enumerate(qs):
        np.testing.assert_array_equal(
            per_image[i], jpeg.jpeg_degrade(torch.from_numpy(x[i]), float(q)).numpy())
    for table, ref_table in zip(jpeg.ijg_quant_tables(quality), jax_jpeg.ijg_quant_tables(quality)):
        np.testing.assert_array_equal(table.numpy(), np.asarray(ref_table))


def test_random_wrappers_in_range_and_reproducible():
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 255, (4, 8, 8, 3)).astype(np.float32))
    ranges = {"adjust_hue": augment.DEFAULT_HUE_RANGE,
              "adjust_saturation": augment.DEFAULT_SATURATION_RANGE,
              "adjust_brightness": augment.DEFAULT_BRIGHTNESS_RANGE,
              "adjust_contrast": augment.DEFAULT_CONTRAST_RANGE,
              "adjust_gamma": augment.DEFAULT_GAMMA_RANGE,
              "adjust_jpg_quality": augment.DEFAULT_JPG_QUALITY_RANGE}
    names = ["rotate90"] + list(ranges)
    params = augment.draw_batch_params(names, torch.Generator().manual_seed(0), 500)
    again = augment.draw_batch_params(names, torch.Generator().manual_seed(0), 500)
    assert torch.equal(params, again)
    assert set(params[0].tolist()) == {1.0, 2.0}
    for row, (name, (lo, hi)) in zip(params[1:], ranges.items()):
        assert lo <= row.min() and row.max() < hi, name
        assert row.std() > 0, name
    jq = params[-1]
    assert torch.equal(jq, jq.round())
    for name, fn in augment.AUGMENTATIONS.items():
        a = fn(torch.Generator().manual_seed(4), x)
        b = fn(torch.Generator().manual_seed(4), x)
        assert a.shape == x.shape and torch.equal(a, b), name
    # a batch applies each item's own draw, through the cores
    aug_ids = [0, 1, 2, 7]
    small = augment.draw_batch_params(names, torch.Generator().manual_seed(2), 4)
    out = augment.apply_batch(x, aug_ids, names, small)
    assert torch.equal(out[0], x[0])
    assert torch.equal(out[1], augment.rotate90_by(x[1], int(small[0, 1])))
    torch.testing.assert_close(out[2], augment.adjust_hue_by(x[2], float(small[1, 2])))
    assert torch.equal(out[3], augment.adjust_jpg_quality_by(x[3:4], small[6, 3:4])[0])


@pytest.mark.parametrize("min_batch", [0.0, 100.0])
def test_diverse_crops_match_jax_on_the_same_candidates(monkeypatch, min_batch):
    img = read_png(ROOT / "data/corpus/gallery/gt_7.png").astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    cands = crop.random_crops(gen, torch.from_numpy(img), 32, (16, 16))
    monkeypatch.setattr(jax_crop, "random_crops",
                        lambda key, im, k, p: jnp.asarray(cands.numpy()))
    ref = np.asarray(jax_crop.diverse_crops(jax.random.key(0), jnp.asarray(img), 4, (16, 16),
                                            20.0, min_batch))
    pick = crop.diverse_pick(cands, 4, 20.0, min_batch)
    np.testing.assert_array_equal(cands[pick].numpy(), ref)
    got = crop.diverse_crops(torch.Generator().manual_seed(0), torch.from_numpy(img), 4,
                             (16, 16), 20.0, min_batch)
    assert torch.equal(got, cands[pick])
