"""The training input pipeline, as simplesr_tpu.data.pipeline.DataPipeline:
the same constructor, factories (``from_config``, ``eval_pipeline``,
``inference_pipeline``), generators and dataset semantics.

  * Files are listed from directories and split into training and validation
    as sklearn's ``train_test_split(files, test_size=f, random_state=seed)``
    splits them (``train_test_split`` below; sklearn is not imported).
  * Each image gives ``num_crops`` random (or diversity-sampled) crops, each
    crop is used as it is and once per augmentation, the (image, crop,
    augmentation) items are shuffled globally each epoch and batched.
  * HR goes to [-1, 1]; LR is the antialiased bicubic downscale of HR/255 in
    [0, 1], optionally JPEG-degraded.

The host decodes each image once into a uint8 cache and slices crops. With
``use_native=True`` (the default, as in the JAX package) the port's C++
loader (``data/native_loader.py``) decodes PNG and JPEG (and WebP, GIF and
TIFF, which the listing does not pick) and serves naive crops from its own
cache and thread pool, and BMP decodes in numpy (``data/bmp.py``), as the
JAX pipeline hands it to PIL; ``use_native=False`` decodes PNG in Python
(``data/png.py``) and JPEG through the C++ decoder's bytes entry.
Each path reads 16-bit grey as its JAX counterpart does: the native loader's
high byte, or PIL's clip to 255. numpy draws the file order, the shuffle and
the crop offsets exactly as the JAX package draws them, so that HR batches
are bit-equal to its own for one ``random_seed``. The per-batch work (augmentation, grouped
by kind; normalisation; the resize; the JPEG degrade) runs as tensor ops on
the pipeline's device. The random parameters of each batch (the turns of
``rotate90``, the colour factors, JPEG qualities) come from a CPU
``torch.Generator`` seeded from ``random_seed`` and move to the device, so
the card and the CPU give the same batches; the JAX package draws them from
``jax.random``, which the port cannot reproduce.

As in the JAX package: host batches are assembled by ``num_workers``
threads with per-file crop streams (the same batches for any worker count);
up to ``device_prefetch`` prepared batches are dispatched ahead; and in
``device_resident="auto"`` mode a corpus whose crop pool fits
``device_pool_budget`` bytes is uploaded once and its crops gathered on the
device, giving the same batches as the host path.
"""

import logging
import math
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.data.image import PYTHON_KINDS, file_kind, read_rgb_u8
from simplesr_tpu_torch.data.native_loader import get_native_loader
from simplesr_tpu_torch.ops import augment as augment_ops
from simplesr_tpu_torch.ops.jpeg import jpeg_degrade
from simplesr_tpu_torch.ops.resize import resize as _resize

log = logging.getLogger("simple_sr")

# The JAX package's batch preparation is one jitted function, in which XLA
# turns x / 255 into x * float32(1 / 255) and x / 127.5 - 1 into one fused
# multiply-add of float32(1 / 127.5). The port computes the same roundings:
# the product in float32, and the multiply-add exactly in float64 (exact for
# float32 inputs of [0, 255] scale) with one rounding to float32.
_INV_255 = float(np.float32(1.0 / 255.0))
_INV_127_5 = float(np.float32(1.0 / 127.5))


def _to_01(hr):
    """[0, 255] -> [0, 1], as normalize_01 under XLA."""
    return hr * _INV_255


def _to_11(hr):
    """[0, 255] -> [-1, 1], as normalize_11 under XLA."""
    return (hr.double() * _INV_127_5 - 1.0).float()


def train_test_split(items, test_size, random_state=None):
    """sklearn's ``train_test_split(items, test_size=..., random_state=...)``
    for a list: ``ceil(test_size * n)`` test items (or ``test_size`` when it
    is an int), taken first from a permutation by
    ``np.random.RandomState(random_state)`` (numpy's global state for None)."""
    n = len(items)
    n_test = int(test_size) if isinstance(test_size, (int, np.integer)) \
        else math.ceil(float(test_size) * n)
    if not 0 < n_test < n:
        raise ValueError(f"test_size={test_size} leaves no train or no test item of {n}")
    if random_state is None:
        perm = np.random.permutation(n)
    elif isinstance(random_state, np.random.RandomState):
        perm = random_state.permutation(n)
    else:
        perm = np.random.RandomState(random_state).permutation(n)
    return [items[i] for i in perm[n_test:]], [items[i] for i in perm[:n_test]]


def _list_images(path):
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if os.path.isfile(os.path.join(path, f)))


def _resolve_augmentations(augmentations):
    """Names or ``(generator, imgs) -> imgs`` callables, as (name, entry)."""
    if not augmentations:
        return []
    out = []
    for aug in augmentations:
        if isinstance(aug, str):
            if aug not in augment_ops.AUGMENTATIONS:
                raise ValueError(f"unknown augmentation {aug!r}; options: "
                                 f"{augment_ops.get_all_available_augmentations()}")
            out.append((aug, aug))
        else:
            out.append((getattr(aug, "__name__", "custom"), aug))
    return out


def _process_shard():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DataPipeline:
    """See the module docstring. The constructor's arguments are the JAX
    package's, and ``device`` (the card by default)."""

    def __init__(self,
                 hr_img_path,
                 scale,
                 resize_filter=None,
                 antialias=True,
                 train_val_split=0.1,
                 validationset_path=None,
                 batch_size=8,
                 augmentations=None,
                 test_img_paths=None,
                 crop=True,
                 crop_size=(80, 80, 3),
                 num_crops=8,
                 crop_naive=True,
                 minimum_variation_patch=0.8,
                 minimum_variation_batch=0.05,
                 random_seed=None,
                 shuffle_buffer_size=4096,
                 jpg_noise=False,
                 jpg_noise_level=50,
                 shard_by_process=False,
                 drop_remainder=False,
                 use_native=True,
                 num_workers=None,
                 device_prefetch=4,
                 device_resident="auto",
                 device_pool_budget=1 << 30,
                 device="cuda"):
        self.device = resolve_device(device)
        self.scale = int(scale)
        self.data_path = None if hr_img_path is None else (
            hr_img_path if isinstance(hr_img_path, list) else [hr_img_path])
        self.validationset_path = None if validationset_path is None else (
            validationset_path if isinstance(validationset_path, list) else [validationset_path])
        self.test_img_paths = test_img_paths
        self.crop = crop
        self.shuffle_buffer_size = shuffle_buffer_size
        self.resize_filter = resize_filter or "bicubic"
        self.antialias = antialias
        self.batch_size = int(batch_size)
        self.crop_size = tuple(crop_size)
        self.num_crops = int(num_crops)
        self.crop_naive = crop_naive
        self.minimum_variation_patch = minimum_variation_patch
        self.minimum_variation_batch = minimum_variation_batch
        self.random_seed = random_seed
        self.augmentations = _resolve_augmentations(augmentations)
        self.jpg_noise = jpg_noise
        # a level L is the fixed quality 100 - L; a (lo, hi) pair draws a
        # quality per crop from [100 - hi, 100 - lo] each batch
        if isinstance(jpg_noise_level, (tuple, list)):
            lo, hi = (int(jpg_noise_level[0]), int(jpg_noise_level[1]))
            if not (0 <= lo <= hi <= 99):
                raise ValueError(f"jpg_noise_level range {jpg_noise_level} must satisfy "
                                 "0 <= lo <= hi <= 99")
            self.jpg_noise_level = (lo, hi)
        else:
            self.jpg_noise_level = int(jpg_noise_level)
        if jpg_noise and any(n == "adjust_jpg_quality" for n, _ in self.augmentations):
            log.warning("augmenting hr images with jpg noise and additionally "
                        "degrading lr images with jpg noise")
        self.shard_by_process = shard_by_process
        self.drop_remainder = drop_remainder
        self.train_val_split = train_val_split
        self.validationset_size = train_val_split
        self.num_workers = int(num_workers) if num_workers else max(1, min(4, os.cpu_count() or 1))
        self.device_prefetch = max(1, int(device_prefetch))
        self.device_resident = device_resident
        self.device_pool_budget = int(device_pool_budget)
        self._rng = np.random.default_rng(random_seed)
        # the batches' random parameters: one CPU stream rooted at random_seed
        self._torch_gen = torch.Generator().manual_seed(
            random_seed if random_seed is not None
            else int(np.random.default_rng().integers(2**31 - 1)))
        self._decode_cache = {}
        self._native_kind = {}
        self._device_img_cache = {}
        # the C++ decode and crop server (thread pool, LRU cache)
        self._native = get_native_loader() if use_native else None

        self.train_imgs, self.val_imgs = self._split_train_val()
        world, rank = _process_shard()
        if self.shard_by_process and world > 1:
            self.train_imgs = self.train_imgs[rank::world]

        self.test_imgs = None
        if self.test_img_paths is not None and len(self.test_img_paths) > 0:
            self.test_imgs = self._collect_test_files()

    # ------------------------------------------------------------- listing

    def _split_train_val(self):
        img_files = []
        if self.data_path is not None:
            for p in self.data_path:
                img_files += _list_images(p)
        val_list = []
        if self.validationset_path is not None:
            self.validationset_size = 0
            train_list = img_files
            for vp in self.validationset_path:
                if os.path.isfile(vp):
                    val_list.append(vp)
                else:
                    val_list += _list_images(vp)
        elif self.data_path is not None and self.validationset_size > 0.0:
            train_list, val_list = train_test_split(img_files, self.validationset_size,
                                                    self.random_seed)
        else:
            train_list = img_files
        return train_list, val_list

    def _collect_test_files(self):
        paths = self.test_img_paths
        if not isinstance(paths, list):
            paths = [paths]
        files = []
        for p in paths:
            if os.path.isfile(p):
                files.append(p)
            elif os.path.isdir(p):
                files += _list_images(p)
            else:
                raise ValueError(f"could not locate path: {p}")
        return files

    # ------------------------------------------------------------- decode

    def _native_reads(self, path):
        """Whether the C++ loader reads this file (BMP decodes in numpy)."""
        if self._native is None:
            return False
        if path not in self._native_kind:
            self._native_kind[path] = file_kind(path) not in PYTHON_KINDS
        return self._native_kind[path]

    def _decoded(self, path):
        """The uint8 RGB image, decoded once."""
        img = self._decode_cache.get(path)
        if img is None:
            if self._native_reads(path):
                img = self._native.load_image_u8(path)
            else:
                img = read_rgb_u8(path, native=False)
            self._decode_cache[path] = img
        return img

    def _image_hw(self, path):
        img = self._decode_cache.get(path)
        if img is not None:
            return img.shape[0], img.shape[1]
        if self._native_reads(path):
            return self._native.image_size(path)
        return self._decoded(path).shape[:2]

    # ------------------------------------------------- host crop assembly

    def _host_crops(self, path, rng):
        """``num_crops`` HWC uint8 crops of one image, naive or
        diversity-sampled (bounded oversample, threshold, top-up by std).
        Naive crops of an image not in the Python cache come from the C++
        loader, with the same draws."""
        ph, pw = self.crop_size[0], self.crop_size[1]
        n = self.num_crops
        if self.crop_naive and path not in self._decode_cache and self._native_reads(path):
            h, w = self._native.image_size(path)
            if h < ph or w < pw:
                raise ValueError(f"patch {ph}x{pw} larger than image {h}x{w} ({path})")
            tops = rng.integers(0, h - ph + 1, size=n).astype(np.int32)
            lefts = rng.integers(0, w - pw + 1, size=n).astype(np.int32)
            return list(self._native.load_crops([path] * n, tops, lefts, ph, pw,
                                                dtype=np.uint8))
        img = self._decoded(path)
        h, w = img.shape[0], img.shape[1]
        if h < ph or w < pw:
            raise ValueError(f"patch {ph}x{pw} larger than image {h}x{w} ({path})")
        if self.crop_naive:
            tops = rng.integers(0, h - ph + 1, size=n)
            lefts = rng.integers(0, w - pw + 1, size=n)
            return [img[t:t + ph, l:l + pw] for t, l in zip(tops, lefts)]
        k = n * 8
        tops = rng.integers(0, h - ph + 1, size=k)
        lefts = rng.integers(0, w - pw + 1, size=k)
        cands = np.stack([img[t:t + ph, l:l + pw] for t, l in zip(tops, lefts)])
        stds = cands.reshape(k, -1).astype(np.float32).std(axis=1)
        passing = np.flatnonzero(stds > self.minimum_variation_patch)
        order = list(passing) + list(np.argsort(-stds)[~np.isin(np.argsort(-stds), passing)])
        pick = order[:n]
        means = cands.reshape(k, -1).astype(np.float32).mean(axis=1)
        if np.std(means[pick]) < self.minimum_variation_batch:
            # both tails: the lowest and highest passing means
            rank_key = np.where(stds > self.minimum_variation_patch, means, np.median(means))
            by_mean = np.argsort(rank_key)
            n_lo = n - n // 2
            pick = list(by_mean[:n_lo]) + list(by_mean[k - n // 2:])
        return [cands[i] for i in pick]

    # ------------------------------------------------- batch preparation

    def _draw(self, batch_size):
        """The batch's random parameters, drawn on the CPU in a fixed order:
        (augmentation parameters, JPEG quality or None)."""
        names = [entry for _, entry in self.augmentations]
        params = augment_ops.draw_batch_params(names, self._torch_gen, batch_size)
        quality = None
        if self.jpg_noise:
            level = self.jpg_noise_level
            if isinstance(level, tuple):
                q_lo, q_hi = 100 - level[1], 100 - level[0]
                quality = torch.rand(batch_size, generator=self._torch_gen) * (q_hi - q_lo) + q_lo
            else:
                quality = float(100 - level)
        return params, quality

    def _prepare(self, hr_crops, aug_ids):
        """(lr, hr) of one batch: ``hr_crops`` (B, H, W, 3) in [0, 255]
        (uint8 or float, on any device), ``aug_ids`` a host int array."""
        params, quality = self._draw(hr_crops.shape[0])
        hr = hr_crops.to(self.device).float()
        if self.augmentations:
            names = [entry for _, entry in self.augmentations]
            hr = augment_ops.apply_batch(hr, list(aug_ids), names, params,
                                         generator=self._torch_gen)
        lr_h, lr_w = hr.shape[1] // self.scale, hr.shape[2] // self.scale
        lr = _resize(_to_01(hr), (lr_h, lr_w), method=self.resize_filter,
                     antialias=self.antialias)
        if self.jpg_noise:
            if isinstance(quality, torch.Tensor):
                quality = quality.to(self.device)
            lr = jpeg_degrade(lr, quality)
        return lr.float(), _to_11(hr)

    # --------------------------------------- device-resident crop pool

    def _pooled_mode(self, files):
        """Whether this epoch uses the device-resident crop pool: naive
        crops only, and the pool and images within the budget (``True``
        forces it, ``False`` turns it off)."""
        if not (self.crop and self.crop_naive) or not files:
            return False
        if self.device_resident is False:
            return False
        if self.device_resident is True:
            return True
        ph, pw = self.crop_size[0], self.crop_size[1]
        pool_bytes = len(files) * self.num_crops * ph * pw * 3
        img_bytes = sum(h * w * 3 for h, w in map(self._image_hw, files))
        return pool_bytes + img_bytes <= self.device_pool_budget

    def _device_image(self, path):
        img = self._device_img_cache.get(path)
        if img is None:
            img = torch.from_numpy(self._decoded(path)).to(self.device)
            self._device_img_cache[path] = img
        return img

    def _iter_batches_pooled(self, chunks, file_seeds):
        """The epoch from the device-resident pool: the same per-file crop
        streams as the host path, crops gathered on the device."""
        ph, pw = self.crop_size[0], self.crop_size[1]
        n = self.num_crops
        parts, index_of = [], {}
        for f in sorted(file_seeds):
            h, w = self._image_hw(f)
            if h < ph or w < pw:
                raise ValueError(f"patch {ph}x{pw} larger than image {h}x{w} ({f})")
            rng_f = np.random.default_rng(file_seeds[f])
            tops = rng_f.integers(0, h - ph + 1, size=n)
            lefts = rng_f.integers(0, w - pw + 1, size=n)
            rows = torch.as_tensor(tops[:, None] + np.arange(ph), device=self.device)
            cols = torch.as_tensor(lefts[:, None] + np.arange(pw), device=self.device)
            for c in range(n):
                index_of[(f, c)] = len(parts) * n + c
            parts.append(self._device_image(f)[rows[:, :, None], cols[:, None, :]])
        pool = torch.cat(parts)

        pending = []
        for chunk in chunks:
            idx = torch.as_tensor([index_of[(f, c)] for f, c, _ in chunk], device=self.device)
            aug_ids = np.asarray([a for _, _, a in chunk], np.int32)
            pending.append(self._prepare(pool.index_select(0, idx), aug_ids))
            if len(pending) > self.device_prefetch:
                yield pending.pop(0)
        yield from pending

    # ------------------------------------------------------- generators

    def _work_items(self, files, with_augs):
        n_augs = 1 + len(self.augmentations) if with_augs else 1
        n_crops = self.num_crops if self.crop else 1
        return [(f, c, a) for f in files for c in range(n_crops) for a in range(n_augs)]

    def _iter_batches(self, files, shuffle, with_augs, drop_remainder=False):
        rng = np.random.default_rng(self._rng.integers(0, 2**31 - 1))
        items = self._work_items(files, with_augs)
        if shuffle:
            rng.shuffle(items)
        bs = self.batch_size
        # per-file crop streams, seeded in sorted file order, so that any
        # worker count gives the same batches
        file_seeds = {f: int(rng.integers(0, 2**31 - 1))
                      for f in sorted({f for f, _, _ in items})}

        crop_bank = {}
        bank_guard = threading.Lock()
        bank_locks = {}

        def _crop_for(f, c):
            if not self.crop:
                return self._decoded(f)
            bank = crop_bank.get(f)
            if bank is None:
                with bank_guard:
                    lock = bank_locks.setdefault(f, threading.Lock())
                with lock:
                    bank = crop_bank.get(f)
                    if bank is None:
                        bank = self._host_crops(f, np.random.default_rng(file_seeds[f]))
                        crop_bank[f] = bank
            return bank[c]

        def _assemble(chunk):
            """The host side of one batch (on a worker thread)."""
            crops = [_crop_for(f, c) for f, c, _ in chunk]
            if len({x.shape for x in crops}) > 1:
                return "hetero", chunk, crops
            return "homo", np.stack(crops), np.asarray([a for _, _, a in chunk], np.int32)

        chunks = [items[start:start + bs] for start in range(0, len(items), bs)]
        if drop_remainder and chunks and len(chunks[-1]) < bs:
            chunks.pop()

        if self._pooled_mode(files):
            yield from self._iter_batches_pooled(chunks, file_seeds)
            return

        depth = max(2, 2 * self.num_workers)
        pending = []
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            futures = [pool.submit(_assemble, chunks[i]) for i in range(min(depth, len(chunks)))]
            for i in range(len(chunks)):
                kind, a, b = futures[i].result()
                futures[i] = None
                if i + depth < len(chunks):
                    futures.append(pool.submit(_assemble, chunks[i + depth]))
                if kind == "hetero":  # whole images of several sizes: one at a time
                    for (_, _, aug), x in zip(a, b):
                        pending.append(self._prepare(torch.from_numpy(x[None]),
                                                     np.asarray([aug], np.int32)))
                        if len(pending) > self.device_prefetch:
                            yield pending.pop(0)
                    continue
                pending.append(self._prepare(torch.from_numpy(a), b))
                if len(pending) > self.device_prefetch:
                    yield pending.pop(0)
        yield from pending

    def train_batch_generator(self):
        """(lr, hr) batches on the pipeline's device, for training."""
        if not self.train_imgs:
            return iter([])
        return self._iter_batches(self.train_imgs, shuffle=True, with_augs=True,
                                  drop_remainder=self.drop_remainder)

    def validation_batch_generator(self):
        """(lr, hr) batches for validation: no augmentation, no shuffle."""
        if not self.val_imgs:
            return iter([])
        return self._iter_batches(self.val_imgs, shuffle=False, with_augs=False)

    def test_batch_generator(self, batch_size=8):
        """(images in [0, 1] on the device, paths) batches; images of another
        size than the batch's start a new batch."""
        if self.test_imgs is None:
            return iter([])

        def _gen():
            batch, paths = [], []
            for f in self.test_imgs:
                img = self._decoded(f).astype(np.float32) / 255.0
                if batch and img.shape != batch[0].shape:
                    yield torch.from_numpy(np.stack(batch)).to(self.device), list(paths)
                    batch, paths = [], []
                batch.append(img)
                paths.append(f)
                if len(batch) == batch_size:
                    yield torch.from_numpy(np.stack(batch)).to(self.device), list(paths)
                    batch, paths = [], []
            if batch:
                yield torch.from_numpy(np.stack(batch)).to(self.device), list(paths)

        return _gen()

    # ------------------------------------------------------------ debugging

    def _dump_train_dataset(self, save_dir, n_epochs=1):
        """Render every training batch as an LR/HR grid."""
        from simplesr_tpu_torch.eval import rendering
        for epoch in range(n_epochs):
            for idx, (lr_batch, hr_batch) in enumerate(self.train_batch_generator()):
                rendering.prepare_image_grid(save_dir, f"epoch{epoch}_{idx}_train",
                                             low_res_key="LR", LR=lr_batch, HR=hr_batch)

    def _dump_validation_dataset(self, save_dir, n_epochs=1):
        from simplesr_tpu_torch.eval import rendering
        for epoch in range(n_epochs):
            for idx, (lr_batch, hr_batch) in enumerate(self.validation_batch_generator()):
                rendering.prepare_image_grid(save_dir, f"epoch{epoch}_{idx}_val",
                                             low_res_key="LR", LR=lr_batch, HR=hr_batch)

    # ------------------------------------------------------------ factories

    def __str__(self):
        augs = [name for name, _ in self.augmentations] or None
        return (f"DataPipeline:\n"
                f"data path: {self.data_path}\n"
                f"validation data path: {self.validationset_path}\n"
                f"test images: {self.test_img_paths}\n"
                f"resize filter: {self.resize_filter}\n"
                f"antialias: {self.antialias}\n"
                f"validation set size: {self.validationset_size}\n"
                f"batch size: {self.batch_size}\n"
                f"augmentations: {augs}\n"
                f"jpg noise: {self.jpg_noise} (level {self.jpg_noise_level})\n"
                f"crop: {self.crop} size {self.crop_size} x{self.num_crops} "
                f"naive={self.crop_naive}\n")

    @staticmethod
    def from_config(config, device="cuda"):
        """The training pipeline of a ConfigUtil."""
        return DataPipeline(
            hr_img_path=config.train_data_paths,
            scale=config.scale, resize_filter=config.resize_filter,
            antialias=config.antialias,
            train_val_split=config.train_val_split,
            validationset_path=config.validation_data_path,
            batch_size=config.batch_size,
            augmentations=config.augmentations, jpg_noise=config.jpg_noise,
            jpg_noise_level=config.jpg_noise_level,
            test_img_paths=config.test_data_paths,
            crop=config.crop_imgs, crop_size=config.crop_size,
            random_seed=config.random_seed,
            num_crops=config.num_crops, crop_naive=config.crop_naive,
            shuffle_buffer_size=config.shuffle_buffer_size,
            minimum_variation_patch=config.minimum_variation_patch,
            minimum_variation_batch=config.minimum_variation_batch,
            drop_remainder=getattr(config, "data_parallel", False),
            num_workers=getattr(config, "num_workers", None),
            device_resident=getattr(config, "device_resident", "auto"),
            device=device,
        )

    @staticmethod
    def eval_pipeline(config, device="cuda"):
        """(downscaled, ground-truth) pairs through the validation generator."""
        return DataPipeline(
            hr_img_path=None, scale=config.scale,
            validationset_path=config.test_data_paths,
            batch_size=config.batch_size, resize_filter=config.resize_filter,
            antialias=config.antialias,
            crop=config.crop_imgs, crop_size=config.crop_size,
            random_seed=config.random_seed,
            num_crops=config.num_crops, crop_naive=config.crop_naive,
            minimum_variation_patch=config.minimum_variation_patch,
            minimum_variation_batch=config.minimum_variation_batch,
            device=device,
        )

    @staticmethod
    def inference_pipeline(config, device="cuda"):
        """(image, path) pairs through the test generator."""
        return DataPipeline(
            hr_img_path=None, test_img_paths=config.test_data_paths,
            antialias=config.antialias, scale=config.scale, device=device,
        )
