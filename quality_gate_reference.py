#!/usr/bin/env python3
"""The JAX package's run of the quality gate's recipe, the reference that
``chip_smoke.py`` phase 16 (b) holds the port's run to.

    JAX_PLATFORMS=cpu python3 quality_gate_reference.py [steps]
    JAX_PLATFORMS=cpu python3 quality_gate_reference.py --save-init FILE

``simplesr_tpu_torch/tools/quality_check.py`` trains SRResNet x2 (16 blocks,
64 filters, BN-free) from scratch for 4000 steps of batch 16 on 96 px crops
of the 12 training gallery tiles (flips and turns), Adam on 2e-4 / 1e-4 /
5e-5 at half and three quarters of the steps, and scores the train member
gt_11 and the held-out gt_1, gt_10, gt_13 and gt_6 on their 96 px tiles
against bicubic. This script stages the same pairs with the port's code,
trains the JAX package's ``SRModel`` and ``Generator`` on them (float32 on
the CPU, about 1.4 s a step on 8 cores: the default bf16 convolutions are
slower there) and scores with the JAX package's resize and PSNR. It prints
one JSON line: each probe's model and bicubic PSNR and their gap, and the
held-out mean gap. ``--save-init FILE`` writes the JAX package's initial
weights of that generator (seed 0) as a model file instead, for
``quality_gate_variants.py``'s run from them on the card. It imports JAX
and runs no CUDA; the card has no JAX.
"""

import json
import sys
import tempfile
import time

import numpy as np
import torch

import jax.numpy as jnp
from simplesr_tpu.ops import psnr, resize
from simplesr_tpu.train import Generator, SRModel
from simplesr_tpu.train.optimizers import piecewise_constant_decay
from simplesr_tpu.train.serialization import save_model
from simplesr_tpu_torch.data.image import read_img
from simplesr_tpu_torch.ops.crop import batch_random_crops
from simplesr_tpu_torch.tools import quality_check
from simplesr_tpu_torch.tools.quality_campaign import _augmented, corpus_split

SCALE, CROP, BATCH, SEED = 2, quality_check.CROP, quality_check.BATCH, 42


def staged_pairs(train_imgs):
    """quality_check's training pairs, as numpy: the same crops, augmented
    copies and LR."""
    crops = []
    for i, path in enumerate(train_imgs.values()):
        img = torch.from_numpy(read_img(path))
        n = max(64, int(img.shape[0] * img.shape[1] / 40000))
        crops.append(batch_random_crops(torch.Generator().manual_seed(i), img[None],
                                        num_crops=n, patch_size=(CROP, CROP)))
    crops = torch.cat(crops)
    augd = [crops] + [_augmented(crops, name, 100 + i) for i, name in
                      enumerate(["flip_along_x", "flip_along_y", "rotate90"])]
    lr, hr = quality_check._pairs(torch.cat(augd), SCALE)
    n = (lr.shape[0] // BATCH) * BATCH
    return lr[:n].numpy(), hr[:n].numpy()


def probe_tiles(path):
    """A probe's 96 px tiles and their LR, as quality_check cuts them."""
    region = torch.from_numpy(read_img(path))
    hh, ww = (region.shape[0] // CROP) * CROP, (region.shape[1] // CROP) * CROP
    tiles = region[:hh, :ww].reshape(hh // CROP, CROP, ww // CROP, CROP, 3) \
        .permute(0, 2, 1, 3, 4).reshape(-1, CROP, CROP, 3)
    lr, hr = quality_check._pairs(tiles, SCALE)
    return lr.numpy(), hr.numpy()


def main(steps=4000):
    torch.set_num_threads(2)  # staging only; the JAX step takes the cores
    train_imgs, heldout_imgs, members = corpus_split()
    lr_all, hr_all = staged_pairs(train_imgs)
    n = lr_all.shape[0]
    with tempfile.TemporaryDirectory() as tmp:
        class Cfg:
            model_dir = tmp + "/models"
            checkpoint_dir = tmp + "/ckpt"
            early_stop_metric = "psnr"
            early_stop_patience = 10**6
            epoch_train_summary_writer = None
            batch_train_summary_writer = None
            epoch_validation_summary_writer = None
            batch_validation_summary_writer = None

        gen = Generator.srresnet(upsample_factor=SCALE, batch_norm=False,
                                 input_dims=(CROP // SCALE, CROP // SCALE), dtype=jnp.float32)
        model = SRModel(model_type="resnet", generator=gen, generator_optimizer="Adam",
                        generator_optimizer_config={"learning_rate": piecewise_constant_decay(
                            [steps // 2, (3 * steps) // 4], [2e-4, 1e-4, 5e-5])},
                        config=Cfg)
        rng = np.random.default_rng(SEED)
        batches = n // BATCH
        t0 = time.perf_counter()
        model.before_epoch()
        for step in range(steps):
            if step % batches == 0:
                order = rng.permutation(n)
            idx = order[(step % batches) * BATCH:(step % batches + 1) * BATCH]
            model.train_step(jnp.asarray(lr_all[idx]), jnp.asarray(hr_all[idx]))
            model.after_train_batch()
            if step % 500 == 499:
                print(f"step {step + 1} ({time.perf_counter() - t0:.0f}s)", flush=True)
        train_s = time.perf_counter() - t0

        probes = {f"train-member {k}": v for k, v in members.items()
                  if k in ("lena", quality_check.GALLERY_TRAIN_MEMBER)}
        probes.update({f"held-out {k}": v for k, v in heldout_imgs.items()})
        out = {}
        for label, path in probes.items():
            lr_t, hr_t = probe_tiles(path)
            sr = np.concatenate([np.asarray(model.generate(jnp.asarray(lr_t[i:i + BATCH])),
                                            np.float32) for i in range(0, len(lr_t), BATCH)])
            bic = resize(jnp.asarray(lr_t) * 2.0 - 1.0, (CROP, CROP), method="bicubic")
            mp = float(jnp.mean(psnr(jnp.asarray(hr_t), jnp.asarray(sr), max_val=2.0)))
            bp = float(jnp.mean(psnr(jnp.asarray(hr_t), bic, max_val=2.0)))
            out[label] = {"model_psnr": mp, "bicubic_psnr": bp, "gap": mp - bp}
    held = [v["gap"] for k, v in out.items() if k.startswith("held-out")]
    print(json.dumps({"steps": steps, "dtype": "float32", "train_s": train_s,
                      "probes": out, "heldout_mean_gap": sum(held) / len(held)}), flush=True)


def save_init(path):
    gen = Generator.srresnet(upsample_factor=SCALE, batch_norm=False,
                             input_dims=(CROP // SCALE, CROP // SCALE))
    save_model(gen.module_config(), gen.variables, path)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--save-init"]:
        save_init(sys.argv[2])
    else:
        main(int(sys.argv[1]) if len(sys.argv) > 1 else 4000)
