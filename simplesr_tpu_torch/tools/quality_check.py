"""Quality gate, as scripts/quality_check.py: train SRResNet from scratch on
the images in reach and check that it beats bicubic interpolation on a
train member and on held-out images, the end-to-end "is the whole stack
learning?" signal.

    python -m simplesr_tpu_torch.tools.quality_check [steps] [scale]
        [--tiny] [--device cpu]

The images are the quality campaign's (``quality_campaign.corpus_split``):
with no checkout of the reference, the 12 training tiles of
``data/corpus/gallery`` train, the largest of them
(``GALLERY_TRAIN_MEMBER``) is the train-member probe, and gt_1, gt_10,
gt_13 and gt_6 are held out. x2 by default, 4000 steps of batch 16, 96 px
HR crops (flips and turns), Adam on 2e-4 / 1e-4 / 5e-5 at half and three
quarters of the steps, as the JAX script. Each probe is scored on its
96 px tiles, the mean PSNR and SSIM against bicubic's, printed with
``BEATS_BICUBIC`` or ``BELOW_BICUBIC``; ``main`` returns the numbers.
``QUALITY_ARCH=rrdb`` trains an 8-block RRDB instead; ``--tiny`` a 2-block
16-filter SRResNet (a smoke run). On the card unless ``--device cpu``.
"""

import argparse
import os
import sys
import tempfile
import time

import torch

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.data.image import read_img
from simplesr_tpu_torch.ops.crop import batch_random_crops
from simplesr_tpu_torch.ops.metrics import psnr, ssim
from simplesr_tpu_torch.ops.resize import resize
from simplesr_tpu_torch.tools.quality_campaign import (GALLERY_TRAIN_MEMBER, _augmented,
                                                      corpus_split)
from simplesr_tpu_torch.train import Generator, SRModel
from simplesr_tpu_torch.train.optimizers import piecewise_constant_decay

CROP = 96
BATCH = 16


def _pairs(hr_crops, scale):
    lr = resize(hr_crops / 255.0, (CROP // scale, CROP // scale),
                method="bicubic", antialias=True)
    return lr.float(), (hr_crops / 127.5 - 1.0).float()


def main(steps=4000, scale=2, tiny=False, device="cuda"):
    """Train, then score the train member and each held-out image: returns
    {"steps", "train_s", "images": {label: {"model_psnr", "model_ssim",
    "bicubic_psnr", "bicubic_ssim", "heldout"}}}."""
    dev = resolve_device(device)
    train_imgs, heldout_imgs, members = corpus_split()
    with tempfile.TemporaryDirectory() as tmp:
        return _run(steps, scale, tiny, dev, tmp, train_imgs, heldout_imgs, members)


def _run(steps, scale, tiny, dev, tmp, train_imgs, heldout_imgs, members):
    class Cfg:
        model_dir = tmp + "/models"
        checkpoint_dir = tmp + "/ckpt"
        early_stop_metric = "psnr"
        early_stop_patience = 10**6
        epoch_train_summary_writer = None
        batch_train_summary_writer = None
        epoch_validation_summary_writer = None
        batch_validation_summary_writer = None

    # -------- stage training crops (the port's ops, one upload an image)
    all_crops = []
    for i, (name, path) in enumerate(train_imgs.items()):
        if not os.path.exists(path):
            print(f"skipping {name}: {path} not found", flush=True)
            continue
        img = torch.from_numpy(read_img(path)).to(dev)
        n = max(64, int(img.shape[0] * img.shape[1] / 40000))
        all_crops.append(batch_random_crops(
            torch.Generator().manual_seed(i), img[None], num_crops=n,
            patch_size=(CROP, CROP)))
    crops = torch.cat(all_crops)
    augd = [crops] + [_augmented(crops, name, 100 + i) for i, name in
                      enumerate(["flip_along_x", "flip_along_y", "rotate90"])]
    lr_all, hr_all = _pairs(torch.cat(augd), scale)
    n = (hr_all.shape[0] // BATCH) * BATCH
    lr_all, hr_all = lr_all[:n], hr_all[:n]
    print(f"staged {n} training pairs on {dev.type} (scale x{scale})", flush=True)

    lr_dims = (CROP // scale, CROP // scale)
    arch = os.environ.get("QUALITY_ARCH", "srresnet")
    if arch == "rrdb":
        gen = Generator.rrdb(upsample_factor=scale, num_blocks=8, input_dims=lr_dims,
                             device=dev)
    else:
        size = dict(num_blocks=2, num_filters=16) if tiny else {}
        gen = Generator.srresnet(upsample_factor=scale, batch_norm=False,
                                 input_dims=lr_dims, device=dev, **size)
    schedule = piecewise_constant_decay(
        [steps // 2, (3 * steps) // 4], [2e-4, 1e-4, 5e-5])
    model = SRModel(model_type="resnet", generator=gen,
                    generator_optimizer="Adam",
                    generator_optimizer_config={"learning_rate": schedule},
                    config=Cfg, device=dev)

    t0 = time.perf_counter()
    model.before_epoch()
    perm = torch.Generator().manual_seed(42)
    batches = n // BATCH
    for step in range(steps):
        if step % batches == 0:
            order = torch.randperm(n, generator=perm).to(dev)
            lr_all, hr_all = lr_all[order], hr_all[order]
        i = (step % batches) * BATCH
        model.train_step(lr_all[i:i + BATCH], hr_all[i:i + BATCH])
        if step % 1000 == 999:
            loss = float(model.generator_wrapper().batch_metrics()
                         .ensure("generator_loss")._values[-1])
            print(f"step {step + 1}: loss={loss:.5f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
        model.after_train_batch()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0

    # -------------------------------------------------------- evaluation
    def eval_image(path, label):
        region = torch.from_numpy(read_img(path)).to(dev)
        hh = (region.shape[0] // CROP) * CROP
        ww = (region.shape[1] // CROP) * CROP
        tiles = region[:hh, :ww].reshape(
            hh // CROP, CROP, ww // CROP, CROP, 3).permute(0, 2, 1, 3, 4) \
            .reshape(-1, CROP, CROP, 3)
        lr_t, hr_t = _pairs(tiles, scale)
        outs = []
        for i in range(0, lr_t.shape[0], BATCH):
            chunk = lr_t[i:i + BATCH]
            pad = BATCH - chunk.shape[0]
            if pad:
                chunk = torch.cat([chunk, chunk.new_zeros((pad,) + chunk.shape[1:])])
            outs.append(model.generate(chunk)[:BATCH - pad].float())
        sr = torch.cat(outs)
        bic = resize(lr_t * 2.0 - 1.0, (CROP, CROP), method="bicubic")
        mp = float(psnr(hr_t, sr, max_val=2.0).mean())
        ms = float(ssim(hr_t, sr, max_val=2.0).mean())
        bp = float(psnr(hr_t, bic, max_val=2.0).mean())
        bs = float(ssim(hr_t, bic, max_val=2.0).mean())
        print(f"{label}: model PSNR {mp:.2f} SSIM {ms:.4f} | "
              f"bicubic PSNR {bp:.2f} SSIM {bs:.4f} | "
              f"{'BEATS_BICUBIC' if mp > bp else 'BELOW_BICUBIC'}", flush=True)
        return {"model_psnr": mp, "model_ssim": ms, "bicubic_psnr": bp, "bicubic_ssim": bs}

    # in-distribution check: a training member (lena, the JAX script's,
    # where the reference is); the model must clearly beat bicubic here if
    # the stack is learning correctly
    member = members.get("lena") or members[GALLERY_TRAIN_MEMBER]
    label = f"train-member {os.path.basename(member)} x{scale}"
    images = {label: {**eval_image(member, label), "heldout": False}}
    for path in heldout_imgs.values():
        if not os.path.exists(path):
            print(f"skipping {path}: not found", flush=True)
            continue
        label = f"held-out {os.path.basename(path)} (unseen) x{scale}"
        images[label] = {**eval_image(path, label), "heldout": True}
    return {"steps": steps, "train_s": train_s, "images": images}


def _parse_cli(argv):
    p = argparse.ArgumentParser(description="Train SRResNet and check it beats bicubic")
    p.add_argument("steps", nargs="?", type=int, default=4000)
    p.add_argument("scale", nargs="?", type=int, default=2)
    p.add_argument("--tiny", action="store_true", help="a 2-block 16-filter smoke model")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return vars(p.parse_args(argv))


if __name__ == "__main__":
    main(**_parse_cli(sys.argv[1:]))
