"""GAN-dynamics smoke, as scripts/gan_smoke.py: a short SRGAN training (the
generator and the critic updated together, label smoothing) on real crops,
reporting the loss and accuracy trajectories: evidence that the adversarial
game is stable (the critic's accuracy between chance and saturation, no
divergence, every value finite).

    python -m simplesr_tpu_torch.tools.gan_smoke [steps] [--tiny] [--device cpu]

The recipe is the JAX script's: ``srgan_generator`` x4 (16 blocks, 64
filters, BatchNorm) with MSE for VGG (``vgg_loss=False``) and adversarial
1e-3, the standard critic at 96 x 96 with label smoothing 0.2, Adam 1e-4 on
both, batches of 16 from 512 seeded 96 px crops. The crops come from the
largest training tile of ``data/corpus/gallery``
(``quality_campaign.GALLERY_TRAIN_MEMBER``), where the JAX script cut them
from a DIV2K image of the reference. Prints ``GAN_STABLE`` when every epoch
mean is finite and the critic's mean accuracy lies in [0.2, 0.999], else
``GAN_UNSTABLE``; ``main`` returns the means and the verdict. ``--tiny``
cuts both networks (a smoke run). On the card unless ``--device cpu``.
"""

import argparse
import math
import sys
import tempfile
import time

import torch

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.data.image import read_img
from simplesr_tpu_torch.ops.crop import batch_random_crops
from simplesr_tpu_torch.ops.resize import resize
from simplesr_tpu_torch.tools.quality_campaign import _GALLERY_DIR, GALLERY_TRAIN_MEMBER
from simplesr_tpu_torch.train import Discriminator, Generator, SRModel

SCALE, CROP, BATCH = 4, 96, 16
CROP_SOURCE = f"{_GALLERY_DIR}/{GALLERY_TRAIN_MEMBER}.png"


def main(steps=1500, tiny=False, device="cuda"):
    """Train ``steps`` GAN steps; returns {"generator": epoch means,
    "discriminator": epoch means, "stable": bool}."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        return _run(steps, tiny, dev, tmp)


def _run(steps, tiny, dev, tmp):
    class Cfg:
        model_dir = tmp + "/models"
        checkpoint_dir = tmp + "/ckpt"
        early_stop_metric = "psnr"
        early_stop_patience = 10**6
        epoch_train_summary_writer = None
        batch_train_summary_writer = None
        epoch_validation_summary_writer = None
        batch_validation_summary_writer = None

    img = torch.from_numpy(read_img(CROP_SOURCE)).to(dev)
    crops = batch_random_crops(torch.Generator().manual_seed(0), img[None],
                               num_crops=512, patch_size=(CROP, CROP))
    lr_all = resize(crops / 255.0, (CROP // SCALE, CROP // SCALE),
                    method="bicubic", antialias=True).float()
    hr_all = (crops / 127.5 - 1.0).float()

    gen = Generator.srgan_generator(
        upsample_factor=SCALE, vgg_loss=False, adversarial_loss_weight=1e-3,
        input_dims=(CROP // SCALE, CROP // SCALE), device=dev,
        **(dict(num_blocks=2, num_filters=16) if tiny else {}))
    disc = Discriminator.initialize_standard(
        label_smoothing=True, smoothing_offset=0.2, input_dims=(CROP, CROP), device=dev,
        **(dict(num_filters=8) if tiny else {}))
    model = SRModel(model_type="gan", generator=gen,
                    generator_optimizer="Adam",
                    generator_optimizer_config={"learning_rate": 1e-4},
                    discriminator=disc, discriminator_optimizer="Adam",
                    discriminator_optimizer_config={"learning_rate": 1e-4},
                    config=Cfg, device=dev)

    t0 = time.perf_counter()
    model.before_epoch()
    n = lr_all.shape[0]
    for step in range(steps):
        i = (step * BATCH) % (n - BATCH)
        model.train_step(lr_all[i:i + BATCH], hr_all[i:i + BATCH])
        if step % 250 == 249:
            gm = {k: float(v) for k, v in
                  model.generator_wrapper().batch_metrics().last_values().items()}
            dm = {k: float(v) for k, v in
                  model.discriminator_wrapper().batch_metrics().last_values().items()}
            print(f"step {step + 1}: G={gm.get('generator_loss', float('nan')):.4f} "
                  f"(adv {gm.get('adversarial_loss', float('nan')):.3f}) "
                  f"D={dm.get('discriminator_loss', float('nan')):.3f} "
                  f"acc={dm.get('discriminator_accuracy', float('nan')):.2f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
        model.after_train_batch()

    gm = model.generator_wrapper().epoch_metrics(True).results()
    dm = model.discriminator_wrapper().epoch_metrics(True).results()
    finite = all(math.isfinite(v) for v in list(gm.values()) + list(dm.values()))
    acc = dm.get("discriminator_accuracy", float("nan"))
    stable = finite and 0.2 <= acc <= 0.999
    print(f"epoch means: G {gm.get('generator_loss'):.4f} "
          f"D {dm.get('discriminator_loss'):.4f} acc {acc:.3f} "
          f"SR_acc {dm.get('SR_accuracy'):.3f} HR_acc {dm.get('HR_accuracy'):.3f}")
    print("GAN_STABLE" if stable else "GAN_UNSTABLE", flush=True)
    return {"generator": gm, "discriminator": dm, "stable": stable,
            "train_s": time.perf_counter() - t0}


def _parse_cli(argv):
    p = argparse.ArgumentParser(description="A short SRGAN run: is the game stable?")
    p.add_argument("steps", nargs="?", type=int, default=1500)
    p.add_argument("--tiny", action="store_true", help="cut both networks (a smoke run)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return vars(p.parse_args(argv))


if __name__ == "__main__":
    main(**_parse_cli(sys.argv[1:]))
