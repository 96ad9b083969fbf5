"""Quality campaign, as scripts/quality_campaign.py: train pixel stages
(SRResNet, RRDB and their wide variants) to convergence, early-stopped,
then warm-start GAN stages from them, and score every stage against bicubic
on whole held-out images.

    python -m simplesr_tpu_torch.tools.quality_campaign [--fast | --tiny]
        [--scale N] [--crop C] [--batch B] [--out DIR] [--paired W]
        [--distill teacher.msgpack[:weight]] [--rrdb-blocks N] [--epochs N]
        [--pixel a,b] [--gan gan:parent,...] [--remat]
        [--no-gallery-corpus | --legacy-holdout] [--device cpu]

It writes, under ``--out`` (default ``runs/quality_r2``, ``_x<scale>``
appended for ``--scale 4`` and ``8``; the directory is git-ignored, and the
committed ``results/`` campaigns are never written unless ``--out`` names
one):

  RESULTS.json   per stage and image, model and bicubic PSNR, PSNR on Y,
                 SSIM and the learned-perceptual distance (merged into an
                 existing file, as the JAX script merges)
  RESULTS.md     the held-out summary and per-image tables, word for word
                 the JAX script's, so that the two packages' tables diff
  models/        the stages' model files
  galleries/     annotated grids and half-splits of each held-out image

The corpus: the reference's images (div2k 0004 and 0006, lena; baboon and
comic held out) when a checkout of the reference is at
``$SIMPLESR_REFERENCE``, and the gallery tiles of ``data/corpus/gallery``,
of which gt_1, gt_10, gt_13 and gt_6 are held out and never trained on.
Without the reference the campaign trains on the 12 other gallery tiles,
and the largest of them (``GALLERY_TRAIN_MEMBER``) is the train member that
``evaluate`` scores beside the held-out tiles. A missing image is skipped
by name. Crops are cut and augmented on the device, training and
validation from disjoint seeded ``torch.Generator`` streams.

The run is on the card unless ``--device cpu`` is given.
"""

import json
import os
import shutil
import statistics
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.data.image import read_img
from simplesr_tpu_torch.eval import rendering
from simplesr_tpu_torch.ops import augment
from simplesr_tpu_torch.ops.crop import batch_random_crops
from simplesr_tpu_torch.ops.metrics import psnr, psnr_on_y, ssim
from simplesr_tpu_torch.ops.resize import resize
from simplesr_tpu_torch.train import Discriminator, Generator, SRModel
from simplesr_tpu_torch.train.optimizers import piecewise_constant_decay

REPO = Path(__file__).resolve().parents[2]
_GALLERY_DIR = str(REPO / "data" / "corpus" / "gallery")
# where the JAX package's tests find a checkout of the reference
REFERENCE = Path(os.environ.get("SIMPLESR_REFERENCE", "/root/reference"))
REFERENCE_TRAIN = {"div2k_0004": "data/datasets/div2k/4/0004.png",
                   "div2k_0006": "data/datasets/div2k/8/0006.png",
                   "lena": "tests/data/lena.png"}
REFERENCE_HELDOUT = {"baboon": "tests/data/baboon.png", "comic": "tests/data/comic.png"}
HELDOUT_GALLERY = ("gt_1", "gt_10", "gt_13", "gt_6")
# the largest training tile (512 x 448; the first by name of five that size)
GALLERY_TRAIN_MEMBER = "gt_11"


def corpus_split(reference=REFERENCE, gallery_dir=_GALLERY_DIR):
    """(train, held-out, evaluated train members), each {name: path}: the
    reference's images when its checkout exists, then the gallery tiles,
    the four of HELDOUT_GALLERY held out."""
    reference = Path(reference)
    train, heldout = {}, {}
    if reference.is_dir():
        train = {k: str(reference / v) for k, v in REFERENCE_TRAIN.items()}
        heldout = {k: str(reference / v) for k, v in REFERENCE_HELDOUT.items()}
    if os.path.isdir(gallery_dir):
        for p in sorted(os.listdir(gallery_dir)):
            if p.endswith(".png") and p[:-4] not in HELDOUT_GALLERY:
                train[p[:-4]] = os.path.join(gallery_dir, p)
    for p in HELDOUT_GALLERY:
        path = os.path.join(gallery_dir, p + ".png")
        if os.path.exists(path):
            heldout[p] = path
    # eval stays on the three canonical train members where they exist
    members = [k for k in REFERENCE_TRAIN if k in train] or \
        [k for k in (GALLERY_TRAIN_MEMBER,) if k in train]
    return train, heldout, {k: train[k] for k in members}


TRAIN_IMGS, HELDOUT_IMGS, EVAL_TRAIN_IMGS = corpus_split()
SCALE = 2
CROP = 96
BATCH = 16
AUGS = ["flip_along_x", "flip_along_y", "rotate90"]

OUT_DIR = str(REPO / "runs" / "quality_r2")
DEVICE = "cuda"  # --device


def _device():
    return resolve_device(DEVICE)


def _present(name, path, what):
    """Whether the image exists; a missing one is skipped by name."""
    if os.path.exists(path):
        return True
    print(f"[{what}] skipping {name}: {path} not found", flush=True)
    return False


def _cfg(tmp, patience):
    class Cfg:
        model_dir = tmp + "/models"
        checkpoint_dir = tmp + "/ckpt"
        early_stop_metric = "psnr"
        early_stop_patience = patience
        epoch_train_summary_writer = None
        batch_train_summary_writer = None
        epoch_validation_summary_writer = None
        batch_validation_summary_writer = None
    return Cfg


def _pairs(hr_crops):
    lr = resize(hr_crops / 255.0, (CROP // SCALE, CROP // SCALE),
                method="bicubic", antialias=True)
    return lr.float(), (hr_crops / 127.5 - 1.0).float()


def _augmented(base, name, seed):
    """Each crop through augmentation ``name`` with its own draw from the
    seeded stream (the JAX script's vmap over split keys)."""
    n = base.shape[0]
    params = augment.draw_batch_params([name], torch.Generator().manual_seed(seed), n)
    return augment.apply_batch(base, [1] * n, [name], params)


def stage_dataset(crops_per_mpix=96, val_crops_per_img=32):
    """Upload full train images once; crop + augment on device.
    Training and validation crops use disjoint RNG streams."""
    dev = _device()
    train_parts, val_parts = [], []
    for i, (name, path) in enumerate(TRAIN_IMGS.items()):
        if not _present(name, path, "stage"):
            continue
        img = torch.from_numpy(read_img(path)).to(dev)
        if min(img.shape[0], img.shape[1]) < CROP:
            print(f"[stage] skipping {name}: {tuple(img.shape[:2])} < crop {CROP}",
                  flush=True)
            continue
        mpix = img.shape[0] * img.shape[1] / 1e6
        n = max(48, int(mpix * crops_per_mpix))
        train_parts.append(batch_random_crops(
            torch.Generator().manual_seed(1000 + i), img[None], num_crops=n,
            patch_size=(CROP, CROP)))
        val_parts.append(batch_random_crops(
            torch.Generator().manual_seed(2000 + i), img[None],
            num_crops=val_crops_per_img, patch_size=(CROP, CROP)))
    if not train_parts:
        raise SystemExit("no training image found (see the [stage] lines above)")
    base = torch.cat(train_parts)
    fanout = [base] + [_augmented(base, name, 3000 + i) for i, name in enumerate(AUGS)]
    lr_train, hr_train = _pairs(torch.cat(fanout))
    n = (hr_train.shape[0] // BATCH) * BATCH
    lr_val, hr_val = _pairs(torch.cat(val_parts))
    m = (hr_val.shape[0] // BATCH) * BATCH
    return (lr_train[:n], hr_train[:n]), (lr_val[:m], hr_val[:m])


def run_training(model, train, val, max_epochs, label):
    (lr_t, hr_t), (lr_v, hr_v) = train, val
    n = lr_t.shape[0]
    batches = n // BATCH
    perm = torch.Generator().manual_seed(7)
    t0 = time.perf_counter()
    for epoch in range(max_epochs):
        if model.stop_early():
            print(f"[{label}] early stop after epoch {epoch}", flush=True)
            break
        model.before_epoch()
        order = torch.randperm(n, generator=perm).to(lr_t.device)
        lr_t, hr_t = lr_t[order], hr_t[order]
        for b in range(batches):
            model.train_step(lr_t[b * BATCH:(b + 1) * BATCH],
                             hr_t[b * BATCH:(b + 1) * BATCH])
            model.after_train_batch()
        for b in range(lr_v.shape[0] // BATCH):
            model.validation_step(lr_v[b * BATCH:(b + 1) * BATCH],
                                  hr_v[b * BATCH:(b + 1) * BATCH])
            model.after_validation_batch()
        model.after_epoch()
        val_psnr = model.histories()["valid_epoch"]["psnr"][-1]
        print(f"[{label}] epoch {epoch + 1}: val psnr "
              f"{float(val_psnr):.3f} best "
              f"{float(model.best_metric):.3f} "
              f"({time.perf_counter() - t0:.0f}s)", flush=True)
    model.after_training()
    return model


def _full_image_sr(model, img_01):
    """Whole-image SR (dims cropped to a multiple of SCALE) of an HWC image
    in [0, 1]: (HR, SR, bicubic) in [-1, 1] and the LR input, on the
    device."""
    img = torch.as_tensor(img_01, dtype=torch.float32).to(_device())
    h = (img.shape[0] // SCALE) * SCALE
    w = (img.shape[1] // SCALE) * SCALE
    hr_ref = img[:h, :w] * 2.0 - 1.0
    lr = resize(img[None, :h, :w], (h // SCALE, w // SCALE),
                method="bicubic", antialias=True)
    sr = model.generate(lr)[0].float().to(hr_ref.device)
    bic = resize(lr * 2.0 - 1.0, (h, w), method="bicubic")[0]
    return hr_ref, sr, bic, lr[0]


_LP_CACHE = {}


def _lp_metric_fn():
    """The campaign's perceptual EVAL metric: feature-MSE in a FIXED
    extractor space, this campaign's own srresnet pixel model
    (losses/learned_perceptual.py). Lower is better; comparable only within
    one campaign. None until the srresnet pixel stage has been saved (subset
    runs before it simply omit the column)."""
    path = os.path.join(OUT_DIR, "models",
                        f"resnet_gen_srresnet_x{SCALE}_best.msgpack")
    if not os.path.exists(path):
        return None
    if _LP_CACHE.get("path") != path:
        from simplesr_tpu_torch.losses import LearnedPerceptualLoss
        lp = LearnedPerceptualLoss(model_path=path)

        def fn(a, b):
            with torch.inference_mode():
                return lp(a, b)[0]

        _LP_CACHE["path"] = path
        _LP_CACHE["fn"] = fn
    return _LP_CACHE["fn"]


def evaluate(model, label, results):
    lp_fn = _lp_metric_fn()
    for name, path in {**EVAL_TRAIN_IMGS, **HELDOUT_IMGS}.items():
        if not _present(name, path, label):
            continue
        img = read_img(path) / 255.0
        hr, sr, bic, _ = _full_image_sr(model, img)
        row = {}
        for tag, out in (("model", sr), ("bicubic", bic)):
            row[tag] = {
                "psnr": round(float(psnr(hr[None], out[None], max_val=2.0)[0]), 3),
                "psnr_y": round(float(psnr_on_y(hr[None], out[None], max_val=2.0)[0]), 3),
                "ssim": round(float(ssim(hr[None], out[None], max_val=2.0)[0]), 4),
            }
            if lp_fn is not None:
                row[tag]["lp"] = round(float(lp_fn(hr[None], out[None])), 5)
        row["heldout"] = name in HELDOUT_IMGS
        results.setdefault(label, {})[name] = row
        lp_note = (f" lp {row['model']['lp']:.4f}/"
                   f"{row['bicubic']['lp']:.4f}" if lp_fn else "")
        print(f"[{label}] {name}: model {row['model']['psnr']:.2f}dB "
              f"ssim {row['model']['ssim']:.4f} | bicubic "
              f"{row['bicubic']['psnr']:.2f}dB ssim {row['bicubic']['ssim']:.4f}"
              f"{lp_note}{' (heldout)' if row['heldout'] else ''}", flush=True)
    return results


def render_galleries(model, label):
    """Annotated grid + half-split for each held-out image."""
    gal_dir = os.path.join(OUT_DIR, "galleries", label)
    for name, path in HELDOUT_IMGS.items():
        if not _present(name, path, label):
            continue
        img = read_img(path) / 255.0
        hr, sr, bic, lr = _full_image_sr(model, img)
        vals = {}
        for tag, out in (("model", sr), ("bicubic", bic)):
            vals[tag] = (float(psnr(hr[None], out[None], max_val=2.0)[0]),
                         float(ssim(hr[None], out[None], max_val=2.0)[0]))
        sr, bic, lr, hr = (t.cpu().numpy() for t in (sr, bic, lr, hr))
        rendering.prepare_image_grid(
            gal_dir, f"{name}_grid", low_res_key="LR",
            model=sr[None], bicubic=bic[None], LR=lr[None],
            **{"ground truth": hr[None]},
            psnr={"model": np.array([vals["model"][0]]),
                  "bicubic": np.array([vals["bicubic"][0]]),
                  "LR": np.array([-1.0]), "ground truth": np.array([np.inf])},
            ssim={"model": np.array([vals["model"][1]]),
                  "bicubic": np.array([vals["bicubic"][1]]),
                  "LR": np.array([-1.0]), "ground truth": np.array([1.0])})
        rendering.combine_halfs(sr, bic, "sr", gal_dir, f"{name}_half")


def _calibrated_lp(extractor_path, calib):
    """LearnedPerceptualLoss with loss_weight set so the perceptual term
    equals the pixel-MSE magnitude at the GAN stage's starting point (the
    warm-start model's own outputs)."""
    from simplesr_tpu_torch.losses import LearnedPerceptualLoss
    from simplesr_tpu_torch.train.serialization import load_model

    lr_v, hr_v = calib
    module = load_model(extractor_path, device=lr_v.device)
    with torch.inference_mode():
        sr0 = module(lr_v).float()
        mse0 = float(torch.mean((hr_v - sr0) ** 2))
        lp = LearnedPerceptualLoss(model_path=extractor_path)
        lp_raw = float(lp(hr_v, sr0, None, None)[0])
    weight = mse0 / max(lp_raw, 1e-12)
    print(f"[srgan_lp] calibration: mse0={mse0:.5f} lp_raw={lp_raw:.5f} "
          f"-> loss_weight={weight:.5f}", flush=True)
    return LearnedPerceptualLoss(model_path=extractor_path,
                                 loss_weight=weight)


def _gan_model(gen, disc, tmp, resnet_checkpoint, arch):
    return SRModel(model_type="gan", generator=gen,
                   generator_optimizer="Adam",
                   generator_optimizer_config={"learning_rate": 1e-4},
                   discriminator=disc, discriminator_optimizer="Adam",
                   discriminator_optimizer_config={"learning_rate": 1e-4},
                   resnet_checkpoint=resnet_checkpoint,
                   config=_cfg(tmp, 10**6), paired_ways=_paired_for(arch), device=DEVICE)


def build_model(arch, tmp, patience, steps_hint, resnet_checkpoint=None,
                tiny=False, lp_extractor=None, lp_calib=None,
                pretrained_path=None):
    from simplesr_tpu_torch.losses import (AdversarialLoss, MeanAbsoluteError,
                                           RaAdversarialLoss)

    schedule = piecewise_constant_decay(
        [steps_hint // 2, (3 * steps_hint) // 4], [2e-4, 1e-4, 5e-5])
    lr_dims = (CROP // SCALE, CROP // SCALE)
    size = dict(num_blocks=2, num_filters=16) if tiny else {}
    on = dict(remat=REMAT, device=DEVICE)
    tiny_critic = dict(num_filters=8) if tiny else {}
    if arch == "srresnet":
        gen = Generator.srresnet(upsample_factor=SCALE, batch_norm=False,
                                 input_dims=lr_dims, **on, **size)
    elif arch == "srresnet128":
        # the 128-filter variant; tiny smoke runs keep the reduced width
        gen = Generator.srresnet(upsample_factor=SCALE, batch_norm=False,
                                 input_dims=lr_dims, **on,
                                 **(size or dict(num_filters=128)))
    elif arch == "rrdb":
        gen = Generator.rrdb(upsample_factor=SCALE, input_dims=lr_dims, **on,
                             **(size or dict(num_blocks=RRDB_BLOCKS)))
    elif arch == "rrdb_wide":
        # nf=128 trunk, growth=128 dense convs, 2 blocks
        gen = Generator.rrdb(upsample_factor=SCALE, input_dims=lr_dims, **on,
                             **(size or dict(num_filters=128, growth_channels=128,
                                             num_blocks=2)))
    elif arch == "srgan":
        gen = Generator.srgan_generator(
            upsample_factor=SCALE, vgg_loss=False, batch_norm=False,
            adversarial_loss_weight=1e-3, input_dims=lr_dims, **on,
            pretrained_model_path=pretrained_path, **size)
        disc = Discriminator.initialize_standard(
            label_smoothing=True, smoothing_offset=0.2, input_dims=(CROP, CROP),
            device=DEVICE, **tiny_critic)
        return _gan_model(gen, disc, tmp, resnet_checkpoint, arch)
    elif arch == "srgan_lp":
        # SRGAN with the perceptual space of the pixel-pretrained SRResNet's
        # own trunk (the stage-1 model this GAN warm-starts from), weighted
        # to the pixel-MSE scale at initialisation
        lp = _calibrated_lp(lp_extractor, lp_calib)
        gen = Generator(
            upsample_factor=SCALE, architecture="srresnet",
            loss_functions=[lp, AdversarialLoss(weighted=True, loss_weight=1e-3)],
            batch_norm=False, input_dims=lr_dims, **on,
            pretrained_model_path=pretrained_path, **size)
        disc = Discriminator.initialize_standard(
            label_smoothing=True, smoothing_offset=0.2, input_dims=(CROP, CROP),
            device=DEVICE, **tiny_critic)
        return _gan_model(gen, disc, tmp, resnet_checkpoint, arch)
    elif arch == "esrgan_lp":
        # ESRGAN's three-term structure (perceptual + 1e-2 L1 + 5e-3 RaGAN)
        # with the calibrated SR-trunk perceptual space for VGG
        lp = _calibrated_lp(lp_extractor, lp_calib)
        gen = Generator(
            upsample_factor=SCALE, architecture="rrdb",
            loss_functions=[
                MeanAbsoluteError(weighted=True, loss_weight=1e-2),
                RaAdversarialLoss(weighted=True, loss_weight=5e-3),
                lp,
            ],
            residual_scaling=0.2, batch_norm=False, input_dims=lr_dims,
            pretrained_model_path=pretrained_path, **on,
            **(size or dict(num_blocks=RRDB_BLOCKS)))
        disc = Discriminator.initialize_relativistic(
            input_dims=(CROP, CROP), device=DEVICE, **tiny_critic)
        return _gan_model(gen, disc, tmp, resnet_checkpoint, arch)
    elif arch == "esrgan":
        # RRDB + RaGAN without a VGG term: the pixel anchor at weight 1.0
        # (the paper's 1e-2 L1 + 5e-3 RaGAN collapses without VGG)
        gen = Generator(
            upsample_factor=SCALE, architecture="rrdb",
            loss_functions=[
                MeanAbsoluteError(weighted=True, loss_weight=1.0),
                RaAdversarialLoss(weighted=True, loss_weight=5e-3),
            ],
            residual_scaling=0.2, batch_norm=False, input_dims=lr_dims,
            pretrained_model_path=pretrained_path, **on,
            **(size or dict(num_blocks=RRDB_BLOCKS)))
        disc = Discriminator.initialize_relativistic(
            input_dims=(CROP, CROP), device=DEVICE, **tiny_critic)
        return _gan_model(gen, disc, tmp, resnet_checkpoint, arch)
    else:
        raise ValueError(arch)
    return SRModel(model_type="resnet", generator=gen,
                   generator_optimizer="Adam",
                   generator_optimizer_config={"learning_rate": schedule},
                   config=_cfg(tmp, patience), distill=DISTILL,
                   paired_ways=_paired_for(arch), device=DEVICE)


RRDB_BLOCKS = 8   # --rrdb-blocks; 8 fits the corpus, 16+ = paper capacity
MAX_EPOCHS = 120  # --epochs
REMAT = False     # --remat; kept in the model files' config
DISTILL = None    # --distill teacher.msgpack[:weight]: pixel stages train
                  # with the frozen-teacher term (train/distill.py)
PAIRED = None     # --paired W: SRResNet-family stages train as paired_ways=W


def _paired_for(arch):
    """paired_ways for SRModel: SRResNet-family BN-free stages only."""
    if PAIRED and arch in ("srresnet", "srresnet128", "srgan", "srgan_lp"):
        return PAIRED
    return None


def main(fast=False, tiny=False, pixel_archs=("srresnet", "rrdb"),
         gan_pairs=(("srgan", "srresnet"), ("esrgan", "rrdb"))):
    _device()  # no CUDA and no --device cpu: raise before writing anything
    os.makedirs(os.path.join(OUT_DIR, "models"), exist_ok=True)
    max_epochs = 3 if fast else MAX_EPOCHS
    patience = 10**6 if fast else 8
    gan_epochs = 2 if fast else 25

    print("staging dataset on device...", flush=True)
    train, val = stage_dataset(crops_per_mpix=12 if fast else 96,
                               val_crops_per_img=16 if fast else 32)
    steps_hint = (train[0].shape[0] // BATCH) * max_epochs
    print(f"{train[0].shape[0]} train pairs, {val[0].shape[0]} val pairs, "
          f"{train[0].shape[0] // BATCH} steps/epoch", flush=True)

    # merge into an existing results file so subset runs (--pixel / --gan)
    # append to the campaign table instead of clobbering it
    results = {"scale": SCALE, "train_imgs": list(TRAIN_IMGS),
               "heldout_imgs": list(HELDOUT_IMGS)}
    results_path = os.path.join(OUT_DIR, "RESULTS.json")
    if os.path.exists(results_path):
        with open(results_path) as f:
            results = {**json.load(f), **results}
    ckpt_dirs = {}
    tmps = []

    def write_results():
        with open(results_path, "w") as f:
            json.dump(results, f, indent=2)

    try:
        for arch in pixel_archs:
            tmps.append(tempfile.mkdtemp(prefix=f"campaign_{arch}_"))
            model = build_model(arch, tmps[-1], patience, steps_hint, tiny=tiny)
            print(f"=== training {arch} x{SCALE} ===", flush=True)
            run_training(model, train, val, max_epochs, arch)
            # save FIRST: a gallery/eval failure must not lose the trained model
            saved = model.save_model(os.path.join(OUT_DIR, "models"),
                                     postfix=f"{arch}_x{SCALE}_best")
            ckpt_dirs[arch] = os.path.join(tmps[-1], "ckpt", "resnet")
            print(f"[{arch}] saved {saved}", flush=True)
            try:
                evaluate(model, arch, results)
                render_galleries(model, arch)
            except Exception:  # the campaign goes on; the table lacks the rows
                traceback.print_exc()
            write_results()

        # two-stage runs: warm-start each GAN from its pixel-pretrained
        # parent. "r2:<arch>" reuses the committed round-2 model, "out:<arch>"
        # one saved into this campaign's OUT_DIR by an earlier invocation.
        r2_models = str(REPO / "results" / "quality_r2" / "models")
        for arch, parent in gan_pairs:
            ckpt, pretrained = None, None
            if parent.startswith("r2:"):
                pretrained = os.path.join(
                    r2_models, f"resnet_gen_{parent[3:]}_x{SCALE}_best.msgpack")
                if not os.path.exists(pretrained):
                    print(f"[{arch}] skipped: no committed {pretrained}", flush=True)
                    continue
            elif parent.startswith("out:"):
                pretrained = os.path.join(
                    OUT_DIR, "models", f"resnet_gen_{parent[4:]}_x{SCALE}_best.msgpack")
                if not os.path.exists(pretrained):
                    print(f"[{arch}] skipped: no saved {pretrained}", flush=True)
                    continue
            elif parent in ckpt_dirs:
                ckpt = ckpt_dirs[parent]
            else:
                print(f"[{arch}] skipped: no {parent} pretrain in this run", flush=True)
                continue
            tmps.append(tempfile.mkdtemp(prefix=f"campaign_{arch}_"))
            lp_kw = {}
            if arch in ("srgan_lp", "esrgan_lp"):
                # extractor = the stage-1 model this GAN warm-starts from;
                # calibration batch = first val pairs (never held-out images)
                extractor = pretrained or os.path.join(
                    OUT_DIR, "models", f"resnet_gen_{parent}_x{SCALE}_best.msgpack")
                lp_kw = dict(lp_extractor=extractor,
                             lp_calib=(val[0][:BATCH], val[1][:BATCH]))
            model = build_model(arch, tmps[-1], patience, steps_hint,
                                resnet_checkpoint=ckpt, tiny=tiny,
                                pretrained_path=pretrained, **lp_kw)
            print(f"=== training {arch} x{SCALE} (pretrain warm start) ===", flush=True)
            run_training(model, train, val, gan_epochs, arch)
            saved = model.save_model(os.path.join(OUT_DIR, "models"),
                                     postfix=f"{arch}_x{SCALE}_final")
            print(f"[{arch}] saved {saved}", flush=True)
            try:
                evaluate(model, arch, results)
                render_galleries(model, arch)
            except Exception:  # the campaign goes on; the table lacks the rows
                traceback.print_exc()
            write_results()
    finally:
        for tmp in tmps:
            shutil.rmtree(tmp, ignore_errors=True)

    _write_markdown(results)
    print("campaign complete", flush=True)
    return results


def _write_markdown(results):
    model_labels = [k for k in results
                    if k not in ("scale", "train_imgs", "heldout_imgs")]
    lines = [
        f"# Quality results ({os.path.basename(OUT_DIR.rstrip('/'))} campaign)",
        "",
        f"x{SCALE} super-resolution trained to convergence (early-stopped) on "
        "every real photo available in this zero-egress environment "
        f"({', '.join(results['train_imgs'])}); held-out probes never seen "
        f"during training or model selection: {', '.join(results['heldout_imgs'])}.",
        "",
        "Produced by `scripts/quality_campaign.py`; galleries under "
        "`galleries/`, model files under `models/`. Metrics on [-1,1] "
        "tensors, max_val=2.0 (reference convention). `LP` is the learned-"
        "perceptual feature distance (lower is better) in this campaign's "
        "srresnet-trunk space — comparable only within this table.",
        "",
        "## Held-out summary (mean ± stdev over the held-out set)",
        "",
        "| model | n | PSNR | ΔPSNR vs bicubic | SSIM | LP (bicubic LP) | images below bicubic PSNR |",
        "|---|---|---|---|---|---|---|",
    ]
    for label in model_labels:
        rows = {n: r for n, r in results[label].items() if r["heldout"]}
        if not rows:
            continue
        p = [r["model"]["psnr"] for r in rows.values()]
        bp = [r["bicubic"]["psnr"] for r in rows.values()]
        s = [r["model"]["ssim"] for r in rows.values()]
        losers = sorted(n for n, r in rows.items()
                        if r["model"]["psnr"] < r["bicubic"]["psnr"])
        spread = statistics.stdev(p) if len(p) > 1 else 0.0
        lp_cell = "—"
        if all("lp" in r["model"] for r in rows.values()):
            lp = sum(r["model"]["lp"] for r in rows.values()) / len(rows)
            blp = sum(r["bicubic"]["lp"] for r in rows.values()) / len(rows)
            lp_cell = f"{lp:.4f} ({blp:.4f})"
        lines.append(
            f"| {label} | {len(p)} | {sum(p)/len(p):.3f} ± {spread:.3f} "
            f"| {sum(p)/len(p) - sum(bp)/len(bp):+.3f} "
            f"| {sum(s)/len(s):.4f} | {lp_cell} "
            f"| {', '.join(losers) if losers else 'none'} |")
    lines += [
        "",
        "## Per-image detail",
        "",
        "Rows where the model loses to bicubic on PSNR are flagged explicitly.",
        "",
        "| model | image | | PSNR | PSNR-Y | SSIM | LP |",
        "|---|---|---|---|---|---|---|",
    ]
    for label in model_labels:
        for name, row in results[label].items():
            tag = "held-out" if row["heldout"] else "train-member"
            m, b = row["model"], row["bicubic"]
            flag = " **(< bicubic)**" if m["psnr"] < b["psnr"] else ""
            lines.append(f"| {label} | {name} ({tag}) | model | {m['psnr']}{flag} "
                         f"| {m['psnr_y']} | {m['ssim']} | {m.get('lp', '—')} |")
            lines.append(f"| | | bicubic | {b['psnr']} | {b['psnr_y']} "
                         f"| {b['ssim']} | {b.get('lp', '—')} |")
    with open(os.path.join(OUT_DIR, "RESULTS.md"), "w") as f:
        f.write("\n".join(lines) + "\n")


def _parse_cli(argv):
    """--scale N (4 and 8 switch to 128 px crops and an ``_x<N>`` OUT_DIR),
    --pixel a[,b...], --gan gan:parent[,...] to run subsets; --device."""
    global SCALE, CROP, OUT_DIR, DEVICE
    kwargs = {"fast": "--fast" in argv or "--tiny" in argv,
              "tiny": "--tiny" in argv}
    if "--no-gallery-corpus" in argv:  # the reference's 3-image corpus only
        for k in [k for k, v in TRAIN_IMGS.items() if v.startswith(_GALLERY_DIR)]:
            del TRAIN_IMGS[k]
            EVAL_TRAIN_IMGS.pop(k, None)
        # gallery tiles leave the game entirely: held-out reverts to the
        # 2-probe split as well
        for k in HELDOUT_GALLERY:
            HELDOUT_IMGS.pop(k, None)
    elif "--legacy-holdout" in argv:
        # the pre-round-5 split: gallery tiles all train, held-out = 2 probes
        for k in HELDOUT_GALLERY:
            path = HELDOUT_IMGS.pop(k, None)
            if path:
                TRAIN_IMGS[k] = path
    if "--scale" in argv:
        SCALE = int(argv[argv.index("--scale") + 1])
        if SCALE not in (2, 4, 8):
            raise SystemExit(f"--scale must be 2, 4, or 8, got {SCALE}")
        CROP = 96 if SCALE == 2 else 128
        if SCALE != 2:
            OUT_DIR = OUT_DIR.rstrip("/") + f"_x{SCALE}"
    global BATCH
    if "--crop" in argv:  # e.g. the EDSR-style 192-crop production recipe
        CROP = int(argv[argv.index("--crop") + 1])
        if CROP % SCALE:
            raise SystemExit(f"--crop {CROP} must divide scale {SCALE}")
    if "--batch" in argv:
        BATCH = int(argv[argv.index("--batch") + 1])
    if "--out" in argv:
        OUT_DIR = argv[argv.index("--out") + 1]
    if "--device" in argv:
        DEVICE = argv[argv.index("--device") + 1]
    global RRDB_BLOCKS, MAX_EPOCHS, REMAT, DISTILL, PAIRED
    if "--remat" in argv:
        REMAT = True
    if "--paired" in argv:
        PAIRED = int(argv[argv.index("--paired") + 1])
        if PAIRED < 2:
            raise SystemExit(f"--paired must be >= 2, got {PAIRED}")
        if BATCH % PAIRED:
            raise SystemExit(f"--paired {PAIRED} must divide batch {BATCH}")
    if "--distill" in argv:
        spec = argv[argv.index("--distill") + 1]
        path, weight = spec, 1.0
        if ":" in spec:
            head, tail = spec.rsplit(":", 1)
            try:
                weight = float(tail)
                path = head
            except ValueError:
                pass  # no numeric tail — the whole spec is the path
        if not os.path.exists(path):  # fail BEFORE hours of training
            raise SystemExit(f"--distill teacher not found: {path}")
        DISTILL = {"model": path, "weight": weight}
    if "--rrdb-blocks" in argv:
        RRDB_BLOCKS = int(argv[argv.index("--rrdb-blocks") + 1])
    if "--epochs" in argv:
        MAX_EPOCHS = int(argv[argv.index("--epochs") + 1])
    if "--pixel" in argv:
        spec = argv[argv.index("--pixel") + 1]
        kwargs["pixel_archs"] = () if spec in ("none", "") else \
            tuple(spec.split(","))
    if "--gan" in argv:
        spec = argv[argv.index("--gan") + 1]
        if spec in ("none", ""):
            kwargs["gan_pairs"] = ()
        else:
            # parent may itself be namespaced ("r2:srresnet") — split once
            pairs = tuple(tuple(p.split(":", 1)) for p in spec.split(","))
            bad = [":".join(p) for p in pairs if len(p) != 2]
            if bad:  # fail BEFORE hours of pixel training, not after
                raise SystemExit(
                    f"--gan entries must be gan:parent, got {bad}")
            kwargs["gan_pairs"] = pairs
    return kwargs


if __name__ == "__main__":
    main(**_parse_cli(sys.argv[1:]))
