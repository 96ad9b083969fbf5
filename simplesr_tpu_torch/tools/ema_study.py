"""EMA shadow weights on a real GAN stage, measured as scripts/ema_study.py
measures them.

    python -m simplesr_tpu_torch.tools.ema_study [--epochs 15] [--decay 0.995]
        [--out DIR] [--device cpu]

GAN generators oscillate: the adversarial gradient keeps kicking the raw
weights around the perceptual optimum. ``SRModel(ema_decay=...)`` keeps an
EMA of the generator after each step; this study trains a pixel-anchored
SRGAN stage (the quality campaign's ``srgan`` stage, warm-started from the
committed x2 SRResNet best) on ``quality_campaign.stage_dataset()``'s
pairs and records, per epoch, the held-out PSNR and SSIM of the raw
generator and of its EMA shadow, then each probe's mean and spread over the
last two thirds of the epochs. The probes are the campaign's held-out
images: the four held-out gallery tiles, standing in for the reference's
baboon and comic. A missing probe is skipped by name.

It writes ``EMA.json`` under ``--out`` (default the git-ignored
``runs/quality_r3``). The run is on the card unless ``--device cpu`` is
given.
"""

import argparse
import json
import os
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.data.image import read_img
from simplesr_tpu_torch.ops.metrics import psnr, ssim
from simplesr_tpu_torch.ops.resize import resize
from simplesr_tpu_torch.tools import quality_campaign as qc
from simplesr_tpu_torch.train import Discriminator, Generator, SRModel

REPO = Path(__file__).resolve().parents[2]
PRETRAINED = str(REPO / "results/quality_r2/models/resnet_gen_srresnet_x2_best.msgpack")


def stage_probes(dev):
    """{name: (LR in [0, 1], HR in [-1, 1])} of each held-out image, cropped
    to a multiple of the scale, on ``dev``."""
    probes = {}
    for name, path in qc.HELDOUT_IMGS.items():
        if not qc._present(name, path, "probe"):
            continue
        img = torch.as_tensor(read_img(path) / 255.0, dtype=torch.float32).to(dev)
        h = (img.shape[0] // qc.SCALE) * qc.SCALE
        w = (img.shape[1] // qc.SCALE) * qc.SCALE
        hr = img[None, :h, :w] * 2.0 - 1.0
        lr = resize(img[None, :h, :w], (h // qc.SCALE, w // qc.SCALE), method="bicubic",
                    antialias=True)
        probes[name] = (lr, hr)
    return probes


def probe_scores(model, probes, ema):
    out = {}
    for name, (lr, hr) in probes.items():
        sr = torch.clamp(model.generate(lr, ema=ema).float().to(hr.device), -1, 1)
        out[name] = {"psnr": float(psnr(hr, sr, max_val=2.0)[0]),
                     "ssim": float(ssim(hr, sr, max_val=2.0)[0])}
    return out


def summarize(history, names):
    """Per probe: mean and spread of raw and EMA PSNR over the last two
    thirds of the epochs (past the warm-in), and the final epoch's."""
    tail = history[len(history) // 3:]
    summary = {}
    for name in names:
        raw_t = [h["raw"][name]["psnr"] for h in tail]
        ema_t = [h["ema"][name]["psnr"] for h in tail]
        summary[name] = {
            "raw_mean": float(np.mean(raw_t)), "raw_std": float(np.std(raw_t)),
            "ema_mean": float(np.mean(ema_t)), "ema_std": float(np.std(ema_t)),
            "final_raw": history[-1]["raw"][name]["psnr"],
            "final_ema": history[-1]["ema"][name]["psnr"],
        }
    return summary


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--decay", type=float, default=0.995)
    p.add_argument("--out", default=str(REPO / "runs" / "quality_r3"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    device = str(dev)

    saved_device, qc.DEVICE = qc.DEVICE, device
    try:
        train, _ = qc.stage_dataset()
    finally:
        qc.DEVICE = saved_device
    lr_t, hr_t = train
    n = lr_t.shape[0]
    batches = n // qc.BATCH
    print(f"dataset: {n} train crops, {batches} batches/epoch", flush=True)

    lr_dims = (qc.CROP // qc.SCALE, qc.CROP // qc.SCALE)
    gen = Generator.srgan_generator(
        upsample_factor=qc.SCALE, vgg_loss=False, batch_norm=False,
        adversarial_loss_weight=1e-3, input_dims=lr_dims,
        pretrained_model_path=PRETRAINED, device=device)
    disc = Discriminator.initialize_standard(
        label_smoothing=True, smoothing_offset=0.2,
        input_dims=(qc.CROP, qc.CROP), device=device)
    tmp = tempfile.mkdtemp(prefix="ema_study_")  # the config's dirs; nothing is saved
    model = SRModel(model_type="gan", generator=gen,
                    generator_optimizer="Adam",
                    generator_optimizer_config={"learning_rate": 1e-4},
                    discriminator=disc, discriminator_optimizer="Adam",
                    discriminator_optimizer_config={"learning_rate": 1e-4},
                    config=qc._cfg(tmp, 10**6), ema_decay=args.decay, device=device)

    probes = stage_probes(dev)
    perm = torch.Generator().manual_seed(7)
    history = []
    for epoch in range(args.epochs):
        model.before_epoch()
        order = torch.randperm(n, generator=perm).to(lr_t.device)
        lr_t, hr_t = lr_t[order], hr_t[order]
        for b in range(batches):
            model.train_step(lr_t[b * qc.BATCH:(b + 1) * qc.BATCH],
                             hr_t[b * qc.BATCH:(b + 1) * qc.BATCH])
        raw = probe_scores(model, probes, ema=False)
        ema = probe_scores(model, probes, ema=True)
        history.append({"epoch": epoch + 1, "raw": raw, "ema": ema})
        print(f"epoch {epoch + 1}: "
              + "  ".join(f"{k} raw {raw[k]['psnr']:.3f} / "
                          f"ema {ema[k]['psnr']:.3f}" for k in raw),
              flush=True)
        # no validation or early stop: the study wants the raw trajectory,
        # not the best-checkpoint behaviour
    shutil.rmtree(tmp, ignore_errors=True)

    summary = summarize(history, probes)
    for name, s in summary.items():
        print(f"{name}: tail raw {s['raw_mean']:.3f}±{s['raw_std']:.3f}  "
              f"ema {s['ema_mean']:.3f}±{s['ema_std']:.3f}", flush=True)

    report = {"decay": args.decay, "epochs": args.epochs,
              "recipe": "srgan pixel-anchored, warm from srresnet x2",
              "history": history, "summary": summary}
    os.makedirs(args.out, exist_ok=True)
    out_path = os.path.join(args.out, "EMA.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print("wrote", out_path)
    return report


if __name__ == "__main__":
    main()
