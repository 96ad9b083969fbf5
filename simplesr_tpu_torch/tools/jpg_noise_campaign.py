"""JPEG-noise (denoising SR) campaign, as scripts/jpg_noise_campaign.py:
train SRResNet x2 on LR crops degraded by the DCT JPEG model on the device
(``ops/jpeg.py``) with a fresh quality U[30, 95] per crop each epoch (the
pipeline's ``jpg_noise_level: [5, 70]``), and a clean-trained control on
the same corpus and schedule; then score both against bicubic on real
JPEG inputs at qualities 30, 50, 75 and 90 and on clean inputs, and
measure the gap between the DCT model and real JPEG (``domain_gap``).

    python -m simplesr_tpu_torch.tools.jpg_noise_campaign [--fast] [--out DIR]
        [--device cpu]

The JAX script degrades its evaluation inputs through PIL's libjpeg; the
port through its own encoder and decoder (``data/native_loader.py``:
``libjpeg_degrade``), which write and read what PIL 12.1 over
libjpeg-turbo 3.1.3 does, byte for byte: the same inputs. ``--fast`` is the
JAX script's smoke run (3 epochs, fewer crops, the FAST_SIZE model: 2
blocks of 16 filters); setting ``FAST_SIZE = {}`` keeps the production
width (16 x 64) in it.

It writes, under ``--out`` (default the git-ignored ``runs/quality_r4``;
never point it at the committed ``results/``):

  RESULTS_jpg.json / RESULTS_jpg.md   the round-4 schema and tables
  models/resnet_gen_srresnet_jpg_rq_x2_best.msgpack   (noise-trained)
  models/resnet_gen_srresnet_ctl_x2_best.msgpack      (clean control)
  galleries/srresnet_jpg_rq/                          (held-out grids, q50)

The corpus is ``quality_campaign.corpus_split()``'s: the reference's
images when a checkout of it is at ``$SIMPLESR_REFERENCE``, and the gallery
tiles, of which gt_1, gt_10, gt_13 and gt_6 are held out (they stand in for
the reference's baboon and comic). A missing image is skipped by name.

The run is on the card unless ``--device cpu`` is given.
"""

import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.data.image import read_img
from simplesr_tpu_torch.data.native_loader import libjpeg_degrade
from simplesr_tpu_torch.eval import rendering
from simplesr_tpu_torch.ops.crop import batch_random_crops
from simplesr_tpu_torch.ops.jpeg import jpeg_degrade
from simplesr_tpu_torch.ops.metrics import psnr, psnr_on_y, ssim
from simplesr_tpu_torch.ops.resize import resize
from simplesr_tpu_torch.tools import quality_campaign as qc
from simplesr_tpu_torch.train import Generator, SRModel
from simplesr_tpu_torch.train.optimizers import piecewise_constant_decay

REPO = Path(__file__).resolve().parents[2]
TRAIN_IMGS, HELDOUT_IMGS, EVAL_TRAIN_IMGS = qc.corpus_split()

SCALE = 2
CROP = 96
BATCH = 16
# pipeline semantics: jpg_noise_level [5, 70] -> per-crop quality U[30, 95]
QUALITY_LO, QUALITY_HI = 30.0, 95.0
EVAL_QUALITIES = (30, 50, 75, 90)
AUGS = ["flip_along_x", "flip_along_y", "rotate90"]
FAST_SIZE = dict(num_blocks=2, num_filters=16)  # the --fast model's width

OUT_DIR = str(REPO / "runs" / "quality_r4")
DEVICE = "cuda"  # --device
_TMPS = []  # the stages' checkpoint directories, removed when main ends


def _device():
    return resolve_device(DEVICE)


def stage_dataset(crops_per_mpix=96, val_crops_per_img=24):
    """Device-resident staged crops: HR in [-1, 1] and CLEAN bicubic LR in
    [0, 1]. The JPEG degrade is not applied here: it runs again every epoch
    with fresh per-crop qualities (epoch_degrade)."""
    dev = _device()
    train_parts, val_parts = [], []
    for i, (name, path) in enumerate(TRAIN_IMGS.items()):
        if not qc._present(name, path, "stage"):
            continue
        img = torch.from_numpy(read_img(path)).to(dev)
        if min(img.shape[0], img.shape[1]) < CROP:
            print(f"[stage] skipping {name}: {tuple(img.shape[:2])} < {CROP}", flush=True)
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
    fanout = [base] + [qc._augmented(base, name, 3000 + i) for i, name in enumerate(AUGS)]

    def _split(hr_crops):
        lr = resize(hr_crops / 255.0, (CROP // SCALE, CROP // SCALE),
                    method="bicubic", antialias=True)
        return lr.float(), (hr_crops / 127.5 - 1.0).float()

    lr_t, hr_t = _split(torch.cat(fanout))
    n = (hr_t.shape[0] // BATCH) * BATCH
    lr_v, hr_v = _split(torch.cat(val_parts))
    m = (hr_v.shape[0] // BATCH) * BATCH
    return (lr_t[:n], hr_t[:n]), (lr_v[:m], hr_v[:m])


def epoch_qualities(gen, n):
    """n qualities U[QUALITY_LO, QUALITY_HI) from ``gen``, float32 on the CPU."""
    return torch.rand(n, generator=gen) * (QUALITY_HI - QUALITY_LO) + QUALITY_LO


def epoch_degrade(gen, lr_clean, chunk=1024):
    """Fresh per-crop quality U[30, 95] over the whole staged train set: the
    DCT degrade on the device, chunked to bound peak memory. ``gen`` is a
    CPU ``torch.Generator`` (the JAX script's key)."""
    outs = []
    for i in range(0, lr_clean.shape[0], chunk):
        part = lr_clean[i:i + chunk]
        q = epoch_qualities(gen, part.shape[0]).to(part.device)
        outs.append(jpeg_degrade(part, q))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def val_degrade(lr_clean):
    """Deterministic mixed-quality validation: crop i gets
    EVAL_QUALITIES[i % 4], so the early-stop metric scores the whole
    compression range every epoch."""
    q = torch.tensor([EVAL_QUALITIES[i % len(EVAL_QUALITIES)]
                      for i in range(lr_clean.shape[0])], dtype=torch.float32)
    return jpeg_degrade(lr_clean, q.to(lr_clean.device))


def run_training(model, train, val, max_epochs, label, noisy):
    (lr_clean_t, hr_t), (lr_v, hr_v) = train, val
    n = lr_clean_t.shape[0]
    batches = n // BATCH
    perm = torch.Generator().manual_seed(7)
    deg = torch.Generator().manual_seed(11)
    t0 = time.perf_counter()
    for epoch in range(max_epochs):
        if model.stop_early():
            print(f"[{label}] early stop after epoch {epoch}", flush=True)
            break
        model.before_epoch()
        order = torch.randperm(n, generator=perm).to(lr_clean_t.device)
        lr_t = (epoch_degrade(deg, lr_clean_t) if noisy else lr_clean_t)[order]
        hr_e = hr_t[order]
        for b in range(batches):
            model.train_step(lr_t[b * BATCH:(b + 1) * BATCH],
                             hr_e[b * BATCH:(b + 1) * BATCH])
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


def _train_one(label, noisy, train, val, max_epochs, patience, fast):
    steps_hint = (train[0].shape[0] // BATCH) * max_epochs
    tmp = tempfile.mkdtemp(prefix=f"campaign_{label}_")
    _TMPS.append(tmp)
    schedule = piecewise_constant_decay(
        [steps_hint // 2, (3 * steps_hint) // 4], [2e-4, 1e-4, 5e-5])
    size = FAST_SIZE if fast else {}
    gen = Generator.srresnet(upsample_factor=SCALE, batch_norm=False,
                             input_dims=(CROP // SCALE, CROP // SCALE), device=DEVICE, **size)
    model = SRModel(model_type="resnet", generator=gen,
                    generator_optimizer="Adam",
                    generator_optimizer_config={"learning_rate": schedule},
                    config=qc._cfg(tmp, patience), device=DEVICE)
    print(f"=== training {label} x{SCALE} ===", flush=True)
    run_training(model, train, val, max_epochs, label, noisy=noisy)
    saved = model.save_model(os.path.join(OUT_DIR, "models"),
                             postfix=f"{label}_x{SCALE}_best")
    print(f"saved {saved}", flush=True)
    return model


def libjpeg_degrade_01(img_01, quality):
    """The real JPEG round trip through the port's encoder and decoder,
    PIL's bytes and pixels: the evaluation degrade, so that the results
    measure how the training-time DCT model carries over to real JPEG.
    Returns float32 numpy in [0, 1]."""
    x = img_01.detach().float().cpu().numpy() if torch.is_tensor(img_01) else \
        np.asarray(img_01)
    u8 = np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)
    return libjpeg_degrade(u8, int(quality)).astype(np.float32) / 255.0


def _on_device(x):
    return torch.as_tensor(x, dtype=torch.float32).to(_device())


def _metrics(hr, out):
    return {
        "psnr": round(float(psnr(hr[None], out[None], max_val=2.0)[0]), 3),
        "psnr_y": round(float(psnr_on_y(hr[None], out[None], max_val=2.0)[0]), 3),
        "ssim": round(float(ssim(hr[None], out[None], max_val=2.0)[0]), 4),
    }


def _clean_lr(img_01):
    """(HR in [-1, 1], clean bicubic LR in [0, 1]), both on the device, of
    an HWC image in [0, 1] cropped to a multiple of SCALE."""
    img = _on_device(img_01)
    h = (img.shape[0] // SCALE) * SCALE
    w = (img.shape[1] // SCALE) * SCALE
    hr_ref = img[:h, :w] * 2.0 - 1.0
    lr = resize(img[None, :h, :w], (h // SCALE, w // SCALE),
                method="bicubic", antialias=True)[0]
    return hr_ref, lr


def _sr(model, lr):
    return model.generate(lr[None])[0].float().to(lr.device)


def _images(names):
    """{name: path} of those present, each missing one skipped by name."""
    return {k: v for k, v in names.items() if qc._present(k, v, "eval")}


def evaluate(noise_model, ctl_model, results):
    """noise-trained vs clean control vs bicubic, on real-JPEG inputs at
    each EVAL_QUALITIES member and on clean inputs."""
    per_image = {}
    for name, path in _images({**EVAL_TRAIN_IMGS, **HELDOUT_IMGS}).items():
        img = read_img(path) / 255.0
        hr, lr_clean = _clean_lr(img)
        h, w = hr.shape[0], hr.shape[1]
        rows = {}
        for q in list(EVAL_QUALITIES) + ["clean"]:
            lr = lr_clean if q == "clean" else _on_device(libjpeg_degrade_01(lr_clean, q))
            sr_n = _sr(noise_model, lr)
            sr_c = _sr(ctl_model, lr)
            bic = resize(lr[None] * 2.0 - 1.0, (h, w), method="bicubic")[0]
            rows[str(q)] = {
                "noise_trained": _metrics(hr, sr_n),
                "clean_control": _metrics(hr, sr_c),
                "bicubic": _metrics(hr, bic),
            }
            print(f"[eval] {name} q={q}: "
                  + " | ".join(f"{k} {v['psnr']:.2f}dB"
                               for k, v in rows[str(q)].items()),
                  flush=True)
        per_image[name] = {"heldout": name in HELDOUT_IMGS, **rows}
    results["images"] = per_image
    return results


def domain_gap(noise_model, results):
    """The measured DCT-model vs real-JPEG gap on the held-out probes: PSNR
    between the two degraded inputs, and the noise model's output quality
    on each."""
    gap = {}
    for name, path in _images(HELDOUT_IMGS).items():
        img = read_img(path) / 255.0
        hr, lr_clean = _clean_lr(img)
        rows = {}
        for q in EVAL_QUALITIES:
            lr_jpg = _on_device(libjpeg_degrade_01(lr_clean, q))
            lr_dct = jpeg_degrade(lr_clean[None], float(q))[0]
            input_gap = round(float(psnr(lr_jpg[None] * 2 - 1, lr_dct[None] * 2 - 1,
                                         max_val=2.0)[0]), 2)
            rows[str(q)] = {
                "input_dct_vs_libjpeg_psnr": input_gap,
                "out_psnr_on_libjpeg": _metrics(hr, _sr(noise_model, lr_jpg))["psnr"],
                "out_psnr_on_dct": _metrics(hr, _sr(noise_model, lr_dct))["psnr"],
            }
            print(f"[gap] {name} q={q}: inputs agree {input_gap:.1f} dB; "
                  f"out on libjpeg {rows[str(q)]['out_psnr_on_libjpeg']:.2f} "
                  f"vs on dct {rows[str(q)]['out_psnr_on_dct']:.2f}",
                  flush=True)
        gap[name] = rows
    results["domain_gap"] = gap
    return results


def render_galleries(noise_model, ctl_model, q=50):
    gal_dir = os.path.join(OUT_DIR, "galleries", "srresnet_jpg_rq")
    for name, path in _images(HELDOUT_IMGS).items():
        img = read_img(path) / 255.0
        hr, lr_clean = _clean_lr(img)
        h, w = hr.shape[0], hr.shape[1]
        lr_jpg = _on_device(libjpeg_degrade_01(lr_clean, q))
        outs = {
            "noise_model": _sr(noise_model, lr_jpg),
            "clean_model": _sr(ctl_model, lr_jpg),
            "bicubic": resize(lr_jpg[None] * 2.0 - 1.0, (h, w), method="bicubic")[0],
        }
        ms = {k: _metrics(hr, v) for k, v in outs.items()}
        outs = {k: v.cpu().numpy() for k, v in outs.items()}
        rendering.prepare_image_grid(
            gal_dir, f"{name}_q{q}_grid", low_res_key="noisy LR",
            **{k: v[None] for k, v in outs.items()},
            **{"noisy LR": lr_jpg.cpu().numpy()[None],
               "ground truth": hr.cpu().numpy()[None]},
            psnr={**{k: np.array([m["psnr"]]) for k, m in ms.items()},
                  "noisy LR": np.array([-1.0]),
                  "ground truth": np.array([np.inf])},
            ssim={**{k: np.array([m["ssim"]]) for k, m in ms.items()},
                  "noisy LR": np.array([-1.0]),
                  "ground truth": np.array([1.0])})
        rendering.combine_halfs(outs["noise_model"], outs["clean_model"],
                                "noise_vs_clean", gal_dir, f"{name}_q{q}_half")


def _verdict_lines(results):
    """Honest auto-computed verdict: where the noise model wins/loses on the
    held-out probes."""
    wins_bic, wins_clean, losses = [], [], []
    for name, rows in results["images"].items():
        if not rows["heldout"]:
            continue
        for q in [str(x) for x in EVAL_QUALITIES]:
            r = rows[q]
            n, c, b = (r["noise_trained"]["psnr"],
                       r["clean_control"]["psnr"], r["bicubic"]["psnr"])
            (wins_bic if n >= b else losses).append((name, q, "bicubic", n, b))
            (wins_clean if n >= c else losses).append(
                (name, q, "clean", n, c))
    lines = ["## Verdict (held-out probes)", ""]
    lost_bic = sum(1 for l in losses if l[2] == "bicubic")
    lost_clean = sum(1 for l in losses if l[2] == "clean")
    lines.append(f"- vs **bicubic**: noise-trained wins "
                 f"{len(wins_bic)}/{len(wins_bic) + lost_bic} "
                 "held-out (image, quality) cells.")
    lines.append(f"- vs **clean control**: wins "
                 f"{len(wins_clean)}/{len(wins_clean) + lost_clean} cells.")
    for name, q, against, n, o in losses:
        lines.append(f"- loses to {against} on {name} q={q} "
                     f"({n} vs {o} dB).")
    lines += [
        "",
        "Round 3's fixed-quality-50 model lost to bicubic on BOTH held-out "
        "probes at its own training quality; the randomized-quality recipe "
        "on the expanded corpus reverses that. Losses, if any, concentrate "
        "at q=90 (near-clean inputs) where a denoiser's bias costs more "
        "than the artifacts it removes — the clean control or `clean` zoo "
        "models are the right tool there.",
        "",
    ]
    return lines


def _write_markdown(results):
    lines = [
        "# JPEG-noise recipe results (round 4: randomized quality)",
        "",
        f"SRResNet x{SCALE} trained with per-crop quality U[{QUALITY_LO:.0f},"
        f" {QUALITY_HI:.0f}] drawn fresh every epoch (the production "
        "pipeline's `jpg_noise_level: [5, 70]` recipe) on the expanded "
        "gallery corpus; `clean_control` trained on the identical corpus "
        "and schedule without the degrade. Inputs degraded with REAL "
        "libjpeg at each quality; the training-time DCT kernel never "
        "touches evaluation inputs.",
        "",
        *_verdict_lines(results),
        "## PSNR (dB) by real-libjpeg input quality",
        "",
        "| image | q | noise-trained | clean control | bicubic |",
        "|---|---|---|---|---|",
    ]
    for name, rows in results["images"].items():
        tag = " (held-out)" if rows["heldout"] else ""
        for q in [str(x) for x in EVAL_QUALITIES] + ["clean"]:
            r = rows[q]
            n, c, b = (r["noise_trained"]["psnr"],
                       r["clean_control"]["psnr"], r["bicubic"]["psnr"])
            win = " **" if n > max(c, b) else " "
            lines.append(f"| {name}{tag} | {q} |{win}{n}{win.strip()} "
                         f"| {c} | {b} |")
    lines += [
        "",
        "## DCT-kernel vs libjpeg domain gap (held-out)",
        "",
        "| image | q | inputs agree (PSNR dB) | model out on libjpeg "
        "| model out on DCT |",
        "|---|---|---|---|---|",
    ]
    for name, rows in results.get("domain_gap", {}).items():
        for q, r in rows.items():
            lines.append(
                f"| {name} | {q} | {r['input_dct_vs_libjpeg_psnr']} "
                f"| {r['out_psnr_on_libjpeg']} | {r['out_psnr_on_dct']} |")
    with open(os.path.join(OUT_DIR, "RESULTS_jpg.md"), "w") as f:
        f.write("\n".join(lines) + "\n")


def main(fast=False):
    _device()  # no CUDA and no --device cpu: raise before writing anything
    os.makedirs(os.path.join(OUT_DIR, "models"), exist_ok=True)
    max_epochs = 3 if fast else 80
    patience = 10**6 if fast else 8

    print("staging dataset on device...", flush=True)
    train, val_clean = stage_dataset(crops_per_mpix=12 if fast else 96,
                                     val_crops_per_img=8 if fast else 24)
    print(f"{train[0].shape[0]} train crops, {val_clean[0].shape[0]} val",
          flush=True)
    val_noisy = (val_degrade(val_clean[0]), val_clean[1])

    try:
        noise_model = _train_one("srresnet_jpg_rq", True, train, val_noisy,
                                 max_epochs, patience, fast)
        ctl_model = _train_one("srresnet_ctl", False, train, val_clean,
                               max_epochs, patience, fast)

        results = {"scale": SCALE, "quality_range": [QUALITY_LO, QUALITY_HI],
                   "corpus_images": len(TRAIN_IMGS)}
        results = evaluate(noise_model, ctl_model, results)
        results = domain_gap(noise_model, results)
        with open(os.path.join(OUT_DIR, "RESULTS_jpg.json"), "w") as f:
            json.dump(results, f, indent=1)
        _write_markdown(results)
        if not fast:
            render_galleries(noise_model, ctl_model)
    finally:
        while _TMPS:
            shutil.rmtree(_TMPS.pop(), ignore_errors=True)
    print("jpg-noise campaign (r4) complete", flush=True)
    return results


def _parse_cli(argv):
    """--fast, --out DIR, --device; the kwargs of main."""
    global OUT_DIR, DEVICE
    if "--out" in argv:
        OUT_DIR = argv[argv.index("--out") + 1]
    if "--device" in argv:
        DEVICE = argv[argv.index("--device") + 1]
    return {"fast": "--fast" in argv}


if __name__ == "__main__":
    main(**_parse_cli(sys.argv[1:]))
