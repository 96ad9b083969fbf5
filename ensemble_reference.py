#!/usr/bin/env python3
"""The JAX package's ensemble-study rows of the five committed models, the
reference that ``chip_smoke.py`` phase 17 (f) holds the port's
``tools/ensemble_study.py`` to.

    JAX_PLATFORMS=cpu python3 ensemble_reference.py

It loads ``scripts/ensemble_study.py`` from its file and runs its own
``eval_model`` (the model file served through the JAX package's
``_as_predictor(fast=True)``, plain and under the x8 self-ensemble) for each
model of its MODELS on a 64 px crop of the held-out tile gt_6 (rows 100-163,
columns 150-213, the crop of ``tests/test_torch_studies.py``), and the
port's ``eval_model`` on the CPU beside it (``port_cpu_worst``: the worst
|port - JAX| of each model's PSNR and SSIM figures).

It also measures, with the port on the CPU, why ``rrdb_x4``
(``results/quality_r2_x4_deep``) lands far below bicubic in both packages:
the file was trained before the RRDB trunk gained its scaled inner skip
(``trunk = x_skip + residual_scaling * trunk`` before the post-trunk conv,
``simplesr_tpu/models/rrdb.py``), which both packages' RRDBNet now apply.
``pre_fix_trunk`` scores the file on 256 px crops of the four held-out
tiles under today's trunk and without that skip, beside bicubic.

Each model runs in the dtype its file names (bf16). It prints one JSON
line. It imports JAX and PIL and runs no CUDA: the card has neither.
"""

import importlib.util
import json
import tempfile
import time
from pathlib import Path

import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parent
CROP_TILE, CROP_ROWS, CROP_COLS = "gt_6", (100, 164), (150, 214)
ROW_KEYS = ("psnr_plain", "psnr_y_plain", "ssim_plain", "psnr_ens", "psnr_y_ens", "ssim_ens")
HELDOUT = ("gt_1", "gt_10", "gt_13", "gt_6")


def jax_study():
    spec = importlib.util.spec_from_file_location(
        "jax_ensemble_study", ROOT / "scripts/ensemble_study.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_crop(directory):
    img = np.asarray(Image.open(ROOT / "data/corpus/gallery" / f"{CROP_TILE}.png").convert("RGB"))
    path = Path(directory) / "probe.png"
    Image.fromarray(img[slice(*CROP_ROWS), slice(*CROP_COLS)]).save(path)
    return path


def pre_fix_trunk(path, scale=4, crop=256):
    """PSNR of the file on the top-left ``crop`` px of each held-out tile
    under today's RRDB trunk and without the scaled inner skip, and
    bicubic's."""
    import torch

    from simplesr_tpu_torch.data.image import read_img
    from simplesr_tpu_torch.eval.evaluation import _as_predictor
    from simplesr_tpu_torch.models.rrdb import RRDBNet, _conv
    from simplesr_tpu_torch.ops.metrics import psnr
    from simplesr_tpu_torch.ops.resize import resize

    def old_features(self, x):  # RRDBNet.features without the inner skip
        trunk = skip = _conv(self.Conv_0, x.permute(0, 3, 1, 2), self.dtype)
        for i in range(self.num_rrdb_blocks):
            trunk = getattr(self, f"RRDBBlock_{i}")(trunk)
        return skip + _conv(self.Conv_1, trunk, self.dtype)

    out = {}
    today = RRDBNet.features
    for trunk, features in (("today", today), ("pre_fix", old_features)):
        RRDBNet.features = features
        try:
            predict = _as_predictor(path, fast=True, device=torch.device("cpu"))
            for tile in HELDOUT:
                img = read_img(str(ROOT / "data/corpus/gallery" / f"{tile}.png")) / 255.0
                hr = torch.as_tensor(img, dtype=torch.float32)[:crop, :crop]
                n = crop // scale
                lr = resize(hr[None], (n, n), method="bicubic", antialias=True)
                hr11 = (hr * 2.0 - 1.0)[None]
                sr = torch.clamp(predict(lr).float(), -1.0, 1.0)
                row = out.setdefault(tile, {})
                row[trunk] = float(psnr(hr11, sr, max_val=2.0)[0])
                bic = torch.clamp(resize(lr, (crop, crop), method="bicubic")
                                  * 2.0 - 1.0, -1.0, 1.0)
                row["bicubic"] = float(psnr(hr11, bic, max_val=2.0)[0])
        finally:
            RRDBNet.features = today
    return out


def main():
    from simplesr_tpu_torch.tools import ensemble_study as port

    jes = jax_study()
    with tempfile.TemporaryDirectory() as tmp:
        probe = write_crop(tmp)
        jes.HELDOUT = port.HELDOUT = [str(probe)]
        t0 = time.perf_counter()
        jax_rows = {name: jes.eval_model(str(ROOT / path), scale)[0]
                    for name, (path, scale) in jes.MODELS.items()}
        seconds = time.perf_counter() - t0
        worst = {}
        for name, (path, scale) in port.MODELS.items():
            (got,) = port.eval_model(ROOT / path, scale, device="cpu")
            want = jax_rows[name]
            worst[name] = {
                "psnr": max(abs(got[k] - want[k]) for k in ROW_KEYS if "ssim" not in k),
                "ssim": max(abs(got[k] - want[k]) for k in ROW_KEYS if "ssim" in k)}
    print(json.dumps({
        "crop": {"tile": CROP_TILE, "rows": CROP_ROWS, "cols": CROP_COLS},
        "models": {k: v[0] for k, v in jes.MODELS.items()},
        "rows": {k: [r[key] for key in ROW_KEYS] for k, r in jax_rows.items()},
        "row_keys": ROW_KEYS, "seconds": seconds, "port_cpu_worst": worst,
        "rrdb_x4_pre_fix_trunk": pre_fix_trunk(ROOT / jes.MODELS["rrdb_x4"][0])}), flush=True)


if __name__ == "__main__":
    main()
