"""Standard-benchmark harness, as scripts/standard_benchmarks.py: Set5 /
Set14 / BSDS100 against the BASELINE.md anchors, under the literature's
protocol.

    python -m simplesr_tpu_torch.tools.standard_benchmarks [--scale 4]
        [--models a,b,...] [--data-root DIR] [--out DIR] [--selftest]
        [--tile-threshold N] [--device cpu]

It looks for HR images under ``$SIMPLESR_BENCHMARK_DATA/<SetName>/`` or
``data/benchmarks/<SetName>/`` (Set5, Set14, BSDS100, Urban100 or
DIV2K_valid, any case; PNG, BMP or JPEG, files whose stem contains "lr"
left out), scores every zoo model of the scale (or ``--models``) and the
bicubic control row, and writes ``STANDARD.json`` and ``STANDARD.md`` to
``--out`` (default ``results/benchmarks``) with deltas against the anchor
table. Without any set it prints the mount instructions and exits 2.

The protocol: HR cropped to a multiple of the scale; LR from the port's
TF-parity bicubic antialiased downscale (MATLAB's imresize differs
slightly, typically 0.1 dB); SR and HR quantised to uint8 before scoring;
PSNR and SSIM on BT.601 Y (Y = 16 + 65.481 R + 128.553 G + 24.966 B, RGB in
[0, 1]) with a ``scale``-pixel border shave. An LR image whose long side
exceeds the tile threshold (and whose short side holds a 128 px tile) goes
through the overlap-tiled route, 128 px tiles with a 32 px overlap, as the
JAX script routes it: 1000 px for a set of up to 20 images, 160 px for a
larger one (its docstring: one static tile shape for a set of many
shapes), or ``--tile-threshold``. ``--selftest`` runs the same path on one
repo-local image (protocol smoke, not literature numbers). The models run
on the card unless ``--device cpu``.
"""

import argparse
import json
import os
import sys
from pathlib import Path

import torch

from simplesr_tpu_torch.core.device import resolve_device

REPO = Path(__file__).resolve().parents[2]
KNOWN_SETS = ("Set5", "Set14", "BSDS100", "Urban100", "DIV2K_valid")
IMG_EXTS = (".png", ".bmp", ".jpg", ".jpeg")

# BASELINE.md literature anchor table (x4, Y-channel protocol).
ANCHORS_X4 = {
    "bicubic": {"Set5": (28.42, 0.8104), "Set14": (26.00, 0.7027)},
    "srresnet": {"Set5": (32.05, 0.9019), "Set14": (28.49, 0.8184)},
    "srgan": {"Set5": (29.40, 0.8472), "Set14": (26.02, 0.7397)},
    "rrdb": {"Set5": (32.60, 0.900), "Set14": (28.90, 0.79)},
}


def discover_datasets(root=None):
    """{set_name: [image paths]} for every known set present under root."""
    root = Path(root or os.environ.get("SIMPLESR_BENCHMARK_DATA",
                                       REPO / "data" / "benchmarks"))
    found = {}
    if not root.is_dir():
        return found
    by_lower = {p.name.lower(): p for p in root.iterdir() if p.is_dir()}
    for name in KNOWN_SETS:
        d = by_lower.get(name.lower())
        if d is None:
            continue
        imgs = sorted(p for p in d.iterdir()
                      if p.suffix.lower() in IMG_EXTS
                      and "lr" not in p.stem.lower())
        if imgs:
            found[name] = imgs
    return found


def bt601_y(img01):
    """Y of ITU-R BT.601 YCbCr in [16, 235], from float RGB in [0, 1] (the
    MATLAB rgb2ycbcr convention every SR paper scores on)."""
    img01 = torch.as_tensor(img01, dtype=torch.float32)
    w = torch.tensor([65.481, 128.553, 24.966], dtype=torch.float32, device=img01.device)
    return 16.0 + torch.tensordot(img01, w, dims=([-1], [0]))[..., None]


def score_pair(sr01, hr01, scale):
    """Literature-protocol metrics for one image pair in [0, 1] HWC."""
    from simplesr_tpu_torch.ops.metrics import psnr, ssim

    # papers score saved 8-bit images: quantise before Y conversion
    sr01 = torch.round(torch.clamp(torch.as_tensor(sr01).float(), 0.0, 1.0) * 255.0) / 255.0
    hr01 = torch.round(torch.clamp(torch.as_tensor(hr01).float(), 0.0, 1.0) * 255.0) / 255.0
    s = int(scale)
    sr_y = bt601_y(sr01)[s:-s, s:-s]
    hr_y = bt601_y(hr01)[s:-s, s:-s]
    return {
        "psnr_y": float(psnr(sr_y, hr_y, max_val=255.0)),
        "ssim_y": float(ssim(sr_y, hr_y, max_val=255.0)),
    }


def _zoo_models(scale):
    """{label: zoo entry name} for every zoo model at this scale."""
    from simplesr_tpu_torch import zoo

    out = {}
    for e in zoo.list_models():
        if e.scale == scale:
            out.setdefault(e.name, e.qualified)
    return out


def evaluate_set(images, predictors, scale, tile_threshold=1000, device="cuda"):
    """Per-model averaged metrics over one benchmark set. A large LR image
    goes through the overlap-tiled route (the CUDA patch kernel on the
    card); the JAX script routes large sets so to compile one tile shape,
    and the port keeps its routing, so that both score the same route."""
    from simplesr_tpu_torch.data.image import read_img
    from simplesr_tpu_torch.ops.resize import resize
    from simplesr_tpu_torch.ops.tiling import tiled_apply

    dev = resolve_device(device)
    per_model = {label: [] for label in predictors}
    for path in images:
        hr = torch.from_numpy(read_img(str(path))).to(dev) / 255.0
        h = (hr.shape[0] // scale) * scale
        w = (hr.shape[1] // scale) * scale
        hr = hr[:h, :w]
        lr = resize(hr, (h // scale, w // scale), "bicubic", antialias=True)
        for label, fn in predictors.items():
            if fn is None:  # bicubic control row
                sr01 = resize(lr, (h, w), "bicubic", antialias=True)
            elif (max(lr.shape[:2]) > tile_threshold
                  and min(lr.shape[:2]) >= 128):  # segment needs >= one tile
                # the same static tile geometry as the eval route's large-image path
                sr = tiled_apply(fn, lr, (128, 128), 32, scale)
                sr01 = (sr + 1.0) / 2.0
            else:
                sr01 = (fn(lr[None])[0] + 1.0) / 2.0
            row = score_pair(sr01, hr, scale)
            row["image"] = path.stem
            per_model[label].append(row)
    summary = {}
    for label, rows in per_model.items():
        n = len(rows)
        summary[label] = {
            "psnr_y": round(sum(r["psnr_y"] for r in rows) / n, 3),
            "ssim_y": round(sum(r["ssim_y"] for r in rows) / n, 4),
            "images": n,
            "per_image": [{k: (round(v, 3) if isinstance(v, float) else v)
                           for k, v in r.items()} for r in rows],
        }
    return summary


def _anchor_for(label, set_name, scale):
    if scale != 4:
        return None
    for key, table in ANCHORS_X4.items():
        if label == key or label.startswith(key):
            return table.get(set_name)
    return None


def write_reports(results, scale, out_dir):
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "STANDARD.json", "w") as f:
        json.dump(results, f, indent=2)
    lines = [
        "# Standard benchmarks (literature protocol)",
        "",
        f"×{scale} SR scored as the papers do: uint8-quantized, Y channel "
        f"(BT.601), {scale}-px border shave. LR inputs from the framework's "
        "TF-parity bicubic+antialias downscale (MATLAB imresize differs "
        "slightly, typically ±0.1 dB). Anchors: BASELINE.md. Produced by "
        "`simplesr_tpu_torch/tools/standard_benchmarks.py`.",
        "",
        "| set | model | PSNR-Y | SSIM-Y | anchor PSNR/SSIM | ΔPSNR |",
        "|---|---|---|---|---|---|",
    ]
    for set_name, table in results["sets"].items():
        for label, row in table.items():
            anchor = _anchor_for(label, set_name, scale)
            if anchor:
                a = f"{anchor[0]:.2f} / {anchor[1]:.4f}"
                d = f"{row['psnr_y'] - anchor[0]:+.2f}"
            else:
                a, d = "—", "—"
            lines.append(f"| {set_name} | {label} | {row['psnr_y']:.3f} "
                         f"| {row['ssim_y']:.4f} | {a} | {d} |")
    with open(out_dir / "STANDARD.md", "w") as f:
        f.write("\n".join(lines) + "\n")


def run(scale=4, model_specs=None, data_root=None, out_dir=None,
        selftest=False, tile_threshold=None, device="cuda"):
    """Score every set found; 2 (and the mount instructions) when none
    is. ``tile_threshold`` None routes as the JAX script does."""
    from simplesr_tpu_torch.eval.evaluation import _as_predictor

    if selftest:
        # repo-local candidates only: the selftest depends on no path
        # outside the repo
        candidates = [REPO / "tests" / "data", REPO / "data" / "corpus"]
        imgs = []
        for c in candidates:
            if c.is_dir():
                imgs = sorted(p for p in c.rglob("*.png"))[:1]
                if imgs:
                    break
        if not imgs:
            raise SystemExit("selftest: no local test image found")
        datasets = {"SelfSet": imgs}
    else:
        datasets = discover_datasets(data_root)
        if not datasets:
            print(
                "No benchmark datasets found. Mount the HR images as\n"
                f"  {data_root or os.environ.get('SIMPLESR_BENCHMARK_DATA', REPO / 'data' / 'benchmarks')}/"
                "{Set5,Set14,BSDS100}/*.png\n"
                "and rerun. (Zero-egress environment: the sets cannot be "
                "downloaded from here.)", file=sys.stderr)
            return 2

    dev = resolve_device(device)
    predictors = {"bicubic": None}
    if model_specs:
        from simplesr_tpu_torch.train.serialization import resolve_model_spec
        for spec in model_specs:
            predictors[spec] = _as_predictor(resolve_model_spec(spec), device=dev)
    elif not selftest:
        from simplesr_tpu_torch import zoo
        for label, qualified in _zoo_models(scale).items():
            predictors[label] = zoo.load(qualified, device=dev)

    results = {"scale": scale, "protocol": "uint8 BT.601-Y shave-scale",
               "sets": {}}
    for set_name, images in datasets.items():
        print(f"=== {set_name}: {len(images)} images, "
              f"{len(predictors)} models ===", flush=True)
        # many-image sets go through the tiled route unconditionally, as in
        # the JAX script (see evaluate_set)
        threshold = tile_threshold if tile_threshold is not None else \
            1000 if len(images) <= 20 else 160
        results["sets"][set_name] = evaluate_set(
            images, predictors, scale, tile_threshold=threshold, device=dev)
        for label, row in results["sets"][set_name].items():
            print(f"  {label:<28} PSNR-Y {row['psnr_y']:7.3f}  "
                  f"SSIM-Y {row['ssim_y']:.4f}", flush=True)
    write_reports(results, scale,
                  out_dir or REPO / "results" / "benchmarks")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--scale", type=int, default=4, choices=(2, 4, 8))
    p.add_argument("--models", default=None,
                   help="comma-separated model specs (paths or zoo:<name>); "
                        "default: every zoo model at --scale")
    p.add_argument("--data-root", default=None,
                   help="benchmark root (default $SIMPLESR_BENCHMARK_DATA "
                        "or data/benchmarks)")
    p.add_argument("--out", default=None, help="report directory")
    p.add_argument("--selftest", action="store_true",
                   help="run the full path on a repo-local image")
    p.add_argument("--tile-threshold", type=int, default=None,
                   help="LR long side above which an image tiles "
                        "(default: 1000, or 160 for a set of over 20 images)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    specs = args.models.split(",") if args.models else None
    return run(scale=args.scale, model_specs=specs, data_root=args.data_root,
               out_dir=args.out, selftest=args.selftest,
               tile_threshold=args.tile_threshold, device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())
