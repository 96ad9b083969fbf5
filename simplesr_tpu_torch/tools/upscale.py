"""Single-command upscaler: one model file, images in (PNG, JPEG, WebP, GIF,
TIFF, BMP, netpbm: ``data/image.py``), SR PNGs out.

    python -m simplesr_tpu_torch.tools.upscale \\
        --model results/quality_fastrecipe/models/resnet_gen_srresnet_x4_best.msgpack \\
        --scale 4 --output out_dir input1.png input2.png ...

Runs on the GPU unless ``--device cpu``. The model is served in its exact
serving form (the polyphase tail for SRResNet) unless ``--no-fast``;
``--ensemble`` adds the x8 geometric self-ensemble and ``--paired W`` the
paired trunk. LR images over 1000 x 1000 go through the overlap-tiled
route, with the CUDA patch-extraction kernel.
"""

import argparse
import os
import time

import numpy as np
import torch

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.data.image import read_img
from simplesr_tpu_torch.data.png import write_png
from simplesr_tpu_torch.eval.evaluation import (_as_predictor, _upscale,
                                                check_tile_threshold)


def upscale_files(model_path, inputs, output_dir, scale, tile_threshold=1000, fast=True,
                  ensemble=False, paired=0, device="cuda"):
    """Upscale image files into ``output_dir`` as ``<name>_x<scale>.png``;
    return the output paths. ``tile_threshold`` is kept for the JAX
    package's signature: the route tiles LR images over 1000 x 1000, as
    there, and any other value raises ValueError."""
    check_tile_threshold(tile_threshold)
    device = resolve_device(device)
    predict = _as_predictor(model_path, fast=fast, ensemble=ensemble, paired=paired,
                            device=device)
    os.makedirs(output_dir, exist_ok=True)
    outputs = []
    for path in inputs:
        img = read_img(path) / 255.0  # LR contract: [0, 1]
        t0 = time.perf_counter()
        sr = _upscale(predict, torch.from_numpy(img).to(device)[None], scale)
        sr = sr[0].cpu().numpy()
        dt = time.perf_counter() - t0
        out_path = os.path.join(
            output_dir, os.path.splitext(os.path.basename(path))[0] + f"_x{scale}.png")
        # SR output is [-1, 1] (tanh); truncate to uint8 as simplesr_tpu does
        arr = np.clip((sr + 1.0) * 127.5, 0, 255).astype(np.uint8)
        write_png(out_path, arr)
        print(f"{path} -> {out_path}  {img.shape[1]}x{img.shape[0]} -> "
              f"{arr.shape[1]}x{arr.shape[0]}  ({dt:.2f}s)")
        outputs.append(out_path)
    return outputs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, help="saved model (.msgpack) or zoo:<name>")
    p.add_argument("--scale", type=int, default=4, help="model upsample factor")
    p.add_argument("--output", default=".", help="output directory")
    p.add_argument("--no-fast", action="store_true",
                   help="serve the training-form module (skip the exact polyphase tail)")
    p.add_argument("--ensemble", action="store_true",
                   help="x8 geometric self-ensemble (rotations and flips averaged), "
                        "~8x the compute")
    p.add_argument("--paired", type=int, default=0, metavar="W",
                   help="paired trunk (W batch items packed into channels; exact rewrite)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("inputs", nargs="+", help="input image files")
    args = p.parse_args(argv)
    if args.paired and args.paired < 2:
        p.error(f"--paired must be >= 2, got {args.paired}")
    upscale_files(args.model, args.inputs, args.output, args.scale, fast=not args.no_fast,
                  ensemble=args.ensemble, paired=args.paired, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
