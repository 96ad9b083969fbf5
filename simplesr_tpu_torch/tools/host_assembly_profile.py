"""Where a training batch's time goes in the port's ``DataPipeline``, stage
by stage, as scripts/host_assembly_profile.py measures the JAX pipeline.

    python -m simplesr_tpu_torch.tools.host_assembly_profile [--crop 96]
        [--batch 16] [--out results/h100/host_assembly] [--device cpu]

The corpus is the gallery's training tiles (``tools.quality_campaign``'s
``TRAIN_IMGS``), standing in for the JAX script's two DIV2K images and lena
(not in the repo), as x4 pairs of ``--crop`` px crops, ``NUM_CROPS`` a
tile, flips and 90-degree turns, batches of ``--batch``:

- ``decode_cold_s`` / ``decode_cached_s``: every tile through the pipeline's
  decode (the port's native loader), on a fresh pipeline and again;
- ``crop_bank_s``, ``crop_bank_mpix_s``: each tile's crops (``_host_crops``);
- ``stack_mpix_s``: ``_assemble``'s ``np.stack`` of a batch;
- ``upload_mpix_s``: a stacked batch to the device; ``prepare_mpix_s``: the
  upload and the device prep (augmentation, bicubic LR) of ``_prepare``;
- HR MPix/s of ``train_batch_generator`` over two epochs after a warm one,
  under the JAX script's keys: on the host path at ``num_workers`` 1, 2 and
  4 (``"workers=1 (host path)"``, ...), on the device-resident pool
  (``"device-resident pool"``) and at the shipped default (``"auto
  (shipped default)"``).

Each rate ends with the device synchronised. It writes ``RESULTS.json``
under ``--out``. The run is on the card unless ``--device cpu`` is given.
"""

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.tools.bench_timing import card_line, sync, write_json

OUT = Path(__file__).resolve().parents[2] / "results" / "h100" / "host_assembly"
NUM_CROPS = 96
AUGS = ["flip_along_x", "flip_along_y", "rotate90"]


def staged_dir(tmp):
    """A directory of links to the corpus's tiles."""
    from simplesr_tpu_torch.tools.quality_campaign import TRAIN_IMGS

    img_dir = Path(tmp) / "imgs"
    img_dir.mkdir()
    for i, src in enumerate(TRAIN_IMGS.values()):
        os.symlink(src, img_dir / f"{i}{Path(src).suffix}")
    return str(img_dir)


def make_pipe(img_dir, crop, batch, dev, num_workers=None, device_resident="auto"):
    from simplesr_tpu_torch.data import DataPipeline

    return DataPipeline(hr_img_path=img_dir, scale=4, batch_size=batch,
                        crop_size=(crop, crop, 3), num_crops=NUM_CROPS, train_val_split=0.0,
                        augmentations=AUGS, random_seed=0, drop_remainder=True,
                        num_workers=num_workers, device_resident=device_resident, device=dev)


def consume(pipe, dev, crop, epochs=2):
    """HR MPix/s of ``epochs`` epochs of the generator after a warm one."""
    sum(int(b[0].shape[0]) for b in pipe.train_batch_generator())
    sync(dev)
    t0 = time.perf_counter()
    total = 0
    for _ in range(epochs):
        total = sum(int(b[0].shape[0]) for b in pipe.train_batch_generator())
    sync(dev)
    return epochs * total * crop * crop / 1e6 / (time.perf_counter() - t0), total


def profile(img_dir, crop, batch, dev):
    """The stages' numbers (module docstring)."""
    res = {"crop": crop, "batch": batch, "num_crops": NUM_CROPS, "device": str(dev)}
    pipe = make_pipe(img_dir, crop, batch, dev, device_resident=False)
    files = list(pipe.train_imgs)
    res["files"] = len(files)
    for key in ("decode_cold_s", "decode_cached_s"):
        t0 = time.perf_counter()
        for f in files:
            pipe._decoded(f)
        res[key] = time.perf_counter() - t0

    t0 = time.perf_counter()
    banks = {f: pipe._host_crops(f, np.random.default_rng(i)) for i, f in enumerate(files)}
    dt = time.perf_counter() - t0
    n_crops = sum(len(b) for b in banks.values())
    res["crop_bank_s"] = dt
    res["crop_bank_mpix_s"] = n_crops * crop * crop / 1e6 / dt

    flat = [c for b in banks.values() for c in b]
    starts = range(0, len(flat) - batch + 1, batch)
    t0 = time.perf_counter()
    stacks = [np.stack(flat[s:s + batch]) for s in starts]
    dt = time.perf_counter() - t0
    mpix = len(stacks) * batch * crop * crop / 1e6
    res["stack_mpix_s"] = mpix / dt

    aug_ids = np.zeros(batch, np.int32)
    for key, fn in (("upload_mpix_s", lambda a: torch.from_numpy(a).to(dev)),
                    ("prepare_mpix_s", lambda a: pipe._prepare(torch.from_numpy(a), aug_ids))):
        fn(stacks[0])
        sync(dev)
        t0 = time.perf_counter()
        for a in stacks:
            fn(a)
        sync(dev)
        res[key] = mpix / (time.perf_counter() - t0)
    print(f"[stages] {json.dumps(res)}", flush=True)

    runs = [(f"workers={w} (host path)", dict(num_workers=w, device_resident=False))
            for w in (1, 2, 4)]
    runs += [("device-resident pool", dict(device_resident=True)), ("auto (shipped default)", {})]
    for desc, kw in runs:
        rate, per_epoch = consume(make_pipe(img_dir, crop, batch, dev, **kw), dev, crop)
        res[desc] = rate
        print(f"[generator] {desc}: {rate:.1f} MPix/s ({per_epoch} imgs/epoch)", flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--crop", type=int, default=96)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        res = profile(staged_dir(tmp), args.crop, args.batch, dev)
    res["card"] = card_line(dev)
    print("written:", write_json(args.out, "RESULTS.json", res), flush=True)
    return res


if __name__ == "__main__":
    main()
