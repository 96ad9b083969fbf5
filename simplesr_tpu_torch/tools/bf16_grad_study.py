"""bf16 gradients and a bf16 Adam moment in the production step: their
time and their cost in quality, as scripts/bf16_grad_study.py measures them
on the TPU.

    python -m simplesr_tpu_torch.tools.bf16_grad_study [--steps 30]
        [--epochs 25] [--out results/h100/bf16_grad_study] [--skip-quality]
        [--device cpu]

The step's convolutions already run in bf16; the gradients handed to Adam
and Adam's moments stay float32. Four optimisers, each Adam (lr 1e-4,
optax's defaults) over ``train/optimizers.py``'s:

- ``f32``: the control;
- ``grads_bf16``: the gradients rounded to bf16 and back before Adam (the
  precision a data-parallel all-reduce in bf16 would give them);
- ``mu_bf16``: the first moment stored in bf16, as optax's ``mu_dtype``
  stores it (the update uses the new moment before it is rounded);
- ``grads+mu_bf16``: both.

For each it measures (a) the ms per step of the production recipe's shape
(BN-free SRResNet x4 of 16 blocks x 64 filters, 16 crops of 96^2, the
trunk through the kernel on the card; best of 2 runs of ``--steps`` steps
between two CUDA events) and (b) a x2 training run of ``--epochs`` epochs
on crops of the gallery's training tiles, which stand in for the JAX
script's DIV2K and lena images (not in the repo), and its validation PSNR
after each epoch, against the ``f32`` control's. It writes ``RESULTS.json``
and ``RESULTS.md`` under ``--out``. The run is on the card unless
``--device cpu`` is given (the host's clock there).
"""

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.tools.bench_timing import Span, card_line, sync, write_json
from simplesr_tpu_torch.train.optimizers import Optimizer

OUT = Path(__file__).resolve().parents[2] / "results" / "h100" / "bf16_grad_study"
VARIANTS = ("f32", "grads_bf16", "mu_bf16", "grads+mu_bf16")
BLOCKS, FILTERS = 16, 64    # the production generator
TIME_SHAPE = dict(scale=4, crop=96, batch=16)
QUALITY = dict(scale=2, crop=96, batch=16, n_train=1024, n_val=128)


class StudyAdam(Optimizer):
    """optax's ``adam(lr)`` (eps 1e-8), its gradients first rounded through
    bf16 when ``grads_bf16``, its first moment stored in bf16 when
    ``mu_bf16`` (``optax.adam(lr, mu_dtype=jnp.bfloat16)``)."""

    def __init__(self, variant, learning_rate=1e-4):
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}; options {VARIANTS}")
        super().__init__("adam", learning_rate, {"epsilon": 1e-8})
        self.grads_bf16 = variant in ("grads_bf16", "grads+mu_bf16")
        self.mu_bf16 = variant in ("mu_bf16", "grads+mu_bf16")

    @torch.no_grad()
    def apply(self, params, grads):
        if self.grads_bf16:
            grads = [g.to(torch.bfloat16).float() for g in grads]
        if not self.mu_bf16:
            return super().apply(params, grads)
        if "mu" not in self.slots:
            self.slots["mu"] = [torch.zeros_like(p, dtype=torch.bfloat16) for p in params]
        count = self.count + 1
        bc1, bc2 = (float(1 - np.float32(b) ** count) for b in (self.b1, self.b2))
        nus = self._slot("nu", params)
        # optax: (1 - b1) * g + b1 * mu, the product in mu's dtype, b1 too
        # (JAX casts a Python float to the array's dtype; the product of two
        # bf16 values is exact in float32, then rounded once)
        b1 = float(torch.tensor(self.b1, dtype=torch.bfloat16))
        decayed = torch._foreach_mul(self.slots["mu"], b1)
        mus = torch._foreach_add(torch._foreach_mul(grads, 1.0 - self.b1),
                                 [m.float() for m in decayed])
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                    1.0 - self.b2))
        denom = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(torch._foreach_div(mus, bc1), denom)
        torch._foreach_mul_(updates, -self._lr())
        torch._foreach_add_(params, updates)
        torch._foreach_copy_(self.slots["mu"], mus)
        self.count += 1


def make_model(scale, dev, seed=0):
    """The study's generator: BN-free bf16 SRResNet, seeded."""
    from simplesr_tpu_torch.models import SRResNet

    torch.manual_seed(seed)
    return SRResNet(scale, num_filters=FILTERS, num_res_blocks=BLOCKS, batch_norm=False,
                    dtype=torch.bfloat16).to(dev)


def make_step(module, opt):
    """One step: pixel MSE of the training-mode forward, its gradients, the
    optimiser's update."""
    params = list(module.parameters())

    def step(x, y):
        module.train()
        loss = ((module(x).float() - y) ** 2).mean()
        opt.apply(params, torch.autograd.grad(loss, params))
        return loss

    return step


def measure_step_time(variant, dev, steps=30, scale=4, crop=96, batch=16):
    """ms per step of the production-shaped step under ``variant``."""
    module = make_model(scale, dev)
    step = make_step(module, StudyAdam(variant))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (batch, crop // scale, crop // scale, 3))
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.uniform(-1, 1, (batch, crop, crop, 3)).astype(np.float32)).to(dev)
    step(x, y)
    best = float("inf")
    for _ in range(2):
        sync(dev)
        with Span(dev) as span:
            for _ in range(steps):
                step(x, y)
        best = min(best, span.ms / steps)
    return best


def corpus(dev, scale=2, crop=96, n_train=1024, n_val=128):
    """((LR, HR) train, (LR, HR) validation) crops of the gallery's training
    tiles on ``dev``: HR in [-1, 1], LR its antialiased bicubic in [0, 1]."""
    from simplesr_tpu_torch.data.image import read_img
    from simplesr_tpu_torch.ops.crop import random_crops
    from simplesr_tpu_torch.ops.resize import resize
    from simplesr_tpu_torch.tools.quality_campaign import TRAIN_IMGS

    paths = list(TRAIN_IMGS.values())
    parts = {"train": [], "val": []}
    for i, path in enumerate(paths):
        img = torch.from_numpy(read_img(path)).to(dev)
        for split, n, seed in (("train", n_train, 100), ("val", n_val, 200)):
            gen = torch.Generator().manual_seed(seed + i)
            parts[split].append(random_crops(gen, img, max(1, n // len(paths)), (crop, crop)))

    def pairs(hr_u8):
        hr = hr_u8.float()
        lr = resize(hr / 255.0, (crop // scale, crop // scale), method="bicubic",
                    antialias=True)
        return lr.float(), hr / 127.5 - 1.0

    return pairs(torch.cat(parts["train"])), pairs(torch.cat(parts["val"]))


def quality_run(variant, dev, epochs=25, scale=2, crop=96, batch=16, n_train=1024,
                n_val=128, seed=0):
    """Validation PSNR (dB, HR on [-1, 1]) after each of ``epochs`` epochs of
    x2 training under ``variant``."""
    from simplesr_tpu_torch.ops.metrics import psnr

    (lr_t, hr_t), (lr_v, hr_v) = corpus(dev, scale, crop, n_train, n_val)
    module = make_model(scale, dev, seed)
    step = make_step(module, StudyAdam(variant))
    n = (lr_t.shape[0] // batch) * batch
    order_gen = torch.Generator().manual_seed(7)
    curve = []
    for _ in range(epochs):
        order = torch.randperm(lr_t.shape[0], generator=order_gen)[:n].to(dev)
        for b in range(n // batch):
            idx = order[b * batch:(b + 1) * batch]
            step(lr_t[idx], hr_t[idx])
        module.eval()
        with torch.inference_mode():
            curve.append(float(psnr(hr_v, module(lr_v).float(), max_val=2.0).mean()))
    return curve


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--skip-quality", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line(dev)
    key = "ms_per_step_b{batch}_crop{crop}_x{scale}".format(**TIME_SHAPE)
    results = {"card": card, "device": str(dev), "variants": {}}
    for v in VARIANTS:
        ms = measure_step_time(v, dev, steps=args.steps, **TIME_SHAPE)
        results["variants"][v] = {key: ms}
        print(f"[time] {v}: {ms:.3f} ms/step", flush=True)
    if not args.skip_quality:
        for v in VARIANTS:
            curve = quality_run(v, dev, epochs=args.epochs, **QUALITY)
            r = results["variants"][v]
            r["val_psnr_curve_x2"] = curve
            r["final_val_psnr_x2"] = curve[-1]
            r["final_minus_f32"] = curve[-1] - results["variants"]["f32"]["final_val_psnr_x2"]
            print(f"[quality] {v}: final val PSNR {curve[-1]:.3f} (best {max(curve):.3f})",
                  flush=True)
    write_json(args.out, "RESULTS.json", results)
    lines = [f"# bf16-gradient study ({card})", "",
             f"| variant | ms/step (x4 b16 x 96^2) | final val PSNR (x2) | best | "
             "final - f32 |", "|---|---|---|---|---|"]
    for v, r in results["variants"].items():
        c = r.get("val_psnr_curve_x2")
        lines.append(f"| {v} | {r[key]:.3f} | {r.get('final_val_psnr_x2', '-')} | "
                     f"{max(c) if c else '-'} | {r.get('final_minus_f32', '-')} |")
    Path(args.out, "RESULTS.md").write_text("\n".join(lines) + "\n")
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
