"""Training-step roofline of the SRResNet x4 production step on the card:
where its milliseconds go, and what batch, crop, BatchNorm and dtype buy, as
scripts/train_roofline.py measures it on the TPU.

    python -m simplesr_tpu_torch.tools.train_roofline [--steps 30]
        [--out results/h100/train_roofline] [--fast] [--equal-pixels]
        [--device cpu]

For each (batch, crop, batch_norm, dtype) of the JAX script's grid it builds
the port's ``SRModel`` (``Generator.srresnet``, Adam at 1e-4) and times the
full production step, ``train_step`` then ``after_train_batch``, over
``--steps`` steps between two CUDA events (best of 3), and the forward alone
(eval mode, no autograd) at the same shapes, so that the fwd : (bwd + opt)
split is measured. Each row has the JAX script's keys, with
``step_tc_util`` (the step's TFLOP/s over the H100's 989 TFLOP/s bf16 peak,
at the card's power limit, printed beside it) in place of its
``step_mxu_util`` (a v5e share).

FLOPs are counted from the model's shapes (``srresnet_flops``): every conv's
multiply-adds over the taps that fall inside the image (SAME padding's
zeros are no work, as XLA's cost analysis counts them), twice for the
forward and, in the step, twice more for each gradient (the input gradient
of the first conv is not needed); the elementwise ops (bias, PReLU, BatchNorm
and its statistics, residual adds, the loss) in the forward and twice in the
backward; Adam's updates. ``torch.utils.flop_counter`` cannot see inside
``TrunkFunction``. ``--equal-pixels`` runs the JAX script's spatial control
instead (forward only at equal LR pixels, split as batch or as side). The
run is on the card unless ``--device cpu`` is given (the host's clock there,
and no share of the card's peak).
"""

import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.tools.bench_timing import (PEAK_BF16_FLOPS, Span, sync, card_line,
                                                   emit, markdown_table, write_json)
from simplesr_tpu_torch.tools.remat_study import train_config

OUT = Path(__file__).resolve().parents[2] / "results" / "h100" / "train_roofline"
BLOCKS, FILTERS = 16, 64    # the production generator's trunk
SWEEP = [dict(batch=16, crop=96), dict(batch=32, crop=96), dict(batch=64, crop=96),
         dict(batch=16, crop=128), dict(batch=32, crop=128), dict(batch=16, crop=192),
         dict(batch=32, crop=192), dict(batch=16, crop=96, batch_norm=False),
         dict(batch=64, crop=192), dict(batch=64, crop=192, batch_norm=False)]
FAST_SWEEP = [dict(batch=2, crop=32), dict(batch=2, crop=32, batch_norm=False)]
EQUAL_PIXELS = [(16, 24), (4, 48), (1, 96), (16, 96)]
PRELU_OPS, BN_OPS, BN_STAT_OPS, ADAM_OPS, MSE_OPS = 3, 4, 3, 12, 3
COLUMNS = ["batch", "crop", "batch_norm", "step_ms", "fwd_ms", "bwd_opt_ms", "hr_mpix_per_s",
           "step_tflops", "step_tc_util", "fwd_tflops"]


def valid_taps(n, k):
    """Taps of a SAME k-wide conv over n pixels that fall inside them."""
    half = k // 2
    return sum(min(i + half, n - 1) - max(i - half, 0) + 1 for i in range(n))


def srresnet_flops(batch, lr_h, lr_w, scale=4, filters=64, blocks=16, batch_norm=True,
                   num_params=None):
    """{"forward", "step", "forward_convs"}: FLOPs of the SRResNet forward
    (eval mode) and of its training step (module docstring); ``step``
    needs ``num_params`` (Adam's updates)."""
    c = filters

    def conv(h, w, k, cin, cout):
        return 2 * batch * cin * cout * valid_taps(h, k) * valid_taps(w, k)

    lr_px = batch * lr_h * lr_w
    head = conv(lr_h, lr_w, 9, 3, c)
    convs = head + (2 * blocks + 1) * conv(lr_h, lr_w, 3, c, c)
    # elementwise per element: bias 1, PReLU 3, residual and skip adds 1,
    # BatchNorm 4 (and its batch statistics 3 in training)
    trunk_tensors = 2 * blocks + 1           # conv outputs of width c at LR
    ew = lr_px * c * (1 + PRELU_OPS)         # head bias, PReLU
    ew += lr_px * c * trunk_tensors          # trunk biases
    ew += lr_px * c * blocks * (PRELU_OPS + 1) + lr_px * c  # PReLUs, adds, global skip
    bn = lr_px * c * trunk_tensors if batch_norm else 0
    s = 1
    while s < scale:
        convs += conv(s * lr_h, s * lr_w, 3, c, 4 * c)
        ew += s * s * lr_px * 4 * c * (1 + PRELU_OPS)  # bias, then PReLU after depth_to_space
        s *= 2
    convs += conv(s * lr_h, s * lr_w, 9, c, 3)
    hr_values = s * s * lr_px * 3
    ew += hr_values                          # output bias (tanh is a transcendental)
    out = {"forward_convs": convs, "forward": convs + ew + BN_OPS * bn}
    if num_params is not None:
        train_ew = ew + (BN_OPS + BN_STAT_OPS) * bn + MSE_OPS * hr_values
        out["step"] = (3 * convs - head) + 3 * train_ew + ADAM_OPS * num_params
    return out


def _timed(fn, steps, dev, rounds=3):
    """Best ms per call over ``rounds`` runs of ``steps`` calls, each run
    between two CUDA events (the host's clock on the CPU)."""
    best = float("inf")
    for _ in range(rounds):
        sync(dev)
        with Span(dev) as span:
            for _ in range(steps):
                fn()
        best = min(best, span.ms / steps)
    return best


def _batch(batch, lr_hw, crop, dev):
    rng = np.random.default_rng(0)
    lr = torch.from_numpy(rng.uniform(0, 1, (batch, lr_hw, lr_hw, 3)).astype(np.float32))
    hr = torch.from_numpy(rng.uniform(-1, 1, (batch, crop, crop, 3)).astype(np.float32))
    return lr.to(dev), hr.to(dev)


def measure_config(batch, crop, dev, scale=4, batch_norm=True, dtype=None, steps=30):
    """One (batch, crop, batch_norm, dtype) point -> its row."""
    blocks, filters = BLOCKS, FILTERS
    from simplesr_tpu_torch.train import Generator, SRModel

    lr_hw = crop // scale
    gen = Generator.srresnet(scale, num_blocks=blocks, num_filters=filters,
                             batch_norm=batch_norm, dtype=dtype, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        model = SRModel("resnet", gen, "Adam", {"learning_rate": 1e-4},
                        config=train_config(tmp), device=dev)
        lr, hr = _batch(batch, lr_hw, crop, dev)

        def step():
            model.train_step(lr, hr)
            model.after_train_batch()

        model.before_epoch()
        step()  # the optimiser's state, cuDNN's choices
        step_ms = _timed(step, steps, dev)
        module = gen.model()
        module.eval()
        with torch.inference_mode():
            module(lr)
            fwd_ms = _timed(lambda: module(lr), steps, dev)
        module.train()
    num_params = sum(p.numel() for p in module.parameters())
    flops = srresnet_flops(batch, lr_hw, lr_hw, scale, filters, blocks, batch_norm,
                           num_params)
    row = {"batch": batch, "crop": crop, "batch_norm": batch_norm,
           "dtype": str(dtype) if dtype else "policy-bf16",
           "step_ms": step_ms, "fwd_ms": fwd_ms, "bwd_opt_ms": step_ms - fwd_ms,
           "hr_mpix_per_s": batch * crop * crop / 1e6 / (step_ms / 1e3),
           "step_tflops": flops["step"] / step_ms / 1e9,
           "fwd_tflops": flops["forward"] / fwd_ms / 1e9,
           "step_flops": flops["step"], "fwd_flops": flops["forward"], "device": str(dev)}
    if dev.type == "cuda":
        row["step_tc_util"] = flops["step"] / (step_ms / 1e3) / PEAK_BF16_FLOPS
    return row


def equal_pixels_control(dev, steps=30):
    """Forward only (BatchNorm, eval mode) at equal total LR pixels split
    as batch or as side, and at 16 x 96^2: does a small side starve the
    card, or too little work per call?"""
    from simplesr_tpu_torch.train import Generator

    blocks, filters = BLOCKS, FILTERS
    rows = []
    for batch, lr_hw in EQUAL_PIXELS:
        module = Generator.srresnet(4, num_blocks=blocks, num_filters=filters,
                                    batch_norm=True, device=dev).model().eval()
        x, _ = _batch(batch, lr_hw, 4 * lr_hw, dev)
        with torch.inference_mode():
            module(x)
            ms = _timed(lambda: module(x), steps, dev)
        flops = srresnet_flops(batch, lr_hw, lr_hw, 4, filters, blocks, True)["forward"]
        rows.append(emit({"batch": batch, "lr_hw": lr_hw, "lr_pixels": batch * lr_hw * lr_hw,
                          "fwd_ms": ms, "fwd_tflops": flops / ms / 1e9, "fwd_flops": flops,
                          "device": str(dev)}))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--out", default=str(OUT))
    p.add_argument("--fast", action="store_true", help="2 configs, 5 steps (smoke)")
    p.add_argument("--equal-pixels", action="store_true",
                   help="run only the equal-pixels spatial control")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line(dev)
    steps = 5 if args.fast else args.steps
    print(card, flush=True)
    if args.equal_pixels:
        rows = equal_pixels_control(dev, steps)
        write_json(args.out, "EQUAL_PIXELS.json", {"card": card, "rows": rows})
        return rows
    rows = []
    for cfg in FAST_SWEEP if args.fast else SWEEP:
        rows.append(emit({**measure_config(dev=dev, steps=steps, **cfg), "card": card}))
    write_json(args.out, "RESULTS.json", {"card": card, "rows": rows})
    md = markdown_table(rows, COLUMNS)
    Path(args.out, "RESULTS.md").write_text(
        f"# SRResNet x4 training step roofline ({card})\n\n" + md)
    print(md, flush=True)
    return rows


if __name__ == "__main__":
    main()
