"""The SRResNet x4 serving tail (two subpixel stages and the 9 x 9 output
conv) taken apart on the card, as scripts/bench_upsample_tail.py takes it
apart on the TPU.

    python -m simplesr_tpu_torch.tools.bench_upsample_tail [batch] [hw] [runs]
        [--device cpu]

On batch x hw x hw features of 64 channels (16 x 128 x 128 by default, the
JAX script's), from one seeded BN-free bf16 SRResNet x4, it times each stage
alone and five whole-tail forms, each a function of its own over the same
weights, each the same function as the model's tail:

- ``production``: conv, depth_to_space, PReLU twice, then the float32 9 x 9
  output conv and tanh (``SRResNet.tail``);
- ``prelu_before_d2s``: PReLU on the phase tensor (its slope tiled over the
  phases), then depth_to_space;
- ``coarse_output_conv``: the output conv coarsened to a 3 x 3 conv at LR
  on the 16-phase tensor (``ops.polyphase``), one depth_to_space(4) last;
- ``full_polyphase``: every conv at LR (``models.polyphase``'s weights,
  the port's served form);
- ``phase_split``: the full polyphase form with each coarse conv split by
  output phase into convs over its live taps only.

Each line has ``ms`` (one call between two CUDA events, median of ``runs``),
``flops`` (what the convs execute), ``zero_flops`` (of those, the
multiply-adds by a coarsened kernel's structural zeros: the seeded weights
have no zero of their own), ``tflops_per_s`` over the executed FLOPs and
``useful_tflops_per_s`` over the others, under the JAX script's ``stage``
names (``full_tail_production``, ``tail_<form>`` for the others). The run is on the card unless
``--device cpu`` is given (the host's clock there).
"""

import argparse
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.core.dtypes import OUTPUT_CONV_TF32, cudnn_tf32
from simplesr_tpu_torch.models import SRResNet
from simplesr_tpu_torch.models.polyphase import flax_tree, host, polyphase_variables
from simplesr_tpu_torch.ops.polyphase import coarsen_conv_kernel, phase_merge_permutation
from simplesr_tpu_torch.ops.shuffle import depth_to_space_nchw, space_to_depth_nchw
from simplesr_tpu_torch.tools.bench_timing import card_line, cuda_ms, emit, rates

C = 64
FORMS = ("production", "prelu_before_d2s", "coarse_output_conv", "full_polyphase",
         "phase_split")


class ConvW(NamedTuple):
    """A conv's OIHW weight and bias on the device, the count of the
    weight's nonzero entries, and its padding (left, right, top, bottom),
    None for SAME."""
    weight: torch.Tensor
    bias: torch.Tensor
    nonzero: int
    pads: tuple = None


def conv_w(kernel_hwio, bias, dev, pads=None):
    """``ConvW`` of a flax-layout (HWIO) kernel and its bias."""
    kernel = np.asarray(kernel_hwio, np.float32)
    return ConvW(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()).to(dev),
                 torch.from_numpy(np.asarray(bias, np.float32)).to(dev),
                 int(np.count_nonzero(kernel)), pads)


def split_by_phase(kernel, bias, groups, dev):
    """A SAME HWIO ``kernel`` split into ``groups`` equal blocks of output
    channels, each cut to the rows and columns of taps that are nonzero
    anywhere in its block: [ConvW with the padding that keeps the SAME
    alignment]."""
    kc = kernel.shape[0]
    size = kernel.shape[3] // groups
    parts = []
    for g in range(groups):
        block = kernel[..., g * size:(g + 1) * size]
        rows = np.flatnonzero(np.abs(block).sum(axis=(1, 2, 3)))
        cols = np.flatnonzero(np.abs(block).sum(axis=(0, 2, 3)))
        y0, y1, x0, x1 = rows[0], rows[-1], cols[0], cols[-1]
        pads = (kc // 2 - x0, x1 - kc // 2, kc // 2 - y0, y1 - kc // 2)
        parts.append(conv_w(block[y0:y1 + 1, x0:x1 + 1], bias[g * size:(g + 1) * size], dev,
                            tuple(int(p) for p in pads)))
    return parts


class Tail:
    """Runs convs in a given dtype with flax's numerics (the bias added
    after the conv, in that dtype; float32 at the model's TF32 setting on
    CUDA) and, while ``counting``, adds up their FLOPs."""

    def __init__(self, dtype):
        self.dtype = dtype
        self.counting = False
        self.flops = self.useful = 0

    def conv(self, h, cw, dtype=None):
        dtype = dtype or self.dtype
        x, k = h.to(dtype), cw.weight.shape[-1]
        if self.counting:
            pixels = x.shape[0] * x.shape[2] * x.shape[3]
            self.flops += 2 * pixels * cw.weight.numel()
            self.useful += 2 * pixels * cw.nonzero
        tf32 = OUTPUT_CONV_TF32 if dtype == torch.float32 else False
        with cudnn_tf32(x.device, tf32):
            if cw.pads is None:
                y = F.conv2d(x, cw.weight.to(dtype), padding=k // 2)
            else:
                y = F.conv2d(F.pad(x, cw.pads), cw.weight.to(dtype))
        return y + cw.bias.to(dtype).view(1, -1, 1, 1)

    def count(self, fn, x):
        """(executed FLOPs, useful FLOPs) of one ``fn(x)``."""
        self.counting, self.flops, self.useful = True, 0, 0
        try:
            with torch.inference_mode():
                fn(x)
        finally:
            self.counting = False
        return self.flops, self.useful


def prelu(x, alpha):
    alpha = alpha.to(x.dtype).view(1, -1, 1, 1)
    return torch.where(x >= 0, x, alpha * x)


def finish(h):
    """tanh of the HR image, NHWC float32."""
    return torch.tanh(h.float()).permute(0, 2, 3, 1).contiguous()


def srresnet_tail_forms(model):
    """{form: fn(NCHW features) -> (B, 4H, 4W, 3) float32} and {stage: fn}
    for a trained SRResNet x4 ``model``, every one built from its tail's
    weights, and the ``Tail`` that runs their convs."""
    if model.upsample_factor != 4:
        raise ValueError("the tail forms are those of SRResNet x4")
    dev, c = next(model.parameters()).device, model.num_filters
    params = flax_tree(model.state_dict())["params"]
    poly = polyphase_variables(model, {"params": params})["params"]
    t = Tail(model.dtype)
    up = [params[f"SubpixelConvBlock_{i}"] for i in (0, 1)]
    w1, w2 = (conv_w(host(u["Conv_0"]["kernel"]), host(u["Conv_0"]["bias"]), dev) for u in up)
    a1, a2 = (torch.from_numpy(host(u["PReLU_0"]["alpha"])).to(dev) for u in up)
    a1r, a2r, a2c = a1.repeat(4), a2.repeat(4), a2.repeat(16)
    out_k, out_b = host(params["Conv_0"]["kernel"]), host(params["Conv_0"]["bias"])
    w_out = conv_w(out_k, out_b, dev)
    # the coarse output conv: over the direct 16-phase order (PolyOut), and
    # over the nested order that space_to_depth(2) of the 2x tensor gives
    perm = phase_merge_permutation(2, 2, c)
    out_direct = host(poly["PolyOut"]["kernel"])
    out_nested = np.empty_like(out_direct)
    out_nested[:, :, perm] = out_direct
    w_out_c = conv_w(out_nested, host(poly["PolyOut"]["bias"]), dev)
    p_up1 = conv_w(host(poly["PolyUp_1"]["kernel"]), host(poly["PolyUp_1"]["bias"]), dev)
    p_up2 = conv_w(host(poly["PolyUp_2"]["kernel"]), host(poly["PolyUp_2"]["bias"]), dev)
    p_out = conv_w(out_direct, host(poly["PolyOut"]["bias"]), dev)
    # phase split: PolyUp_2 by its four output phases (nested order, 4C
    # channels each), the output conv by its sixteen (3 channels each)
    up2_k, up2_b = coarsen_conv_kernel(host(up[1]["Conv_0"]["kernel"]), 2,
                                       host(up[1]["Conv_0"]["bias"]))
    split_up2 = split_by_phase(up2_k, up2_b, 4, dev)
    split_out = split_by_phase(out_nested, host(poly["PolyOut"]["bias"]), 16, dev)
    f32 = torch.float32

    def production(h):
        h = prelu(depth_to_space_nchw(t.conv(h, w1), 2), a1)
        h = prelu(depth_to_space_nchw(t.conv(h, w2), 2), a2)
        return finish(t.conv(h, w_out, f32))

    def prelu_before_d2s(h):
        h = depth_to_space_nchw(prelu(t.conv(h, w1), a1r), 2)
        h = depth_to_space_nchw(prelu(t.conv(h, w2), a2r), 2)
        return finish(t.conv(h, w_out, f32))

    def coarse_output_conv(h):
        h = depth_to_space_nchw(prelu(t.conv(h, w1), a1r), 2)
        h = space_to_depth_nchw(prelu(t.conv(h, w2), a2r), 2)
        return finish(depth_to_space_nchw(t.conv(h, w_out_c, f32), 4))

    def full_polyphase(h):
        h = prelu(t.conv(h, p_up1), a1r)
        h = prelu(t.conv(h, p_up2), a2c)
        return finish(depth_to_space_nchw(t.conv(h, p_out, f32), 4))

    def phase_split(h):
        h = prelu(t.conv(h, p_up1), a1r)
        h = prelu(torch.cat([t.conv(h, cw) for cw in split_up2], 1), a2c)
        return finish(depth_to_space_nchw(torch.cat([t.conv(h, cw, f32) for cw in split_out],
                                                    1), 4))

    forms = {"production": production, "prelu_before_d2s": prelu_before_d2s,
             "coarse_output_conv": coarse_output_conv, "full_polyphase": full_polyphase,
             "phase_split": phase_split}
    # each stage on the input the stages before it give (the production order)
    stages = [
        ("conv1_64to256@LR", lambda h: t.conv(h, w1)),
        ("conv1+d2s", lambda h: depth_to_space_nchw(t.conv(h, w1), 2)),
        ("conv1+d2s+prelu", lambda h: prelu(depth_to_space_nchw(t.conv(h, w1), 2), a1)),
        ("conv2_64to256@2x", lambda h: t.conv(h, w2)),
        ("conv2+d2s+prelu", lambda h: prelu(depth_to_space_nchw(t.conv(h, w2), 2), a2)),
        ("out_9x9_64to3@4x", lambda h: torch.tanh(t.conv(h, w_out, f32))),
    ]
    return forms, stages, t


def tail_stage_ms(training, poly, lr_nhwc, dev=None):
    """Times (ms, one call between two CUDA events, median of 10) of the
    training and polyphase tails' stages on one batch, each stage on the
    input the previous one gives, from the shared features."""
    from simplesr_tpu_torch.models.srresnet import output_conv

    with torch.inference_mode():
        h = training.features(lr_nhwc)
        stages = [("subpixel_1", training.upsample[0]), ("subpixel_2", training.upsample[1]),
                  ("out_conv_f32+tanh", lambda t: torch.tanh(output_conv(t, training.out)))]
        poly_stages = [("PolyUp_1", lambda t: poly.poly_up(t, 1)),
                       ("PolyUp_2", lambda t: poly.poly_up(t, 2)),
                       ("PolyOut_f32+d2s+tanh", lambda t: torch.tanh(
                           depth_to_space_nchw(poly.poly_out(t), 4)))]
        times = {}
        for chain in (stages, poly_stages):
            x = h
            for name, fn in chain:
                times[name] = cuda_ms(lambda: fn(x), runs=10, warmup=2, dev=dev)
                x = fn(x)
    return times


def measure(label, fn, x, t, runs, dev, card):
    """One JSON line for ``fn(x)``: its time, executed and useful FLOPs."""
    flops, useful = t.count(fn, x)
    with torch.inference_mode():
        ms = cuda_ms(lambda: fn(x), runs=runs, dev=dev)
    row = {"stage": label, "ms": ms, "flops": flops, "zero_flops": flops - useful,
           **rates(ms, flops, dev=dev), "useful_tflops_per_s": useful / ms / 1e9 if useful else None,
           "shape": list(x.shape), "device": str(dev), "card": card}
    return emit(row)


def features(batch, hw, dtype, dev, channels=C, seed=0):
    """Seeded NCHW features, normal(0, 0.5), as the JAX script draws them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.5, (batch, hw, hw, channels)).astype(np.float32)
    return torch.from_numpy(x).to(dev, dtype).permute(0, 3, 1, 2).contiguous()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batch", type=int, nargs="?", default=16)
    p.add_argument("hw", type=int, nargs="?", default=128)
    p.add_argument("runs", type=int, nargs="?", default=20)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line(dev)
    torch.manual_seed(0)
    model = SRResNet(4, num_filters=C, num_res_blocks=1, batch_norm=False,
                     dtype=torch.bfloat16).to(dev).eval()
    forms, stages, t = srresnet_tail_forms(model)
    x = features(args.batch, args.hw, model.dtype, dev)
    rows = []
    h = x
    with torch.inference_mode():
        for name, fn in stages:
            rows.append(measure(name, fn, h, t, args.runs, dev, card))
            if name in ("conv1+d2s+prelu", "conv2+d2s+prelu"):
                h = fn(h)
        for name in FORMS:
            label = "full_tail_production" if name == "production" else f"tail_{name}"
            rows.append(measure(label, forms[name], x, t, args.runs, dev, card))
        big = torch.randn(args.batch, 4 * C, 2 * args.hw, 2 * args.hw, device=dev).to(model.dtype)
        small = torch.randn(args.batch, 48, args.hw, args.hw, device=dev).to(model.dtype)
        for name, fn, y in (("d2s_only_256ch@2x", lambda y: depth_to_space_nchw(y, 2), big),
                            ("d2s4_only_48ch@LR", lambda y: depth_to_space_nchw(y, 4), small)):
            ms = cuda_ms(lambda: fn(y), runs=args.runs, dev=dev)
            rows.append(emit({"stage": name, "ms": ms, **rates(ms, nbytes=2 * y.numel()
                                                                * y.element_size(), dev=dev),
                              "shape": list(y.shape), "device": str(dev), "card": card}))
    return rows


if __name__ == "__main__":
    main()
