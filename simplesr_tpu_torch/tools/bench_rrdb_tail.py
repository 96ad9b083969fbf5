"""The RRDB (ESRGAN) x4 tail and its rewrites on the card, as
scripts/bench_rrdb_tail.py measures them on the TPU.

    python -m simplesr_tpu_torch.tools.bench_rrdb_tail [batch] [hw] [runs]
        [--device cpu]

RRDB's tail has, after the two subpixel stages (LeakyReLU 0.2 each), a
3 x 3 64 -> 64 conv at 4x (LeakyReLU) and a 3 x 3 float32 output conv. On
batch x hw x hw features (16 x 128 x 128 by default, the JAX script's), from
one seeded bf16 RRDBNet x4, it times five forms, each a function of its own
over the same weights and each the same function as ``RRDBNet.tail``:

- ``A_production``: the training form;
- ``B_poly_up_fine_hr``: the subpixel stages at LR, one depth_to_space(4),
  the HR and output convs at 4x (``RRDBNetPolyphase`` mode "up");
- ``C_full_coarse``: every conv at LR (mode "full");
- ``D_2phase_hybrid``: HR and output convs in 2-phase form at 2x (mode
  "2phase"; its channel split folded into PolyUp_2's weights);
- ``E_poly_up_fine_hr_coarse_out``: B with the output conv coarsened to LR
  after a space_to_depth(4);

and the HR and output convs alone. Each line has the keys of
``bench_upsample_tail`` (``ms``, executed ``flops``, structural
``zero_flops``, TFLOP/s). The run is on the card unless ``--device cpu`` is
given (the host's clock there).
"""

import argparse

import torch
import torch.nn.functional as F

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.models import RRDBNet
from simplesr_tpu_torch.models.polyphase import flax_tree, host, rrdb_polyphase_variables
from simplesr_tpu_torch.ops.polyphase import coarsen_conv_kernel, phase_split_permutation
from simplesr_tpu_torch.ops.shuffle import depth_to_space_nchw, space_to_depth_nchw
from simplesr_tpu_torch.tools.bench_timing import card_line
from simplesr_tpu_torch.tools.bench_upsample_tail import C, Tail, conv_w, features, finish, measure

FORMS = ("A_production", "B_poly_up_fine_hr", "C_full_coarse", "D_2phase_hybrid",
         "E_poly_up_fine_hr_coarse_out")


def lrelu(x):
    return F.leaky_relu(x, 0.2)


def rrdb_tail_forms(model):
    """{form: fn(NCHW features) -> (B, 4H, 4W, 3) float32} and {stage: fn}
    for a trained RRDBNet x4 ``model``, built from its tail's weights, and
    the ``Tail`` that runs their convs."""
    if model.upsample_factor != 4 or model.kernel_size != 3:
        raise ValueError("the tail forms are those of RRDBNet x4 with 3 x 3 convs")
    dev, c = next(model.parameters()).device, model.num_filters
    params = flax_tree(model.state_dict())["params"]
    t = Tail(model.dtype)
    f32 = torch.float32

    def cw(tree):
        return conv_w(host(tree["kernel"]), host(tree["bias"]), dev)

    up = [cw(params[f"SubpixelConvBlock_{i}"]["Conv_0"]) for i in (0, 1)]
    hr, out = cw(params["Conv_2"]), cw(params["Conv_3"])
    modes = {m: rrdb_polyphase_variables(model, {"params": params}, m)["params"]
             for m in ("up", "2phase", "full")}
    p_up1, p_up2 = cw(modes["up"]["PolyUp_1"]), cw(modes["up"]["PolyUp_2"])
    # 2-phase: PolyUp_2's output channels in the order depth_to_space(2)
    # needs, folded into its weights
    split = phase_split_permutation(2, 2, c)
    up2 = modes["2phase"]["PolyUp_2"]
    p_up2_split = conv_w(host(up2["kernel"])[..., split], host(up2["bias"])[split], dev)
    hr_2, out_2 = cw(modes["2phase"]["PolyHr"]), cw(modes["2phase"]["PolyOut"])
    hr_4, out_4 = cw(modes["full"]["PolyHr"]), cw(modes["full"]["PolyOut"])
    out_k, out_b = coarsen_conv_kernel(host(params["Conv_3"]["kernel"]), 4,
                                       host(params["Conv_3"]["bias"]))
    out_coarse = conv_w(out_k, out_b, dev)

    def poly_up(h, up2=p_up2):
        return lrelu(t.conv(lrelu(t.conv(h, p_up1)), up2))

    def a_production(h):
        for w in up:
            h = lrelu(depth_to_space_nchw(t.conv(h, w), 2))
        return finish(t.conv(lrelu(t.conv(h, hr)), out, f32))

    def b_poly_up_fine_hr(h):
        h = depth_to_space_nchw(poly_up(h), 4)
        return finish(t.conv(lrelu(t.conv(h, hr)), out, f32))

    def c_full_coarse(h):
        h = lrelu(t.conv(poly_up(h), hr_4))
        return finish(depth_to_space_nchw(t.conv(h, out_4, f32), 4))

    def d_2phase_hybrid(h):
        h = depth_to_space_nchw(poly_up(h, p_up2_split), 2)
        h = lrelu(t.conv(h, hr_2))
        return finish(depth_to_space_nchw(t.conv(h, out_2, f32), 2))

    def e_poly_up_fine_hr_coarse_out(h):
        h = lrelu(t.conv(depth_to_space_nchw(poly_up(h), 4), hr))
        return finish(depth_to_space_nchw(t.conv(space_to_depth_nchw(h, 4), out_coarse, f32),
                                          4))

    forms = dict(zip(FORMS, (a_production, b_poly_up_fine_hr, c_full_coarse, d_2phase_hybrid,
                             e_poly_up_fine_hr_coarse_out)))
    stages = [("hr_conv_64to64@4x", lambda h: lrelu(t.conv(h, hr))),
              ("out_conv_64to3@4x", lambda h: torch.tanh(t.conv(h, out, f32)))]
    return forms, stages, t


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
    model = RRDBNet(4, num_filters=C, num_rrdb_blocks=1, dtype=torch.bfloat16).to(dev).eval()
    forms, stages, t = rrdb_tail_forms(model)
    x = features(args.batch, args.hw, model.dtype, dev)
    rows = [measure(name, forms[name], x, t, args.runs, dev, card) for name in FORMS]
    hr_in = features(args.batch, 4 * args.hw, model.dtype, dev, seed=1)
    rows += [measure(name, fn, hr_in, t, args.runs, dev, card) for name, fn in stages]
    return rows


if __name__ == "__main__":
    main()
