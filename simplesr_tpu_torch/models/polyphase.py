"""The polyphase serving form of SRResNet and RRDB, as
simplesr_tpu.models.polyphase.

``SRResNetPolyphase`` is an exact reparameterisation of a trained SRResNet
for inference. Head and trunk are the training form's modules (``features``,
with the trunk kernel through ``TrunkFunction`` for a BN-free bf16 model of
64 filters, BatchNorm statistics for a BN one); the subpixel tail and the
9 x 9 output conv are rewritten in weight space (``ops/polyphase.py``) so that
every tail conv runs at LR resolution on the DCR phase tensor, with one
depth_to_space at the end. ``PolyUp_{s}`` is one 3 x 3 conv at LR producing
the (2s)-phase tensor directly, ``PolyPReLU_{s}`` its phase-tiled PReLU,
``PolyOut`` the coarsened output conv. The JAX package serves SRResNet in
this form by default (``fast=True``).

``RRDBNetPolyphase`` rewrites RRDB's tail in three modes: "up" (the subpixel
stages coarse, one depth_to_space, HR and output convs at HR), "2phase" (the
HR and output convs in 2-phase form at half the HR resolution) and "full"
(everything at LR). ``fast_inference`` leaves RRDB in its training form, as
the JAX package does.

Modules are named as flax names them, so ``train.convert`` carries the
transformed variables over by name. The transforms work on flax-layout trees
(HWIO kernels) of host arrays, as the JAX package's do; ``*_model`` and
``fast_inference`` take a module and its ``state_dict`` and give the new
module, with its weights loaded, on the module's device and in eval mode,
and its ``state_dict``. Output NHWC float32 in [-1, 1], as the training
form's.
"""

import numpy as np
import torch
import torch.nn.functional as F

from simplesr_tpu_torch.core.dtypes import OUTPUT_CONV_TF32
from simplesr_tpu_torch.models.blocks import PReLU, conv2d, glorot_conv, he_conv, pinned_conv2d
from simplesr_tpu_torch.models.rrdb import RRDBNet
from simplesr_tpu_torch.models.srresnet import SRResNet
from simplesr_tpu_torch.ops.polyphase import (coarsen_conv_kernel, phase_merge_permutation,
                                              phase_split_permutation, tile_phase)
from simplesr_tpu_torch.ops.shuffle import depth_to_space_nchw

__all__ = ["SRResNetPolyphase", "polyphase_variables", "polyphase_model",
           "RRDBNetPolyphase", "rrdb_polyphase_variables", "rrdb_polyphase_model",
           "fast_inference", "srresnet_config", "rrdb_config", "load_transformed", "flax_tree"]

RRDB_MODES = ("up", "2phase", "full")


def srresnet_config(model):
    """The constructor arguments of an SRResNet (or a subclass)."""
    return {"upsample_factor": model.upsample_factor, "num_filters": model.num_filters,
            "num_res_blocks": model.num_res_blocks, "momentum": model.momentum,
            "batch_norm": model.batch_norm, "dtype": model.dtype}


def rrdb_config(model):
    """The constructor arguments of an RRDBNet (or a subclass), but remat."""
    return {"upsample_factor": model.upsample_factor, "num_filters": model.num_filters,
            "num_rrdb_blocks": model.num_rrdb_blocks,
            "num_dense_blocks": model.num_dense_blocks, "num_convs": model.num_convs,
            "kernel_size": model.kernel_size, "residual_scaling": model.residual_scaling,
            "dtype": model.dtype, "growth_channels": model.growth_channels}


def host(leaf):
    """A variable as a numpy array (a bfloat16 tensor as float32, which
    holds its values exactly)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        return (leaf.float() if leaf.dtype == torch.bfloat16 else leaf).numpy()
    return np.asarray(leaf)


def load_transformed(module, variables, like):
    """``module`` given the flax-layout ``variables``, on ``like``'s device,
    in eval mode; returns (module, its state_dict)."""
    from simplesr_tpu_torch.train.convert import from_flax_variables

    state = from_flax_variables(module, variables)
    module.load_state_dict(state)
    device = next(like.parameters()).device
    return module.to(device).eval(), state


def flax_tree(state):
    """A module's ``state_dict`` as a flax-layout tree of host arrays."""
    from simplesr_tpu_torch.train.convert import to_flax_variables

    return to_flax_variables(state)


class SRResNetPolyphase(SRResNet):
    """SRResNet with the subpixel tail rewritten in phase space; inference
    only. ``out_dtype`` is the coarse output conv's dtype: float32 (the
    default) runs it as the training form runs its output conv
    (``blocks.pinned_conv2d`` at ``OUTPUT_CONV_TF32``), bfloat16 like the
    rest of the tail."""

    def __init__(self, upsample_factor=4, num_filters=64, num_res_blocks=16, momentum=0.8,
                 batch_norm=True, dtype=torch.bfloat16, out_dtype=torch.float32):
        super().__init__(upsample_factor, num_filters, num_res_blocks, momentum, batch_norm,
                         dtype)
        del self.upsample, self.out
        self.out_dtype = out_dtype
        c, s = num_filters, 1
        while s < upsample_factor:
            self.add_module(f"PolyUp_{s}", glorot_conv(s * s * c, 4 * s * s * c, 3))
            self.add_module(f"PolyPReLU_{s}", PReLU(4 * s * s * c))
            s *= 2
        self.add_module("PolyOut", glorot_conv(s * s * c, 3 * s * s, 3 if s > 2 else 5))

    def poly_up(self, h, s):
        """``PolyUp_{s}`` and ``PolyPReLU_{s}`` on the s-phase tensor."""
        up = getattr(self, f"PolyUp_{s}")
        return getattr(self, f"PolyPReLU_{s}")(conv2d(h, up.weight, up.bias, self.dtype))

    def poly_out(self, h):
        """``PolyOut`` in ``out_dtype`` on the final phase tensor."""
        out = self.PolyOut
        if self.out_dtype == torch.float32:
            return pinned_conv2d(h, out.weight, out.bias, OUTPUT_CONV_TF32)
        return conv2d(h, out.weight, out.bias, self.out_dtype)

    def tail(self, h):
        s = 1
        while s < self.upsample_factor:
            h = self.poly_up(h, s)
            s *= 2
        h = depth_to_space_nchw(self.poly_out(h), s)
        return torch.tanh(h.float()).permute(0, 2, 3, 1).contiguous()


def polyphase_variables(model, variables):
    """Trained SRResNet variables (a flax-layout tree) -> SRResNetPolyphase
    variables; weight space, host side, exact. ``model`` gives the width and
    scale."""
    params = variables["params"]
    c, scale = model.num_filters, model.upsample_factor
    new_params = {k: v for k, v in params.items()
                  if not k.startswith("SubpixelConvBlock_") and k != "Conv_0"}
    s, idx = 1, 0
    while s < scale:
        block = params[f"SubpixelConvBlock_{idx}"]
        kc, bc = coarsen_conv_kernel(host(block["Conv_0"]["kernel"]), s,
                                     host(block["Conv_0"]["bias"]))
        perm = phase_merge_permutation(s, 2, c)
        new_params[f"PolyUp_{s}"] = {"kernel": kc[..., perm], "bias": bc[perm]}
        new_params[f"PolyPReLU_{s}"] = {
            "alpha": tile_phase(host(block["PReLU_0"]["alpha"]), 2 * s)}
        s, idx = s * 2, idx + 1
    out = params["Conv_0"]
    kc, bc = coarsen_conv_kernel(host(out["kernel"]), scale, host(out["bias"]))
    new_params["PolyOut"] = {"kernel": kc, "bias": bc}
    return {**variables, "params": new_params}


def polyphase_model(model, state=None, out_dtype=torch.float32):
    """(SRResNetPolyphase with the converted weights, its state_dict) for a
    trained SRResNet and its ``state_dict`` (the module's own when None).
    Raises TypeError for other generators."""
    if type(model) is not SRResNet:
        raise TypeError(f"polyphase tail supports SRResNet, got {type(model)}")
    state = model.state_dict() if state is None else state
    poly = SRResNetPolyphase(**srresnet_config(model), out_dtype=out_dtype)
    return load_transformed(poly, polyphase_variables(model, flax_tree(state)), model)


class RRDBNetPolyphase(RRDBNet):
    """RRDB / ESRGAN with the upsample tail rewritten in phase space, in
    ``mode`` "up", "2phase" or "full" (at scale 2, "2phase" is "full");
    inference only."""

    def __init__(self, upsample_factor=4, num_filters=64, num_rrdb_blocks=16,
                 num_dense_blocks=3, num_convs=4, kernel_size=3, residual_scaling=0.2,
                 dtype=torch.bfloat16, growth_channels=None, mode="up"):
        if mode not in RRDB_MODES:
            raise ValueError(f"unknown polyphase mode {mode!r}")
        super().__init__(upsample_factor, num_filters, num_rrdb_blocks, num_dense_blocks,
                         num_convs, kernel_size, residual_scaling, dtype, growth_channels)
        for i in range(self.num_upsample):
            delattr(self, f"SubpixelConvBlock_{i}")
        del self.Conv_2, self.Conv_3
        self.mode = mode
        self.effective_mode = "full" if (mode == "2phase" and upsample_factor == 2) else mode
        c, s = num_filters, 1
        while s < upsample_factor:
            self.add_module(f"PolyUp_{s}", he_conv(s * s * c, 4 * s * s * c, 3))
            s *= 2
        if self.effective_mode == "full":
            hr_c, out_c, self.final = s * s * c, s * s * 3, s
        elif self.effective_mode == "2phase":
            hr_c, out_c, self.final = 4 * c, 4 * 3, 2
            self.split = torch.from_numpy(phase_split_permutation(s // 2, 2, c))
        else:
            hr_c, out_c, self.final = c, 3, 1
        self.PolyHr = he_conv(hr_c, hr_c, 3)
        self.PolyOut = he_conv(hr_c, out_c, 3)

    def tail(self, h):
        scale, s = self.upsample_factor, 1
        while s < scale:
            up = getattr(self, f"PolyUp_{s}")
            h = F.leaky_relu(conv2d(h, up.weight, up.bias, self.dtype), 0.2)
            s *= 2
        if self.effective_mode == "2phase":
            h = depth_to_space_nchw(h.index_select(1, self.split.to(h.device)), scale // 2)
        elif self.effective_mode == "up":
            h = depth_to_space_nchw(h, scale)
        h = F.leaky_relu(conv2d(h, self.PolyHr.weight, self.PolyHr.bias, self.dtype), 0.2)
        h = pinned_conv2d(h, self.PolyOut.weight, self.PolyOut.bias, OUTPUT_CONV_TF32)
        if self.final > 1:
            h = depth_to_space_nchw(h, self.final)
        return torch.tanh(h).permute(0, 2, 3, 1).contiguous()


def rrdb_polyphase_variables(model, variables, mode="up"):
    """Trained RRDBNet variables (a flax-layout tree) -> RRDBNetPolyphase
    variables; weight space, host side, exact."""
    params = variables["params"]
    c, scale = model.num_filters, model.upsample_factor
    new_params = {k: v for k, v in params.items()
                  if not k.startswith("SubpixelConvBlock_") and k not in ("Conv_2", "Conv_3")}
    s, idx = 1, 0
    while s < scale:
        block = params[f"SubpixelConvBlock_{idx}"]["Conv_0"]
        kc, bc = coarsen_conv_kernel(host(block["kernel"]), s, host(block["bias"]))
        perm = phase_merge_permutation(s, 2, c)
        new_params[f"PolyUp_{s}"] = {"kernel": kc[..., perm], "bias": bc[perm]}
        s, idx = s * 2, idx + 1
    eff = "full" if (mode == "2phase" and scale == 2) else mode
    coarse_at = {"up": 1, "2phase": 2, "full": scale}[eff]
    for src, dst in (("Conv_2", "PolyHr"), ("Conv_3", "PolyOut")):
        kern, bias = host(params[src]["kernel"]), host(params[src]["bias"])
        if coarse_at == 1:
            new_params[dst] = {"kernel": kern, "bias": bias}
        else:
            kc, bc = coarsen_conv_kernel(kern, coarse_at, bias)
            new_params[dst] = {"kernel": kc, "bias": bc}
    return {**variables, "params": new_params}


def rrdb_polyphase_model(model, state=None, mode="up"):
    """(RRDBNetPolyphase with the converted weights, its state_dict) for a
    trained RRDBNet and its ``state_dict`` (the module's own when None)."""
    if type(model) is not RRDBNet:
        raise TypeError(f"rrdb polyphase supports RRDBNet, got {type(model)}")
    if model.kernel_size != 3:
        raise ValueError("rrdb polyphase tail assumes 3x3 HR/out convs "
                         f"(got kernel_size={model.kernel_size})")
    state = model.state_dict() if state is None else state
    poly = RRDBNetPolyphase(**rrdb_config(model), mode=mode)
    return load_transformed(poly, rrdb_polyphase_variables(model, flax_tree(state), mode),
                            model)


def fast_inference(module, state=None, paired_ways=0, polyphase=True):
    """The serving form of a trained generator, as the JAX package picks
    it: SRResNet -> the polyphase tail, or with ``paired_ways`` the paired
    trunk (with the polyphase tail unless ``polyphase=False``); RRDB ->
    unchanged unless paired (then the paired trunk, training-form tail);
    anything else unchanged. Returns (module, state_dict)."""
    state = module.state_dict() if state is None else state
    if type(module) is SRResNet:
        if paired_ways:
            from simplesr_tpu_torch.models.paired import paired_model
            return paired_model(module, state, ways=paired_ways, polyphase=polyphase)
        return polyphase_model(module, state)
    if type(module) is RRDBNet and paired_ways:
        from simplesr_tpu_torch.models.paired import rrdb_paired_model
        return rrdb_paired_model(module, state, ways=paired_ways)
    return module, state
