"""The paired serving form of SRResNet and RRDB, as
simplesr_tpu.models.paired.

``SRResNetPaired`` packs ``ways`` consecutive batch items into the channel
dimension for the head and the residual trunk, which then run at
``ways * num_filters`` channels with block-diagonally expanded kernels
(``ops/pairing.py``), and unpacks back to the real batch for the tail. The
rewrite is exact: convolution is linear, block-diagonal kernels keep the
streams apart, and per-channel parameters tile. ``SRResNetPairedPolyphase``
adds the polyphase tail (``models/polyphase.py``); ``RRDBNetPaired`` pairs
RRDB's trunk, its dense convs with segment-aware kernels, and keeps its
training-form tail.

The packed trunk is computed as the JAX package computes it: at w = 2 a
128-wide trunk, which runs the ResBlock modules (cuDNN) as every 128-wide
model does; the trunk kernel takes C = 64 only. Inference only: a module in
training mode or called with grad enabled raises (BatchNorm would mix the
packed streams). The batch must be divisible by ``ways``; the predictors of
``eval.evaluation`` pad it.
"""

import numpy as np
import torch
import torch.nn as nn

from simplesr_tpu_torch.models.blocks import ConvLayer, PReLU, he_conv
from simplesr_tpu_torch.models.polyphase import (SRResNetPolyphase, flax_tree, host,
                                                 load_transformed, polyphase_model,
                                                 rrdb_config, srresnet_config)
from simplesr_tpu_torch.models.rrdb import RRDBBlock, RRDBNet
from simplesr_tpu_torch.models.srresnet import ResBlock, SRResNet
from simplesr_tpu_torch.ops.pairing import (blockdiag_kernel_segmented, pack_batch,
                                            pair_param_tree, unpack_batch)

__all__ = ["SRResNetPaired", "SRResNetPairedPolyphase", "paired_variables", "paired_model",
           "RRDBNetPaired", "rrdb_paired_variables", "rrdb_paired_model"]

_TRUNK_PREFIXES = ("ConvLayer_", "PReLU_", "ResBlock_")


def _inference_only(module):
    if module.training or torch.is_grad_enabled():
        raise ValueError("paired variants are inference-only (BatchNorm would mix packed "
                         "streams): call them in eval mode under torch.inference_mode()")


def _unpacked(h, ways):
    """NCHW packed features -> NCHW features of the real batch."""
    return unpack_batch(h.permute(0, 2, 3, 1), ways).permute(0, 3, 1, 2)


class SRResNetPaired(SRResNet):
    """SRResNet with ``ways`` batch items packed into trunk channels. Takes
    SRResNet's arguments by keyword."""

    def __init__(self, ways=2, **kwargs):
        super().__init__(**kwargs)
        self.ways = ways
        wide = ways * self.num_filters
        self.head = ConvLayer(3 * ways, wide, 9, dtype=self.dtype)
        self.head_act = PReLU(wide)
        self.blocks = nn.ModuleList(
            ResBlock(wide, self.momentum, self.batch_norm, self.dtype)
            for _ in range(self.num_res_blocks))
        self.trunk_out = ConvLayer(wide, wide, 3, self.batch_norm, self.momentum, self.dtype)
        self.uses_trunk_kernel = False  # the kernel takes C = 64

    def forward(self, x):
        _inference_only(self)
        h = self.features(pack_batch(x, self.ways))
        return self.tail(_unpacked(h, self.ways))


class SRResNetPairedPolyphase(SRResNetPaired, SRResNetPolyphase):
    """Paired trunk and polyphase tail: ``forward`` from SRResNetPaired,
    ``tail`` from SRResNetPolyphase."""


def paired_variables(variables, ways=2):
    """Trained SRResNet (or SRResNetPolyphase) variables, a flax-layout
    tree, expanded for the paired trunk: trunk kernels block-diagonal, trunk
    vectors tiled, the tail unchanged; weight space, host side, exact."""
    out = dict(variables)
    out["params"] = {k: (pair_param_tree(_host_tree(v), ways)
                         if k.startswith(_TRUNK_PREFIXES) else v)
                     for k, v in variables["params"].items()}
    if variables.get("batch_stats"):  # only under the trunk's ConvLayers and ResBlocks
        out["batch_stats"] = pair_param_tree(_host_tree(variables["batch_stats"]), ways)
    return out


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return host(tree)


def paired_model(model, state=None, ways=2, polyphase=True):
    """(paired module with the converted weights, its state_dict) for a
    trained SRResNet and its ``state_dict``; with ``polyphase`` (the
    default) also the polyphase tail. An SRResNetPolyphase is paired as it
    is."""
    state = model.state_dict() if state is None else state
    if type(model) is SRResNet:
        if not polyphase:
            paired = SRResNetPaired(ways=ways, **srresnet_config(model))
            return load_transformed(paired, paired_variables(flax_tree(state), ways), model)
        model, state = polyphase_model(model, state)
    if type(model) is not SRResNetPolyphase:
        raise TypeError(f"paired trunk supports SRResNet/SRResNetPolyphase, got {type(model)}")
    paired = SRResNetPairedPolyphase(ways=ways, out_dtype=model.out_dtype,
                                     **srresnet_config(model))
    return load_transformed(paired, paired_variables(flax_tree(state), ways), model)


class RRDBNetPaired(RRDBNet):
    """RRDB / ESRGAN with ``ways`` batch items packed into trunk channels.
    Takes RRDBNet's arguments by keyword."""

    def __init__(self, ways=2, **kwargs):
        super().__init__(**kwargs)
        self.ways = ways
        wide = ways * self.num_filters
        growth = None if self.growth_channels is None else ways * self.growth_channels
        self.Conv_0 = he_conv(3 * ways, wide, 3)
        for i in range(self.num_rrdb_blocks):
            setattr(self, f"RRDBBlock_{i}", RRDBBlock(
                self.num_dense_blocks, self.num_convs, wide, self.kernel_size,
                self.residual_scaling, self.dtype, growth))
        self.Conv_1 = he_conv(wide, wide, self.kernel_size)

    def forward(self, x):
        _inference_only(self)
        h = self.features(pack_batch(x, self.ways))
        return self.tail(_unpacked(h, self.ways))


def _pair_conv(leaf, ways, segments):
    return {"kernel": blockdiag_kernel_segmented(host(leaf["kernel"]), ways, segments),
            "bias": np.tile(host(leaf["bias"]), ways)}


def rrdb_paired_variables(model, variables, ways=2):
    """Trained RRDBNet variables (a flax-layout tree) expanded for the
    paired trunk: head and post-trunk convs block-diagonal, each dense conv
    with the concatenation's segments ([C] + k * [g]), the tail unchanged."""
    c = model.num_filters
    g = model.growth_channels or c // 2
    nc = model.num_convs
    new_params = {}
    for name, sub in variables["params"].items():
        if name in ("Conv_0", "Conv_1"):  # head (3 -> C), post-trunk (C -> C)
            new_params[name] = _pair_conv(sub, ways, [host(sub["kernel"]).shape[2]])
        elif name.startswith("RRDBBlock_"):
            new_params[name] = {
                dname: {f"Conv_{i}": _pair_conv(dsub[f"Conv_{i}"], ways, [c] + [g] * i)
                        for i in range(nc + 1)}
                for dname, dsub in sub.items()}
        else:  # the tail: SubpixelConvBlock_*, Conv_2, Conv_3
            new_params[name] = sub
    return {**variables, "params": new_params}


def rrdb_paired_model(model, state=None, ways=2):
    """(RRDBNetPaired with the converted weights, its state_dict) for a
    trained RRDBNet and its ``state_dict``."""
    if type(model) is not RRDBNet:
        raise TypeError(f"rrdb pairing supports RRDBNet, got {type(model)}")
    state = model.state_dict() if state is None else state
    paired = RRDBNetPaired(ways=ways, **rrdb_config(model))
    return load_transformed(paired, rrdb_paired_variables(model, flax_tree(state), ways),
                            model)
