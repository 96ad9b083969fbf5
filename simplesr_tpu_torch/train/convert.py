"""Carrying variables between simplesr_tpu's (flax) layout and the port's
modules.

``from_flax_variables`` maps the nested ``{"params", "batch_stats"}`` tree of
an SRResNet to a ``state_dict`` of ``models.SRResNet``: module names follow a
fixed table, conv kernels go from HWIO to OIHW, BatchNorm's scale / bias /
mean / var become weight / bias / running_mean / running_var.
``to_flax_variables`` is its inverse, with every map's keys in sorted order
(``batch_stats`` before ``params``), as ``jax.device_get`` hands a tree back
and so as simplesr_tpu's ``save_model`` writes it.
"""

import re

import numpy as np
import torch

# flax module name -> (torch name, kind of the module)
_TOP = [
    (r"ConvLayer_0", "head", "conv_layer"),
    (r"PReLU_0", "head_act", "prelu"),
    (r"ResBlock_(\d+)", r"blocks.\1", "res_block"),
    (r"ConvLayer_1", "trunk_out", "conv_layer"),
    (r"SubpixelConvBlock_(\d+)", r"upsample.\1", "subpixel"),
    (r"Conv_0", "out", "conv"),
]
_CHILDREN = {
    "conv_layer": {"Conv_0": ("conv", "conv"), "BatchNorm_0": ("bn", "bn")},
    "res_block": {"ConvLayer_0": ("conv1", "conv_layer"), "PReLU_0": ("act", "prelu"),
                  "ConvLayer_1": ("conv2", "conv_layer")},
    "subpixel": {"Conv_0": ("conv", "conv"), "PReLU_0": ("act", "prelu")},
}
_LEAVES = {
    "conv": {"kernel": "weight", "bias": "bias"},
    "bn": {"scale": "weight", "bias": "bias", "mean": "running_mean",
           "var": "running_var"},
    "prelu": {"alpha": "alpha"},
}


def _tensor(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().clone()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX hands it out
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _top(name):
    for pattern, torch_name, kind in _TOP:
        if re.fullmatch(pattern, name):
            return re.sub(pattern, torch_name, name), kind
    raise KeyError(f"unknown SRResNet module {name!r}")


def _walk(tree, prefix, kind, out):
    if kind in _LEAVES:
        for leaf_name, leaf in tree.items():
            if leaf_name not in _LEAVES[kind]:
                raise KeyError(f"unknown {kind} variable {prefix}{leaf_name}")
            t = _tensor(leaf)
            if kind == "conv" and leaf_name == "kernel":
                t = t.permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
            out[prefix + _LEAVES[kind][leaf_name]] = t
        return
    for name, sub in tree.items():
        if name not in _CHILDREN[kind]:
            raise KeyError(f"unknown {kind} submodule {prefix}{name}")
        torch_name, sub_kind = _CHILDREN[kind][name]
        _walk(sub, f"{prefix}{torch_name}.", sub_kind, out)


def from_flax_variables(variables):
    """An SRResNet's flax variables -> the port's ``state_dict`` (CPU
    tensors in the leaves' dtypes)."""
    state = {}
    for collection in ("params", "batch_stats"):
        for name, sub in variables.get(collection, {}).items():
            torch_name, kind = _top(name)
            _walk(sub, torch_name + ".", kind, state)
    for key in [k for k in state if k.endswith(".running_mean")]:
        state[key[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return state


_BATCH_STATS = {"running_mean", "running_var"}


def _numpy_or_tensor(t):
    """A CPU copy: numpy where numpy has the dtype, else (bfloat16) a tensor."""
    t = t.detach().cpu().contiguous()
    return t.clone() if t.dtype == torch.bfloat16 else t.numpy().copy()


def _flax_top(parts):
    """The flax name and kind of the top-level module that a split
    state-dict key starts with, and the rest of the key."""
    for pattern, torch_name, kind in _TOP:
        if torch_name.endswith(r".\1"):  # an indexed module: blocks.i, upsample.i
            if parts[0] == torch_name[:-3] and len(parts) > 1 and parts[1].isdigit():
                return pattern.replace(r"(\d+)", parts[1]), kind, parts[2:]
        elif parts[0] == torch_name:
            return pattern, kind, parts[1:]
    return None, None, None


def _flax_path(name):
    """A state-dict key -> (collection, path of flax names), or None for a
    key that flax does not keep (BatchNorm's num_batches_tracked)."""
    if name.endswith(".num_batches_tracked"):
        return None
    top, kind, rest = _flax_top(name.split("."))
    path = [top]
    while top is not None and kind not in _LEAVES and rest:
        flax_child = {t: (f, k) for f, (t, k) in _CHILDREN[kind].items()}.get(rest[0])
        if flax_child is None:
            break
        path.append(flax_child[0])
        kind, rest = flax_child[1], rest[1:]
    leaves = {v: k for k, v in _LEAVES.get(kind, {}).items()}
    if top is None or len(rest) != 1 or rest[0] not in leaves:
        raise KeyError(f"unknown SRResNet parameter {name!r}")
    return ("batch_stats" if rest[0] in _BATCH_STATS else "params"), path + [leaves[rest[0]]]


def _sorted(tree):
    return {k: _sorted(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def to_flax_variables(state_dict):
    """The port's SRResNet ``state_dict`` -> flax's ``{"batch_stats": ...,
    "params": ...}`` tree (the former only when there is BatchNorm),
    leaves as CPU numpy arrays (bfloat16 ones as tensors), conv kernels HWIO."""
    variables = {"params": {}, "batch_stats": {}}
    for name, t in state_dict.items():
        where = _flax_path(name)
        if where is None:
            continue
        collection, path = where
        if name.endswith("conv.weight") or name == "out.weight":
            t = t.permute(2, 3, 1, 0)  # OIHW -> HWIO
        node = variables[collection]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _numpy_or_tensor(t)
    if not variables["batch_stats"]:
        del variables["batch_stats"]
    return _sorted(variables)
