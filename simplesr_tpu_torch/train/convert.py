"""Carrying variables between simplesr_tpu's (flax) layout and the port's
modules.

A ``state_dict`` key names its flax variable: each dotted part is a flax
module name, after the aliases below for the SRResNet's and the blocks'
own names (``blocks.3.conv2.conv.weight`` is ``ResBlock_3/ConvLayer_1/
Conv_0/kernel``). The RRDB generator, the discriminator, VGG and the serving
forms' tails name their modules as flax does (``RRDBBlock_0.DenseBlock_1.
Conv_2``, ``Dense_0``, ``block5_conv4``, ``PolyUp_2``, ``PolyPReLU_1``,
``PolyOut``, ``PolyHr``), and the paired forms keep the trained model's
names at the wider shapes. Conv kernels go HWIO <-> OIHW and Dense kernels
(in, out) <-> (out, in); BatchNorm's scale / bias / mean / var are weight /
bias / running_mean / running_var. ``to_flax_variables`` writes every map's
keys in sorted order (``batch_stats`` before ``params``), as
``jax.device_get`` hands a tree back and so as simplesr_tpu's
``save_model`` writes it.
"""

import numpy as np
import torch

# the port's module names -> flax's
_ALIASES = {"head": "ConvLayer_0", "head_act": "PReLU_0", "trunk_out": "ConvLayer_1",
            "out": "Conv_0", "conv1": "ConvLayer_0", "conv2": "ConvLayer_1",
            "conv": "Conv_0", "bn": "BatchNorm_0", "act": "PReLU_0"}
# a list of the port's modules -> the prefix of flax's numbered names
_INDEXED = {"blocks": "ResBlock_", "upsample": "SubpixelConvBlock_"}
# state-dict leaf -> (flax collection, flax leaf), by the tensor's rank
_LEAVES = {"bias": ("params", "bias"), "alpha": ("params", "alpha"),
           "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def _flax_path(key, ndim):
    """A state-dict key and its tensor's rank -> (collection, flax path), or
    None for a key that flax does not keep (BatchNorm's
    num_batches_tracked)."""
    *parts, leaf = key.split(".")
    if leaf == "num_batches_tracked":
        return None
    if leaf == "weight":  # BatchNorm's scale (rank 1), else a conv or Dense kernel
        where = ("params", "scale" if ndim == 1 else "kernel")
    elif leaf in _LEAVES:
        where = _LEAVES[leaf]
    else:
        raise KeyError(f"no flax variable for {key!r}")
    path, i = [], 0
    while i < len(parts):
        if parts[i] in _INDEXED and i + 1 < len(parts) and parts[i + 1].isdigit():
            path.append(_INDEXED[parts[i]] + parts[i + 1])
            i += 2
        else:
            path.append(_ALIASES.get(parts[i], parts[i]))
            i += 1
    return where[0], path + [where[1]]


def _tensor(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().clone()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX hands it out
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _numpy_or_tensor(t):
    """A CPU copy: numpy where numpy has the dtype, else (bfloat16) a tensor."""
    t = t.detach().cpu().contiguous()
    return t.clone() if t.dtype == torch.bfloat16 else t.numpy().copy()


def _leaves(tree, prefix):
    """The paths of a tree's leaves (an empty map below the collections
    counts as one)."""
    if not tree and len(prefix) > 1:
        yield prefix
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,)


def from_flax_variables(module, variables):
    """``module``'s ``state_dict`` (CPU tensors in the leaves' dtypes) from
    flax ``variables``. Every variable of the tree must belong to the
    module, and every one of the module must be in the tree."""
    state, used, own = {}, set(), module.state_dict()
    for key, like in own.items():
        where = _flax_path(key, like.dim())
        if where is None:
            continue
        collection, path = where
        node = variables.get(collection, {})
        for name in path:
            node = node.get(name) if isinstance(node, dict) else None
        if node is None or isinstance(node, dict):
            raise KeyError(f"{collection}/{'/'.join(path)} is missing for "
                           f"{type(module).__name__}")
        t = _tensor(node)
        if t.dim() == 4:
            t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
        elif t.dim() == 2:
            t = t.t()  # (in, out) -> (out, in)
        state[key] = t.contiguous()
        used.add((collection, *path))
        counter = key[:-len("running_mean")] + "num_batches_tracked"
        if key.endswith(".running_mean") and counter in own:
            state[counter] = torch.tensor(0)
    extra = [p for c, tree in variables.items() for p in _leaves(tree, (c,)) if p not in used]
    if extra:
        raise KeyError(f"variables not used by {type(module).__name__}: "
                       f"{['/'.join(p) for p in extra[:5]]}")
    return state


def _sorted(tree):
    return {k: _sorted(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def to_flax_variables(state_dict):
    """A port module's ``state_dict`` -> flax's ``{"batch_stats": ...,
    "params": ...}`` tree (the former only when there is BatchNorm), leaves
    as CPU numpy arrays (bfloat16 ones as tensors)."""
    variables = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        where = _flax_path(key, t.dim())
        if where is None:
            continue
        collection, path = where
        if t.dim() == 4:
            t = t.permute(2, 3, 1, 0)  # OIHW -> HWIO
        elif t.dim() == 2:
            t = t.t()
        node = variables[collection]
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = _numpy_or_tensor(t)
    if not variables["batch_stats"]:
        del variables["batch_stats"]
    return _sorted(variables)
