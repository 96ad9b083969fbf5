"""FSDP (ZeRO-3) state sharding, as simplesr_tpu.parallel.fsdp: every large
parameter, its optimizer moments and its EMA shadow held at 1/N per rank
of the data axis instead of replicated.

The rule is the JAX package's, applied in flax's layouts so that the same
logical axis is split: a leaf under ``MIN_SHARD_ELEMS`` elements stays
replicated; otherwise the largest axis that the axis size divides is split
(ties to the last, a conv kernel's output channels); nothing under a
``SubpixelConvBlock`` is split (the JAX package keeps the pixel-shuffle tail
replicated because its channel split cannot cross the depth_to_space
reshape; the port keeps the rule, so that both packages shard the same
leaves). ``param_spec`` maps the chosen flax axis back onto the port's
layout (conv weights OIHW, where flax's are HWIO).

``ZeroShards`` is the ZeRO-3 runtime, at the model's granularity: between
steps the module's sharded parameters hold nothing and each rank keeps its
shard; ``gather`` rebuilds the whole parameters for a forward and its
backward (the trunk kernel packs them there, inside the forward;
``release`` drops the packed copy together with the whole parameters),
``reduce_shard`` turns each rank's whole gradients into the rank's slices
of their mean (one reduce-scatter for the sharded parameters, one all-reduce
for the replicated ones), and the optimizer, its accumulator and the EMA
update the shards.
"""

import numpy as np
import torch

from simplesr_tpu_torch.parallel.comm import (all_gather_cat, all_reduce_many_,
                                              reduce_scatter_)
from simplesr_tpu_torch.parallel.mesh import DATA_AXIS

__all__ = ["MIN_SHARD_ELEMS", "leaf_spec", "param_spec", "state_shardings", "shard_count",
           "ZeroShards"]

# leaves smaller than this stay replicated: sharding a PReLU alpha or a BN
# vector buys nothing and costs a gather
MIN_SHARD_ELEMS = 2 ** 11

_REPLICATE_PATH_FRAGMENTS = ("SubpixelConvBlock",)


def leaf_spec(shape, axis_size, axis=DATA_AXIS, min_elems=MIN_SHARD_ELEMS):
    """The JAX package's rule for one array: a spec tuple naming ``axis`` at
    the largest dim that ``axis_size`` divides (ties: the last such dim), or
    ``()`` (replicated) when no dim divides or the leaf is small."""
    if int(np.prod(shape, dtype=np.int64)) < min_elems:
        return ()
    best = None
    for d, n in enumerate(shape):
        if n % axis_size == 0 and (best is None or n >= shape[best]):
            best = d
    if best is None:
        return ()
    return (None,) * best + (axis,)


def _flax_dims(ndim):
    """For each dim of flax's layout, the port's dim it holds: conv kernels
    HWIO <- OIHW, Dense kernels (in, out) <- (out, in)."""
    return {4: (2, 3, 1, 0), 2: (1, 0)}.get(ndim, tuple(range(ndim)))


def param_spec(name, shape, axis_size, axis=DATA_AXIS, min_elems=MIN_SHARD_ELEMS):
    """The spec of the port's parameter ``name`` of ``shape``: the JAX
    rule on flax's layout, mapped back to the port's dims."""
    from simplesr_tpu_torch.train.convert import _flax_path

    where = _flax_path(name, len(shape))
    if where is None or any(frag in part for part in where[1]
                            for frag in _REPLICATE_PATH_FRAGMENTS):
        return ()
    dims = _flax_dims(len(shape))
    spec = leaf_spec(tuple(shape[d] for d in dims), axis_size, axis, min_elems)
    if not spec:
        return ()
    port_dim = dims[len(spec) - 1]
    return (None,) * port_dim + (axis,)


def state_shardings(mesh_axis_size, named_tensors, axis=DATA_AXIS):
    """{name: spec} for named tensors (a module's ``named_parameters``):
    floating tensors under ``param_spec``, others replicated."""
    return {name: param_spec(name, t.shape, mesh_axis_size, axis)
            if t.is_floating_point() else ()
            for name, t in named_tensors}


def shard_count(shardings):
    """How many leaves are sharded (diagnostics and tests)."""
    return sum(any(s is not None for s in spec) for spec in shardings.values())


def _dim(spec):
    return len(spec) - 1 if spec else None


class ZeroShards:
    """The ZeRO-3 state of a module's ``params`` (named ``names``) over a
    data axis of ``size`` ranks (``group``, this rank ``index``)."""

    def __init__(self, module, names, params, group, size, index, axis=DATA_AXIS):
        self.module, self.params = module, list(params)
        self.group, self.size, self.index = group, size, index
        self.specs = state_shardings(size, zip(names, self.params), axis)
        self.dims = [_dim(self.specs[n]) for n in names]
        self.gathered = True
        self.reshard_from_module()
        self.release()

    def shard(self, tensors):
        """This rank's slices of whole tensors (one per parameter)."""
        return [t if d is None else t.chunk(self.size, d)[self.index].clone()
                for t, d in zip(tensors, self.dims)]

    def reduce_shard(self, grads):
        """This rank's slices of the mean over the ranks of each rank's
        whole ``grads`` (one per parameter; collectives)."""
        if self.size == 1:
            return self.shard(grads)
        out = list(grads)
        split = [i for i, d in enumerate(self.dims) if d is not None]
        if split:
            blocks = [torch.cat([grads[i].chunk(self.size, self.dims[i])[r].reshape(-1)
                                 for i in split]) for r in range(self.size)]
            mine = reduce_scatter_(torch.empty_like(blocks[0]), blocks, self.group)
            for i, part in zip(split, mine.split([self.shards[i].numel() for i in split])):
                out[i] = part.view(self.shards[i].shape)
        replicated = [out[i] for i, d in enumerate(self.dims) if d is None]
        all_reduce_many_(replicated, self.group)
        torch._foreach_div_(out, float(self.size))
        return out

    def full(self, tensors):
        """Whole tensors from every rank's slices (one per parameter; a
        collective)."""
        return [t if d is None else all_gather_cat(t.contiguous(), d, self.group)
                for t, d in zip(tensors, self.dims)]

    def gather(self):
        """Give the module's sharded parameters their whole values."""
        if self.gathered:
            return
        for p, t, d in zip(self.params, self.full(self.shards), self.dims):
            if d is not None:
                p.data = t
        self.gathered = True

    def release(self):
        """Drop the whole values of the sharded parameters, and any packed
        copy of them the model keeps."""
        if not self.gathered:
            return
        for p, d in zip(self.params, self.dims):
            if d is not None:
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        if hasattr(self.module, "_packed"):
            self.module._packed = None
        self.gathered = False

    def reshard_from_module(self):
        """Take the shards from the module's parameters, whole (at the
        start, or after they were loaded)."""
        self.shards = [p if d is None else p.detach().chunk(self.size, d)[self.index].clone()
                       for p, d in zip(self.params, self.dims)]
