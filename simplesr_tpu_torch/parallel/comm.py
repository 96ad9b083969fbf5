"""The collectives of the parallel layer, and the data-parallel context.

Every collective here runs on the given process group. Under gloo a CUDA
tensor goes through a host copy, always: gloo does not take CUDA tensors
for every operation (its point-to-point transfers fail on them), and what
it takes differs between torch builds. Under NCCL it stays on the card.

Differentiable collectives, for the two ways a rank's program can relate
to the others':

* across the **data** axis every rank has its own loss, and the objective
  is their mean: ``all_reduce_sum``'s backward is an all-reduce of the
  incoming gradients (the gradient of the sum of the ranks' losses), and
  the parameter gradients are then averaged over the axis;
* across a **model-parallel** axis (tensor or pipeline) the ranks compute
  one loss together, replicated: ``reduce_from_model`` (all-reduce forward,
  identity backward), ``copy_to_model`` (identity forward, all-reduce
  backward) and ``gather_from_model`` (all-gather forward, own slice
  backward) are Megatron's pair of operators and the gather.

``data_parallel(group, size, index)`` makes a data axis current, in the
calling thread, for the code that needs global batch semantics as the JAX
package's single SPMD program has them: ``batch_mean`` (the relativistic losses' critic means),
``batch_moments`` (BatchNorm's statistics) and ``global_rand`` (a random
draw over the global batch, of which the rank takes its slice). Without a
current axis each is its local, single-device self.
"""

import contextlib
import threading

import torch
import torch.distributed as dist

# ----------------------------------------------------------------- plumbing


@contextlib.contextmanager
def _on_host(tensors, group, written=None):
    """The tensors to hand a collective: host copies under gloo for CUDA
    tensors, the tensors themselves otherwise. On exit the host copies of
    the tensors the collective writes (the indices ``written``, all by
    default) are copied back."""
    tensors = list(tensors)
    if dist.get_backend(group) != "gloo" or not any(t.is_cuda for t in tensors):
        yield tensors
        return
    host = [t.detach().cpu() for t in tensors]
    yield host
    for i in range(len(tensors)) if written is None else written:
        tensors[i].copy_(host[i])


def distributed():
    """Whether a process group is up."""
    return dist.is_available() and dist.is_initialized()


def world_rank():
    return dist.get_rank() if distributed() else 0


def world_size():
    return dist.get_world_size() if distributed() else 1


# ------------------------------------------------------- plain collectives


def all_reduce_(tensor, group, op=dist.ReduceOp.SUM):
    """In-place all-reduce of ``tensor`` over ``group``."""
    with _on_host([tensor], group) as (t,):
        dist.all_reduce(t, op=op, group=group)
    return tensor


def all_reduce_many_(tensors, group, op=dist.ReduceOp.SUM):
    """In-place all-reduce of a list of same-dtype tensors, as one flat
    buffer (one collective for all of them)."""
    tensors = list(tensors)
    if not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, group, op)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return tensors


def reduce_scatter_(out, blocks, group):
    """``out``, in place: the sum over ``group`` of each rank's
    ``blocks[i]``, where i is this rank's index in the group."""
    with _on_host([out, *blocks], group, written=[0]) as (o, *b):
        dist.reduce_scatter(o, b, group=group)
    return out


def broadcast_(tensor, src_group_rank, group):
    """In-place broadcast from the group's rank ``src_group_rank``."""
    with _on_host([tensor], group) as (t,):
        dist.broadcast(t, dist.get_global_rank(group, src_group_rank), group=group)
    return tensor


def _all_gather_list(x, group):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    with _on_host(parts + [x], group, written=range(len(parts))) as staged:
        dist.all_gather(staged[:-1], staged[-1], group=group)
    return parts


def exchange(sends, recvs, group):
    """Point-to-point transfers in one batch: ``sends`` is a list of
    (tensor, destination group rank, tag), ``recvs`` of (buffer, source
    group rank, tag); the buffers are filled in place."""
    tensors = [s[0].contiguous() for s in sends] + [r[0] for r in recvs]
    with _on_host(tensors, group, written=range(len(sends), len(tensors))) as staged:
        ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, peer), group, tag)
               for t, (_, peer, tag) in zip(staged, sends)]
        ops += [dist.P2POp(dist.irecv, b, dist.get_global_rank(group, peer), group, tag)
                for b, (_, peer, tag) in zip(staged[len(sends):], recvs)]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
    return [r[0] for r in recvs]


def barrier(group=None):
    if distributed():
        dist.barrier(group=group)


def agree(flag, group, op=dist.ReduceOp.MIN):
    """A boolean every rank of ``group`` agrees on: the minimum (all true)
    by default, the maximum (any true) with ``ReduceOp.MAX``. Its tensor
    lives where the backend takes it: the current card under NCCL."""
    nccl = dist.get_backend(group) == "nccl"
    t = torch.tensor([1.0 if flag else 0.0],
                     device=torch.device("cuda", torch.cuda.current_device()) if nccl else "cpu")
    all_reduce_(t, group, op)
    return bool(t.item() > 0.5)


# ----------------------------------------------- differentiable collectives


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def all_reduce_sum(x, group):
    """Sum over the ranks; its backward sums the ranks' gradients (each rank
    with a loss of its own)."""
    return _AllReduceSum.apply(x, group)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.width = dim, group, x.shape[dim]
        return torch.cat(_all_gather_list(x, group), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        start = dist.get_rank(ctx.group) * ctx.width
        return grad.narrow(ctx.dim, start, ctx.width).contiguous(), None, None


def reduce_from_model(x, group):
    """Sum of the model-parallel ranks' partial results (backward: the
    replicated gradient as it is)."""
    return _ReduceFromModel.apply(x, group)


def copy_to_model(x, group):
    """A replicated activation entering split computation (backward: the
    ranks' partial gradients summed)."""
    return _CopyToModel.apply(x, group)


def gather_from_model(x, dim, group):
    """The model-parallel ranks' slices concatenated along ``dim`` in rank
    order (backward: this rank's slice of the replicated gradient)."""
    return _GatherFromModel.apply(x, dim, group)


def all_gather_cat(x, dim, group):
    """The ranks' tensors concatenated along ``dim`` in rank order (no
    autograd)."""
    with torch.no_grad():
        return torch.cat(_all_gather_list(x, group), dim=dim)


# ------------------------------------------------- the data-parallel context


class DataAxis:
    """The current data axis: its group, size and this rank's index."""

    def __init__(self, group, size, index):
        self.group, self.size, self.index = group, int(size), int(index)


_local = threading.local()  # the current data axis, of this thread's step


@contextlib.contextmanager
def data_parallel(group, size, index):
    """Make a data axis current in this thread (nothing changes for
    ``size`` 1)."""
    previous = current_data_axis()
    _local.axis = DataAxis(group, size, index) if size > 1 else None
    try:
        yield _local.axis
    finally:
        _local.axis = previous


def current_data_axis():
    return getattr(_local, "axis", None)


def batch_mean(x):
    """The mean of ``x`` over the global batch: every rank's slice has the
    same size, so the mean of the ranks' means."""
    axis = current_data_axis()
    if axis is None:
        return x.mean()
    return all_reduce_sum(x.mean(), axis.group) / axis.size


def batch_moments(y, dims):
    """The mean and the biased variance (E[y^2] - E[y]^2, clipped at 0) of
    ``y`` over ``dims`` and the global batch, as BatchNorm takes them."""
    axis = current_data_axis()
    if axis is None:
        mean = y.mean(dims)
        return mean, ((y * y).mean(dims) - mean * mean).clamp_min(0.0)
    count = y.numel() // y.shape[1] * axis.size
    sums = all_reduce_sum(torch.cat([y.sum(dims), (y * y).sum(dims)]), axis.group) / count
    mean, sq = sums.split(y.shape[1])
    return mean, (sq - mean * mean).clamp_min(0.0)


def global_rand(shape, generator=None):
    """``torch.rand(shape)`` as this rank's slice of one draw over the
    global batch (the leading dim times the data axis's size)."""
    axis = current_data_axis()
    if axis is None:
        return torch.rand(shape, generator=generator)
    n = shape[0]
    full = torch.rand((n * axis.size, *shape[1:]), generator=generator)
    return full[axis.index * n:(axis.index + 1) * n]
