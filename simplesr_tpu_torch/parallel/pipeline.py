"""Pipeline parallelism, as simplesr_tpu.parallel.pipeline: the BN-free
SRResNet's residual trunk staged across the ranks of a "stage" mesh axis.

The trunk's blocks split into ``n_stages`` contiguous ranges, one a rank.
A batch splits into ``M`` microbatches that stream through the stages in
GPipe's fill-and-drain order: stage s takes microbatch j from stage s - 1
(stage 0 from the head), runs its blocks on it and hands it to stage s + 1,
so the batch crosses the trunk in ``M + n_stages - 1`` steps. The head,
the trunk's closing conv, the global skip and the subpixel tail run
replicated on every stage; the last stage broadcasts the trunk's output to
the others. Per microbatch the numbers are the sequential forward's.

The backward runs the same schedule in reverse by hand: the last stage
starts from the trunk output's gradient, each stage differentiates its
blocks for each microbatch and hands the input's gradient back, and stage 0
broadcasts the head output's gradient, so that every stage holds the same
gradients for the replicated parameters. A stage's blocks get their
gradients on that stage only (zeros elsewhere): summed over the axis they
are the sequential ones.

A stage of a bf16 model with 64 filters runs its range of blocks through
the trunk kernel (``ops.kernels.TrunkFunction``, packed per call), which
rounds to bf16 after every block as the whole-trunk call does: the same
numbers. Any other model runs its ResBlock modules.
"""

import torch

from simplesr_tpu_torch.models.srresnet import SRResNet
from simplesr_tpu_torch.ops.kernels.trunk import TrunkFunction
from simplesr_tpu_torch.parallel.comm import all_gather_cat, broadcast_, exchange
from simplesr_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size, mesh_shape

__all__ = ["STAGE_AXIS", "stack_block_params", "pipeline_apply"]

STAGE_AXIS = "stage"


def stack_block_params(model):
    """The trunk's per-block parameters stacked on a leading block axis, in
    the port's layouts: (conv1 weight, conv1 bias, PReLU alpha, conv2
    weight, conv2 bias), each (num_res_blocks, ...)."""
    per_block = model._block_parameters()
    return tuple(torch.stack([b[k] for b in per_block]) for k in range(5))


def _stage_forward(model, first, last):
    """The forward of blocks [first, last) on NCHW activations."""
    blocks = list(model.blocks)[first:last]
    if model.uses_trunk_kernel:
        def run(h):
            params = [t for b in model._block_parameters()[first:last] for t in b]
            out = TrunkFunction.apply(h.permute(0, 2, 3, 1), None, *params)
            return out.permute(0, 3, 1, 2)
        return run

    def run(h):
        for block in blocks:
            h = block(h)
        return h
    return run


def _buffer(like):
    """A contiguous buffer of ``like``'s shape for a transfer to land in."""
    return torch.empty_like(like, memory_format=torch.contiguous_format)


class _PipelineTrunk(torch.autograd.Function):
    """The staged trunk on (B, C, H, W) head output ``h``. ``params`` are
    all the blocks' parameters; this stage runs ``run`` with
    ``params[first:first + own]``."""

    @staticmethod
    def forward(ctx, h, plan, *params):
        group, stages, stage, m, run, first, own = plan
        # keep each microbatch's graph for the backward only when there is one
        grad = any(ctx.needs_input_grad)
        mbs = h.detach().chunk(m)
        inputs, outputs = [], []
        for j in range(m):
            if stage == 0:
                x = mbs[j]
            else:
                x = exchange([], [(_buffer(mbs[j]), stage - 1, j)], group)[0]
            x = x.detach().requires_grad_(grad and (stage > 0 or ctx.needs_input_grad[0]))
            with torch.set_grad_enabled(grad):
                y = run(x)
            if stage < stages - 1:
                exchange([(y.detach(), stage + 1, j)], [], group)
            inputs.append(x)
            outputs.append(y)
        ctx.plan, ctx.inputs, ctx.outputs = plan, inputs, outputs
        ctx.mine = params[first:first + own]
        ctx.zeros = [(p.shape, p.dtype, p.device) for p in params]
        out = torch.cat([y.detach() for y in outputs]).contiguous() if stage == stages - 1 \
            else _buffer(h)
        return broadcast_(out, stages - 1, group)

    @staticmethod
    def backward(ctx, grad):
        group, stages, stage, m, run, first, own = ctx.plan
        grads = grad.chunk(m)
        param_grads = [torch.zeros(shape, dtype=dtype, device=device)
                       for shape, dtype, device in ctx.zeros]
        in_grads = [None] * m
        for j in reversed(range(m)):
            g = grads[j].contiguous() if stage == stages - 1 else \
                exchange([], [(_buffer(grads[j]), stage + 1, m + j)], group)[0]
            x, y = ctx.inputs[j], ctx.outputs[j]
            wrt = ([x] if x.requires_grad else []) + list(ctx.mine)
            got = list(torch.autograd.grad(y, wrt, g, allow_unused=True))
            if x.requires_grad:
                in_grads[j] = got.pop(0)
            for k, pg in enumerate(got):
                if pg is not None:
                    param_grads[first + k] += pg
            if stage > 0:
                exchange([(in_grads[j], stage - 1, m + j)], [], group)
        ctx.inputs = ctx.outputs = ctx.mine = None
        h_grad = None
        if ctx.needs_input_grad[0]:
            h_grad = torch.cat(in_grads).contiguous() if stage == 0 else _buffer(grad)
            broadcast_(h_grad, 0, group)
        return (h_grad, None, *param_grads)


def pipeline_apply(model, mesh, num_microbatches, axis=STAGE_AXIS, batch_axis=None):
    """The pipeline-parallel forward of a BN-free SRResNet over
    ``mesh[axis]``: ``f(x)`` with (B, H, W, 3) ``x`` the same on every stage,
    reading the model's parameters as they are at the call, differentiable.
    ``num_microbatches`` must divide the batch. With ``batch_axis`` in the
    mesh, ``x`` is the global batch: each data rank streams its slice and
    the outputs are gathered (forward only). Returns the (B, sH, sW, 3)
    float32 SR batch on every rank."""
    if not isinstance(model, SRResNet):
        raise ValueError("pipeline forward supports SRResNet trunks, got "
                         f"{type(model).__name__}")
    if model.batch_norm:
        raise ValueError("pipeline forward supports batch_norm=False models")
    stages = axis_size(mesh, axis)
    if model.num_res_blocks % stages != 0:
        raise ValueError(f"num_res_blocks {model.num_res_blocks} not "
                         f"divisible by mesh axis {axis}={stages}")
    m = int(num_microbatches)
    group = axis_group(mesh, axis)
    b_ax = batch_axis if batch_axis and batch_axis in mesh_shape(mesh) else None
    per_stage = model.num_res_blocks // stages

    def trunk(h):
        stage = axis_index(mesh, axis)
        first, last = stage * per_stage, (stage + 1) * per_stage
        plan = (group, stages, stage, m, _stage_forward(model, first, last), first * 5,
                (last - first) * 5)
        return _PipelineTrunk.apply(h, plan, *model.trunk_parameters())

    def local(x):
        if x.shape[0] % m != 0:
            raise ValueError(f"batch {x.shape[0]} not divisible by microbatches {m}")
        h = x.permute(0, 3, 1, 2).to(model.dtype)
        h = skip = model.head_act(model.head(h))
        return model.tail(model.trunk_out(trunk(h)) + skip)

    def f(x):
        if b_ax is None:
            return local(x)
        b, nb = x.shape[0], axis_size(mesh, b_ax)
        if b % m != 0:
            raise ValueError(f"batch {b} not divisible by microbatches {m}")
        if (b // m) % nb != 0:
            raise ValueError(
                f"microbatch size {b // m} (batch {b} / {m} microbatches) "
                f"not divisible by the '{b_ax}' mesh axis ({nb}) — dp×pp shards the "
                "microbatch interior over the data axis")
        per, bi = b // nb, axis_index(mesh, b_ax)
        out = local(x[bi * per:(bi + 1) * per])
        return all_gather_cat(out.contiguous(), 0, axis_group(mesh, b_ax))

    return f
