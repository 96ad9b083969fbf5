"""Rank body of tests/test_torch_parallel_fsdp.py: FSDP (ZeRO-3) training of
the port on a gloo group of the CPU (``_ranks.start_ranks``)."""

import torch

from simplesr_tpu_torch.models import srresnet
from simplesr_tpu_torch.parallel import make_mesh, shard_count
from simplesr_tpu_torch.train import Generator, SRModel
from simplesr_tpu_torch.train.convert import to_flax_variables

from _ranks_dp import cfg


def model(path, root, mesh, fsdp=True, optimizer="SGD", lr=0.1, **kw):
    gen = Generator.srresnet(2, num_blocks=1, num_filters=16, batch_norm=False,
                             dtype="float32", pretrained_model_path=path, device="cpu",
                             remat=kw.pop("remat", False))
    return SRModel("resnet", gen, optimizer, {"learning_rate": lr}, config=cfg(root), mesh=mesh,
                   fsdp=fsdp, device="cpu", **kw)


def whole(m):
    """The generator's whole variables (a collective under fsdp)."""
    with m._whole():
        return to_flax_variables(m.generator().state_dict())


def held(m):
    """{name: (elements held now by the module, by this rank's shard,
    whole)} of each parameter."""
    shards = dict(zip(m._param_names, m.parameter_shards))
    return {n: (p.numel(), shards[n].numel()) for n, p in m.generator().named_parameters()}


def body(rank, world, workdir, inputs):
    out = {}
    mesh = make_mesh()
    lr, hr = inputs["batch"]

    # SGD, a validation step after each: the JAX FSDP run's parameters
    sgd = model(inputs["gen"], workdir / "sgd", mesh)
    for _ in range(3):
        sgd.train_step(lr, hr)
        sgd.validation_step(lr, hr)
    out["sgd"] = whole(sgd)
    out["specs"] = sgd.state_shardings
    out["shard_count"] = shard_count(sgd.state_shardings)
    out["held"] = held(sgd)
    out["full_sizes"] = {n: p.numel() for n, p in zip(
        sgd._param_names, sgd._zero.full(sgd.parameter_shards))}

    # Adam and EMA on the shards
    adam = model(inputs["gen"], workdir / "adam", mesh, optimizer="Adam", lr=1e-3, ema_decay=0.9)
    for _ in range(2):
        adam.train_step(lr, hr)
    out["adam"] = whole(adam)
    out["ema"] = to_flax_variables(adam._ema_parameters())
    inner = adam.optimizer.inner
    out["moments"] = {k: [t.numel() for t in v] for k, v in inner.slots.items()}
    out["ema_sizes"] = [t.numel() for t in adam.ema_parameters]

    # every lever: fsdp, remat and two accumulated half batches, with a
    # checkpoint round trip between them; the accumulator is a shard, and
    # whole in the file
    big_lr, big_hr = inputs["big_batch"]
    levers = model(inputs["gen"], workdir / "levers", mesh, remat=True, grad_accum_steps=2)
    levers.before_epoch()
    levers.train_step(big_lr[:8], big_hr[:8])
    out["acc_sizes"] = [t.numel() for t in levers.optimizer.inner.acc]
    levers._save_checkpoint()
    levers._restore_latest_checkpoint()
    levers.train_step(big_lr[8:], big_hr[8:])
    out["levers"] = whole(levers)
    if rank == 0:
        file = torch.load(levers.latest_checkpoint()[1], weights_only=True)
        out["acc_file_sizes"] = [t.numel() for t in file["optimizer"]["inner"]["acc"]]

    # a gradient not finite in the last rank's shard only: every rank skips
    # the step, and the replicated leaves stay equal
    nan = model(inputs["gen"], workdir / "nan", mesh)
    reduce, split = nan._reduce_g, next(i for i, n in enumerate(nan._param_names)
                                        if nan.state_shardings[n])

    def poison(grads):
        grads = list(grads)
        if rank == 0:  # the last element lies in the last rank's slice
            grads[split] = grads[split].clone()
            grads[split][(-1,) * grads[split].dim()] = float("nan")
        return reduce(grads)

    before = whole(nan)
    nan._reduce_g = poison
    nan.train_step(lr, hr)
    nan._reduce_g = reduce
    out["nan"] = {"before": before, "skipped": whole(nan),
                  "notfinite": nan.optimizer.total_notfinite, "count": nan.optimizer.count}
    nan.train_step(lr, hr)
    out["nan"]["after"] = whole(nan)

    # the checkpoint: whole on rank 0's disk, restored onto the shards
    ck = model(inputs["gen"], workdir / "ck", mesh, optimizer="Adam", lr=1e-3)
    ck.before_epoch()
    ck.train_step(lr, hr)
    ck._save_checkpoint()
    saved = whole(ck)
    ck.train_step(lr, hr)
    ck._restore_latest_checkpoint()
    out["ck"] = {"saved": saved, "restored": whole(ck), "held": held(ck)}
    ck.train_step(lr, hr)
    out["ck"]["after"] = whole(ck)
    if rank == 0:
        out["ck"]["file"] = torch.load(ck.latest_checkpoint()[1], weights_only=True)

    # the trunk kernel's route (a bf16, 64-filter, BN-free SRResNet): its
    # packing sees whole weights inside the forward, and no packed copy
    # outlives a release
    seen = []
    pack = srresnet.pack_trunk_weights

    def spy(blocks):
        blocks = [tuple(b) for b in blocks]
        seen.append([tuple(t.shape) for t in blocks[0]])
        return pack(blocks)

    srresnet.pack_trunk_weights = spy
    try:
        gen = Generator.srresnet(2, num_blocks=1, num_filters=64, batch_norm=False,
                                 dtype="bfloat16", pretrained_model_path=inputs["gen64"],
                                 device="cpu")
        k = SRModel("resnet", gen, "SGD", {"learning_rate": 0.1}, config=cfg(workdir / "k"),
                    mesh=mesh, fsdp=True, device="cpu")
        k.train_step(lr, hr)
        k.train_step(lr, hr)
        out["kernel"] = {"seen": seen, "packed_after": k.generator()._packed,
                         "uses": k.generator().uses_trunk_kernel, "vars": whole(k)}
    finally:
        srresnet.pack_trunk_weights = pack
    return out
