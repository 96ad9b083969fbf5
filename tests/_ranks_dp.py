"""Rank body of tests/test_torch_parallel_dp.py: data-parallel training of
the port on a gloo group of the CPU (``_ranks.start_ranks``). Every check of
that file runs here in one go; the body returns what the test compares."""

import numpy as np
import torch

from simplesr_tpu_torch.data import DataPipeline
from simplesr_tpu_torch.parallel import (DATA_AXIS, SPATIAL_AXIS, global_batch, local_batch_slice,
                                         make_mesh, shard_batch)
from simplesr_tpu_torch.parallel.mesh import mesh_shape
from simplesr_tpu_torch.train import Discriminator, Generator, SRModel
from simplesr_tpu_torch.train.convert import to_flax_variables


def cfg(root):
    class Cfg:
        model_dir = str(root / "models")
        checkpoint_dir = str(root / "checkpoints")
        early_stop_metric = "psnr"
        early_stop_patience = 100
        epoch_train_summary_writer = None
        batch_train_summary_writer = None
        epoch_validation_summary_writer = None
        batch_validation_summary_writer = None
    return Cfg


def generator(path, batch_norm):
    return Generator.srresnet(2, num_blocks=1, num_filters=8, batch_norm=batch_norm,
                              dtype="float32", pretrained_model_path=path, device="cpu")


def variables(module):
    return to_flax_variables(module.state_dict())


def epoch_results(model):
    return {k: float(v) for k, v in model._combined_epoch_metrics(train=True).items()}, \
        {k: float(v) for k, v in model._combined_epoch_metrics(train=False).items()}


def models(inputs, root, mesh, relativistic_critic=True, smoothing=False, **kw):
    gen = generator(inputs["bn_gen"], batch_norm=True)
    if relativistic_critic:
        disc = Discriminator.initialize_relativistic(num_filters=8, input_dims=(16, 16),
                                                     dtype="float32", device="cpu")
        disc.set_variables(inputs["ra_disc"])
    else:
        disc = Discriminator.initialize_standard(label_smoothing=smoothing, smoothing_offset=0.2,
                                                 num_filters=8, input_dims=(16, 16),
                                                 dtype="float32", device="cpu")
        disc.set_variables(inputs["std_disc"])
    opt = ("SGD", {"learning_rate": 0.05})
    return SRModel("gan", gen, *opt, disc, *opt, config=cfg(root), mesh=mesh, device="cpu", **kw)


def gan_run(model, batches):
    model.before_epoch()
    for lr, hr in batches:
        model.train_step(lr, hr)
        model.after_train_batch()
    model.validation_step(*batches[0])
    return {"g": variables(model.generator()),
            "d": variables(model.discriminator_wrapper().model()),
            "metrics": epoch_results(model)}


def body(rank, world, workdir, inputs):
    import torch.distributed as dist

    from simplesr_tpu_torch.parallel import initialize_multihost

    out = {}
    # started by start_ranks with torchrun's variables and no group
    out["init"] = (initialize_multihost(device="cpu"), dist.get_backend(),
                   initialize_multihost(device="cpu"), dist.get_rank())
    mesh = make_mesh()
    out["mesh"] = mesh_shape(mesh)
    out["mesh2"] = mesh_shape(make_mesh({DATA_AXIS: world, SPATIAL_AXIS: -1}))
    try:
        make_mesh({DATA_AXIS: 3})
    except ValueError as e:
        out["mesh_error"] = str(e)
    x = torch.arange(4 * world * 3, dtype=torch.float32).reshape(4 * world, 3)
    out["shard"] = shard_batch(mesh, x).numpy()
    out["slice"] = local_batch_slice(4 * world)
    out["global"] = global_batch(mesh, shard_batch(mesh, x)).numpy()

    # SGD on a BatchNorm SRResNet: parameters, running statistics, metrics
    model = SRModel("resnet", generator(inputs["bn_gen"], True), "SGD", {"learning_rate": 0.1},
                    config=cfg(workdir / "bn"), mesh=mesh, device="cpu")
    model.before_epoch()
    for lr, hr in inputs["batches"]:
        model.train_step(lr, hr)
        model.after_train_batch()
    model.validation_step(*inputs["batches"][0])
    model.after_validation_batch()
    out["bn"] = {"vars": variables(model.generator()), "metrics": epoch_results(model),
                 "file": model.save_model(str(workdir / "bn" / "models"))}

    # the relativistic GAN step, BatchNorm in the generator and the critic
    out["gan"] = gan_run(models(inputs, workdir / "gan", mesh), inputs["batches"])
    # label smoothing: one draw over the global batch
    out["smooth"] = gan_run(models(inputs, workdir / "smooth", mesh, relativistic_critic=False,
                                   smoothing=True, seed=3), inputs["batches"])

    # gradient accumulation with a micro-batch that is not finite on one rank
    acc = SRModel("resnet", generator(inputs["plain_gen"], False), "SGD",
                  {"learning_rate": 0.1}, config=cfg(workdir / "acc"), mesh=mesh,
                  grad_accum_steps=2, device="cpu")
    for lr, hr in inputs["accum_batches"]:
        acc.train_step(lr, hr)
    guard = acc.optimizer
    out["accum"] = {"vars": variables(acc.generator()), "step": acc.step,
                    "dropped": guard.total_notfinite, "updates": guard.count}

    # an uneven batch is trimmed, one smaller than the mesh skipped
    lr, hr = inputs["batches"][0]
    steps = []
    for b in (4, 3, 1):
        model.train_step(lr[:b], hr[:b])
        steps.append(model.step)
    out["uneven_steps"] = steps

    # early stopping: patience 1, the second epoch validates worse
    stop = SRModel("resnet", generator(inputs["plain_gen"], False), "SGD",
                   {"learning_rate": 0.1}, config=cfg(workdir / "stop"), mesh=mesh,
                   early_stop_patience=1, device="cpu")
    stopped = []
    for epoch, (train, valid) in enumerate(inputs["epochs"]):
        stop.before_epoch()
        stop.train_step(*train)
        stop.after_train_batch()
        stop.validation_step(*valid)
        stop.after_validation_batch()
        stop.after_epoch()
        stopped.append(stop.stop_early())
        if stop.stop_early():
            break
    out["stop"] = {"stopped": stopped, "vars": variables(stop.generator()),
                   "history": {k: [float(v) for v in vs]
                               for k, vs in stop.histories()["valid_epoch"].items()}}

    # the multi-host file split, and the YAML route with data_parallel
    kw = dict(hr_img_path=inputs["png_dir"], scale=2, train_val_split=0.0, batch_size=2,
              crop=True, crop_size=(16, 16, 3), num_crops=1, random_seed=0, device="cpu")
    out["files"] = [str(p) for p in DataPipeline(shard_by_process=True, **kw).train_imgs]
    out["all_files"] = [str(p) for p in DataPipeline(**kw).train_imgs]

    from simplesr_tpu_torch.config import ConfigUtil
    conf, pipeline, yaml_model = ConfigUtil.from_yaml(inputs["yaml"], device="cpu")
    yaml_model.before_epoch()
    for lr, hr in pipeline.train_batch_generator():
        yaml_model.train_step(lr, hr)
        yaml_model.after_train_batch()
        break
    out["yaml"] = {"mesh": mesh_shape(yaml_model._mesh), "save_path": conf.save_path,
                   "finite": bool(all(np.isfinite(v).all() for v in
                                      variables(yaml_model.generator())["params"]
                                      ["ConvLayer_0"]["Conv_0"].values()))}
    return out
