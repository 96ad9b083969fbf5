"""Rank body of tests/test_torch_parallel_pp.py: pipeline-parallel forwards,
gradients and training of the port on a gloo group of the CPU."""

import torch
# autograd.grad with given output gradients, as each stage's backward calls
# it, imports this (about a second) on its first call; imported here, the
# stages pay it together rather than one after another down the pipeline
import torch.fx.experimental.symbolic_shapes  # noqa: F401

from simplesr_tpu_torch.models.srresnet import SRResNet
from simplesr_tpu_torch.parallel import (DATA_AXIS, MODEL_AXIS, STAGE_AXIS, make_mesh,
                                         pipeline_apply)
from simplesr_tpu_torch.parallel.comm import all_reduce_many_
from simplesr_tpu_torch.parallel.mesh import axis_group
from simplesr_tpu_torch.train import Generator, SRModel
from simplesr_tpu_torch.train.serialization import load_model

from _ranks_dp import cfg, variables
from _ranks_tp import variables_of


def gen(inputs, num_blocks=4):
    return Generator.srresnet(2, num_blocks=num_blocks, num_filters=8, batch_norm=False,
                              dtype="float32", pretrained_model_path=inputs["train_gen"]
                              if num_blocks == 4 else None, device="cpu")


def model(inputs, root, mesh, **kw):
    return SRModel("resnet", gen(inputs), "SGD", {"learning_rate": 1e-2}, config=cfg(root),
                   mesh=mesh, device="cpu", **kw)


def body(rank, world, workdir, inputs):
    out = {}
    module = load_model(inputs["gen"], device="cpu")
    pp4 = make_mesh({STAGE_AXIS: 4})
    dppp = make_mesh({DATA_AXIS: 2, STAGE_AXIS: 2})
    x = torch.from_numpy(inputs["x"])
    with torch.no_grad():
        for m in (4, 2):
            out[f"fwd_{m}"] = pipeline_apply(module, pp4, m)(x).numpy()
        out["fwd_dp"] = pipeline_apply(module, dppp, 2, batch_axis=DATA_AXIS)(x).numpy()
        out["fwd_1"] = pipeline_apply(module, dppp, 1, batch_axis=DATA_AXIS)(
            torch.from_numpy(inputs["x2"])).numpy()

    # gradients: each stage's blocks summed over the stage axis
    f = pipeline_apply(module, pp4, 2)
    names, params = zip(*module.named_parameters())
    got = list(torch.autograd.grad(f(torch.from_numpy(inputs["xg"])).pow(2).mean(), params))
    trunk = {id(p) for p in module.trunk_parameters()}
    all_reduce_many_([g for g, p in zip(got, params) if id(p) in trunk],
                     axis_group(pp4, STAGE_AXIS))
    out["grads"] = variables_of(module, dict(zip(names, got)))

    errors = {}
    for key, build in (
            ("blocks", lambda: pipeline_apply(SRResNet(2, 8, 6, batch_norm=False,
                                                       dtype=torch.float32), pp4, 2)),
            ("batch_norm", lambda: pipeline_apply(SRResNet(2, 8, 8, batch_norm=True), pp4, 2)),
            ("microbatches", lambda: pipeline_apply(module, pp4, 3)(torch.zeros(4, 8, 8, 3))),
            ("no_stage_axis", lambda: model(inputs, workdir / "b1", make_mesh({DATA_AXIS: 4}),
                                            pipeline_parallel=True)),
            ("indivisible", lambda: SRModel(
                "resnet", gen(inputs, 6), "SGD", config=cfg(workdir / "b2"), mesh=pp4,
                pipeline_parallel=True, device="cpu")),
            ("exclusive", lambda: model(inputs, workdir / "b3",
                                        make_mesh({STAGE_AXIS: 2, MODEL_AXIS: 2}),
                                        pipeline_parallel=True, tensor_parallel=True))):
        try:
            build()
        except ValueError as e:
            errors[key] = str(e)
    out["errors"] = errors

    # training on dp x pp with 2 and 4 microbatches, on pp alone
    lr, hr = inputs["batch8"]
    for m in (2, 4):
        t = model(inputs, workdir / f"pp{m}", dppp, pipeline_parallel=True,
                  pipeline_microbatches=m)
        for _ in range(2):
            t.train_step(lr, hr)
        out[f"train_{m}"] = variables(t.generator())
    t = model(inputs, workdir / "pponly", pp4, pipeline_parallel=True)
    t.train_step(*inputs["batch4"])
    out["train_only"] = variables(t.generator())
    t.before_epoch()
    t.validation_step(lr, hr)
    out["valid_loss"] = float(t.generator_wrapper().epoch_metrics(train=False)
                              .results()["generator_loss"])
    out["generate_shape"] = tuple(t.generate(lr).shape)

    # the config factory: pipeline_parallel: 4 -> a data x stage mesh
    conf = cfg(workdir / "factory")
    conf.pipeline_parallel = 4
    conf.data_parallel = False
    f = SRModel.init(conf, gen(inputs), "SGD", {"learning_rate": 1e-2}, device="cpu")
    f.train_step(lr, hr)
    out["factory"] = {"vars": variables(f.generator()),
                      "mesh": dict(zip(f._mesh.mesh_dim_names, f._mesh.shape))}
    return out
