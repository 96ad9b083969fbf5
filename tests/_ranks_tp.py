"""Rank body of tests/test_torch_parallel_tp.py: tensor-parallel forwards,
gradients and training of the port on a gloo group of the CPU."""

import torch

from simplesr_tpu_torch.models.rrdb import RRDBNet
from simplesr_tpu_torch.models.srresnet import SRResNet
from simplesr_tpu_torch.parallel import DATA_AXIS, MODEL_AXIS, make_mesh, tp_apply, tp_param_specs
from simplesr_tpu_torch.parallel.comm import all_reduce_many_
from simplesr_tpu_torch.parallel.mesh import axis_group
from simplesr_tpu_torch.train import Discriminator, Generator, SRModel
from simplesr_tpu_torch.train.serialization import load_model

from _ranks_dp import cfg, variables


def grads(module, f, x, mesh):
    """d mean(f(x)^2) / d parameters, the split ones' slices summed over the
    model axis: the whole gradient, in flax's layout."""
    names, params = zip(*module.named_parameters())
    got = list(torch.autograd.grad(f(x).pow(2).mean(), params))
    specs = tp_param_specs(module)
    split = [g for n, g in zip(names, got) if specs[n]]
    all_reduce_many_(split, axis_group(mesh, MODEL_AXIS))
    it = iter(split)
    got = [next(it) if specs[n] else g for n, g in zip(names, got)]
    return variables_of(module, dict(zip(names, got)))


def variables_of(module, tensors):
    state = dict(module.state_dict())
    state.update(tensors)
    from simplesr_tpu_torch.train.convert import to_flax_variables
    return to_flax_variables(state)


def run_model(inputs, root, mesh, arch="srresnet", steps=2, batch=None, gan=False, **kw):
    path = inputs[f"{arch}_train"]
    gen = Generator.srresnet(2, num_blocks=2, num_filters=8, batch_norm=False, dtype="float32",
                             pretrained_model_path=path, device="cpu") if arch == "srresnet" \
        else Generator.rrdb(2, num_blocks=1, num_dense_blocks=2, num_convs=2, num_filters=8,
                            dtype="float32", pretrained_model_path=path, device="cpu")
    opt = ("SGD", {"learning_rate": 1e-2})
    if gan:
        disc = Discriminator.initialize_standard(label_smoothing=True, smoothing_offset=0.2,
                                                 num_filters=8, input_dims=(16, 16),
                                                 dtype="float32", device="cpu")
        disc.set_variables(inputs["disc"])
        model = SRModel("gan", gen, *opt, disc, *opt, config=cfg(root), mesh=mesh, device="cpu",
                        **kw)
    else:
        model = SRModel("resnet", gen, *opt, config=cfg(root), mesh=mesh, device="cpu", **kw)
    lr, hr = batch or inputs["train_batch"]
    for _ in range(steps):
        model.train_step(lr, hr)
    return model


def body(rank, world, workdir, inputs):
    out = {}
    tp4 = make_mesh({MODEL_AXIS: 4})
    dptp = make_mesh({DATA_AXIS: 2, MODEL_AXIS: 2})
    for arch in ("srresnet", "rrdb"):
        module = load_model(inputs[arch], device="cpu")
        x = torch.from_numpy(inputs["x"])
        with torch.no_grad():
            out[f"{arch}_fwd"] = tp_apply(module, tp4)(x).numpy()
            out[f"{arch}_dptp"] = tp_apply(module, dptp, batch_axis=DATA_AXIS)(
                torch.from_numpy(inputs["x4"])).numpy()
        out[f"{arch}_grads"] = grads(module, tp_apply(module, tp4),
                                     torch.from_numpy(inputs["xg"]), tp4)

    errors = {}
    for key, build in (
            ("filters", lambda: SRResNet(4, 10, 3, batch_norm=False, dtype=torch.float32)),
            ("batch_norm", lambda: SRResNet(2, 16, 1, batch_norm=True)),
            ("growth", lambda: RRDBNet(4, 20, 1, growth_channels=10, dtype=torch.float32))):
        try:
            tp_apply(build(), tp4)
        except ValueError as e:
            errors[key] = str(e)
    wide = RRDBNet(4, 16, 1, num_dense_blocks=1, num_convs=2, growth_channels=16,
                   dtype=torch.float32)
    with torch.no_grad():
        errors["wide_shape"] = tuple(tp_apply(wide, tp4)(torch.zeros(1, 8, 8, 3)).shape)
    try:
        SRModel("resnet", Generator.srresnet(2, num_blocks=1, num_filters=8, device="cpu",
                                             dtype="float32"),
                config=cfg(workdir / "bad"), mesh=make_mesh({DATA_AXIS: 4}),
                tensor_parallel=True, device="cpu")
    except ValueError as e:
        errors["no_model_axis"] = str(e)
    out["errors"] = errors

    # training: SRModel(tensor_parallel=True) on dp x tp, on tp alone with
    # an odd batch, in GAN mode; then validation and generate
    for arch in ("srresnet", "rrdb"):
        m = run_model(inputs, workdir / f"tp_{arch}", dptp, arch, tensor_parallel=True)
        out[f"train_{arch}"] = variables(m.generator())
    odd = tuple(a[:3] for a in inputs["train_batch"])
    m = run_model(inputs, workdir / "tponly", tp4, steps=1, batch=odd, tensor_parallel=True)
    out["train_odd"] = variables(m.generator())
    m = run_model(inputs, workdir / "gan", dptp, gan=True, tensor_parallel=True, seed=5)
    out["train_gan"] = {"g": variables(m.generator()),
                        "d": variables(m.discriminator_wrapper().model())}
    m.before_epoch()
    m.validation_step(*inputs["train_batch"])
    out["valid_loss"] = float(m.generator_wrapper().epoch_metrics(train=False)
                              .results()["generator_loss"])
    out["generate_shape"] = tuple(m.generate(inputs["train_batch"][0]).shape)
    return out
