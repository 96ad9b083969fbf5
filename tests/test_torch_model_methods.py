"""The public methods of the JAX package's trainer classes that the port
gained last: ``SRModel.resume()`` (tests/train/test_resume.py's cases on the
port, 1 block of 8 filters on the CPU), ``Generator.loss_functions``,
``set_model`` and ``set_variables``, and ``VGGLoss.visualize_feature_maps``
against the JAX method on a seeded VGG19 at a 16 x 16 input (float32 convs
summed in another order: 1e-5 of the largest feature)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplesr_tpu.losses import VGGLoss as JaxVGGLoss
from simplesr_tpu_torch.losses import MeanAbsoluteError, MeanSquaredError, VGGLoss
from simplesr_tpu_torch.train import Generator, SRModel


def _cfg(root):
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


def _model(tmp_path):
    gen = Generator.srresnet(2, num_blocks=1, num_filters=8, batch_norm=False, seed=0,
                             dtype="float32", device="cpu")
    return SRModel("resnet", gen, "Adam", {"learning_rate": 1e-2}, config=_cfg(tmp_path),
                   device="cpu")


def test_resume_restores_full_state(tmp_path):
    rng = np.random.default_rng(0)
    lr = rng.uniform(0, 1, size=(2, 8, 8, 3)).astype(np.float32)
    hr = rng.uniform(-1, 1, size=(2, 16, 16, 3)).astype(np.float32)
    m1 = _model(tmp_path)
    m1.before_epoch()
    m1.train_step(lr, hr)
    m1.after_train_batch()
    m1.validation_step(lr, hr)
    m1.after_validation_batch()
    m1.after_epoch()  # writes the best-state checkpoint
    step1 = m1.step
    params1 = {k: v.clone() for k, v in m1.generator().state_dict().items()}
    opt1 = m1.optimizer.state_dict()

    # a fresh SRModel over the same checkpoint directory picks the run up
    m2 = _model(tmp_path)
    assert m2.resume() == step1
    assert m2.step == step1 and m2.iterations() == step1
    assert m2.best_metric == m1.best_metric
    for k, v in m2.generator().state_dict().items():
        torch.testing.assert_close(v, params1[k], rtol=0, atol=0)
    assert m2.optimizer.state_dict().keys() == opt1.keys()
    m2.train_step(lr, hr)  # training goes on from the restored state
    assert m2.step == step1 + 1


def test_resume_without_checkpoint_returns_none(tmp_path):
    assert _model(tmp_path).resume() is None


def test_generator_loss_functions_set_model_and_set_variables():
    losses = [MeanAbsoluteError(), MeanSquaredError(loss_weight=0.5)]
    gen = Generator.srresnet(2, loss_function=losses, num_blocks=1, num_filters=8,
                             batch_norm=False, seed=1, dtype="float32", device="cpu")
    assert [type(f).__name__ for f in gen.loss_functions()] == [
        "MeanAbsoluteError", "MeanSquaredError"]
    other = Generator.srresnet(2, num_blocks=1, num_filters=8, batch_norm=False, seed=2,
                               dtype="float32", device="cpu")
    x = torch.rand(1, 6, 6, 3)
    # set_variables: another generator's flax-layout variables, loaded
    gen.set_variables(other.variables)
    torch.testing.assert_close(gen.generate(x), other.generate(x), rtol=0, atol=0)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, gen.variables, other.variables))
    # set_model: the module swapped in, with or without variables
    third = Generator.srresnet(2, num_blocks=1, num_filters=8, batch_norm=False, seed=3,
                               dtype="float32", device="cpu")
    gen.set_model(third.model())
    assert gen.model() is third.model()
    torch.testing.assert_close(gen.generate(x), third.generate(x), rtol=0, atol=0)
    gen.set_model(third.model(), other.variables)
    torch.testing.assert_close(gen.generate(x), other.generate(x), rtol=0, atol=0)


def _seeded_vgg19(seed=0):
    """VGG19's conv variables in flax's layout, He-normal from a numpy seed
    (quicker than either package's own seeded init)."""
    rng = np.random.default_rng(seed)
    params, cin = {}, 3
    for block, (convs, cout) in enumerate([(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)], 1):
        for conv in range(1, convs + 1):
            params[f"block{block}_conv{conv}"] = {
                "kernel": (rng.standard_normal((3, 3, cin, cout)) * np.sqrt(2 / (9 * cin))
                           ).astype(np.float32),
                "bias": (rng.standard_normal(cout) * 0.01).astype(np.float32)}
            cin = cout
    return {"params": params}


@pytest.mark.parametrize("denormalize", [True, False])
def test_visualize_feature_maps_matches_jax(denormalize):
    params = _seeded_vgg19()
    layers = ["block1_conv2", "block2_conv2"]
    rng = np.random.default_rng(4)
    picture = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    if not denormalize:
        picture = (picture + 1) * 127.5
    want = JaxVGGLoss(layers, vgg_params=params).visualize_feature_maps(
        jnp.asarray(picture), denormalize=denormalize)
    got = VGGLoss(layers, vgg_params=params).visualize_feature_maps(picture,
                                                                    denormalize=denormalize)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
