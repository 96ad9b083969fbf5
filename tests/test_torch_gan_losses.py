"""The port's adversarial, VGG perceptual and learned perceptual losses
against simplesr_tpu's, on the same seeded inputs: the two binary
cross-entropies (the probability clip and logits of +-80 included), the four
adversarial losses, VGG19 / VGG16 taps before and after their ReLU with
flax's random init carried over, VGGLoss with several layers, feature
scale, loss weight and total variation, the .npz weights round trip, and
LearnedPerceptualLoss on a tiny saved SRResNet."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplesr_tpu import losses as jax_losses
from simplesr_tpu.models.vgg import VGGFeatures as JaxVGG
from simplesr_tpu.models.vgg import init_vgg_params as jax_init_vgg
from simplesr_tpu.train.generator import Generator as JaxGenerator
from simplesr_tpu.train.serialization import save_model as jax_save_model
from simplesr_tpu_torch import losses
from simplesr_tpu_torch.models.vgg import (VGGFeatures, default_vgg_weights_path,
                                           init_vgg_params, load_vgg_weights_npz,
                                           vgg_layer_names)
from simplesr_tpu_torch.train.convert import from_flax_variables
from simplesr_tpu_torch.train.serialization import load_model


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _critics(seed, shape=(6, 1)):
    rng = np.random.default_rng(seed)
    probs = rng.uniform(0, 1, shape).astype(np.float32)
    probs[0, 0], probs[1, 0] = 0.0, 1.0  # the clip at 1e-7 and 1 - 1e-7
    logits = rng.normal(0, 4, shape).astype(np.float32)
    logits[0, 0], logits[1, 0] = 80.0, -80.0
    labels = rng.uniform(0, 1, shape).astype(np.float32)
    return probs, logits, labels


def test_bce_matches_jax():
    """Both BCEs to rel 1e-6: tf.keras's clip (not torch's log clamp at
    -100, which gives other values at 0 and 1) and the stable logit form at
    +-80."""
    probs, logits, labels = _critics(0)
    for jfn, fn, x in ((jax_losses.bce_from_probs, losses.bce_from_probs, probs),
                       (jax_losses.bce_from_logits, losses.bce_from_logits, logits)):
        ref = float(jfn(jnp.asarray(labels), jnp.asarray(x)))
        got = float(fn(_t(labels), _t(x)))
        assert np.isfinite(got) and got == pytest.approx(ref, rel=1e-6)
    torch_bce = torch.nn.functional.binary_cross_entropy(_t(probs), _t(labels)).item()
    assert torch_bce != pytest.approx(float(losses.bce_from_probs(_t(labels), _t(probs))),
                                      rel=1e-3)


@pytest.mark.parametrize("name", ["AdversarialLoss", "RaAdversarialLoss", "DiscriminatorLoss",
                                  "RaDiscriminatorLoss"])
@pytest.mark.parametrize("weighted", [False, True])
def test_adversarial_losses_match_jax(name, weighted):
    """Loss and metrics to rel 1e-6, registered under the JAX names."""
    probs, logits, labels = _critics(1)
    critic = logits if name.startswith("Ra") else probs
    sr, hr = critic[:3], critic[3:]
    kw = dict(weighted=weighted, loss_weight=0.25)
    ref_fn, fn = jax_losses.LOSS_REGISTRY[name](**kw), losses.LOSS_REGISTRY[name](**kw)
    if name.endswith("DiscriminatorLoss"):
        args = (sr, hr, labels[:3], labels[3:])
    else:
        args = (np.zeros((3, 8, 8, 3), np.float32), np.zeros((3, 8, 8, 3), np.float32), hr, sr)
    ref_loss, ref_m = ref_fn(*(jnp.asarray(a) for a in args))
    loss, m = fn(*(_t(a) for a in args))
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-6)
    assert m.keys() == ref_m.keys()
    for k in m:
        assert float(m[k]) == pytest.approx(float(ref_m[k]), rel=1e-6)


def _vgg_params(variant):
    return jax.device_get(jax_init_vgg(variant))


@pytest.mark.parametrize("variant", ["vgg19", "vgg16"])
@pytest.mark.parametrize("before", [False, True])
def test_vgg_taps_match_flax(variant, before):
    """Three taps of flax's random-init VGG carried over: rel 1e-5 of each
    tap's largest value (float32 convolutions, summed in another order)."""
    params = _vgg_params(variant)
    layers = ("block1_conv2", "block3_conv1", vgg_layer_names(variant)[-1])
    x = np.random.default_rng(2).uniform(-120, 130, (2, 32, 40, 3)).astype(np.float32)
    ref = JaxVGG(variant=variant, output_layers=layers, before_activation=before).apply(
        params, jnp.asarray(x))
    module = VGGFeatures(variant, layers, before_activation=before)
    module.load_state_dict(from_flax_variables(module, params))
    with torch.no_grad():
        got = module(_t(x))
    assert got.keys() == ref.keys()
    for name in layers:
        want = np.asarray(ref[name]).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(got[name].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=name)
        if not before:
            assert (got[name] >= 0).all()
    assert not any(p.requires_grad for p in module.parameters())
    with pytest.raises(ValueError):
        VGGFeatures(variant, ("block9_conv1",))


@pytest.mark.parametrize("kw", [
    dict(output_layers="block5_conv4", feature_scale=1 / 12.75),
    dict(output_layers=["block2_conv2", "block4_conv3"], feature_scale=0.5, loss_weight=0.3,
         after_activation=False),
    dict(output_layers="block3_conv4", loss_weight=2.0, total_variation_loss=True,
         total_varation_weight=1e-4),
    dict(output_layers=["block1_conv1", "block5_conv3"], vgg16=True),
], ids=["srgan", "two_layers_pre", "tv", "vgg16"])
def test_vgg_loss_matches_jax(kw):
    """VGGLoss (denormalise, caffe preprocess, per-layer MSE with the loss
    weight inside the sum, total variation) to rel 1e-5, and its gradient
    wrt the SR batch to 1e-4 of its largest value (up to 16 float32 convs
    back, summed in another order)."""
    params = _vgg_params("vgg16" if kw.get("vgg16") else "vgg19")
    rng = np.random.default_rng(3)
    hr = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    sr = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ref_fn = jax_losses.VGGLoss(vgg_params=params, **kw)
    fn = losses.VGGLoss(vgg_params=params, **kw)
    ref, ref_m = ref_fn(jnp.asarray(hr), jnp.asarray(sr))
    ref_grad = jax.grad(lambda s: ref_fn(jnp.asarray(hr), s)[0])(jnp.asarray(sr))
    sr_t = _t(sr).requires_grad_(True)
    loss, m = fn(_t(hr), sr_t)
    loss.backward()
    assert loss.item() == pytest.approx(float(ref), rel=1e-5)
    assert m.keys() == ref_m.keys() == {"vgg_loss"}
    np.testing.assert_allclose(sr_t.grad.numpy(), np.asarray(ref_grad), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(ref_grad)).max())
    np.testing.assert_allclose(losses.vgg_preprocess(_t(hr)).numpy(),
                               np.asarray(jax_losses.vgg_preprocess(jnp.asarray(hr))), rtol=1e-6)
    assert float(losses.total_variation(_t(sr))) == pytest.approx(
        float(jax_losses.total_variation(jnp.asarray(sr))), rel=1e-6)


def test_vgg_weights_npz_round_trip_and_fallback(tmp_path, monkeypatch, caplog):
    """An .npz of flax's layout loads into the JAX package's tree shape and
    gives the same loss; SIMPLESR_VGG_WEIGHTS finds it; without weights the
    loss warns and falls back to the seeded init (the same each time)."""
    params = _vgg_params("vgg19")["params"]
    path = tmp_path / "vgg19.npz"
    np.savez(path, **{f"{n}/{k}": np.asarray(v) for n, leaves in params.items()
                      for k, v in leaves.items()})
    loaded = load_vgg_weights_npz(path)
    for name in vgg_layer_names():
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(loaded["params"][name][k], params[name][k])
    monkeypatch.setenv("SIMPLESR_VGG_WEIGHTS", str(path))
    assert default_vgg_weights_path() == str(path)
    x = np.random.default_rng(4).uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    from_env = losses.VGGLoss("block2_conv2")(_t(x), _t(-x))[0]
    from_path = losses.VGGLoss("block2_conv2", custom_weights_path=str(path))(_t(x), _t(-x))[0]
    ref = jax_losses.VGGLoss("block2_conv2", custom_weights_path=str(path))(
        jnp.asarray(x), jnp.asarray(-x))[0]
    assert float(from_env) == float(from_path) == pytest.approx(float(ref), rel=1e-5)

    monkeypatch.delenv("SIMPLESR_VGG_WEIGHTS")
    with caplog.at_level(logging.WARNING, logger="simple_sr"):
        a = losses.VGGLoss("block2_conv2")(_t(x), _t(-x))[0]
    assert "RANDOM-init" in caplog.text
    b = losses.VGGLoss("block2_conv2", vgg_params=init_vgg_params())(_t(x), _t(-x))[0]
    assert float(a) == float(b) and float(a) > 0
    with pytest.raises(ValueError):
        losses.VGGLoss("block2_conv2", custom_weights=True)


@pytest.mark.parametrize("filters,dtype,rel", [(8, "float32", 1e-5), (64, "bfloat16", 2e-2)],
                         ids=["f32", "bf16_trunk_function"])
def test_learned_perceptual_matches_jax(tmp_path, filters, dtype, rel):
    """The trunk features of a saved 2-block SRResNet: float32 to rel 1e-5;
    the bf16 64-filter model, whose trunk is TrunkFunction (SR side) and the
    kernel's plain version (HR side) on the CPU, to rel 2e-2 (flax rounds
    the trunk to bf16 at other points). The SR side takes a gradient; the
    extractor does not."""
    jgen = JaxGenerator.srresnet(4, num_blocks=2, num_filters=filters, batch_norm=False,
                                 dtype=getattr(jnp, dtype), input_dims=(8, 8))
    path = str(tmp_path / "extractor.msgpack")
    jax_save_model(jgen.module_config(), jgen.variables, path)
    rng = np.random.default_rng(5)
    hr = rng.uniform(-1, 1, (2, 12, 12, 3)).astype(np.float32)
    sr = rng.uniform(-1, 1, (2, 12, 12, 3)).astype(np.float32)
    kw = dict(feature_scale=0.5, loss_weight=3.0)
    ref, ref_m = jax_losses.LearnedPerceptualLoss(model_path=path, **kw)(
        jnp.asarray(hr), jnp.asarray(sr))
    fn = losses.LOSS_REGISTRY["LearnedPerceptualLoss"](model_path=path, **kw)
    sr_t = _t(sr).requires_grad_(True)
    loss, m = fn(_t(hr), sr_t)
    loss.backward()
    assert loss.item() == pytest.approx(float(ref), rel=rel)
    assert m.keys() == ref_m.keys()
    assert sr_t.grad is not None and torch.isfinite(sr_t.grad).all()
    assert not any(p.requires_grad for p in fn._module.parameters())
    assert fn._module.uses_trunk_kernel == (filters == 64 and dtype == "bfloat16")
    by_extractor = losses.LearnedPerceptualLoss(
        extractor=(load_model(path, device="cpu"), None), **kw)(_t(hr), _t(sr))[0]
    assert float(by_extractor) == loss.item()
    with pytest.raises(ValueError):
        losses.LearnedPerceptualLoss()
