"""The port's discriminator against simplesr_tpu's: the critic's forward in
both modes with flax's parameters carried over, its BatchNorm running
statistics after one train step's two calls, the flatten order (a
non-square grid, so that a transposed flatten fails), the XLA ``SAME``
padding of the stride-2 convs, the label ranges and the accuracy metrics,
and ``from_yaml``."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplesr_tpu.config.yaml_helper import load_yaml as jax_load_yaml
from simplesr_tpu.train.discriminator import Discriminator as JaxDiscriminator
from simplesr_tpu_torch.config.yaml_helper import load_yaml
from simplesr_tpu_torch.losses import DiscriminatorLoss, RaDiscriminatorLoss
from simplesr_tpu_torch.models.blocks import same_padding
from simplesr_tpu_torch.train import Discriminator

ROOT = Path(__file__).resolve().parents[1]


def _pair(relativistic, dims, dtype, filters=8, gain=3.0):
    """A JAX critic and the port's with its variables. Every kernel is
    scaled by ``gain`` in both, so that the logits are far from 0 (the
    scaled he-normal init shrinks them to about 1e-7 over ten layers)."""
    factory = "initialize_relativistic" if relativistic else "initialize_standard"
    ref = getattr(JaxDiscriminator, factory)(num_filters=filters, input_dims=dims,
                                             dtype=getattr(jnp, dtype))
    ref.set_variables(jax.tree_util.tree_map_with_path(
        lambda path, v: v * gain if jax.tree_util.keystr(path).endswith("['kernel']") else v,
        jax.device_get(ref.variables)))
    got = getattr(Discriminator, factory)(num_filters=filters, input_dims=dims, dtype=dtype,
                                          device="cpu")
    got.set_variables(jax.device_get(ref.variables))
    return ref, got


def _flat(variables):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(variables)}


@pytest.mark.parametrize("relativistic", [False, True], ids=["standard", "relativistic"])
@pytest.mark.parametrize("dims", [(32, 32), (32, 48), (33, 47)], ids=str)
def test_forward_matches_flax_float32(relativistic, dims):
    """Eval and train mode (batch statistics) to 1e-4 of the logits' (or the
    probabilities' distance from 0.5) largest value in float32, on square,
    non-square (a transposed flatten would fail) and odd sizes (other SAME
    padding); the variables come back bit-equal."""
    ref, got = _pair(relativistic, dims, "float32")
    for k, v in _flat(ref.variables).items():
        np.testing.assert_array_equal(_flat(got.variables)[k], v, err_msg=k)
    x = np.random.default_rng(0).uniform(-1, 1, (3, *dims, 3)).astype(np.float32)
    module = got.model()
    for train in (False, True):
        module.train(train)
        want = ref.model().apply(ref.variables, jnp.asarray(x), train=train,
                                 **({"mutable": ["batch_stats"]} if train else {}))
        want = np.asarray(want[0] if train else want)
        with torch.no_grad():
            out = module(torch.from_numpy(x)).numpy()
        assert out.shape == want.shape == (3, 1)
        scale = np.abs(want - (0.0 if relativistic else 0.5)).max()
        assert scale > 1e-3
        np.testing.assert_allclose(out, want, rtol=0, atol=1e-4 * scale)
        if not relativistic:
            assert ((out > 0) & (out < 1)).all()


def test_flatten_order_is_flax_hwc():
    """The Dense 1024 of flax's parameters on a (h, w, c) flatten of the
    last conv's output gives flax's critic; on the (c, h, w) flatten that
    NCHW's plain reshape gives, on a non-square grid, it does not (the
    logits part by far more than the float32 tolerance)."""
    ref, got = _pair(True, (32, 48), "float32")
    module = got.model().eval()
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    want = np.asarray(ref.model().apply(ref.variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        h = torch.from_numpy(x).permute(0, 3, 1, 2)
        for i in range(module.num_layers):
            h = torch.nn.functional.leaky_relu(getattr(module, f"ConvLayer_{i}")(h), 0.2)
        assert h.shape[-2:] == (2, 3)
        logits = {}
        for order, flat in (("hwc", h.permute(0, 2, 3, 1).reshape(2, -1)),
                            ("chw", h.reshape(2, -1))):
            y = torch.nn.functional.leaky_relu(module.Dense_0(flat), 0.2)
            logits[order] = module.Dense_1(y).numpy()
    scale = np.abs(want).max()
    assert scale > 1e-3
    np.testing.assert_allclose(logits["hwc"], want, rtol=0, atol=1e-4 * scale)
    assert np.abs(logits["chw"] - want).max() > 0.1 * scale


@pytest.mark.parametrize("size,stride,expect", [(32, 2, (0, 1)), (33, 2, (1, 1)),
                                                (16, 1, (1, 1)), (1, 2, (1, 1))])
def test_same_padding_is_xla(size, stride, expect):
    assert same_padding(size, 3, stride) == expect


def test_bf16_forward_matches_flax():
    """The bf16 default policy: logits to 2e-2 of their largest value (bf16
    convs and Dense 1024, rounded at other points)."""
    ref, got = _pair(True, (32, 32), "bfloat16", filters=16)
    x = np.random.default_rng(2).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    want = np.asarray(ref.model().apply(ref.variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        out = got.model().eval()(torch.from_numpy(x)).numpy()
    assert out.dtype == np.float32 and np.abs(want).max() > 0.1
    np.testing.assert_allclose(out, want, rtol=0, atol=2e-2 * np.abs(want).max())


def test_running_statistics_after_two_calls():
    """One train step's discriminator branch calls the critic on SR then on
    HR in training mode: momentum 0.8, biased variance, the two updates in
    that order, to 1e-6 of flax's."""
    ref, got = _pair(False, (32, 32), "float32")
    rng = np.random.default_rng(3)
    sr, hr = (rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32) for _ in range(2))
    variables = ref.variables
    for x in (sr, hr):
        _, mut = ref.model().apply(variables, jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
        variables = {**variables, "batch_stats": mut["batch_stats"]}
    module = got.model().train()
    with torch.no_grad():
        for x in (sr, hr):
            module(torch.from_numpy(x))
    want, have = _flat({"batch_stats": variables["batch_stats"]}), _flat(got.variables)
    assert len(want) == 14
    for k, v in want.items():
        np.testing.assert_allclose(have[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    before = _flat(ref.variables)
    assert any(not np.allclose(before[k], v) for k, v in want.items())


def test_labels_and_accuracy():
    """Smoothed labels over 10^4 draws: SR in [0, offset], HR in
    [1 - offset, 1 - offset + 0.5], both ranges nearly filled; without
    smoothing 0 and 1. Accuracies as the JAX package computes them."""
    disc = Discriminator.initialize_standard(label_smoothing=True, smoothing_offset=0.2,
                                             num_filters=8, input_dims=(16, 16), device="cpu")
    critic = torch.zeros((10_000, 1))
    gen = torch.Generator().manual_seed(0)
    sr, hr = disc.get_labels(critic, critic, gen)
    assert 0.0 <= sr.min() and sr.max() <= 0.2 and sr.max() > 0.199 and sr.min() < 1e-3
    assert 0.8 <= hr.min() < 0.801 and 1.299 < hr.max() <= 1.3
    sr2, _ = disc.get_labels(critic, critic, torch.Generator().manual_seed(0))
    assert torch.equal(sr, sr2)
    plain = Discriminator.initialize_relativistic(num_filters=8, input_dims=(16, 16),
                                                  device="cpu")
    sr, hr = plain.get_labels(critic[:3], critic[:3])
    assert torch.equal(sr, torch.zeros(3, 1)) and torch.equal(hr, torch.ones(3, 1))

    sr_c, hr_c = np.array([[0.2], [0.7], [0.4]], np.float32), np.array([[0.5], [0.1], [0.9]],
                                                                      np.float32)
    for rel, fn in ((False, disc), (True, plain)):
        ref = JaxDiscriminator(DiscriminatorLoss(), rel, num_filters=8, input_dims=(16, 16))
        shift = -0.5 if rel else 0.0
        want = ref.accuracy_metrics(jnp.asarray(sr_c + shift), jnp.asarray(hr_c + shift))
        have = fn.accuracy_metrics(torch.from_numpy(sr_c + shift), torch.from_numpy(hr_c + shift))
        assert {k: float(v) for k, v in have.items()} == \
            pytest.approx({k: float(v) for k, v in want.items()})
    loss, metrics = plain.calculate_loss(torch.from_numpy(sr_c), torch.from_numpy(hr_c))
    assert set(metrics) == {"ra_discriminator_loss", "discriminator_accuracy", "SR_accuracy",
                            "HR_accuracy"} and torch.isfinite(loss)


@pytest.mark.parametrize("name", ["srgan_x4.yaml", "esrgan_x4.yaml"])
def test_from_yaml(name):
    """The examples' discriminator sections: the same critic, smoothing,
    losses and Dense width as the JAX package builds; several loss functors
    are summed."""
    spec = load_yaml(str(ROOT / "examples/training" / name))
    assert spec == jax_load_yaml(str(ROOT / "examples/training" / name))
    ref = JaxDiscriminator.from_yaml(spec)
    got = Discriminator.from_yaml(spec, device="cpu")
    assert got.relativistic == ref.relativistic
    assert got._label_smoothing == ref._label_smoothing
    assert got._smoothing_offset == ref._smoothing_offset
    assert [type(f).__name__ for f in got._loss_functions] == \
        [type(f).__name__ for f in ref._loss_functions]
    shapes = {k: v.shape for k, v in _flat(ref.variables).items()}
    assert {k: v.shape for k, v in _flat(got.variables).items()} == shapes
    assert str(got) == str(ref)
    assert got.model().Dense_0.weight.dtype == torch.float32
    assert got.model().dtype == torch.bfloat16

    twice = dict(spec["model"]["discriminator"])
    twice["loss_functions"] = twice["loss_functions"] * 2
    disc = Discriminator.from_yaml({"model": {"discriminator": twice}}, device="cpu")
    critic = torch.full((2, 1), 0.3 if not disc.relativistic else -0.4)
    loss, _ = disc.calculate_loss(critic, -critic if disc.relativistic else critic,
                                  torch.Generator().manual_seed(0))
    one = type(disc._loss_functions[0])()
    single, _ = one(critic, -critic if disc.relativistic else critic,
                    *disc.get_labels(critic, critic, torch.Generator().manual_seed(0)))
    assert float(loss) == pytest.approx(2 * float(single), rel=1e-6)
    assert isinstance(disc.loss_function(), list)
    assert isinstance(Discriminator.from_yaml(spec, device="cpu").loss_function(),
                      (DiscriminatorLoss, RaDiscriminatorLoss))
