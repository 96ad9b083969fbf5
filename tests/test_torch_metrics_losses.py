"""The port's image metrics, pixel losses, metric accumulators and early
stopping against simplesr_tpu's, on the same numpy arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplesr_tpu.losses import MeanAbsoluteError as JaxMAE
from simplesr_tpu.losses import MeanSquaredError as JaxMSE
from simplesr_tpu.ops import metrics as jax_metrics
from simplesr_tpu.train.early_stopping import EarlyStopping as JaxEarlyStopping
from simplesr_tpu.train.metrics import MetricBundle as JaxMetricBundle
from simplesr_tpu_torch.losses import (LOSS_REGISTRY, MeanAbsoluteError, MeanSquaredError,
                                       adapt_generator_loss)
from simplesr_tpu_torch.ops import metrics
from simplesr_tpu_torch.train import EarlyStopping, MetricBundle


def _pair(shape, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), -1, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", ["mse", "psnr", "psnr_on_y", "ssim"])
@pytest.mark.parametrize("shape", [(2, 24, 20, 3), (17, 15, 3)])
def test_metrics_match_jax(name, shape):
    a, b = _pair(shape)
    got = getattr(metrics, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(getattr(jax_metrics, name)(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5)  # float32 sums in another order


def test_rgb_to_y_and_max_val():
    a, b = _pair((2, 12, 12, 3), seed=1)
    np.testing.assert_allclose(metrics.rgb_to_y(torch.from_numpy(a)).numpy(),
                               np.asarray(jax_metrics.rgb_to_y(jnp.asarray(a))), rtol=1e-6)
    for fn in ("psnr", "ssim"):
        got = getattr(metrics, fn)(torch.from_numpy(a), torch.from_numpy(b), max_val=1.0)
        ref = getattr(jax_metrics, fn)(jnp.asarray(a), jnp.asarray(b), max_val=1.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    with pytest.raises(ValueError):
        metrics.psnr_on_y(torch.zeros(2, 4, 4, 3), torch.zeros(2, 4, 5, 3))
    with pytest.raises(ValueError):
        metrics.psnr(torch.zeros(4, 4), torch.zeros(4, 4))


@pytest.mark.parametrize("weighted,weight", [(False, 1.0), (True, 0.25), (False, 3.0)])
@pytest.mark.parametrize("port_cls,jax_cls", [(MeanSquaredError, JaxMSE),
                                              (MeanAbsoluteError, JaxMAE)])
def test_pixel_losses_match_jax(port_cls, jax_cls, weighted, weight):
    hr, sr = _pair((2, 16, 16, 3), seed=2)
    loss, m = port_cls(weighted=weighted, loss_weight=weight)(torch.from_numpy(hr),
                                                               torch.from_numpy(sr))
    ref_loss, ref_m = jax_cls(weighted=weighted, loss_weight=weight)(jnp.asarray(hr),
                                                                     jnp.asarray(sr))
    assert set(m) == set(ref_m)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    for k in m:
        np.testing.assert_allclose(m[k].item(), float(ref_m[k]), rtol=1e-5)


def test_adapted_callable_and_registry():
    def l1(hr, sr, hr_critic, sr_critic):
        return (hr - sr).abs().sum()

    fn = adapt_generator_loss(l1)
    loss, m = fn(torch.ones(2), torch.zeros(2), None, None)
    assert loss.item() == 2.0 and set(m) == {"l1"}
    mse = MeanSquaredError()
    assert adapt_generator_loss(mse) is mse
    assert LOSS_REGISTRY["MeanSquaredError"] is MeanSquaredError


def test_metric_bundle_matches_jax():
    rng = np.random.default_rng(3)
    values = [{"psnr": rng.uniform(20, 30), "loss": rng.uniform(0, 1)} for _ in range(5)]
    port, ref = MetricBundle(["psnr"]), JaxMetricBundle(["psnr"])
    for v in values:
        port.update({k: torch.tensor(x, dtype=torch.float32) for k, x in v.items()})
        ref.update({k: jnp.asarray(x, jnp.float32) for k, x in v.items()})
    assert port.results().keys() == ref.results().keys()
    for k, v in port.results().items():
        np.testing.assert_allclose(v, ref.results()[k], rtol=1e-6)
    assert {k: float(v) for k, v in port.last_values().items()} == pytest.approx(
        {k: float(v) for k, v in ref.last_values().items()})
    port.reset()
    assert port.results() == {} and np.isnan(port["psnr"].result())


@pytest.mark.parametrize("history", [
    [10.0, 11.0, 10.5, 10.4, 10.3, 12.0, 11.0],
    [5.0, 4.0, 4.5, 3.0, 3.5, 2.0],
    [1.0, 1.0, 1.0, 1.0],
])
def test_early_stopping_matches_jax(history):
    port, ref = EarlyStopping("psnr", patience=2), JaxEarlyStopping("psnr", patience=2)
    for i in range(1, len(history) + 1):
        port.evaluate_stop_criterion(history[:i])
        ref.evaluate_stop_criterion(history[:i])
        assert (port.stop_early(), port.num_epochs_after_best(),
                port.epochs_without_improvement()) == (
            ref.stop_early(), ref.num_epochs_after_best(), ref.epochs_without_improvement())
        assert port.state_dict() == ref.state_dict()
    fresh = EarlyStopping("psnr", patience=2)
    fresh.load_state_dict(port.state_dict())
    assert fresh.state_dict() == port.state_dict() and fresh.best_value == ref.best_value
