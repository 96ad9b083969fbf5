"""The port's optimizers against optax, as simplesr_tpu.train.optimizers
builds it from the same Keras-style config: the same gradient sequence, one
step of it non-finite, through the NaN guard (``optax.apply_if_finite``),
for every optimizer under every schedule."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from simplesr_tpu.train.optimizers import build_optimizer as jax_build_optimizer
from simplesr_tpu_torch.train.optimizers import SkipNonFinite, build_optimizer

SHAPES = [(3, 4), (5,), (2, 3, 3)]
STEPS = 6
NONFINITE_STEP = 2  # after the guard drops it, the boundary at 2 is crossed one step later

SCHEDULES = {
    "constant": 1e-3,
    "piecewise": {"piecewise_constant_decay": {"boundaries": [2], "values": [1e-3, 1e-4]}},
    "exponential": {"exponential_decay": {"initial_learning_rate": 1e-3, "decay_steps": 2,
                                          "decay_rate": 0.5, "staircase": False}},
    "cosine": {"cosine_decay": {"initial_learning_rate": 1e-3, "decay_steps": 4, "alpha": 0.1}},
    "warmup_cosine": {"warmup_cosine_decay": {"initial_learning_rate": 1e-4,
                                              "peak_learning_rate": 1e-3, "warmup_steps": 2,
                                              "decay_steps": 6, "end_learning_rate": 1e-5}},
}
OPTIMIZERS = {
    "Adam": {},
    "AdamW": {"weight_decay": 1e-2},
    "SGD": {"momentum": 0.9, "nesterov": True},
    "RMSprop": {"rho": 0.8, "momentum": 0.5},
}


def _gradients(seed):
    rng = np.random.default_rng(seed)
    steps = [[rng.normal(0, 1, s).astype(np.float32) for s in SHAPES] for _ in range(STEPS)]
    steps[NONFINITE_STEP][1][2] = np.nan
    steps[NONFINITE_STEP][0][0, 1] = np.inf
    return steps


def _run_both(name, config, grads):
    init = [np.random.default_rng(99).normal(0, 1, s).astype(np.float32) for s in SHAPES]
    tx = optax.apply_if_finite(jax_build_optimizer(name, dict(config)),
                               max_consecutive_errors=100)
    jax_params = [jnp.asarray(p) for p in init]
    state = tx.init(jax_params)
    port = SkipNonFinite(build_optimizer(name, dict(config)), max_consecutive_errors=100)
    params = [torch.from_numpy(p.copy()) for p in init]
    applied = []
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        applied.append(port.apply(params, [torch.from_numpy(x) for x in g]))
    return [np.asarray(p) for p in jax_params], [p.numpy() for p in params], applied, port


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_matches_optax_through_the_nan_guard(name, schedule):
    config = {**OPTIMIZERS[name], "learning_rate": SCHEDULES[schedule]}
    ref, got, applied, port = _run_both(name, config, _gradients(len(name) + len(schedule)))
    assert applied == [i != NONFINITE_STEP for i in range(STEPS)]
    assert port.count == STEPS - 1  # the schedule's step counts applied updates only
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)  # float32, another op order


@pytest.mark.parametrize("clipnorm", [0.5, 100.0])
def test_clipnorm_matches_optax(clipnorm):
    config = {"learning_rate": 1e-2, "clipnorm": clipnorm}
    ref, got, _, _ = _run_both("Adam", config, _gradients(3))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_guard_lets_one_through_after_max_consecutive_errors():
    port = SkipNonFinite(build_optimizer("SGD", {"learning_rate": 0.1}),
                         max_consecutive_errors=3)
    params = [torch.ones(2)]
    bad = [torch.tensor([1.0, float("nan")])]
    assert [port.apply(params, bad) for _ in range(5)] == [False, False, False, True, True]
    assert port.notfinite_count == 5 and port.total_notfinite == 5
    assert torch.isnan(params[0][1])
    port.apply(params, [torch.zeros(2)])
    assert port.notfinite_count == 0


def test_state_dict_round_trip_continues_identically():
    grads = _gradients(5)
    grads[NONFINITE_STEP] = [np.zeros(s, np.float32) for s in SHAPES]
    config = {"learning_rate": SCHEDULES["piecewise"]}
    a = SkipNonFinite(build_optimizer("Adam", dict(config)))
    pa = [torch.ones(s) for s in SHAPES]
    for g in grads[:3]:
        a.apply(pa, [torch.from_numpy(x) for x in g])
    b = SkipNonFinite(build_optimizer("Adam", dict(config)))
    b.load_state_dict(a.state_dict())
    pb = [p.clone() for p in pa]
    for g in grads[3:]:
        a.apply(pa, [torch.from_numpy(x) for x in g])
        b.apply(pb, [torch.from_numpy(x) for x in g])
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))


@pytest.mark.parametrize("step", [0, 1, 2, 3, 7])
def test_piecewise_switches_only_after_the_boundary(step):
    from simplesr_tpu.train.optimizers import piecewise_constant_decay as jax_piecewise
    from simplesr_tpu_torch.train.optimizers import piecewise_constant_decay

    got = piecewise_constant_decay([2, 5], [1e-3, 1e-4, 1e-5])(step)
    ref = float(jax_piecewise([2, 5], [1e-3, 1e-4, 1e-5])(step))
    assert np.float32(got) == np.float32(ref)


def test_unknown_names_raise():
    with pytest.raises(ValueError):
        build_optimizer("Adagrad")
    with pytest.raises(ValueError):
        build_optimizer("Adam", {"learning_rate": {"linear": {}}})
