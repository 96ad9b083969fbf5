"""The port's polyphase serving form against simplesr_tpu's: the weight
transforms bit for bit, SRResNetPolyphase and RRDBNetPolyphase against flax
``apply`` on the same variables and inputs (the JAX side eager on the CPU),
the committed bf16 flagship at the bounds of tests/test_torch_srresnet.py,
and ``fast_inference``'s dispatch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplesr_tpu.models import RRDBNet as FlaxRRDBNet
from simplesr_tpu.models import SRResNet as FlaxSRResNet
from simplesr_tpu.models import polyphase as jax_poly
from simplesr_tpu.ops import polyphase as jax_ops
from simplesr_tpu.train.serialization import load_model as jax_load_model
from simplesr_tpu_torch.models import build_generator_model, polyphase
from simplesr_tpu_torch.ops import polyphase as ops
from simplesr_tpu_torch.train import from_flax_variables, load_model
from test_torch_srresnet import _port, _randomised, _run

FLAGSHIP = "results/quality_fastrecipe/models/resnet_gen_srresnet_x4_best.msgpack"
# Both packages on the same float32 weights and inputs: the same products,
# summed in another order (measured under 1e-6 on these models).
F32_TOL = 1e-5


def _assert_trees_equal(got, ref):
    assert isinstance(got, dict) == isinstance(ref, dict)
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _assert_trees_equal(got[k], ref[k])
    else:
        ref = np.asarray(ref)
        got = np.asarray(got)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("s", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [3, 5, 9])
def test_weight_transforms_are_bit_equal(k, s):
    rng = np.random.default_rng(10 * k + s)
    kernel = rng.normal(size=(k, k, 2, 3)).astype(np.float32)
    bias = rng.normal(size=(3,)).astype(np.float32)
    assert ops.coarse_kernel_taps(k, s) == jax_ops.coarse_kernel_taps(k, s)
    got, got_b = ops.coarsen_conv_kernel(kernel, s, bias)
    ref, ref_b = jax_ops.coarsen_conv_kernel(kernel, s, bias)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got_b, ref_b)
    assert ops.coarsen_conv_kernel(kernel, s)[1] is None
    np.testing.assert_array_equal(ops.tile_phase(bias, s), jax_ops.tile_phase(bias, s))
    for c in (1, 3):
        np.testing.assert_array_equal(ops.phase_merge_permutation(s, 2, c),
                                      jax_ops.phase_merge_permutation(s, 2, c))
        np.testing.assert_array_equal(ops.phase_split_permutation(s, 2, c),
                                      jax_ops.phase_split_permutation(s, 2, c))
    with pytest.raises(ValueError):
        ops.coarse_kernel_taps(k + 1, s)


def _srresnet_pair(scale, batch_norm, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (2, 7, 9, 3)).astype(np.float32)
    flax_model = FlaxSRResNet(upsample_factor=scale, num_filters=16, num_res_blocks=2,
                              batch_norm=batch_norm, dtype=jnp.float32)
    variables = _randomised(flax_model.init(jax.random.key(seed), jnp.asarray(x)), rng)
    port = _port(variables, upsample_factor=scale, num_blocks=2, num_filters=16,
                 batch_norm=batch_norm, dtype="float32")
    return x, flax_model, variables, port


@pytest.mark.parametrize("scale", [2, 4, 8])
@pytest.mark.parametrize("batch_norm", [False, True])
def test_srresnet_polyphase_matches_flax_and_training_form(scale, batch_norm):
    x, flax_model, variables, port = _srresnet_pair(scale, batch_norm, scale + 10 * batch_norm)
    flax_poly, flax_vars = jax_poly.polyphase_model(flax_model, variables)
    ref = np.asarray(flax_poly.apply(flax_vars, jnp.asarray(x), train=False))

    poly, state = polyphase.polyphase_model(port)
    assert type(poly).__name__ == type(flax_poly).__name__ == "SRResNetPolyphase"
    # the transformed tree is flax's, bit for bit, and fills the module exactly
    got_vars = polyphase.polyphase_variables(port, polyphase.flax_tree(port.state_dict()))
    _assert_trees_equal(got_vars, jax.device_get(flax_vars))
    assert set(state) == set(poly.state_dict())
    got = _run(poly, x)
    assert got.shape == ref.shape == (2, 7 * scale, 9 * scale, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(got, _run(port, x), rtol=0, atol=F32_TOL)


def test_polyphase_keeps_the_trunk_and_out_dtype():
    """The serving form shares ``features`` (and with it the trunk kernel's
    route) with the training form; ``out_dtype=bfloat16`` runs the output
    conv in bf16 and stays within bf16 rounding of the float32 one."""
    port = load_model(FLAGSHIP, device="cpu")
    poly, _ = polyphase.polyphase_model(port)
    assert poly.uses_trunk_kernel and not hasattr(poly, "upsample") and not hasattr(poly, "out")
    x = np.random.default_rng(5).uniform(0, 1, (1, 10, 12, 3)).astype(np.float32)
    with torch.inference_mode():
        h = port.features(torch.from_numpy(x))
        assert torch.equal(poly.features(torch.from_numpy(x)), h)
        f32 = poly.tail(h)
        bf16, _ = polyphase.polyphase_model(port, out_dtype=torch.bfloat16)
        assert bf16.PolyOut.weight.dtype == torch.float32
        assert (bf16.tail(h) - f32).abs().max().item() < 2e-2  # bf16 inputs to one conv


def test_committed_flagship_at_bf16_matches_flax():
    """At bf16 through 16 blocks the port and flax round at other points
    (tests/test_torch_srresnet.py: max 0.1, mean 0.01 on [-1, 1]); and the
    port's serving form is no further from the float32 forward than flax's
    bf16 serving form is, up to 1.5x in mean."""
    module, variables = jax_load_model(FLAGSHIP)
    flax_poly, flax_vars = jax_poly.polyphase_model(module, variables)
    f32_poly, f32_vars = jax_poly.polyphase_model(module.clone(dtype=jnp.float32), variables)
    poly, _ = polyphase.polyphase_model(load_model(FLAGSHIP, device="cpu"))
    for seed in range(2):
        x = np.random.default_rng(seed).uniform(0, 1, (1, 12, 16, 3)).astype(np.float32)
        ref = np.asarray(flax_poly.apply(flax_vars, jnp.asarray(x), train=False))
        exact = np.asarray(f32_poly.apply(f32_vars, jnp.asarray(x), train=False))
        got = _run(poly, x)
        diff = np.abs(got - ref)
        assert diff.max() < 0.1 and diff.mean() < 0.01, (diff.max(), diff.mean())
        assert np.abs(got - exact).mean() <= 1.5 * np.abs(ref - exact).mean()


@pytest.mark.parametrize("scale,mode", [(2, "up"), (2, "2phase"), (2, "full"), (4, "up"),
                                        (4, "2phase"), (4, "full"), (8, "2phase")])
def test_rrdb_polyphase_matches_flax(scale, mode):
    rng = np.random.default_rng(scale)
    x = rng.uniform(0, 1, (2, 6, 7, 3)).astype(np.float32)
    flax_model = FlaxRRDBNet(upsample_factor=scale, num_filters=8, num_rrdb_blocks=1,
                             num_dense_blocks=1, num_convs=2, dtype=jnp.float32)
    variables = _randomised(flax_model.init(jax.random.key(scale), jnp.asarray(x)), rng)
    flax_poly, flax_vars = jax_poly.rrdb_polyphase_model(flax_model, variables, mode=mode)
    ref = np.asarray(flax_poly.apply(flax_vars, jnp.asarray(x), train=False))
    port = _port(variables, upsample_factor=scale, architecture="rrdb", num_blocks=1,
                 num_filters=8, num_dense_blocks=1, num_convs=2, dtype="float32")
    poly, _ = polyphase.rrdb_polyphase_model(port, mode=mode)
    got_vars = polyphase.rrdb_polyphase_variables(port, polyphase.flax_tree(port.state_dict()),
                                                   mode)
    _assert_trees_equal(got_vars, jax.device_get(flax_vars))
    got = _run(poly, x)
    assert got.shape == ref.shape == (2, 6 * scale, 7 * scale, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(got, _run(port, x), rtol=0, atol=F32_TOL)
    with pytest.raises(ValueError):
        polyphase.RRDBNetPolyphase(upsample_factor=scale, num_filters=8, mode="half")


def test_fast_inference_dispatches_as_jax():
    """SRResNet -> polyphase, or paired (+ polyphase); RRDB -> unchanged
    unless paired; anything else unchanged, in both packages."""
    from simplesr_tpu_torch.models import Discriminator

    x = jnp.zeros((2, 6, 6, 3))
    flax_sr = FlaxSRResNet(upsample_factor=2, num_filters=8, num_res_blocks=1,
                           batch_norm=False, dtype=jnp.float32)
    flax_rrdb = FlaxRRDBNet(upsample_factor=2, num_filters=8, num_rrdb_blocks=1,
                            num_dense_blocks=1, num_convs=1, dtype=jnp.float32)
    flax_vars = {m: m.init(jax.random.key(0), x) for m in (flax_sr, flax_rrdb)}
    sr = _port(flax_vars[flax_sr], upsample_factor=2, num_blocks=1, num_filters=8,
               batch_norm=False, dtype="float32")
    rrdb = _port(flax_vars[flax_rrdb], upsample_factor=2, architecture="rrdb", num_blocks=1,
                 num_filters=8, num_dense_blocks=1, num_convs=1, dtype="float32")
    for (flax_m, port_m) in ((flax_sr, sr), (flax_rrdb, rrdb)):
        for kwargs in ({}, {"paired_ways": 2}, {"paired_ways": 2, "polyphase": False},
                       {"polyphase": False}):
            if "polyphase" in kwargs and not kwargs.get("paired_ways"):
                continue  # JAX's callers reach fast_inference with fast=False only if paired
            want, _ = jax_poly.fast_inference(flax_m, flax_vars[flax_m], **kwargs)
            got, state = polyphase.fast_inference(port_m, **kwargs)
            assert type(got).__name__ == type(want).__name__, kwargs
            assert set(state) == set(got.state_dict())
            if type(want) is type(flax_m):
                assert got is port_m
    critic = Discriminator()
    assert polyphase.fast_inference(critic)[0] is critic
    with pytest.raises(TypeError):
        polyphase.polyphase_model(rrdb)
    with pytest.raises(TypeError):
        polyphase.rrdb_polyphase_model(sr)


def test_crd_shuffle_in_place_of_dcr_is_caught(monkeypatch):
    """torch's pixel_shuffle (CRD order) in place of the DCR depth_to_space
    scrambles the phase tensor: the comparison above fails by far."""
    x, flax_model, variables, port = _srresnet_pair(4, False, 3)
    flax_poly, flax_vars = jax_poly.polyphase_model(flax_model, variables)
    ref = np.asarray(flax_poly.apply(flax_vars, jnp.asarray(x), train=False))
    poly, _ = polyphase.polyphase_model(port)
    np.testing.assert_allclose(_run(poly, x), ref, rtol=0, atol=F32_TOL)
    monkeypatch.setattr(polyphase, "depth_to_space_nchw",
                        lambda h, r: torch.nn.functional.pixel_shuffle(h, r))
    assert np.abs(_run(poly, x) - ref).max() > 100 * F32_TOL


def test_flagship_serving_form_against_training_form_at_bf16():
    """The bound chip_smoke.py phase 11 holds the card to: the flagship's
    polyphase form against its training form, both at bf16 (measured on 4
    gallery crops: max 7.2e-5, mean 4.4e-7 on [-1, 1]: PolyUp_2 and PolyOut
    sum the same products in another order, and a bf16 rounding of PolyUp_2
    flips now and then), and the evaluation's metrics of the two forms, on a
    gallery crop."""
    from pathlib import Path

    from simplesr_tpu_torch.data.image import read_img
    from simplesr_tpu_torch.eval.evaluation import _as_predictor
    from simplesr_tpu_torch.ops import metrics

    fast = _as_predictor(FLAGSHIP, device="cpu")
    slow = _as_predictor(FLAGSHIP, fast=False, device="cpu")
    gallery = sorted(Path("data/corpus/gallery").glob("*.png"))
    for path in gallery[:1]:
        hr = torch.from_numpy(read_img(path)[:96, :128] / 127.5 - 1.0).float()[None]
        x = torch.from_numpy(read_img(path)[:24, :32] / 255.0).float()[None]
        a, b = fast(x), slow(x)
        diff = (a - b).abs()
        assert diff.max().item() < 5e-3 and diff.mean().item() < 5e-5  # chip_smoke's bounds
        for fn, tol in ((metrics.psnr, 1e-2), (metrics.ssim, 1e-4)):
            delta = (fn(hr, a, max_val=2.0) - fn(hr, b, max_val=2.0)).abs().max().item()
            assert delta < tol, (fn.__name__, delta)


@pytest.fixture
def one_torch_thread():
    """torch on one thread for the test: RRDB's forward is thousands of
    small ops, and with the tier-1 run's six workers each on all cores their
    thread pools thrash (measured 136 s under load against 24 s on one
    thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_committed_rrdb_serving_forms_at_bf16(one_torch_thread):
    """The bound chip_smoke.py phase 11 holds the card to for the committed
    quality_r4 RRDB on a 32 x 40 gallery crop: its paired and polyphase
    ("up") forms at bf16 against its training form at bf16 (two summation
    orders of one bf16 model: the rewrites are exact, tests above), and
    against their own float32 forms no further than the training form is
    from its own, up to 1.5x in mean. Measured: the training form 0.0207
    from its float32 form (mean 1.22e-3), the forms 5.0e-5 and 1.2e-4 from
    the training form, each mean ratio 1.00."""
    from simplesr_tpu_torch.data.png import read_png
    from simplesr_tpu_torch.models.paired import rrdb_paired_model
    from simplesr_tpu_torch.train import load_payload

    path = "results/quality_r4/models/resnet_gen_rrdb_x4_best.msgpack"
    crop = read_png("data/corpus/gallery/gt_3.png")[:32, :40, :3] / 255.0
    x = np.stack([crop, crop[:, ::-1]]).astype(np.float32)
    config, tree = load_payload(path)
    port = load_model(path, device="cpu")
    port_f32 = build_generator_model(**dict(config, dtype="float32"), device="cpu")
    port_f32.load_state_dict(from_flax_variables(port_f32, tree))
    training, training_f32 = _run(port, x), _run(port_f32, x)
    assert np.abs(training - training_f32).max() < 5e-2  # chip_smoke's ROUTE_MAX_ABS_TOL
    for name, form in (("paired", lambda m: rrdb_paired_model(m, ways=2)[0]),
                       ("up", lambda m: polyphase.rrdb_polyphase_model(m, mode="up")[0])):
        got, exact = _run(form(port), x), _run(form(port_f32), x)
        assert np.abs(got - training).max() < 5e-2, name
        assert np.abs(got - exact).mean() <= 1.5 * np.abs(training - training_f32).mean(), name
