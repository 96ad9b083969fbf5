"""The port's SRResNet under ``remat`` and the study tools
(``tools/{remat_study,train_roofline,bf16_grad_study,host_assembly_profile}``)
against the JAX package and the JAX scripts, on the CPU at small sizes
(2 blocks, 8-16 filters, crops of 16-32)."""

import functools
import importlib.util
import json
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplesr_tpu.models import SRResNet as JaxSRResNet
from simplesr_tpu.train import Generator as JaxGenerator
from simplesr_tpu.train import SRModel as JaxSRModel
from simplesr_tpu_torch.models import SRResNet
from simplesr_tpu_torch.tools import (bf16_grad_study, host_assembly_profile, remat_study,
                                      train_roofline)
from simplesr_tpu_torch.train.convert import from_flax_variables, to_flax_variables

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _batch(seed=0, n=2, lr_hw=8, scale=4):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n, lr_hw, lr_hw, 3)).astype(np.float32),
            rng.uniform(-1, 1, (n, scale * lr_hw, scale * lr_hw, 3)).astype(np.float32))


def _port_step(module, lr, hr):
    """Training-mode MSE, its gradients by parameter name, the state after."""
    module.train()
    loss = ((module(torch.from_numpy(lr)) - torch.from_numpy(hr)) ** 2).mean()
    names, params = zip(*module.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return loss.item(), dict(zip(names, grads)), {k: v.clone() for k, v in
                                                   module.state_dict().items()}


# ------------------------------------------------------------ the remat repair

@pytest.mark.parametrize("batch_norm", [True, False], ids=["bn", "no_bn"])
def test_remat_step_equals_plain_step(batch_norm):
    """float32, 2 blocks x 8 filters: with remat the loss, every gradient and
    BatchNorm's running statistics equal the plain step's (to 1e-6; both run
    the same float32 ops, measured bit-equal here), the parameter names are
    the same, and the statistics moved once (one momentum step, not two)."""
    torch.manual_seed(0)
    plain = SRResNet(4, num_filters=8, num_res_blocks=2, batch_norm=batch_norm,
                     dtype=torch.float32)
    remat = SRResNet(4, num_filters=8, num_res_blocks=2, batch_norm=batch_norm,
                     dtype=torch.float32, remat=True)
    remat.load_state_dict(plain.state_dict())
    assert list(remat.state_dict()) == list(plain.state_dict())
    lr, hr = _batch()
    before = {k: v.clone() for k, v in plain.state_dict().items()}
    loss_p, grads_p, state_p = _port_step(plain, lr, hr)
    loss_r, grads_r, state_r = _port_step(remat, lr, hr)
    assert abs(loss_p - loss_r) <= 1e-6 * abs(loss_p)
    for name, g in grads_p.items():
        np.testing.assert_allclose(grads_r[name].numpy(), g.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    for key, v in state_p.items():
        np.testing.assert_allclose(state_r[key].numpy(), v.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=key)
    if batch_norm:
        # one update: running = 0.8 * before + 0.2 * batch mean; a second
        # application would leave 0.64 * before + 0.36 * mean
        bn = remat.blocks[0].conv1.bn
        with torch.no_grad():
            h = remat.head_act(remat.head(torch.from_numpy(lr).permute(0, 3, 1, 2)))
            y = torch.nn.functional.conv2d(h, remat.blocks[0].conv1.conv.weight,
                                           remat.blocks[0].conv1.conv.bias, padding=1)
        mean = y.mean((0, 2, 3))
        want = 0.8 * before["blocks.0.conv1.bn.running_mean"] + 0.2 * mean
        np.testing.assert_allclose(bn.running_mean.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("batch_norm", [True, False], ids=["bn", "no_bn"])
def test_remat_saves_fewer_bytes_for_the_backward(batch_norm):
    """``remat_study.saved_bytes`` (a ``saved_tensors_hooks`` count of the
    distinct storages saved for the backward) falls with remat on."""
    lr, hr = _batch()
    saved = {}
    for remat in (False, True):
        torch.manual_seed(0)
        module = SRResNet(4, num_filters=8, num_res_blocks=2, batch_norm=batch_norm,
                          dtype=torch.float32, remat=remat)
        saved[remat] = remat_study.saved_bytes(lambda: _port_step(module, lr, hr),
                                               module.parameters())
    assert 0 < saved[True] < saved[False]


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("batch_norm", [True, False], ids=["bn", "no_bn"])
def test_remat_step_matches_jax_remat_step(batch_norm):
    """The JAX package's SRResNet(remat=True) and the port's, on the weights
    ``train/convert.py`` carries across (float32, 2 blocks x 8 filters): the
    loss, every gradient and the new batch statistics agree to 1e-4
    relative (tests/models/test_remat.py's bound for gradients)."""
    kw = dict(upsample_factor=4, num_res_blocks=2, num_filters=8, batch_norm=batch_norm,
              dtype=jnp.float32, remat=True)
    ref = JaxSRResNet(**kw)
    lr, hr = _batch(1)
    variables = jax.jit(lambda k, x: ref.init(k, x, train=False))(jax.random.key(0),
                                                                  jnp.asarray(lr))
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}

    def loss(p):
        out = ref.apply({"params": p, **rest}, jnp.asarray(lr), train=True,
                        **({"mutable": ["batch_stats"]} if rest else {}))
        sr, new = out if rest else (out, {})
        return jnp.mean((sr - jnp.asarray(hr)) ** 2), new

    (ref_loss, new_stats), ref_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    module = SRResNet(4, num_filters=8, num_res_blocks=2, batch_norm=batch_norm,
                      dtype=torch.float32, remat=True)
    module.load_state_dict(from_flax_variables(module, variables))
    got_loss, grads, state = _port_step(module, lr, hr)
    assert abs(got_loss - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    got = _flat(to_flax_variables(grads)["params"])
    want = _flat(ref_grads)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    if batch_norm:
        got_stats = _flat(to_flax_variables(state)["batch_stats"])
        for k, v in _flat(new_stats["batch_stats"]).items():
            np.testing.assert_allclose(got_stats[k], v, rtol=1e-4, atol=1e-6, err_msg=k)


# ------------------------------------------------ bf16_grad_study's optimisers

@pytest.mark.parametrize("variant", bf16_grad_study.VARIANTS)
def test_bf16_study_optimizers_match_optax(variant):
    """``StudyAdam(variant)`` against ``scripts/bf16_grad_study._make_tx``
    over three updates of the same parameters and gradients: equal to
    float32 rounding (1e-7 absolute on parameters near 1; measured equal)."""
    import optax

    ref_tx = _script("bf16_grad_study")._make_tx(variant)
    rng = np.random.default_rng(3)
    p0 = [rng.normal(size=(5, 7)).astype(np.float32), rng.normal(size=(4,)).astype(np.float32)]
    grads = [[rng.normal(size=p.shape).astype(np.float32) * 1e-2 for p in p0]
             for _ in range(3)]
    ref = [jnp.asarray(p) for p in p0]
    state = ref_tx.init(ref)
    got = [torch.from_numpy(p.copy()) for p in p0]
    opt = bf16_grad_study.StudyAdam(variant)
    for g in grads:
        updates, state = ref_tx.update([jnp.asarray(x) for x in g], state, ref)
        ref = optax.apply_updates(ref, updates)
        opt.apply(got, [torch.from_numpy(x) for x in g])
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-7)


# ------------------------------------------------- train_roofline's FLOP count

@functools.lru_cache(maxsize=None)
def _xla_flops():
    """(forward, step, parameter count) of the JAX script's ``_flops`` for a
    float32 2-block x 16-filter SRResNet x4 with BatchNorm on 2 LR images of
    8 x 8. Float32: under the bf16 policy XLA:CPU also counts the converts
    it inserts (1.8 % more on the forward, 5 % on the step, measured), which
    are no arithmetic of the model's."""
    roofline = _script("train_roofline")
    gen = JaxGenerator.srresnet(upsample_factor=4, batch_norm=True, dtype=jnp.float32,
                                num_blocks=2, num_filters=16, input_dims=(8, 8))
    module = gen.model()
    lr, hr = (jnp.asarray(a) for a in _batch(0, 2, 8))
    variables = jax.jit(lambda k, x: module.init(k, x, train=False))(jax.random.key(0), lr)
    fwd = roofline._flops(jax.jit(lambda v, x: module.apply(v, x, train=False)), variables, lr)
    model = JaxSRModel(model_type="resnet", generator=gen, generator_optimizer="Adam",
                       generator_optimizer_config={"learning_rate": 1e-4},
                       config=roofline._cfg(tempfile.mkdtemp()))
    # the step the JAX script measures (``model._train_step_fn``), built
    # without running it first
    step = roofline._flops(model._build_train_step(), model.state, lr, hr)
    n = sum(x.size for x in jax.tree_util.tree_leaves(model.state.g_params))
    return fwd, step, n


def test_forward_flops_match_xla_cost_analysis():
    """``srresnet_flops``'s forward within 2 % of XLA's cost analysis of the
    JAX forward (0.04 % here)."""
    fwd, _, n = _xla_flops()
    got = train_roofline.srresnet_flops(2, 8, 8, 4, 16, 2, True, n)["forward"]
    assert abs(got / fwd - 1) < 0.02, (got, fwd)


def test_step_flops_match_xla_cost_analysis():
    """The step's count within 2 % of XLA's cost analysis of the JAX
    package's whole fused step (1.1 % under it here). They differ where the
    JAX step does more than the port's count takes in: the step's PSNR and
    SSIM metrics, which XLA counts; and the analytic count takes the
    backward's elementwise ops as twice the forward's."""
    _, step, n = _xla_flops()
    got = train_roofline.srresnet_flops(2, 8, 8, 4, 16, 2, True, n)["step"]
    assert abs(got / step - 1) < 0.02, (got, step)


def test_valid_taps_count_only_taps_inside_the_image():
    assert train_roofline.valid_taps(1, 3) == 1
    assert train_roofline.valid_taps(4, 3) == 10
    assert train_roofline.valid_taps(100, 9) == 100 * 9 - 2 * (1 + 2 + 3 + 4)


# ----------------------------------------------------- each tool end to end

def test_remat_study_runs_on_the_cpu(capsys):
    """The JAX script's rows and table; XLA's ``temp_size_in_bytes`` is
    ``peak_excess_bytes`` on the card and not measured here, where
    ``saved_bytes`` stands for it."""
    rows = remat_study.main(["--batch", "2", "--crop", "32", "--configs", "srresnet:2,rrdb:1",
                             "--steps", "1", "--device", "cpu"])
    assert [(r["arch"], r["blocks"], r["remat"]) for r in rows] == [
        ("srresnet", 2, False), ("srresnet", 2, True), ("rrdb", 1, False), ("rrdb", 1, True)]
    for r in rows:
        assert r["saved_bytes"] > 0 and r["ms_per_step"] > 0 and "peak_bytes" not in r
    for plain, remat in zip(rows[::2], rows[1::2]):
        assert remat["saved_bytes"] < plain["saved_bytes"]
    out = capsys.readouterr().out
    assert "| model | blocks |" in out and "ratio" in out
    assert json.loads(out.strip().splitlines()[-1])["remat_study"] == json.loads(
        json.dumps(rows))


def test_train_roofline_runs_on_the_cpu(tmp_path, monkeypatch):
    """The JAX script's columns (``step_mxu_util`` is ``step_tc_util``, a
    share of the card's peak, absent from a CPU run) and files; the trunk
    cut to 2 blocks x 16 filters, 1 x 8 for the equal-pixels forwards."""
    monkeypatch.setattr(train_roofline, "BLOCKS", 2)
    monkeypatch.setattr(train_roofline, "FILTERS", 16)
    rows = train_roofline.main(["--fast", "--device", "cpu", "--out", str(tmp_path)])
    assert [(r["batch"], r["crop"], r["batch_norm"]) for r in rows] == [
        (2, 32, True), (2, 32, False)]
    for r in rows:
        for key in set(train_roofline.COLUMNS) - {"step_tc_util"}:
            assert key in r, key
        assert "step_tc_util" not in r and r["device"] == "cpu"
        assert r["bwd_opt_ms"] == pytest.approx(r["step_ms"] - r["fwd_ms"])
        assert r["step_flops"] > 2 * r["fwd_flops"]
    assert json.loads((tmp_path / "RESULTS.json").read_text())["rows"] == rows
    assert "| batch | crop |" in (tmp_path / "RESULTS.md").read_text()
    monkeypatch.setattr(train_roofline, "BLOCKS", 1)
    monkeypatch.setattr(train_roofline, "FILTERS", 8)
    eq = train_roofline.main(["--equal-pixels", "--steps", "1", "--device", "cpu", "--out",
                              str(tmp_path)])
    assert [(r["batch"], r["lr_hw"]) for r in eq] == train_roofline.EQUAL_PIXELS
    assert {"lr_pixels", "fwd_ms", "fwd_tflops"} <= set(eq[0])
    assert (tmp_path / "EQUAL_PIXELS.json").exists()


def test_bf16_grad_study_runs_on_the_cpu(tmp_path, monkeypatch):
    """Four variants with the JAX script's keys, quality cut to 16 crops of
    32 px and one epoch, the model to 1 block x 8 filters."""
    monkeypatch.setattr(bf16_grad_study, "BLOCKS", 1)
    monkeypatch.setattr(bf16_grad_study, "FILTERS", 8)
    monkeypatch.setattr(bf16_grad_study, "QUALITY", dict(bf16_grad_study.QUALITY, crop=32,
                                                         n_train=32, n_val=8))
    res = bf16_grad_study.main(["--steps", "1", "--epochs", "1", "--device", "cpu",
                                "--out", str(tmp_path)])
    assert list(res["variants"]) == list(bf16_grad_study.VARIANTS)
    for r in res["variants"].values():
        assert r["ms_per_step_b16_crop96_x4"] > 0
        assert len(r["val_psnr_curve_x2"]) == 1 and np.isfinite(r["final_val_psnr_x2"])
    assert json.loads((tmp_path / "RESULTS.json").read_text())["variants"].keys() == \
        res["variants"].keys()
    assert "| grads+mu_bf16 |" in (tmp_path / "RESULTS.md").read_text()


def test_host_assembly_profile_runs_on_the_cpu(tmp_path, monkeypatch):
    """The JAX script's keys, 2 crops a tile of 32 px."""
    monkeypatch.setattr(host_assembly_profile, "NUM_CROPS", 2)
    res = host_assembly_profile.main(["--crop", "32", "--batch", "4", "--device", "cpu",
                                      "--out", str(tmp_path)])
    keys = ["decode_cold_s", "decode_cached_s", "crop_bank_s", "crop_bank_mpix_s",
            "stack_mpix_s", "workers=1 (host path)", "workers=2 (host path)",
            "workers=4 (host path)", "device-resident pool", "auto (shipped default)"]
    for key in keys:
        assert np.isfinite(res[key]) and res[key] >= 0, key
    assert res["files"] == 12 and res["upload_mpix_s"] > 0 and res["prepare_mpix_s"] > 0
    assert json.loads((tmp_path / "RESULTS.json").read_text()).keys() == res.keys()
