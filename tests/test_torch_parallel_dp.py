"""The port's data-parallel training (one process a rank, gloo on the CPU)
against the JAX package's SPMD program on a 2-device slice of the 8-device
CPU mesh: the same JAX-initialised weights and seeded batches through both.

Checked against JAX (tolerances of tests/parallel/test_parallel.py, SGD):
the mesh shapes and batch helpers, a BatchNorm SRResNet's parameters and
running statistics, the relativistic GAN step with BatchNorm in the
generator and the critic, and gradient accumulation with a micro-batch
that is not finite on one rank only. Checked against the port on one
process (the JAX package draws its labels from JAX keys, the port from
torch generators, so the smoothed labels can only be held against the
port's own single-device draw, itself held against JAX with smoothing off
in tests/test_torch_gan_step.py): label smoothing, the metrics every rank
records, early stopping and the model file. Also: the uneven and too-small
batch, ``shard_by_process`` and ``data_parallel`` from YAML.

All ranks run once, in the module's fixture (tests/_ranks_dp.py)."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _ranks import assert_close, start_ranks
from simplesr_tpu.models.discriminator import Discriminator as JaxDiscriminatorNet
from simplesr_tpu.parallel import make_mesh as jax_make_mesh
from simplesr_tpu.train import Discriminator as JaxDiscriminator
from simplesr_tpu.train import Generator as JaxGenerator
from simplesr_tpu.train import SRModel as JaxSRModel
from simplesr_tpu.train.serialization import load_model as jax_load_model
from simplesr_tpu_torch.data.png import write_png
from simplesr_tpu_torch.train import Discriminator, Generator
from simplesr_tpu_torch.train.serialization import save_model

WORLD = 2
SGD = dict(rtol=1e-4, atol=1e-5)  # tests/parallel/test_parallel.py:70


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


def _batch(rng, n=4):
    return (rng.uniform(0, 1, (n, 8, 8, 3)).astype(np.float32),
            rng.uniform(-1, 1, (n, 16, 16, 3)).astype(np.float32))


@pytest.fixture(scope="module", autouse=True)
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(0)
    inputs = {"batches": [_batch(rng) for _ in range(3)]}
    for name, bn in (("bn_gen", True), ("plain_gen", False)):
        # initial weights from the port's initialiser, in the format both read
        gen = Generator.srresnet(2, num_blocks=1, num_filters=8, batch_norm=bn,
                                 dtype="float32", seed=1, device="cpu")
        inputs[name] = str(root / f"{name}.msgpack")
        save_model(gen.module_config(), gen.variables, inputs[name])
    inputs["ra_disc"] = Discriminator.initialize_relativistic(
        num_filters=8, input_dims=(16, 16), dtype="float32", device="cpu").variables
    inputs["std_disc"] = Discriminator.initialize_standard(
        num_filters=8, input_dims=(16, 16), dtype="float32", device="cpu").variables
    acc = [_batch(rng) for _ in range(5)]
    acc[2][0][2:] = np.nan  # the third micro-batch: not finite in rank 1's half
    inputs["accum_batches"] = acc
    lr = _batch(rng)[0]
    good = (lr, np.zeros((4, 16, 16, 3), np.float32))  # near the fresh model's output
    bad = (lr, np.ones((4, 16, 16, 3), np.float32))    # far from it: a worse PSNR
    inputs["epochs"] = [(inputs["batches"][0], good), (inputs["batches"][1], bad),
                        (inputs["batches"][2], good)]
    png_dir = root / "pngs"
    png_dir.mkdir()
    for i in range(5):
        write_png(png_dir / f"{i}.png", rng.integers(0, 255, (40, 48, 3), dtype=np.uint8))
    inputs["png_dir"] = str(png_dir)
    inputs["yaml"] = {
        "general": {"operation": "training", "train_data_paths": str(png_dir),
                    "results_save_path": str(root / "results"), "num_epochs": 1,
                    "batch_size": 4, "scale": 2, "train_val_split": 0.2, "crop_imgs": True,
                    "crop_size": (16, 16, 3), "num_crops": 2, "random_seed": 0,
                    "data_parallel": True},
        "model": {"generator": {"upsample_factor": 2, "architecture": "srresnet",
                                "num_blocks": 1, "num_filters": 8, "input_dims": (16, 16),
                                "dtype": "float32",
                                "loss_functions": [{"loss_function": "MeanSquaredError"}]},
                  "generator_optimizer": "Adam",
                  "generator_optimizer_config": {"learning_rate": 1e-3}}}
    # the ranks start from torchrun's variables, through initialize_multihost
    ranks = start_ranks("_ranks_dp", "body", WORLD, root / "ranks", inputs, torchrun=True)
    return inputs, ranks, root


def _jax_mesh():
    return jax_make_mesh(devices=jax.devices()[:WORLD])


def _jax_vars(model, d=False):
    state = model.state
    out = {"params": state.d_params if d else state.g_params}
    stats = state.d_batch_stats if d else state.g_batch_stats
    if stats:
        out["batch_stats"] = stats
    return jax.device_get(out)


def _jax_generator(path):
    module, variables = jax_load_model(path)
    return JaxGenerator.srresnet(upsample_factor=2, num_blocks=1, num_filters=8,
                                 batch_norm=module.batch_norm, dtype=jnp.float32,
                                 input_dims=(8, 8), pretrained_model=(module, variables))


def test_multihost_helpers_on_one_process(tmp_path):
    """tests/parallel/test_multihost_helpers.py's cases on one process: no
    process group, so one host's slice is the whole batch and the helpers
    are no-ops."""
    from simplesr_tpu_torch.data import DataPipeline
    from simplesr_tpu_torch.parallel import global_batch, initialize_multihost, local_batch_slice
    from simplesr_tpu.parallel import local_batch_slice as jax_local_batch_slice

    assert local_batch_slice(32) == jax_local_batch_slice(32) == slice(0, 32)
    assert initialize_multihost(device="cpu") == 1  # no torchrun environment: a no-op
    import torch
    assert not torch.distributed.is_initialized()
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    np.testing.assert_array_equal(np.asarray(global_batch(None, torch.from_numpy(x))), x)
    for i in range(4):
        write_png(tmp_path / f"{i}.png", np.full((32, 32, 3), 40 * i, np.uint8))
    p = DataPipeline(hr_img_path=str(tmp_path), scale=2, train_val_split=0.25, batch_size=4,
                     crop_size=(16, 16, 3), num_crops=1, random_seed=0, shard_by_process=True,
                     device="cpu")
    assert len(p.train_imgs) == 3  # one process: unsharded


def test_a_parallel_option_with_several_cards_and_one_process_raises(tmp_path, monkeypatch):
    """The JAX package would use every visible device; the port runs one
    process a card, and says so rather than train on one card."""
    import torch
    from simplesr_tpu_torch.train import sr_model

    monkeypatch.setattr(sr_model, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cfg = _cfg(tmp_path)
    cfg.data_parallel = True
    gen = Generator.srresnet(2, num_blocks=1, num_filters=8, dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2 -m "
                                         "simplesr_tpu_torch.tools.train"):
        sr_model.SRModel.init(cfg, gen, "SGD")


def test_relativistic_gan_step_matches_jax_mesh(setup, tmp_path):
    inputs, ranks, _ = setup
    # the critic's module, its variables the port's initial ones (the same
    # network, not initialised twice)
    with mock.patch.object(JaxDiscriminatorNet, "init", lambda *a, **kw: inputs["ra_disc"]):
        disc = JaxDiscriminator.initialize_relativistic(num_filters=8, input_dims=(16, 16),
                                                        dtype=jnp.float32)
    jm = JaxSRModel("gan", _jax_generator(inputs["bn_gen"]), "SGD", {"learning_rate": 0.05},
                    disc, "SGD", {"learning_rate": 0.05}, config=_cfg(tmp_path),
                    mesh=_jax_mesh(), async_checkpointing=False)
    jm._state = jm._state.replace(d_params=inputs["ra_disc"]["params"],
                                  d_batch_stats=inputs["ra_disc"]["batch_stats"])
    jm._state = jax.device_put(jm._state, jm._state_sharding)
    for lr, hr in inputs["batches"]:
        jm.train_step(lr, hr)
    for out in ranks:
        assert_close(out["gan"]["g"], _jax_vars(jm), **SGD)
        assert_close(out["gan"]["d"], _jax_vars(jm, d=True), **SGD)


def test_batchnorm_training_matches_jax_mesh(setup, tmp_path):
    inputs, ranks, _ = setup
    jm = JaxSRModel("resnet", _jax_generator(inputs["bn_gen"]), "SGD", {"learning_rate": 0.1},
                    config=_cfg(tmp_path), mesh=_jax_mesh(), seed=0, async_checkpointing=False)
    for lr, hr in inputs["batches"]:
        jm.train_step(lr, hr)
    want = _jax_vars(jm)
    assert "batch_stats" in want
    for out in ranks:  # every rank holds the same state, the JAX one
        assert_close(out["bn"]["vars"], want, **SGD)


def test_mesh_and_batch_helpers(setup):
    _, ranks, _ = setup
    jmesh = _jax_mesh()
    jmesh2 = jax_make_mesh({"data": WORLD, "spatial": -1}, devices=jax.devices()[:WORLD])
    x = np.arange(4 * WORLD * 3, dtype=np.float32).reshape(4 * WORLD, 3)
    for rank, out in enumerate(ranks):
        assert out["mesh"] == dict(jmesh.shape)
        assert out["mesh2"] == dict(jmesh2.shape)
        assert "does not cover" in out["mesh_error"]
        np.testing.assert_array_equal(out["shard"], x[4 * rank:4 * (rank + 1)])
        assert out["slice"] == slice(4 * rank, 4 * (rank + 1))
        np.testing.assert_array_equal(out["global"], x)


def test_metrics_and_model_file_match_one_process(setup, tmp_path):
    """Every rank records the global batch's metrics, the one-process ones;
    rank 0's model file is the format JAX reads, with the state trained."""
    inputs, ranks, _ = setup
    import _ranks_dp
    single = _ranks_dp.SRModel("resnet", _ranks_dp.generator(inputs["bn_gen"], True), "SGD",
                               {"learning_rate": 0.1}, config=_cfg(tmp_path), device="cpu")
    single.before_epoch()
    for lr, hr in inputs["batches"]:
        single.train_step(lr, hr)
        single.after_train_batch()
    single.validation_step(*inputs["batches"][0])
    train, valid = _ranks_dp.epoch_results(single)
    for out in ranks:
        got_train, got_valid = out["bn"]["metrics"]
        assert sorted(got_train) == sorted(train) and sorted(got_valid) == sorted(valid)
        for k in train:
            np.testing.assert_allclose(got_train[k], train[k], rtol=1e-4, err_msg=k)
        for k in valid:
            np.testing.assert_allclose(got_valid[k], valid[k], rtol=1e-4, err_msg=k)
    module, variables = jax_load_model(ranks[0]["bn"]["file"])
    assert module.batch_norm
    assert_close(variables, ranks[0]["bn"]["vars"], rtol=0, atol=0)


def test_label_smoothing_draws_over_the_global_batch(setup, tmp_path):
    inputs, ranks, _ = setup
    import _ranks_dp
    single = _ranks_dp.gan_run(_ranks_dp.models(inputs, tmp_path, None, relativistic_critic=False,
                                                smoothing=True, seed=3), inputs["batches"])
    for out in ranks:
        assert_close(out["smooth"]["g"], single["g"], **SGD)
        assert_close(out["smooth"]["d"], single["d"], **SGD)


def test_grad_accumulation_and_nan_skip_match_jax_mesh(setup, tmp_path):
    inputs, ranks, _ = setup
    jm = JaxSRModel("resnet", _jax_generator(inputs["plain_gen"]), "SGD",
                    {"learning_rate": 0.1}, config=_cfg(tmp_path), mesh=_jax_mesh(), seed=0,
                    grad_accum_steps=2, async_checkpointing=False)
    for lr, hr in inputs["accum_batches"]:
        jm.train_step(lr, hr)
    want = _jax_vars(jm)
    for out in ranks:
        assert (out["accum"]["step"], out["accum"]["dropped"], out["accum"]["updates"]) \
            == (5, 1, 2)
        assert_close(out["accum"]["vars"], want, **SGD)


def test_uneven_batch_is_trimmed_and_a_small_one_skipped(setup):
    _, ranks, _ = setup
    for out in ranks:
        first = out["uneven_steps"][0]
        assert out["uneven_steps"] == [first, first + 1, first + 1]


def test_early_stopping_stops_every_rank_at_once(setup, tmp_path):
    inputs, ranks, _ = setup
    import _ranks_dp
    single = _ranks_dp.SRModel("resnet", _ranks_dp.generator(inputs["plain_gen"], False), "SGD",
                               {"learning_rate": 0.1}, config=_cfg(tmp_path),
                               early_stop_patience=1, device="cpu")
    stopped = []
    for train, valid in inputs["epochs"]:
        single.before_epoch()
        single.train_step(*train)
        single.after_train_batch()
        single.validation_step(*valid)
        single.after_validation_batch()
        single.after_epoch()
        stopped.append(single.stop_early())
        if single.stop_early():
            break
    assert stopped == [False, True]
    for out in ranks:
        assert out["stop"]["stopped"] == stopped
        assert_close(out["stop"]["vars"], _ranks_dp.variables(single.generator()), **SGD)
        for k, v in single.histories()["valid_epoch"].items():
            np.testing.assert_allclose(out["stop"]["history"][k], [float(x) for x in v],
                                       rtol=1e-4, err_msg=k)


def test_shard_by_process_splits_the_files(setup):
    _, ranks, _ = setup
    every = ranks[0]["all_files"]
    parts = [out["files"] for out in ranks]
    assert sorted(sum(parts, [])) == sorted(every)
    for rank, part in enumerate(parts):
        assert part == every[rank::WORLD]


def test_yaml_data_parallel_builds_the_mesh(setup):
    _, ranks, _ = setup
    assert all(out["yaml"]["mesh"] == {"data": WORLD} for out in ranks)
    assert len({out["yaml"]["save_path"] for out in ranks}) == 1  # rank 0's save dir
    assert all(out["yaml"]["finite"] for out in ranks)


def test_initialize_multihost_reads_torchruns_environment(setup):
    """The ranks started from torchrun's variables alone: gloo for the CPU,
    each rank its own, and a second call is a no-op."""
    _, ranks, _ = setup
    for rank, out in enumerate(ranks):
        assert out["init"] == (WORLD, "gloo", WORLD, rank)
