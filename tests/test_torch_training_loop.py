"""The YAML training run of the port against simplesr_tpu's: the same YAML
dict through ``ConfigUtil.from_yaml`` and ``run_training`` in both
packages, from the same seeded weights (the JAX generator's, converted),
the TensorBoard scalars of the two runs (tensorboardX's files against the
port's own, batch scalars at every step), and the port's preemption, resume
and ``tools.train`` exit codes.

Tolerances: a float32 16-wide, 2-block x4 model trained by SGD for 2
epochs on bit-equal HR batches (LR within 1e-5): the two packages sum
convolutions in other orders, so the epoch histories agree within rel 1e-4,
the final parameters within atol 1e-4, and the final evaluation's PSNR and
SSIM within rel 1e-4.
"""

import copy
import os
import signal
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from simplesr_tpu.config import ConfigUtil as JaxConfigUtil
from simplesr_tpu.eval import evaluation as jax_evaluation
from simplesr_tpu.train import run_training as jax_run_training
from simplesr_tpu.train.serialization import load_model as jax_load_model
from simplesr_tpu_torch.config import ConfigUtil, _yaml
from simplesr_tpu_torch.eval import evaluation
from simplesr_tpu_torch.tools import train as train_tool
from simplesr_tpu_torch.train import from_flax_variables, run_training, to_flax_variables
from simplesr_tpu_torch.train import training as training_mod
from simplesr_tpu_torch.utils.tensorboard import event_files, read_scalars

GALLERY = str(Path(__file__).resolve().parents[1] / "data/corpus/gallery")
REL, ATOL = 1e-4, 1e-4


def _yaml_dict(results, optimizer="SGD", lr=0.05, epochs=2):
    return {
        "general": {
            "operation": "training", "train_data_paths": GALLERY,
            "results_save_path": str(results), "num_epochs": epochs, "batch_size": 16,
            "scale": 4, "train_val_split": 0.1, "crop_imgs": True,
            "crop_size": (32, 32, 3), "num_crops": 2,
            "augmentations": ["flip_along_x", "flip_along_y"], "random_seed": 0,
            "early_stop_metric": "psnr", "early_stop_patience": 5,
        },
        "model": {
            "generator": {
                "upsample_factor": 4, "architecture": "srresnet", "num_blocks": 2,
                "num_filters": 16, "batch_norm": False, "dtype": "float32",
                "loss_functions": [{"loss_function": "MeanSquaredError"}],
            },
            "generator_optimizer": optimizer,
            "generator_optimizer_config": {"learning_rate": lr},
        },
    }


def _load_jax_weights(port_model, jax_model):
    module = port_model.generator()
    state = from_flax_variables(module, {"params": jax_model.state.g_params})
    module.load_state_dict(state)


def _tree(root):
    """Relative paths of the run's files and directories, without the
    packages' own checkpoint formats; a TensorBoard event file counts under
    its name without the time and host."""
    out = set()
    for dirpath, dirnames, filenames in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if rel.startswith("checkpoints" + os.sep):
            continue
        out.add(rel)
        out.update(os.path.normpath(os.path.join(
            rel, "events.out.tfevents" if "tfevents" in f else f)) for f in filenames)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    jax_conf, jax_pipe, jax_model = JaxConfigUtil.from_yaml(_yaml_dict(root / "jax"))
    conf, pipe, model = ConfigUtil.from_yaml(_yaml_dict(root / "torch"), device="cpu")
    _load_jax_weights(model, jax_model)
    jax_model._tb_batch_interval = model._tb_batch_interval = 1  # batch scalars at every step
    jax_result = jax_run_training(jax_conf, jax_pipe, jax_model)
    result = run_training(conf, pipe, model, device="cpu")
    return dict(jax=(jax_conf, jax_pipe, jax_model, jax_result),
                torch=(conf, pipe, model, result))


def test_histories_match_jax(runs):
    jax_model, jax_result = runs["jax"][2:]
    model, result = runs["torch"][2:]
    assert result is not None and jax_result is not None
    for key in ("train_epoch", "valid_epoch", "train_batch", "valid_batch"):
        got, ref = model.histories()[key], jax_model.histories()[key]
        assert sorted(got) == sorted(ref), key
        for name in ref:
            g = np.asarray([float(v) for v in got[name]])
            r = np.asarray([float(v) for v in ref[name]])
            assert g.shape == r.shape and np.all(np.isfinite(g)), (key, name)
            np.testing.assert_allclose(g, r, rtol=REL, err_msg=f"{key} {name}")
    assert len(model.histories()["train_epoch"]["generator_loss"]) == 2
    assert model.iterations() == jax_model.iterations() == 2 * 6


def test_final_parameters_and_best_file_match_jax(runs):
    jax_conf, _, jax_model, _ = runs["jax"]
    conf, _, model, _ = runs["torch"]
    got = to_flax_variables(model.generator().state_dict())["params"]
    flat_ref = {k: np.asarray(v) for k, v in _flatten(jax_model.state.g_params).items()}
    flat_got = {k: np.asarray(v) for k, v in _flatten(got).items()}
    assert flat_got.keys() == flat_ref.keys()
    for k in flat_ref:
        np.testing.assert_allclose(flat_got[k], flat_ref[k], atol=ATOL, err_msg=k)
    # the port's _best file loads in the JAX package, bit-equal to the port's weights
    best = Path(conf.model_dir) / "resnet_gen_best.msgpack"
    _, variables = jax_load_model(str(best))
    for k, v in _flatten(variables["params"]).items():
        np.testing.assert_array_equal(np.asarray(v), flat_got[k], err_msg=k)


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def test_files_match_jax(runs):
    jax_conf = runs["jax"][0]
    conf = runs["torch"][0]
    got, ref = _tree(conf.save_path), _tree(jax_conf.save_path)
    assert got == ref, (got ^ ref)
    for name in ("train_batch", "train_epoch", "valid_batch", "valid_epoch"):
        assert f"json_dump/resnet_{name}_history.json" in got
    assert {"models/resnet_gen_best.msgpack", "perf_logfile", "config_logfile"} <= got
    assert os.path.islink(Path(conf.save_path).parent / "latest")


LOG_DIRS = ("train/batch", "train/epoch", "val/batch", "val/epoch")


def _jax_scalars(jax_conf):
    """The JAX run's scalars by log directory, its tensorboardX writers
    flushed first (they write from a thread every two minutes)."""
    for name in ("epoch_train", "batch_train", "epoch_validation", "batch_validation"):
        getattr(jax_conf, f"{name}_summary_writer").flush()
    return {d: read_scalars(Path(jax_conf.save_path) / "logs" / d) for d in LOG_DIRS}


def test_tensorboard_scalars_match_jax(runs):
    jax_conf, jax_model = runs["jax"][0], runs["jax"][2]
    conf, model = runs["torch"][0], runs["torch"][2]
    ref = _jax_scalars(jax_conf)
    for d in LOG_DIRS:
        jax_files = event_files(Path(jax_conf.save_path) / "logs" / d)
        files = event_files(Path(conf.save_path) / "logs" / d)
        assert len(jax_files) == len(files) == 1, d
        got = read_scalars(files[0])
        assert sorted(got) == sorted(ref[d]) and got, d
        for tag in ref[d]:
            g, r = np.asarray(got[tag]), np.asarray(ref[d][tag])
            assert g.shape == r.shape, (d, tag)
            np.testing.assert_array_equal(g[:, 0], r[:, 0], err_msg=f"{d} {tag} steps")
            np.testing.assert_allclose(g[:, 1], r[:, 1], rtol=REL, err_msg=f"{d} {tag}")
    # batch scalars at every train step, epoch scalars at epochs 1 and 2
    steps = {s for values in ref["train/batch"].values() for s, _ in values}
    assert steps == set(range(1, model.iterations() + 1))
    assert {s for values in ref["val/epoch"].values() for s, _ in values} == {1, 2}
    # the epoch scalars are the epoch histories, at float32
    for d, key in (("train/epoch", "train_epoch"), ("val/epoch", "valid_epoch")):
        for tag, values in read_scalars(Path(conf.save_path) / "logs" / d).items():
            history = np.float32([float(v) for v in model.histories()[key][tag]])
            np.testing.assert_array_equal(np.float32([v for _, v in values]), history, err_msg=tag)


def test_tensorboard_loads_the_port_files(runs, monkeypatch):
    """TensorBoard's own loader reads the port's files: the same scalars
    (it moves a simple value into a float32 tensor) and the file version."""
    monkeypatch.setitem(sys.modules, "tensorflow", sys.modules.get("tensorflow"))  # no import
    from tensorboard.backend.event_processing.event_file_loader import EventFileLoader
    from tensorboard.util import tensor_util

    conf = runs["torch"][0]
    for d in LOG_DIRS:
        (path,) = event_files(Path(conf.save_path) / "logs" / d)
        events = list(EventFileLoader(str(path)).Load())
        assert events[0].file_version == "brain.Event:2"
        loaded = {}
        for event in events[1:]:
            for value in event.summary.value:
                loaded.setdefault(value.tag, []).append(
                    (event.step, float(tensor_util.make_ndarray(value.tensor))))
        assert loaded == read_scalars(path), d


def test_final_evaluation_matches_jax(runs):
    jax_conf, jax_pipe, jax_model, _ = runs["jax"]
    conf, pipe, model, _ = runs["torch"]
    ref = jax_evaluation.evaluate_on_validationdata(jax_conf, "resnet", jax_pipe, jax_model,
                                                    calc_stats=True)
    got = evaluation.evaluate_on_validationdata(conf, "resnet", pipe, model, calc_stats=True,
                                                device="cpu")
    assert sorted(got) == sorted(ref) == ["bicubic", "resnet"]
    for name in ref:
        for metric in ("psnr", "psnr-y", "ssim"):
            assert got[name][metric].shape == ref[name][metric].shape == (4,)
            np.testing.assert_allclose(got[name][metric], ref[name][metric], rtol=REL,
                                       err_msg=f"{name} {metric}")


def _preempt_after(monkeypatch, steps):
    """Make the next run_training preempted after ``steps`` train steps:
    SIGTERM itself where the handler is installed (the main thread),
    else its event."""
    install = training_mod._install_preemption_handler
    state = {}

    def installer():
        state["event"], restore = install()
        return state["event"], restore

    monkeypatch.setattr(training_mod, "_install_preemption_handler", installer)
    from simplesr_tpu_torch.train import SRModel
    step = SRModel.train_step
    count = [0]

    def counted(self, lr, hr):
        step(self, lr, hr)
        count[0] += 1
        if count[0] == steps:
            if threading.current_thread() is threading.main_thread():
                signal.raise_signal(signal.SIGTERM)
            else:
                state["event"].set()
            assert state["event"].is_set()

    monkeypatch.setattr(SRModel, "train_step", counted)
    return count


def _state(model):
    return (copy.deepcopy({k: v.clone() for k, v in model.generator().state_dict().items()}),
            copy.deepcopy(model.optimizer.state_dict()), model.step, model._epochs,
            copy.deepcopy(model.histories()["train_epoch"]),
            copy.deepcopy(model.histories()["valid_epoch"]),
            model._early_stopping_util.state_dict())


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_preemption_and_resume_restore_exactly(tmp_path, monkeypatch):
    handler = signal.getsignal(signal.SIGTERM)
    spec = _yaml_dict(tmp_path, optimizer="Adam", lr=1e-3)
    conf, pipe, model = ConfigUtil.from_yaml(copy.deepcopy(spec), device="cpu")
    assert run_training(conf, pipe, model, device="cpu") is not None  # 2 epochs
    saved = _state(model)
    monkeypatch.undo()

    # a third epoch, preempted after 2 of its steps
    spec3 = copy.deepcopy(spec)
    spec3["general"].update(num_epochs=3, resume=True)
    conf, pipe, model = ConfigUtil.from_yaml(copy.deepcopy(spec3), device="cpu")
    count = _preempt_after(monkeypatch, 2)
    assert run_training(conf, pipe, model, device="cpu") is None
    assert count[0] == 2 and signal.getsignal(signal.SIGTERM) == handler
    preempted = _state(model)
    assert preempted[2] == saved[2] + 2 and preempted[3] == 3
    monkeypatch.undo()

    # a fresh process's view: the resume point holds the preempted state
    conf, pipe, fresh = ConfigUtil.from_yaml(copy.deepcopy(spec3), device="cpu")
    assert fresh.resume_training() == 2
    restored = _state(fresh)
    for i, name in enumerate(("params", "optimizer", "step")):
        assert _equal(restored[i], preempted[i]), name
    assert restored[3] == 2
    for i in (4, 5, 6):  # epoch histories and early stopping: those of epoch 2
        assert _equal(restored[i], saved[i])

    # resumed: runs the third epoch only
    conf, pipe, model = ConfigUtil.from_yaml(copy.deepcopy(spec3), device="cpu")
    assert run_training(conf, pipe, model, device="cpu") is not None
    assert model._epochs == 3 and model.iterations() == preempted[2] + 6
    assert len(model.histories()["train_epoch"]["generator_loss"]) == 3
    assert len(model.histories()["train_batch"]["generator_loss"]) == 6


def test_train_tool_exit_codes(tmp_path, monkeypatch):
    path = tmp_path / "run.yaml"
    path.write_text(_yaml.dump(_yaml_dict(tmp_path / "results", epochs=1)))
    assert train_tool.main([str(path), "--device", "cpu"]) == 0
    longer = tmp_path / "run2.yaml"
    longer.write_text(_yaml.dump(_yaml_dict(tmp_path / "results", epochs=2)))
    _preempt_after(monkeypatch, 1)
    assert train_tool.main([str(longer), "--device", "cpu", "--resume"]) == \
        train_tool.EXIT_PREEMPTED
    runs = [p for p in (tmp_path / "results" / "training").iterdir() if p.name != "latest"]
    assert len(runs) == 1  # --resume reused the run's directory
    assert (runs[0] / "checkpoints" / "resnet_resume_meta.json").exists()
