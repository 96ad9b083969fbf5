"""The GAN examples' YAML files (examples/training/srgan_x4.yaml and
esrgan_x4.yaml) through the port's ``ConfigUtil.from_yaml`` and
``run_training`` on the CPU, against simplesr_tpu's run of the same dict.

Each file is read as it is and cut to a CPU's size: the gallery PNGs, 2
epochs of 32 x 32 crops (one per image, batch 4), seed 0, a 1-block 8-filter
float32 generator, an 8-filter critic at 32 x 32 and the VGG loss at
``block2_conv2`` (random-init VGG, as no weights are in the repo). The
rest of each recipe stays: the loss stacks and their weights, the critics'
kinds and label smoothing, the optimizers and schedules, ESRGAN's EMA.
Checked: a GAN SRModel of the recipe, and a finished run with the JAX
package's save-dir tree (model files, plots, JSON histories, resume meta),
finite histories with the critic's metrics.
"""

import copy
import os
from pathlib import Path

import numpy as np
import pytest

from simplesr_tpu.config import ConfigUtil as JaxConfigUtil
from simplesr_tpu.train import run_training as jax_run_training
from simplesr_tpu_torch.config import ConfigUtil
from simplesr_tpu_torch.config.yaml_helper import load_yaml
from simplesr_tpu_torch.losses import VGGLoss
from simplesr_tpu_torch.models import RRDBNet, SRResNet
from simplesr_tpu_torch.train import run_training

ROOT = Path(__file__).resolve().parents[1]
GALLERY = str(ROOT / "data/corpus/gallery")


def _tiny(name, results):
    spec = load_yaml(str(ROOT / "examples/training" / name))
    spec["general"].update(train_data_paths=GALLERY, results_save_path=str(results),
                           num_epochs=2, batch_size=4, crop_size=(32, 32, 3), num_crops=1,
                           random_seed=0)
    gen = spec["model"]["generator"]
    gen.update(num_blocks=1, num_filters=8, dtype="float32")
    for loss in gen["loss_functions"]:
        if loss["loss_function"] == "VGGLoss":
            loss["output_layers"] = "block2_conv2"
    spec["model"]["discriminator"].update(num_filters=8, input_dims=(32, 32),
                                          dtype="float32")
    return spec


def _tree(root):
    out = set()
    for dirpath, _, filenames in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if rel.startswith("checkpoints" + os.sep):
            continue
        out.add(rel)
        if not rel.startswith("logs"):
            out.update(os.path.normpath(os.path.join(rel, f)) for f in filenames)
    return out


@pytest.mark.parametrize("name", ["srgan_x4.yaml", "esrgan_x4.yaml"])
def test_gan_yaml_builds_and_trains_like_jax(name, tmp_path):
    spec = _tiny(name, tmp_path / "port")
    conf, pipeline, model = ConfigUtil.from_yaml(copy.deepcopy(spec), device="cpu")
    gan = name.startswith("srgan")
    assert model.model_type == "gan" and model.device.type == "cpu"
    assert isinstance(model.generator(), SRResNet if gan else RRDBNet)
    disc = model.discriminator_wrapper()
    assert disc.relativistic == (not gan) and disc._label_smoothing == gan
    assert (model.ema_parameters is None) == gan
    assert any(isinstance(f, VGGLoss) for f in model.generator_wrapper()._loss_functions)
    assert model.discriminator_optimizer.inner.kind == "adam"

    result = run_training(conf, pipeline, model, device="cpu")
    jax_spec = _tiny(name, tmp_path / "jax")
    jax_conf, jax_pipeline, jax_model = JaxConfigUtil.from_yaml(jax_spec)
    jax_run_training(jax_conf, jax_pipeline, jax_model)

    assert result is not None
    tree, jax_tree = _tree(conf.save_path), _tree(jax_conf.save_path)
    assert tree == jax_tree, tree ^ jax_tree
    expect = {"models/gan_gen_1.msgpack", "models/gan_gen_2.msgpack",
              "models/gan_gen_best.msgpack", "checkpoints/gan_resume_meta.json",
              "json_dump/gan_train_epoch_history.json"}
    if not gan:
        expect.add("models/gan_gen_best_ema.msgpack")
    assert expect <= tree
    histories = model.histories()
    assert histories.keys() == jax_model.histories().keys()
    for part, history in histories.items():
        assert history.keys() == jax_model.histories()[part].keys(), part
        values = [float(v) for vs in history.values() for v in vs]
        assert values and np.all(np.isfinite(values)), part
    assert "discriminator_accuracy" in histories["train_epoch"]
    assert len(histories["train_epoch"]["generator_loss"]) == 2
