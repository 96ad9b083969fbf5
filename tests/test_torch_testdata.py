"""The port's unpaired inference and the YAML operations against
simplesr_tpu's: ``evaluate_on_testdata`` on a folder of gallery crops and
one LR PNG over 1000 x 1000 (tiled with the other large images through
``tiled_apply_many``), the files both write, and
``tools.run_example`` on ``inference`` and ``evaluation`` YAML files, whose
metrics (the serving form by default, the x8 self-ensemble when the YAML
asks) match the JAX package's."""

import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplesr_tpu.config import ConfigUtil as JaxConfigUtil
from simplesr_tpu.data import DataPipeline as JaxDataPipeline
from simplesr_tpu.eval.evaluation import evaluate_on_testdata as jax_evaluate_on_testdata
from simplesr_tpu.eval.evaluation import (
    evaluate_on_validationdata as jax_evaluate_on_validationdata)
from simplesr_tpu.train.generator import Generator
from simplesr_tpu.train.serialization import save_model as jax_save_model
from simplesr_tpu_torch.config import ConfigUtil, _yaml
from simplesr_tpu_torch.data import DataPipeline
from simplesr_tpu_torch.data.png import read_png, write_png
from simplesr_tpu_torch.eval.evaluation import evaluate_on_testdata, evaluate_on_validationdata
from simplesr_tpu_torch.tools.run_example import main as run_example

ROOT = Path(__file__).resolve().parents[1]
GALLERY = sorted((ROOT / "data/corpus/gallery").glob("*.png"))
# float32 model, the same products summed in another order, through the
# tiled route too (as tests/test_torch_slice.py holds it)
OUT_TOL = 1e-4
METRIC_REL_TOL = 1e-4


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    """A 1-block, 8-filter float32 SRResNet x2 saved by simplesr_tpu."""
    gen = Generator.srresnet(upsample_factor=2, num_blocks=1, num_filters=8,
                             batch_norm=False, dtype=jnp.float32, input_dims=(16, 16))
    path = str(tmp_path_factory.mktemp("models") / "tiny.msgpack")
    jax_save_model(gen.module_config(), gen.variables, path)
    return path


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """tests/<set>/: three gallery crops (two of one size) and an LR image
    of 1010 x 1003 (a gallery picture tiled by reflection)."""
    root = tmp_path_factory.mktemp("data")
    folder = root / "set"
    folder.mkdir()
    for i, (path, (h, w)) in enumerate(zip(GALLERY, [(24, 20), (24, 20), (30, 26)])):
        write_png(folder / f"crop{i}.png", read_png(path)[:h, :w, :3])
    big = np.pad(read_png(GALLERY[3])[:, :, :3], ((0, 1010), (0, 1003), (0, 0)),
                 mode="reflect")[:1010, :1003]
    write_png(folder / "large.png", np.ascontiguousarray(big))
    return root


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _inference_config(cls, data_dir, model_path, results):
    return cls.evaluation_config(
        data_paths=str(data_dir), test_originals_path=None, model_paths=[model_path],
        results_save_path=str(results), scale=2, batch_size=2, operation="inference",
        save_single=True, grid=True, interpolate=True, combine_halfs=True)


def test_evaluate_on_testdata_matches_jax(tmp_path, data_dir, model_path):
    jax_conf = _inference_config(JaxConfigUtil, data_dir, model_path, tmp_path / "jax")
    conf = _inference_config(ConfigUtil, data_dir, model_path, tmp_path / "port")
    ref = jax_evaluate_on_testdata(jax_conf, pipeline=JaxDataPipeline.inference_pipeline(jax_conf),
                                   combine_halfs=True)
    got = evaluate_on_testdata(conf, pipeline=DataPipeline.inference_pipeline(conf, device="cpu"),
                               combine_halfs=True, device="cpu")
    assert len(got) == len(ref) == 3  # two crops of one size, one other crop, the large image
    for g, r in zip(got, ref):
        assert set(g) == set(r) == {"tiny", "interpolated"}
        for name in r:
            assert tuple(g[name].shape) == tuple(np.asarray(r[name]).shape)
            np.testing.assert_allclose(g[name].numpy(), np.asarray(r[name]), rtol=0,
                                       atol=OUT_TOL)
    assert max(g["tiny"].shape[1] for g in got) == 2020  # the tiled image
    files = _files(conf.pic_dir)
    assert files == _files(jax_conf.pic_dir)
    assert "set/half/0_set_tiny_1.png" in files and "grids/2_set.png" in files


def _yaml_spec(operation, data_dir, model_path, results, **general):
    spec = {"general": {"operation": operation, "data_paths": str(data_dir),
                        "test_originals_path": None, "model_paths": [model_path],
                        "results_save_path": str(results), "scale": 2, "batch_size": 1,
                        "save_single": True, "grid": True, **general}}
    return spec


@pytest.fixture(scope="module")
def hr_dir(tmp_path_factory):
    """Ground-truth crops for the paired evaluation."""
    folder = tmp_path_factory.mktemp("hr") / "gallery"
    folder.mkdir()
    for i, path in enumerate(GALLERY[:3]):
        write_png(folder / f"gt{i}.png", read_png(path)[40:88, 8:48, :3])
    return folder.parent


def test_run_example_inference_yaml(tmp_path, data_dir, model_path):
    path = tmp_path / "inference.yaml"
    path.write_text(_yaml.dump(_yaml_spec("inference", data_dir, model_path, tmp_path / "r",
                                          interpolate=True)))
    assert run_example([str(path), "--device", "cpu"]) == 0
    (run,) = [p for p in (tmp_path / "r" / "inference").iterdir() if p.name != "latest"]
    files = _files(run / "pics")
    # batches of one: three crops, then the large image, tiled
    assert "grids/3_set.png" in files and "set/single/3_set_tiny_0.png" in files
    assert read_png(run / "pics/set/single/3_set_tiny_0.png").shape == (2020, 2006, 3)


@pytest.mark.parametrize("self_ensemble", [False, True])
def test_run_example_evaluation_yaml_matches_jax_metrics(tmp_path, hr_dir, model_path,
                                                         self_ensemble):
    spec = _yaml_spec("evaluation", hr_dir, model_path, tmp_path / "r",
                      resize_filter="bicubic", crop_imgs=False, self_ensemble=self_ensemble)
    path = tmp_path / "evaluation.yaml"
    path.write_text(_yaml.dump(spec))
    assert run_example([str(path), "--device", "cpu"]) == 0

    conf, pipeline = ConfigUtil.from_yaml(spec, device="cpu")
    assert conf.self_ensemble is self_ensemble
    got = evaluate_on_validationdata(config=conf, pipeline=pipeline, calc_stats=True,
                                     device="cpu")
    spec["general"]["results_save_path"] = str(tmp_path / "jax")
    jax_conf, jax_pipeline = JaxConfigUtil.from_yaml(spec)
    ref = jax_evaluate_on_validationdata(config=jax_conf, pipeline=jax_pipeline, calc_stats=True)
    assert set(got) == set(ref) == {"tiny", "bicubic"}
    for name in ref:
        for metric in ("psnr", "psnr-y", "ssim"):
            np.testing.assert_allclose(got[name][metric], ref[name][metric],
                                       rtol=METRIC_REL_TOL, atol=0)


def test_run_example_unknown_operation_returns_1(tmp_path, data_dir, model_path):
    path = tmp_path / "x.yaml"
    path.write_text(_yaml.dump(_yaml_spec("distillation", data_dir, model_path, tmp_path)))
    assert run_example([str(path), "--device", "cpu"]) == 1
    assert not (tmp_path / "distillation").exists()


def test_testdata_predictor_defaults_to_the_serving_form(tmp_path, data_dir, model_path):
    """evaluate_on_testdata serves the polyphase form unless fast=False; the
    two agree at float32."""
    conf = _inference_config(ConfigUtil, data_dir, model_path, tmp_path)
    pipeline = DataPipeline.inference_pipeline(conf, device="cpu")
    small = [b for b in pipeline.test_batch_generator(2) if b[0].shape[1] < 100]
    assert small
    fast = evaluate_on_testdata(conf, pipeline=pipeline, save_single=False, grid=False,
                                device="cpu")
    slow = evaluate_on_testdata(conf, pipeline=pipeline, save_single=False, grid=False,
                                fast=False, device="cpu")
    for a, b in zip(fast, slow):
        torch.testing.assert_close(a["tiny"], b["tiny"], rtol=0, atol=1e-5)
