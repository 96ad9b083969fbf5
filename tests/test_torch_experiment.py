"""The port's Experiment (simplesr_tpu_torch/config/experiment.py) over its
ConfigUtil against simplesr_tpu's over its own: the same grid gives the same
configs, in the same order, with the same save paths, and leaves the base
config as it was."""

from pathlib import Path

import pytest

from simplesr_tpu.config import ConfigUtil as JaxConfigUtil
from simplesr_tpu.config import Experiment as JaxExperiment
from simplesr_tpu_torch.config import ConfigUtil, Experiment

GALLERY = str(Path(__file__).resolve().parents[1] / "data/corpus/gallery")
PARAMS = [{"exp_a": {"batch_size": 8}},
          {"exp_b": {"num_epochs": 5, "scale": 4}},
          {"exp_c": {}}]
FIELDS = ("batch_size", "num_epochs", "scale", "operation")


def _base(lib, root, create):
    return lib.training_config(train_data_paths=GALLERY, num_epochs=2, batch_size=4, scale=2,
                               results_save_path=str(root), operation="testing",
                               create_save_dirs=create)


def test_experiment_sweep_isolation(tmp_path):
    """The JAX package's sweep case: overrides apply per experiment and the
    base config is untouched."""
    base = _base(ConfigUtil, tmp_path, create=False)
    exp = Experiment.initialize_experiment(base, PARAMS, include_base_config=True)
    configs = list(exp.next_config())
    assert len(configs) == 4
    assert configs[0].batch_size == 4           # base config first
    assert configs[1].batch_size == 8
    assert configs[2].num_epochs == 5 and configs[2].scale == 4
    assert configs[3].batch_size == 4
    assert base.batch_size == 4 and base.num_epochs == 2  # isolation
    assert configs[1].save_path.endswith("exp_a")

    exp.add_result({"loss": [1.0]}, {}, {"loss": [1.0]}, {})
    exp.serialize_last_result(str(tmp_path / "res"))
    assert sorted(p.name for p in (tmp_path / "res").glob("*.json")) == [
        f"exp_c_{h}.json" for h in ("train_batch_history", "train_epoch_history",
                                    "valid_batch_history", "valid_epoch_history")]


@pytest.mark.parametrize("include_base", [True, False])
def test_same_grid_as_jax(tmp_path, include_base):
    """Both packages' sweeps, with their save directories created: the same
    experiment names, fields and save paths under each results tree, and
    the same directories made."""
    runs = {}
    for name, lib, exp_lib in (("jax", JaxConfigUtil, JaxExperiment),
                               ("port", ConfigUtil, Experiment)):
        root = tmp_path / name
        exp = exp_lib.initialize_experiment(_base(lib, root, create=True), PARAMS,
                                            include_base_config=include_base)
        rows = []
        for conf in exp.next_config():
            rows.append((exp.current_experiment_name, [getattr(conf, f) for f in FIELDS],
                         Path(conf.save_path).relative_to(root).parts[-1:]))
        made = sorted(str(p.relative_to(root)) for p in root.rglob("*")
                      if p.is_dir() and "logs" not in p.parts)
        runs[name] = rows, exp.experiments_run, exp.num_experiments, made
    assert runs["port"][:3] == runs["jax"][:3]
    assert len(runs["port"][0]) == len(PARAMS) + include_base
    # the run directories are named by time: compare the trees below them
    strip = lambda made: sorted({"/".join(p.split("/")[2:]) for p in made})
    assert strip(runs["port"][3]) == strip(runs["jax"][3])


def test_invalid_experiment_dict_raises(tmp_path):
    exp = Experiment.initialize_experiment(_base(ConfigUtil, tmp_path, create=False),
                                           [{"a": {}, "b": {}}], include_base_config=False)
    with pytest.raises(ValueError, match="invalid experiment dict"):
        next(exp.next_config())
