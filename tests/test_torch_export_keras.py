"""The port's Keras exporter (``tools/export_keras.py``) against the JAX
package and legacy Keras: model files of seeded numpy weights, saved by
simplesr_tpu's ``save_model``, exported as ``.h5`` by the port, must

  (i) read back, config and every array bit-equal, through both packages'
      importers;
 (ii) load in tf_keras (``load_model(h5, compile=False)``, as the reference's
      evaluation loads a generator) with the layers in the file's order and
      a forward within ``atol=2e-5`` of the flax forward (the JAX exporter's
      own tolerance, tests/eval/test_export_keras.py);
(iii) open in h5py, every dataset and attribute equal to the port's reader;

for SRResNet with and without BN at x2 and x4 and for an RRDB. Also: the
refusals (wide growth, unknown architecture, weights that do not match the
config), ``growth_channels=None`` as the default, byte-identical repeats,
the CLI, and, where a checkout of the reference is importable, the JAX
exporter's file layer for layer."""

import os
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

from _h5_compare import assert_same
from simplesr_tpu_torch.tools.export_keras import _Graph, export_keras_model, main, write_h5
from simplesr_tpu_torch.train import _hdf5

os.environ.setdefault("TF_USE_LEGACY_KERAS", "1")
os.environ.setdefault("CUDA_VISIBLE_DEVICES", "-1")
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

# a checkout of the reference framework, where the JAX package's own tests
# look for it (tests/eval/test_export_keras.py)
REFERENCE = Path(os.environ.get("SIMPLESR_REFERENCE", "/root/reference"))

RRDB = dict(architecture="rrdb", num_blocks=2, num_dense_blocks=2, num_convs=3, num_filters=8,
            residual_scaling=0.2, batch_norm=False)
CASES = {
    "srresnet_bn_x2": dict(upsample_factor=2, architecture="srresnet", num_blocks=2,
                           num_filters=8, batch_norm=True),
    "srresnet_x2": dict(upsample_factor=2, architecture="srresnet", num_blocks=2,
                        num_filters=8, batch_norm=False),
    "srresnet_bn_x4": dict(upsample_factor=4, architecture="srresnet", num_blocks=2,
                           num_filters=8, batch_norm=True),
    "srresnet_x4": dict(upsample_factor=4, architecture="srresnet", num_blocks=2,
                        num_filters=8, batch_norm=False),
    "rrdb_x4": dict(upsample_factor=4, **RRDB),
}


def _seeded_variables(config, seed):
    """The flax module's tree, every leaf drawn from a numpy seed: kernels
    scaled by fan-in, BN variances positive, PReLU slopes non-zero."""
    import jax
    import jax.numpy as jnp
    from simplesr_tpu.models import build_generator_model

    module = build_generator_model(**config, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), jnp.zeros((1, 8, 8, 3)),
                                                train=False))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        if "var" in name:
            return rng.uniform(0.5, 1.5, s.shape)
        if "scale" in name:
            return 1 + 0.1 * rng.normal(size=s.shape)
        return 0.1 * rng.normal(size=s.shape)

    tree = jax.tree_util.tree_map_with_path(leaf, dict(shapes))
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _save(tmp_path, name, config, seed=0):
    from simplesr_tpu.train import serialization

    variables = _seeded_variables(config, seed)
    path = tmp_path / f"{name}.msgpack"
    serialization.save_model(config, variables, str(path))
    return path, variables


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(value)
    return out


def _flax_forward(config, variables, x):
    import jax.numpy as jnp
    from simplesr_tpu.models import build_generator_model

    module = build_generator_model(**config, dtype=jnp.float32)
    return np.asarray(module.apply(variables, jnp.asarray(x), train=False))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """name -> (config, variables, h5 path, layers), each case exported once."""
    root = tmp_path_factory.mktemp("export")
    done = {}

    def get(name):
        if name not in done:
            config = CASES[name]
            path, variables = _save(root, name, config, seed=len(done))
            h5 = root / f"{name}.h5"
            layers, config_out = export_keras_model(path, h5)
            assert config_out == config
            done[name] = config, variables, h5, layers
        return done[name]

    return get


def _rrdb_flags(config):
    return ({k: config[k] for k in ("num_dense_blocks", "residual_scaling")}
            if config["architecture"] == "rrdb" else {})


@pytest.mark.parametrize("case", CASES)
def test_both_importers_read_it_back_bit_equal(exported, case):
    from simplesr_tpu.tools.import_keras import import_keras_model as jax_import
    from simplesr_tpu_torch.tools.import_keras import import_keras_model as port_import

    config, variables, h5, _ = exported(case)
    want = _flat(variables)
    for importer in (jax_import, port_import):
        config2, variables2 = importer(str(h5), **_rrdb_flags(config))
        assert config2 == {k: config[k] for k in config2}, importer.__module__
        got = _flat(variables2)
        assert sorted(got) == sorted(want), importer.__module__
        for key, value in want.items():
            assert got[key].dtype == np.float32, key
            np.testing.assert_array_equal(got[key], value, err_msg=f"{importer.__module__} {key}")


@pytest.mark.parametrize("case", CASES)
def test_keras_loads_it_and_runs_it_as_flax_does(exported, case):
    tf_keras = pytest.importorskip("tf_keras")
    config, variables, h5, layers = exported(case)
    model = tf_keras.models.load_model(str(h5), compile=False)
    assert [(layer.name, type(layer).__name__) for layer in model.layers] == [
        (name, cls) for name, cls, _ in layers]
    x = np.random.default_rng(7).uniform(0, 1, (2, 10, 12, 3)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(model(x, training=False)),
                               _flax_forward(config, variables, x), atol=2e-5)


@pytest.mark.parametrize("case", CASES)
def test_h5py_reads_what_the_port_reads(exported, case):
    _, _, h5, layers = exported(case)
    with _hdf5.File(h5) as mine, h5py.File(h5, "r") as ref:
        assert_same(mine, ref)
        assert list(ref["model_weights"].attrs["layer_names"]) == [n for n, _, _ in layers]
        assert ref.attrs["model_config"].startswith('{"class_name": "Functional"')


def test_the_same_model_gives_the_same_bytes(exported, tmp_path):
    config, variables, h5, _ = exported("rrdb_x4")
    from simplesr_tpu.train import serialization

    path = tmp_path / "again.msgpack"
    serialization.save_model(config, variables, str(path))
    export_keras_model(path, tmp_path / "again.h5")
    assert (tmp_path / "again.h5").read_bytes() == h5.read_bytes()


def test_refusals(tmp_path):
    wide, _ = _save(tmp_path, "wide", dict(upsample_factor=2, **{
        **RRDB, "num_blocks": 1, "growth_channels": 8}))
    with pytest.raises(ValueError, match="growth_channels"):
        export_keras_model(wide, tmp_path / "wide.h5")
    assert not (tmp_path / "wide.h5").exists()

    config = CASES["srresnet_x2"]
    path, variables = _save(tmp_path, "plain", config)
    from simplesr_tpu.train import serialization

    serialization.save_model({**config, "architecture": "unet"}, variables,
                             str(tmp_path / "unet.msgpack"))
    with pytest.raises(ValueError, match="unknown architecture 'unet'"):
        export_keras_model(tmp_path / "unet.msgpack")
    # a config that claims BN and three blocks over weights without them
    for wrong in ({"batch_norm": True}, {"num_blocks": 3}):
        serialization.save_model({**config, **wrong}, variables, str(tmp_path / "bad.msgpack"))
        with pytest.raises(ValueError, match="variables do not match"):
            export_keras_model(tmp_path / "bad.msgpack")
    # layer names that Keras would split into layer_names0, layer_names1, ...
    graph = _Graph()
    for _ in range(9000):
        graph.add(["input_1"])
    with pytest.raises(ValueError, match="layer_names0"):
        write_h5(graph, tmp_path / "many.h5")


def test_growth_none_means_the_default(tmp_path):
    config = dict(upsample_factor=2, **{**RRDB, "num_blocks": 1, "growth_channels": None})
    path, variables = _save(tmp_path, "growth_none", config)
    layers, _ = export_keras_model(path, tmp_path / "g.h5")
    dense = [w for name, _, w in layers if w and w[0][1].shape[-1] == 4]
    assert len(dense) == 2 * 3  # the growth convs at num_filters // 2
    from simplesr_tpu_torch.tools.import_keras import import_keras_model

    config2, variables2 = import_keras_model(tmp_path / "g.h5", **_rrdb_flags(config))
    assert "growth_channels" not in config2
    for key, value in _flat(variables).items():
        np.testing.assert_array_equal(_flat(variables2)[key], value)


def test_cli(tmp_path, capsys):
    path, variables = _save(tmp_path, "cli", CASES["srresnet_bn_x2"])
    assert main([str(path), str(tmp_path / "g.h5")]) == 0
    assert "reference" not in capsys.readouterr().out
    assert main([str(path), str(tmp_path / "r.h5"), "--reference", "/nowhere"]) == 0
    assert "reads no reference; --reference /nowhere is ignored" in capsys.readouterr().out
    assert (tmp_path / "g.h5").read_bytes() == (tmp_path / "r.h5").read_bytes()
    tf_keras = pytest.importorskip("tf_keras")
    model = tf_keras.models.load_model(str(tmp_path / "g.h5"), compile=False)
    x = np.random.default_rng(3).uniform(0, 1, (1, 8, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(model(x, training=False)),
                               _flax_forward(CASES["srresnet_bn_x2"], variables, x), atol=2e-5)


@pytest.mark.parametrize("case", ["srresnet_bn_x2", "srresnet_x4", "rrdb_x4"])
def test_matches_the_jax_exporters_file(exported, case, tmp_path):
    if not (REFERENCE / "simple_sr").is_dir():
        pytest.skip(f"no checkout of the reference at {REFERENCE} (set SIMPLESR_REFERENCE)")
    from simplesr_tpu.tools.export_keras import export_keras_model as jax_export
    from simplesr_tpu.train import serialization

    config, variables, h5, _ = exported(case)
    path = tmp_path / "m.msgpack"
    serialization.save_model(config, variables, str(path))
    theirs = tmp_path / "jax.h5"
    sys_path = list(sys.path)
    try:
        jax_export(str(path), str(theirs), reference=str(REFERENCE))
    finally:
        sys.path[:] = sys_path
    with h5py.File(theirs, "r") as a, h5py.File(h5, "r") as b:
        names = list(a["model_weights"].attrs["layer_names"])
        assert names == list(b["model_weights"].attrs["layer_names"])
        import json

        classes = [[(layer["name"], layer["class_name"])
                    for layer in json.loads(f.attrs["model_config"])["config"]["layers"]]
                   for f in (a, b)]
        assert classes[0] == classes[1]
        for name in names:
            wa, wb = (list(f["model_weights"][name].attrs["weight_names"]) for f in (a, b))
            assert wa == wb, name
            for w in wa:
                np.testing.assert_array_equal(a["model_weights"][name][w][()],
                                              b["model_weights"][name][w][()])
