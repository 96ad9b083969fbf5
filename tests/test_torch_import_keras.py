"""The port's Keras importer (``tools/import_keras.py``, on the port's own
HDF5 reader) against simplesr_tpu.tools.import_keras on the same files:
legacy-Keras ``.h5`` generators in the reference's layer order, written here
with h5py in Keras' layout (SRResNet with and without BatchNorm, RRDB, a
weights-only file). The config and every array must be equal, the written
model file must load in the JAX package's serialization (its bytes are the
JAX importer's), and a float32 forward through each package's generator
(an SRResNet and an RRDB case) must agree within 1e-4 (the two packages
sum the convolutions in another order)."""

import json
from collections import defaultdict

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplesr_tpu.models import build_generator_model as jax_build
from simplesr_tpu.tools.import_keras import import_keras_model as jax_import
from simplesr_tpu.tools.import_keras import main as jax_main
from simplesr_tpu.train import serialization as jax_serialization
from simplesr_tpu_torch.models import build_generator_model
from simplesr_tpu_torch.tools import import_keras
from simplesr_tpu_torch.train.convert import from_flax_variables
from simplesr_tpu_torch.train.serialization import load_model

FORWARD_TOL = 1e-4
WEIGHT_NAMES = {"conv2d": ["kernel", "bias"], "p_re_lu": ["alpha"],
                "batch_normalization": ["gamma", "beta", "moving_mean", "moving_variance"]}


class _Layers:
    """Keras' auto-named layers in creation order, with seeded weights."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.count = defaultdict(int)
        self.layers = [("input_1", [])]

    def add(self, kind, *weights):
        n = self.count[kind]
        self.count[kind] += 1
        self.layers.append((kind if n == 0 else f"{kind}_{n}", list(weights)))

    def conv(self, k, cin, cout):
        self.add("conv2d", self.rng.normal(0, 0.2, (k, k, cin, cout)).astype(np.float32),
                 self.rng.normal(0, 0.1, cout).astype(np.float32))

    def prelu(self, c):
        self.add("p_re_lu", self.rng.uniform(0, 0.3, (1, 1, c)).astype(np.float32))

    def bn(self, c):
        r = self.rng
        self.add("batch_normalization", *(a.astype(np.float32) for a in (
            r.uniform(0.5, 1.5, c), r.normal(0, 0.1, c), r.normal(0, 0.2, c),
            r.uniform(0.5, 1.5, c))))


def srresnet_layers(filters=8, blocks=2, ups=1, batch_norm=True, seed=0):
    """build_resnet's order (reference model_builder.py:99-134)."""
    m = _Layers(seed)
    m.conv(9, 3, filters)
    m.prelu(filters)
    for _ in range(blocks):
        m.conv(3, filters, filters)
        if batch_norm:
            m.bn(filters)
        m.prelu(filters)
        m.conv(3, filters, filters)
        if batch_norm:
            m.bn(filters)
        m.add("add")
    m.conv(3, filters, filters)
    if batch_norm:
        m.bn(filters)
    m.add("add")
    for _ in range(ups):
        m.conv(3, filters, 4 * filters)
        m.add("tf.nn.depth_to_space")
        m.prelu(filters)
    m.conv(9, filters, 3)
    return m.layers


def rrdb_layers(filters=8, growth=4, blocks=2, dense=2, convs=2, ups=1, seed=1):
    """build_enhanced_resnet's order (reference model_builder.py:43-97)."""
    m = _Layers(seed)
    m.conv(3, 3, filters)
    for _ in range(blocks):
        for _ in range(dense):
            for k in range(convs):
                m.conv(3, filters + k * growth, growth)
                m.add("concatenate")
            m.conv(3, filters + convs * growth, filters)
            m.add("lambda")
            m.add("add")
    m.conv(3, filters, filters)
    m.add("add")
    m.add("add")
    for _ in range(ups):
        m.conv(3, filters, 4 * filters)
        m.add("tf.nn.depth_to_space")
    m.conv(3, filters, filters)
    m.conv(3, filters, 3)
    return m.layers


def write_keras_h5(path, layers, weights_only=False):
    """The legacy Keras HDF5 layout (tf_keras hdf5_format.save_weights_to_hdf5_group)."""
    with h5py.File(path, "w") as f:
        if weights_only:
            root = f
        else:
            f.attrs["keras_version"] = b"2.15.0"
            f.attrs["backend"] = b"tensorflow"
            f.attrs["model_config"] = json.dumps({"class_name": "Functional"}).encode()
            root = f.create_group("model_weights")
        root.attrs["layer_names"] = np.array([n.encode() for n, _ in layers])
        root.attrs["backend"] = b"tensorflow"
        root.attrs["keras_version"] = b"2.15.0"
        for name, weights in layers:
            group = root.create_group(name)
            kind = import_keras._kind(name)
            names = [f"{name}/{w}:0" for w in WEIGHT_NAMES.get(kind, [])][:len(weights)]
            group.attrs["weight_names"] = np.array([n.encode() for n in names], dtype="S")
            for wname, w in zip(names, weights):
                group.create_dataset(wname, data=w)
    return path


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}") if isinstance(v, dict) else {f"{prefix}/{k}": v})
    return out


def _forward_agree(config, variables):
    x = np.random.default_rng(5).uniform(0, 1, (1, 10, 12, 3)).astype(np.float32)
    cfg = {**config, "dtype": "float32"}
    ref = np.asarray(jax_build(**{**config, "dtype": jnp.float32}).apply(
        variables, jnp.asarray(x), train=False))
    module = build_generator_model(**cfg, device="cpu")
    module.load_state_dict(from_flax_variables(module, variables))
    with torch.inference_mode():
        got = module(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=FORWARD_TOL)


# name: (layers, their sizes, importer options, whether to run the forward)
CASES = {
    "srresnet_bn": (srresnet_layers, dict(), {}, True),
    "srresnet_plain_x4": (srresnet_layers, dict(batch_norm=False, ups=2, blocks=3), {}, False),
    "rrdb": (rrdb_layers, dict(blocks=1), dict(num_dense_blocks=2), True),
    "rrdb_weights_only": (rrdb_layers, dict(blocks=1, dense=3, convs=3, growth=2),
                          dict(num_dense_blocks=3, residual_scaling=0.1), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_import_matches_the_jax_importer(tmp_path, case):
    make, kw, opts, forward = CASES[case]
    h5 = write_keras_h5(tmp_path / "gen.h5", make(**kw), weights_only="weights_only" in case)
    config, variables = import_keras.import_keras_model(h5, tmp_path / "port.msgpack", **opts)
    jax_config, jax_variables = jax_import(str(h5), str(tmp_path / "jax.msgpack"), **opts)
    assert config == jax_config
    ours, theirs = _flat(variables), _flat(jax_variables)
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert ours[key].dtype == np.asarray(theirs[key]).dtype
        np.testing.assert_array_equal(ours[key], np.asarray(theirs[key]))
    # the model file: the JAX importer's bytes, read by both packages
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()
    _, loaded = jax_serialization.load_model(str(tmp_path / "port.msgpack"))
    assert _flat(jax_serialization.load_model(str(tmp_path / "jax.msgpack"))[1]).keys() \
        == _flat(loaded).keys()
    assert load_model(tmp_path / "port.msgpack", device="cpu") is not None
    if forward:
        _forward_agree(config, variables)


def test_cli_matches_the_jax_cli(tmp_path, capsys):
    h5 = write_keras_h5(tmp_path / "gen.h5", rrdb_layers(blocks=1, dense=2, convs=1))
    args = ["--num-dense-blocks", "2", "--residual-scaling", "0.25"]
    assert import_keras.main([str(h5), str(tmp_path / "port.msgpack"), *args]) == 0
    assert "config:" in capsys.readouterr().out
    assert jax_main([str(h5), str(tmp_path / "jax.msgpack"), *args]) == 0
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()
    with pytest.raises(SystemExit):
        import_keras.main([str(h5), str(tmp_path / "x.msgpack"), "--arch", "unet"])


def test_bad_files_raise_as_the_jax_importer_does(tmp_path):
    layers = [(n, w) for n, w in srresnet_layers() if not n.startswith("add")]
    h5 = write_keras_h5(tmp_path / "bad.h5", layers)
    for importer in (import_keras.import_keras_model, jax_import):
        with pytest.raises(ValueError):
            importer(str(h5))
    h5 = write_keras_h5(tmp_path / "rrdb.h5", rrdb_layers(blocks=1, dense=3))
    for importer in (import_keras.import_keras_model, jax_import):
        with pytest.raises(ValueError, match="num_dense_blocks"):
            importer(str(h5), num_dense_blocks=2)
        with pytest.raises(ValueError, match="unknown arch"):
            importer(str(h5), arch="unet")
