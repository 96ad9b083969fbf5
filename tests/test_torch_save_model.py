"""Model files written by the port: read by simplesr_tpu bit-equal, and
byte-equal to flax's encoding of the same variables."""

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization as flax_ser

from simplesr_tpu.train.generator import Generator as JaxGenerator
from simplesr_tpu.train.serialization import load_model as jax_load_model
from simplesr_tpu.train.serialization import save_model as jax_save_model
from simplesr_tpu_torch.models import build_generator_model
from simplesr_tpu_torch.train import (from_flax_variables, load_model, save_model,
                                      to_flax_variables)
from simplesr_tpu_torch.train._msgpack import packb, unpackb
from simplesr_tpu_torch.train.generator import Generator


def _sorted_device_get(variables):
    """The tree as simplesr_tpu's SRModel hands it to save_model: params,
    then batch_stats (save_model's jax.device_get sorts every map's keys)."""
    return {k: jax.device_get(variables[k]) for k in ("params", "batch_stats")
            if k in variables}


@pytest.mark.parametrize("batch_norm,dtype", [(False, "float32"), (True, "bfloat16")])
def test_port_file_loads_bit_equal_in_jax(tmp_path, batch_norm, dtype):
    gen = Generator.srresnet(2, num_blocks=2, num_filters=8, batch_norm=batch_norm,
                             dtype=dtype, seed=3, device="cpu")
    path = str(tmp_path / "m.msgpack")
    save_model(gen.module_config(), gen.variables, path)
    module, variables = jax_load_model(path)
    ours = gen.variables
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    assert len(leaves) == len(jax.tree_util.tree_leaves(ours))
    for key, leaf in leaves:
        node = ours
        for k in key:
            node = node[k.key]
        np.testing.assert_array_equal(np.asarray(leaf), node)
    assert module.batch_norm == batch_norm and module.num_filters == 8


def test_bytes_equal_flax_for_the_same_variables(tmp_path):
    gen = JaxGenerator.srresnet(upsample_factor=4, num_blocks=2, num_filters=8,
                                batch_norm=True, dtype=jnp.float32, input_dims=(8, 8))
    variables = _sorted_device_get(gen.variables)
    jax_path, port_path = tmp_path / "jax.msgpack", tmp_path / "port.msgpack"
    jax_save_model(gen.module_config(), variables, str(jax_path))
    module = build_generator_model(**gen.module_config(), device="cpu")
    state = from_flax_variables(module, variables)
    save_model(gen.module_config(), to_flax_variables(state), str(port_path))
    assert port_path.read_bytes() == jax_path.read_bytes()


def test_generator_module_config_and_file_round_trip(tmp_path):
    jax_gen = JaxGenerator.srresnet(upsample_factor=2, num_blocks=1, num_filters=8,
                                    batch_norm=False, input_dims=(8, 8))
    gen = Generator.srresnet(2, num_blocks=1, num_filters=8, batch_norm=False, device="cpu")
    assert gen.module_config() == jax_gen.module_config()
    path = tmp_path / "g.msgpack"
    save_model(gen.module_config(), gen.variables, str(path))
    again = load_model(path, device="cpu")
    for k, v in gen.model().state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_seeded_init_is_reproducible_and_flax_shaped():
    a = Generator.srresnet(4, num_blocks=2, num_filters=16, batch_norm=False, seed=5,
                           device="cpu")
    b = Generator.srresnet(4, num_blocks=2, num_filters=16, batch_norm=False, seed=5,
                           device="cpu")
    c = Generator.srresnet(4, num_blocks=2, num_filters=16, batch_norm=False, seed=6,
                           device="cpu")
    sa, sb, sc = (g.model().state_dict() for g in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["head.conv.weight"], sc["head.conv.weight"])
    assert all(sa[k].abs().max() == 0 for k in sa if k.endswith(("alpha", "bias")))
    ref = JaxGenerator.srresnet(upsample_factor=4, num_blocks=2, num_filters=16,
                                batch_norm=False, input_dims=(8, 8)).variables
    assert jax.tree_util.tree_structure(jax.device_get(ref)) == \
        jax.tree_util.tree_structure(a.variables)
    for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree_util.tree_leaves(a.variables)):
        assert np.shape(x) == np.shape(y), path
        if path[-1].key == "kernel":
            h, w, i, o = np.shape(x)
            if path[-2].key == "Conv_0" and path[-3].key == "params":
                # the output conv keeps flax's default, lecun normal: a normal
                # truncated at 2 sigma with variance 1 / fan_in
                bound = 2.0 * np.sqrt(1.0 / (i * h * w)) / 0.87962566103423978
            else:  # glorot uniform: |w| <= sqrt(6 / (fan_in + fan_out))
                bound = np.sqrt(6.0 / ((i + o) * h * w))
            assert np.abs(y).max() <= bound + 1e-7, path


@pytest.mark.parametrize("obj", [
    None, True, 0, 127, 128, 70000, 2 ** 40, -1, -33, -200, -70000, -2 ** 40, 0.25,
    "", "x" * 31, "y" * 32, "z" * 300, "é" * 40000, b"", b"b" * 300, b"c" * 70000,
    [1, [2, "a"]], list(range(20)), {"a": {"b": [1.5]}}, {str(i): i for i in range(20)},
])
def test_encoder_matches_msgpack(obj):
    assert packb(obj) == msgpack.packb(obj, use_bin_type=True)
    assert unpackb(packb(obj)) == obj


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16", "uint8"])
def test_encoder_arrays_match_flax(dtype):
    x = jnp.arange(12).reshape(3, 4).astype(dtype)
    port = torch.from_numpy(np.asarray(x).view(np.uint16).copy()).view(torch.bfloat16) \
        if dtype == "bfloat16" else np.asarray(x)
    assert packb({"x": port}) == flax_ser.to_bytes({"x": x})


def test_encoder_refuses_what_it_cannot_write():
    with pytest.raises(TypeError):
        packb({1, 2})
    with pytest.raises(ValueError):
        packb(2 ** 64)
