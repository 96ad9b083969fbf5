"""The port's model-file reader against simplesr_tpu's: the same config and
bit-equal arrays for the committed models, and its msgpack decoder against
the msgpack package on every type it covers."""

import json

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization as flax_ser

from simplesr_tpu.train.serialization import load_payload as jax_load_payload
from simplesr_tpu_torch.models import build_generator_model
from simplesr_tpu_torch.train import from_flax_variables, load_payload, to_flax_variables
from simplesr_tpu_torch.train._msgpack import unpackb

FLAGSHIP = "results/quality_fastrecipe/models/resnet_gen_srresnet_x4_best.msgpack"
BN_MODEL = "models/resnet_gen_1.msgpack"


def _bits(leaf):
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", ""), tuple(leaf.shape), \
            leaf.contiguous().view(torch.int16).numpy().tobytes()
    arr = np.asarray(leaf)
    return arr.dtype.name, arr.shape, arr.tobytes()


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("path", [FLAGSHIP, BN_MODEL])
def test_payload_bit_equal_to_reference(path):
    config, variables = load_payload(path)
    ref_config, ref_variables = jax_load_payload(path)
    assert config == ref_config
    got, ref = _flat(variables), _flat(ref_variables)
    assert got.keys() == ref.keys()
    for key in ref:
        assert _bits(got[key]) == _bits(ref[key]), key


@pytest.mark.parametrize("path", [FLAGSHIP, BN_MODEL])
def test_converted_state_dict_fills_the_module(path):
    config, variables = load_payload(path)
    module = build_generator_model(**config, device="cpu")
    state = from_flax_variables(module, variables)
    assert set(state) == set(module.state_dict())
    module.load_state_dict(state)  # strict
    kernel = variables["params"]["ResBlock_3"]["ConvLayer_1"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(
        module.blocks[3].conv2.conv.weight.detach().numpy(),
        np.transpose(kernel, (3, 2, 0, 1)))


def test_converted_bfloat16_leaves_from_jax_arrays():
    arr = np.asarray(jnp.asarray(np.linspace(-3, 3, 24).reshape(2, 3, 1, 4), jnp.bfloat16))
    module = build_generator_model(4, num_blocks=1, num_filters=4, device="cpu")
    variables = to_flax_variables(module.state_dict())
    variables["params"]["Conv_0"] = {"kernel": arr, "bias": arr[0, 0, 0]}
    state = from_flax_variables(module, variables)
    assert state["out.weight"].dtype == torch.bfloat16
    np.testing.assert_array_equal(state["out.weight"].float().numpy(),
                                  np.transpose(arr.astype(np.float32), (3, 2, 0, 1)))


def test_unknown_module_is_refused():
    module = build_generator_model(4, num_blocks=1, device="cpu")
    variables = to_flax_variables(module.state_dict())
    from_flax_variables(module, variables)
    variables["params"]["RRDBBlock_0"] = {}
    with pytest.raises(KeyError):
        from_flax_variables(module, variables)


@pytest.mark.parametrize("obj", [
    0, 5, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63, -1, -32, -33, -128, -129,
    -32768, -32769, -2**31 - 1, -2**63, 1.5, -0.25, 1e300, None, True, False, "",
    "a" * 31, "b" * 32, "c" * 300, "é" * 40000, b"", b"x" * 300, b"y" * 70000,
    [], list(range(15)), list(range(16)), list(range(70000)),
    {"k": 1}, {str(i): i for i in range(16)}, {str(i): [i] for i in range(70000)},
    {"nested": {"list": [1, "two", 3.0, None, {"x": b"\x00"}]}},
])
def test_decoder_matches_msgpack(obj):
    data = msgpack.packb(obj, use_bin_type=True)
    assert unpackb(data) == msgpack.unpackb(data, raw=False, strict_map_key=False)


def test_decoder_float32_and_raw_strings():
    data = msgpack.packb(np.float32(0.1).item(), use_single_float=True)
    assert unpackb(data) == msgpack.unpackb(data)
    assert unpackb(msgpack.packb("abc"), raw=True) == b"abc"


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int8, np.uint16, np.float64,
                                   jnp.bfloat16])
def test_decoder_flax_ndarray_ext(dtype):
    arr = np.arange(-12, 12).reshape(2, 3, 4)
    arr = np.asarray(jnp.asarray(arr, dtype)) if dtype is jnp.bfloat16 else arr.astype(dtype)
    data = flax_ser.msgpack_serialize({"a": arr, "scalar_dims": arr[:1, :1, :1]})
    got = unpackb(data)
    for key, ref in flax_ser.msgpack_restore(data).items():
        assert _bits(got[key]) == _bits(ref)


@pytest.mark.parametrize("data", [b"\xc1", b"\xd9\x05ab", b"\x92\x01",
                                  msgpack.packb(1) + b"\x00",
                                  msgpack.packb(msgpack.ExtType(5, b"12"))])
def test_decoder_rejects_bad_input(data):
    with pytest.raises(ValueError):
        unpackb(data)


def test_payload_config_is_json():
    with open(FLAGSHIP, "rb") as f:
        payload = unpackb(f.read())
    assert json.loads(payload["config"])["num_blocks"] == 16
    assert isinstance(payload["variables"], bytes)
