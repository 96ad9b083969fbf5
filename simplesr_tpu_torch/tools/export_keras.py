"""Export model files as reference-loadable Keras ``.h5`` generators, as
simplesr_tpu.tools.export_keras does:

    python -m simplesr_tpu_torch.tools.export_keras model.msgpack out.h5

The reverse of ``tools/import_keras.py``: a model trained here (SRResNet /
SRGAN or RRDB / ESRGAN) becomes a legacy-HDF5 Keras model that the
reference framework (bw0248/SimpleSR) loads with
``tf.keras.models.load_model`` (reference operations/evaluation.py:322-328)
and takes as a GAN warm start (``pretrained_model_path``, reference
utils/models/model_builder.py:13-19).

The JAX exporter builds the graph with the reference's own
``model_builder`` under TensorFlow and saves it with Keras. The port needs
neither TensorFlow, h5py nor the reference: it writes the file itself,
through its own HDF5 writer (``train/_hdf5_write.py``), in the layout that
tf_keras 2.21's ``model.save("x.h5")`` writes:
  * root attributes ``backend``, ``keras_version`` and ``model_config``,
    the Functional model's JSON (hundreds of KB for a 16-block RRDB, so a
    variable-length string in the global heap);
  * ``model_weights`` with ``backend``, ``keras_version`` and
    ``layer_names``, and a group per layer, weightless layers too, holding
    ``weight_names`` and ``<layer>/<weight>:0`` datasets, plus
    ``top_level_model_weights``.
The layers are those the reference creates, in its creation order
(model_builder.build_resnet :99-134, build_enhanced_resnet :42-97, which
both importers replay) and under Keras' automatic names (``conv2d``,
``conv2d_1``, ``p_re_lu``, ``batch_normalization``, ``add``,
``concatenate``, ``leaky_re_lu``, ``lambda``, ``tf.nn.depth_to_space``).
Keras loads weights by that order, not by name.

Weights, as the JAX exporter converts them: flax HWIO conv kernels are
Keras' layout already; PReLU alpha (C,) becomes the layer's (1, 1, C); BN
``{scale, bias}`` and ``batch_stats {mean, var}`` become [gamma, beta,
moving_mean, moving_variance].

``depth_to_space`` is a ``TFOpLambda`` layer (``"nn.depth_to_space"``, no
code). RRDB's residual scaling is a ``Lambda`` layer, which Keras stores as
the marshalled bytecode of ``lambda x: x * <scaling>``, the constant a
literal so that loading needs no globals. Bytecode belongs to one Python
version: a file holding an RRDB loads under the Python minor version that
wrote it, as the JAX exporter's files do (Keras marshals the running
interpreter's code). The weights carry no such limit: both importers and
the reference's ``load_weights`` read them by layer order.

Exportability limits, as in the JAX exporter: the reference hardcodes the
dense-block growth convs at ``num_filters // 2`` (model_builder.py:333), so
an RRDB with another ``growth_channels`` (``rrdb_wide``) is refused; so are
an unknown architecture and a config that does not match the weights.
"""

import argparse
import base64
import json
import marshal
import types

import numpy as np

from simplesr_tpu_torch.tools.import_keras import check_variables
from simplesr_tpu_torch.train import _hdf5_write

KERAS_VERSION = "2.21.0"  # the tf_keras whose legacy layout the file follows
# Keras splits layer_names into layer_names0, layer_names1, ... when the
# names, as a numpy byte array, pass this many bytes; that form is not written
HDF5_OBJECT_HEADER_LIMIT = 64512
BN_MOMENTUM, BN_EPSILON = 0.8, 1e-3  # the generators' BatchNorm (models/blocks.py)
LEAKY_ALPHA = float(np.float32(0.2))  # Keras stores LeakyReLU's alpha as a float32


def _initializer(class_name, **config):
    return {"module": "keras.initializers", "class_name": class_name, "config": config,
            "registered_name": None}


GLOROT = _initializer("GlorotUniform", seed=None)
# he_normal with its scale set to 0.2 (model_builder.py:60-61)
SCALED_HE = _initializer("VarianceScaling", scale=0.2, mode="fan_in",
                         distribution="truncated_normal", seed=None)


def _scaling_function(scale):
    """Keras' dump of ``lambda x: x * scale``: [base64 of the marshalled
    code object, defaults, closure]."""
    module = compile(f"lambda x: x * {float(scale)!r}", "<residual scaling>", "eval")
    code = next(c for c in module.co_consts if isinstance(c, types.CodeType))
    return [base64.encodebytes(marshal.dumps(code)).decode("ascii"), None, None]


class _Graph:
    """A Keras Functional graph built layer by layer, as the reference's
    builder calls Keras: ``layers`` is [(name, class name, [(weight name,
    array)])] in creation order, ``entries`` the model_config's layers."""

    def __init__(self):
        self.layers, self.entries, self._counts = [], [], {}
        self.entries.append({"class_name": "InputLayer", "config": {
            "batch_input_shape": [None, None, None, 3], "dtype": "float32", "sparse": False,
            "ragged": False, "name": "input_1", "optional": False},
            "name": "input_1", "inbound_nodes": []})
        self.layers.append(("input_1", "InputLayer", []))

    def layer(self, base, class_name, inputs, config=(), weights=(), call_kwargs=None):
        count = self._counts.get(base, 0)
        self._counts[base] = count + 1
        name = base if count == 0 else f"{base}_{count}"
        if call_kwargs is None:
            nodes = [[[x, 0, 0, {}] for x in inputs]]
        else:  # a TFOpLambda records the op's keyword arguments with its input
            nodes = [[inputs[0], 0, 0, call_kwargs]]
        self.entries.append({"class_name": class_name, "config": {
            "name": name, "trainable": True, "dtype": "float32", **dict(config)},
            "name": name, "inbound_nodes": nodes})
        self.layers.append((name, class_name, [
            (w, np.asarray(a, dtype=np.float32)) for w, a in weights]))
        return name

    def conv(self, x, p, init, activation="linear"):
        kernel = np.asarray(p["kernel"])
        return self.layer("conv2d", "Conv2D", [x], {
            "filters": int(kernel.shape[3]), "kernel_size": list(kernel.shape[:2]),
            "strides": [1, 1], "padding": "same", "data_format": "channels_last",
            "dilation_rate": [1, 1], "groups": 1, "activation": activation, "use_bias": True,
            "kernel_initializer": init, "bias_initializer": _initializer("Zeros"),
            "kernel_regularizer": None, "bias_regularizer": None,
            "activity_regularizer": None, "kernel_constraint": None, "bias_constraint": None},
            [("kernel", kernel), ("bias", p["bias"])])

    def prelu(self, x, p):
        alpha = np.asarray(p["alpha"])
        return self.layer("p_re_lu", "PReLU", [x], {
            "alpha_initializer": _initializer("Zeros"), "alpha_regularizer": None,
            "alpha_constraint": None, "shared_axes": [1, 2]},
            [("alpha", alpha.reshape(1, 1, -1))])

    def batch_norm(self, x, p, s):
        return self.layer("batch_normalization", "BatchNormalization", [x], {
            "axis": [3], "momentum": BN_MOMENTUM, "epsilon": BN_EPSILON, "center": True,
            "scale": True, "beta_initializer": _initializer("Zeros"),
            "gamma_initializer": _initializer("Ones"),
            "moving_mean_initializer": _initializer("Zeros"),
            "moving_variance_initializer": _initializer("Ones"), "beta_regularizer": None,
            "gamma_regularizer": None, "beta_constraint": None, "gamma_constraint": None},
            [("gamma", p["scale"]), ("beta", p["bias"]), ("moving_mean", s["mean"]),
             ("moving_variance", s["var"])])

    def leaky_relu(self, x):
        return self.layer("leaky_re_lu", "LeakyReLU", [x], {"alpha": LEAKY_ALPHA})

    def add(self, inputs):
        return self.layer("add", "Add", inputs)

    def concatenate(self, inputs):
        return self.layer("concatenate", "Concatenate", inputs, {"axis": -1})

    def scale(self, x, scale):
        return self.layer("lambda", "Lambda", [x], {
            "function": _scaling_function(scale), "function_type": "lambda", "module": None,
            "output_shape": None, "output_shape_type": "raw", "output_shape_module": None,
            "arguments": {}})

    def depth_to_space(self, x):
        return self.layer("tf.nn.depth_to_space", "TFOpLambda", [x],
                          {"function": "nn.depth_to_space"}, call_kwargs={"block_size": 2})

    def model_config(self):
        return {"class_name": "Functional", "config": {
            "name": "model", "trainable": True, "layers": self.entries,
            "input_layers": [["input_1", 0, 0]],
            "output_layers": [[self.layers[-1][0], 0, 0]]}}


def _upsamples(config):
    return int(np.log2(config["upsample_factor"]))


def _srresnet_graph(config, variables):
    """The reference's build_resnet (model_builder.py:99-134, 275-319):
    9x9 conv -> PReLU -> N x (conv[+BN] -> PReLU -> conv[+BN] -> add) ->
    conv[+BN] -> add -> k x (conv -> depth_to_space -> PReLU) -> 9x9 conv,
    tanh."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    bn = config.get("batch_norm", True)
    g = _Graph()

    def conv_layer(x, p, s):
        x = g.conv(x, p["Conv_0"], GLOROT)
        return g.batch_norm(x, p["BatchNorm_0"], s["BatchNorm_0"]) if bn else x

    x = skip = g.prelu(g.conv("input_1", params["ConvLayer_0"]["Conv_0"], GLOROT),
                       params["PReLU_0"])
    for i in range(config["num_blocks"]):
        p, s = params[f"ResBlock_{i}"], stats.get(f"ResBlock_{i}", {})
        y = g.prelu(conv_layer(x, p["ConvLayer_0"], s.get("ConvLayer_0")), p["PReLU_0"])
        x = g.add([x, conv_layer(y, p["ConvLayer_1"], s.get("ConvLayer_1"))])
    x = g.add([skip, conv_layer(x, params["ConvLayer_1"], stats.get("ConvLayer_1"))])
    for k in range(_upsamples(config)):
        p = params[f"SubpixelConvBlock_{k}"]
        x = g.prelu(g.depth_to_space(g.conv(x, p["Conv_0"], GLOROT)), p["PReLU_0"])
    g.conv(x, params["Conv_0"], GLOROT, activation="tanh")
    return g


def _rrdb_graph(config, variables):
    """The reference's build_enhanced_resnet (model_builder.py:42-97,
    328-365): conv -> N RRDB blocks of D dense blocks (C x (conv ->
    LeakyReLU -> concatenate) -> conv -> x scaling -> add) -> x scaling ->
    add of the head -> conv -> add of the head -> k x (conv ->
    depth_to_space -> LeakyReLU) -> conv -> LeakyReLU -> conv, tanh."""
    params = variables["params"]
    scaling = config.get("residual_scaling", 0.2)
    num_convs = config.get("num_convs", 4)
    g = _Graph()
    x = skip = g.conv("input_1", params["Conv_0"], SCALED_HE)
    for i in range(config["num_blocks"]):
        for j in range(config.get("num_dense_blocks", 3)):
            dense = params[f"RRDBBlock_{i}"][f"DenseBlock_{j}"]
            cat = x
            for k in range(num_convs):
                y = g.leaky_relu(g.conv(cat, dense[f"Conv_{k}"], SCALED_HE))
                cat = g.concatenate([cat, y])
            y = g.scale(g.conv(cat, dense[f"Conv_{num_convs}"], SCALED_HE), scaling)
            x = g.add([x, y])
    x = g.add([skip, g.scale(x, scaling)])
    x = g.add([skip, g.conv(x, params["Conv_1"], SCALED_HE)])
    for k in range(_upsamples(config)):
        x = g.conv(x, params[f"SubpixelConvBlock_{k}"]["Conv_0"], SCALED_HE)
        x = g.leaky_relu(g.depth_to_space(x))
    x = g.leaky_relu(g.conv(x, params["Conv_2"], SCALED_HE))
    g.conv(x, params["Conv_3"], SCALED_HE, activation="tanh")
    return g


def write_h5(graph, out_path):
    """Write ``graph`` as tf_keras' legacy ``model.save`` lays out a model."""
    names = [name.encode("utf8") for name, _, _ in graph.layers]
    if np.asarray(names).nbytes > HDF5_OBJECT_HEADER_LIMIT:
        raise ValueError(
            f"{len(names)} layer names take {np.asarray(names).nbytes} bytes, over Keras' "
            f"{HDF5_OBJECT_HEADER_LIMIT}: Keras would split them into layer_names0, "
            "layer_names1, ..., which this writer does not write")
    root = _hdf5_write.Group()
    root.attrs["keras_version"] = KERAS_VERSION
    root.attrs["backend"] = "tensorflow"
    root.attrs["model_config"] = json.dumps(graph.model_config()).encode("utf8")
    weights = root.create_group("model_weights")
    weights.attrs["layer_names"] = names
    weights.attrs["backend"] = b"tensorflow"
    weights.attrs["keras_version"] = KERAS_VERSION.encode("utf8")
    for name, _, arrays in graph.layers:
        group = weights.create_group(name)
        group.attrs["weight_names"] = [f"{name}/{w}:0".encode("utf8") for w, _ in arrays]
        for w, a in arrays:
            group.create_dataset(f"{name}/{w}:0", a)
    weights.create_group("top_level_model_weights").attrs["weight_names"] = []
    _hdf5_write.write_file(out_path, root)


def export_keras_model(model_path, out_path=None):
    """Convert a model file -> its Keras graph; when ``out_path`` is given,
    also write the legacy ``.h5`` the way the reference's SRModel saves one
    (sr_model.py:233-244).

    The JAX function returns ``(keras_model, config)``. There is no Keras
    here, so this returns ``(layers, config)``: ``layers`` is the ordered
    [(name, class name, [(weight name, float32 array)])] written, weightless
    layers included."""
    from simplesr_tpu_torch.train import serialization

    config, variables = serialization.load_payload(model_path)
    arch = config.get("architecture", "srresnet")
    if arch == "rrdb":
        nf = config.get("num_filters", 64)
        growth = config.get("growth_channels") or nf // 2
        if growth != nf // 2:
            raise ValueError(
                f"growth_channels={growth} is not representable in the reference builder "
                f"(it hardcodes num_filters//2={nf // 2}, model_builder.py:333): wide-growth "
                "RRDBs cannot be exported")
    elif arch != "srresnet":
        raise ValueError(f"unknown architecture {arch!r} (srresnet|rrdb)")
    check_variables(config, variables)
    graph = (_rrdb_graph if arch == "rrdb" else _srresnet_graph)(config, variables)
    if out_path is not None:
        write_h5(graph, out_path)
    return graph.layers, config


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model", help="model file (.msgpack)")
    p.add_argument("out", help="output Keras model (.h5)")
    p.add_argument("--reference",
                   help="accepted as simplesr_tpu's exporter takes it, and not read")
    args = p.parse_args(argv)
    if args.reference is not None:
        print("export_keras: the port writes the Keras graph itself and reads no "
              f"reference; --reference {args.reference} is ignored")
    _, config = export_keras_model(args.model, args.out)
    print(f"exported {args.model} -> {args.out}\n  config: {config}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
