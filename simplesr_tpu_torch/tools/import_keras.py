"""Import reference-trained Keras ``.h5`` generators into model files, as
simplesr_tpu.tools.import_keras does:

    python -m simplesr_tpu_torch.tools.import_keras trained_gen.h5 out.msgpack

The reference framework (bw0248/SimpleSR) saves its generators as legacy
Keras HDF5 files (reference sr_model.py:233-244); this tool writes their
weights as the model files that both packages serve. Neither TensorFlow nor
h5py is needed: the file is read by the port's own HDF5 reader
(``train/_hdf5.py``), through the legacy format's ordered ``layer_names`` /
``weight_names`` attributes.

The reference builds its graphs in a fixed creation order
(model_builder.build_resnet :99-134, build_enhanced_resnet :43-97), which
the generators of both packages follow, so the import is an ordered replay:

- SRResNet (srgan generator): 9x9 conv -> PReLU -> N x (conv[+BN] -> PReLU
  -> conv[+BN] -> add) -> conv[+BN] -> add -> k x (conv x4 channels ->
  depth_to_space -> PReLU) -> 9x9 conv.
- RRDB (esrgan generator): every weight-bearing layer is a conv; the
  ordered conv list maps one-to-one onto Conv_0 /
  RRDBBlock_i.DenseBlock_j.Conv_k / Conv_1 / SubpixelConvBlock_l.Conv_0 /
  Conv_2 / Conv_3.

The architecture's sizes come from the layer list (filters from the head
conv, scale from the depth_to_space count, blocks from the add and
concatenate counts); what the file cannot encode (RRDB's dense-block split,
the residual scaling, which live in Lambda layers) takes the reference's
defaults and command-line flags. Keras and flax share the HWIO kernel
layout; PReLU alpha (1, 1, C) becomes (C,); BN [gamma, beta, mean, var]
becomes params {scale, bias} and batch_stats {mean, var}. The result is
checked against the port's own module of that config before it is written.
"""

import argparse

import numpy as np

from simplesr_tpu_torch.train import _hdf5


def read_h5_layers(path):
    """Legacy-Keras HDF5 → ordered [(layer_name, [np arrays])]; includes
    weightless layers (add, concatenate, lambda, d2s) with empty lists so
    callers can replay the creation order."""
    def _dec(x):
        return x.decode() if isinstance(x, bytes) else x

    with _hdf5.File(path) as f:
        mw = f["model_weights"] if "model_weights" in f else f
        names = [_dec(n) for n in mw.attrs["layer_names"]]
        out = []
        for name in names:
            g = mw[name]
            wn = [_dec(n) for n in g.attrs.get("weight_names", [])]
            out.append((name, [np.asarray(g[n]) for n in wn]))
    return out


def _kind(name):
    """Layer kind from a Keras auto-generated name ('conv2d_3' → 'conv2d')."""
    base = name.rsplit("_", 1)
    if len(base) == 2 and base[1].isdigit():
        name = base[0]
    return name


class _Replay:
    """Ordered consumer over the layer list, by kind."""

    def __init__(self, layers):
        self.layers = [(n, _kind(n), w) for n, w in layers]
        self.pos = 0

    def take(self, kind):
        while self.pos < len(self.layers):
            name, k, w = self.layers[self.pos]
            self.pos += 1
            if k == kind:
                return w
            if w:  # a weight-bearing layer of a different kind: order bug
                raise ValueError(
                    f"expected {kind!r} next but found {name!r} — not a "
                    f"reference-built generator?")
        raise ValueError(f"ran out of layers looking for {kind!r}")

    def count(self, kind):
        return sum(1 for _, k, _ in self.layers if k == kind)


def _conv(weights):
    kernel, bias = weights
    return {"kernel": kernel, "bias": bias}


def _prelu(weights):
    (alpha,) = weights
    return {"alpha": alpha.reshape(-1)}


def _bn(weights):
    gamma, beta, mean, var = weights
    return ({"scale": gamma, "bias": beta}, {"mean": mean, "var": var})


def import_srresnet(layers):
    """Replay reference build_resnet order → (config, flax variables)."""
    r = _Replay(layers)
    batch_norm = r.count("batch_normalization") > 0
    num_ups = r.count("tf.nn.depth_to_space")
    num_blocks = r.count("add") - 1
    if num_blocks < 1 or num_ups < 1:
        raise ValueError("layer counts do not look like an SRResNet")

    params, stats = {}, {}

    head = _conv(r.take("conv2d"))
    num_filters = head["kernel"].shape[-1]
    params["ConvLayer_0"] = {"Conv_0": head}
    params["PReLU_0"] = _prelu(r.take("p_re_lu"))

    for i in range(num_blocks):
        blk_p, blk_s = {}, {}
        blk_p["ConvLayer_0"] = {"Conv_0": _conv(r.take("conv2d"))}
        if batch_norm:
            p, s = _bn(r.take("batch_normalization"))
            blk_p["ConvLayer_0"]["BatchNorm_0"] = p
            blk_s["ConvLayer_0"] = {"BatchNorm_0": s}
        blk_p["PReLU_0"] = _prelu(r.take("p_re_lu"))
        blk_p["ConvLayer_1"] = {"Conv_0": _conv(r.take("conv2d"))}
        if batch_norm:
            p, s = _bn(r.take("batch_normalization"))
            blk_p["ConvLayer_1"]["BatchNorm_0"] = p
            blk_s["ConvLayer_1"] = {"BatchNorm_0": s}
        r.take("add")
        params[f"ResBlock_{i}"] = blk_p
        if blk_s:
            stats[f"ResBlock_{i}"] = blk_s

    post_p = {"Conv_0": _conv(r.take("conv2d"))}
    if batch_norm:
        p, s = _bn(r.take("batch_normalization"))
        post_p["BatchNorm_0"] = p
        stats["ConvLayer_1"] = {"BatchNorm_0": s}
    params["ConvLayer_1"] = post_p
    r.take("add")

    for j in range(num_ups):
        sub = {"Conv_0": _conv(r.take("conv2d"))}
        r.take("tf.nn.depth_to_space")
        sub["PReLU_0"] = _prelu(r.take("p_re_lu"))
        params[f"SubpixelConvBlock_{j}"] = sub

    params["Conv_0"] = _conv(r.take("conv2d"))

    config = dict(upsample_factor=2 ** num_ups, architecture="srresnet",
                  num_blocks=num_blocks, num_filters=int(num_filters),
                  batch_norm=batch_norm)
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    return config, variables


def import_rrdb(layers, num_dense_blocks=3, num_convs=4,
                residual_scaling=0.2):
    """Replay reference build_enhanced_resnet order → (config, variables).

    The dense-block split (B RRDB blocks × D dense blocks) and the
    residual-scaling constant are not recoverable from the weight file
    (they live in weightless Lambda/Add layers); D and the scaling default
    to the reference defaults (model_builder.py:44) and are overridable."""
    r = _Replay(layers)
    num_ups = r.count("tf.nn.depth_to_space")
    n_add = r.count("add")
    total_dense = n_add - 2  # one add per dense block + trunk add + skip add
    if total_dense < 1 or num_ups < 1:
        raise ValueError("layer counts do not look like an RRDB generator")
    if total_dense % num_dense_blocks:
        raise ValueError(
            f"{total_dense} dense blocks not divisible by "
            f"num_dense_blocks={num_dense_blocks}; pass --num-dense-blocks")
    num_rrdb = total_dense // num_dense_blocks
    n_concat = r.count("concatenate")
    if n_concat and n_concat != total_dense * num_convs:
        num_convs = n_concat // total_dense

    params = {}
    head = _conv(r.take("conv2d"))
    num_filters = head["kernel"].shape[-1]
    params["Conv_0"] = head
    growth = None

    for i in range(num_rrdb):
        blk = {}
        for j in range(num_dense_blocks):
            dense = {}
            for k in range(num_convs):
                w = _conv(r.take("conv2d"))
                if growth is None:
                    growth = int(w["kernel"].shape[-1])
                dense[f"Conv_{k}"] = w
                r.take("concatenate")
            dense[f"Conv_{num_convs}"] = _conv(r.take("conv2d"))
            r.take("lambda")
            r.take("add")
            blk[f"DenseBlock_{j}"] = dense
        params[f"RRDBBlock_{i}"] = blk

    params["Conv_1"] = _conv(r.take("conv2d"))
    r.take("add")

    for l in range(num_ups):
        params[f"SubpixelConvBlock_{l}"] = {"Conv_0": _conv(r.take("conv2d"))}
        r.take("tf.nn.depth_to_space")

    params["Conv_2"] = _conv(r.take("conv2d"))
    params["Conv_3"] = _conv(r.take("conv2d"))

    config = dict(upsample_factor=2 ** num_ups, architecture="rrdb",
                  num_blocks=num_rrdb, num_dense_blocks=num_dense_blocks,
                  num_convs=num_convs, num_filters=int(num_filters),
                  residual_scaling=residual_scaling, batch_norm=False)
    if growth is not None and growth != num_filters // 2:
        config["growth_channels"] = growth
    return config, {"params": params}


def check_variables(config, variables):
    """Raise ``ValueError`` unless ``variables`` is exactly the tree of the
    port's module of ``config``: every variable in place and of its shape."""
    from simplesr_tpu_torch.models import build_generator_model
    from simplesr_tpu_torch.train.convert import from_flax_variables

    module = build_generator_model(**config, device="cpu")
    try:
        module.load_state_dict(from_flax_variables(module, variables))
    except (KeyError, RuntimeError) as e:
        raise ValueError(f"the variables do not match {config}: {e}") from None


def import_keras_model(h5_path, out_path=None, arch=None,
                       num_dense_blocks=3, num_convs=4, residual_scaling=0.2):
    """Convert a reference ``.h5`` generator -> (config, flax-layout
    variables of numpy arrays); when ``out_path`` is given, also write the
    model file."""
    layers = read_h5_layers(h5_path)
    kinds = {_kind(n) for n, _ in layers}
    if arch is None:
        arch = "srresnet" if "p_re_lu" in kinds else "rrdb"
    if arch == "srresnet":
        config, variables = import_srresnet(layers)
    elif arch == "rrdb":
        config, variables = import_rrdb(
            layers, num_dense_blocks=num_dense_blocks, num_convs=num_convs,
            residual_scaling=residual_scaling)
    else:
        raise ValueError(f"unknown arch {arch!r} (srresnet|rrdb)")

    check_variables(config, variables)  # catches silent mis-maps
    if out_path is not None:
        from simplesr_tpu_torch.train import serialization
        serialization.save_model(config, variables, out_path)
    return config, variables


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("h5", help="reference-trained Keras model (.h5)")
    p.add_argument("out", help="output model file (.msgpack)")
    p.add_argument("--arch", choices=("srresnet", "rrdb"),
                   help="override architecture autodetection")
    p.add_argument("--num-dense-blocks", type=int, default=3,
                   help="[rrdb] dense blocks per RRDB block (reference "
                        "default 3; not encoded in the weight file)")
    p.add_argument("--num-convs", type=int, default=4,
                   help="[rrdb] growth convs per dense block (inferred "
                        "from concat count when present)")
    p.add_argument("--residual-scaling", type=float, default=0.2,
                   help="[rrdb] residual scaling constant (lives in Lambda "
                        "layers; reference default 0.2)")
    args = p.parse_args(argv)
    config, _ = import_keras_model(
        args.h5, args.out, arch=args.arch,
        num_dense_blocks=args.num_dense_blocks, num_convs=args.num_convs,
        residual_scaling=args.residual_scaling)
    print(f"imported {args.h5} -> {args.out}\n  config: {config}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
