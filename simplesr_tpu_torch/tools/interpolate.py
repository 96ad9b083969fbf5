"""Network interpolation between two trained models (ESRGAN, section 3.4),
as simplesr_tpu.tools.interpolate.

Blends the parameters of a PSNR-oriented model and a GAN-finetuned one,
``theta = (1 - alpha) * theta_psnr + alpha * theta_gan``, trading pixel
fidelity against perceptual sharpness without retraining. The two stages of
the pretrain -> GAN flow give exactly such a compatible pair.

It works on the files' variables as host arrays (numpy), as the JAX
package's does: no device is involved. The blend is in float64, cast back to
each leaf's dtype; the result is written by ``save_model``, byte-equal to the
JAX package's file.

    python -m simplesr_tpu_torch.tools.interpolate \\
        --psnr resnet_gen_best.msgpack --gan gan_gen_final.msgpack \\
        --alpha 0.8 --output blended.msgpack

Several alphas sweep in one call (files get an ``_a{alpha}`` postfix):

    ... --alpha 0.2 0.5 0.8 --output out_dir/
"""

import argparse
import os

import numpy as np
import torch

from simplesr_tpu_torch.train import serialization


def _blend(a, b, alpha):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):  # bfloat16 leaves
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        if a.shape != b.shape:
            raise ValueError(f"parameter shape mismatch: {tuple(a.shape)} vs {tuple(b.shape)}")
        if not a.is_floating_point():
            return b
        return ((1.0 - alpha) * a.double() + alpha * b.double()).to(a.dtype)
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        raise ValueError(f"parameter shape mismatch: {a.shape} vs {b.shape}")
    if not np.issubdtype(a.dtype, np.floating):
        return b
    return ((1.0 - alpha) * a.astype(np.float64) + alpha * b.astype(np.float64)).astype(a.dtype)


def _tree_blend(a, b, alpha):
    """Leaf-wise blend of two variable trees of the same structure, keys in
    sorted order (as a JAX tree map gives them back)."""
    if isinstance(a, dict) or isinstance(b, dict):
        if not (isinstance(a, dict) and isinstance(b, dict)) or set(a) != set(b):
            raise ValueError("model variable trees differ in structure")
        return {k: _tree_blend(a[k], b[k], alpha) for k in sorted(a)}
    return _blend(a, b, alpha)


def interpolate_models(psnr_path, gan_path, alpha):
    """Blend two saved models -> (module_config, variables).

    The architecture configs must match (interpolation is defined parameter
    by parameter); a key missing from one config counts as None, as for a
    model saved before that key existed. Every float leaf is blended,
    BatchNorm statistics included; non-float leaves are taken from the GAN
    model.
    """
    cfg_a, var_a = serialization.load_payload(psnr_path)
    cfg_b, var_b = serialization.load_payload(gan_path)
    keys = set(cfg_a) | set(cfg_b)
    if any(cfg_a.get(k) != cfg_b.get(k) for k in keys):
        raise ValueError(
            f"model architectures differ - psnr={cfg_a} gan={cfg_b}; interpolation needs "
            "the same topology (the two-stage pretrain->GAN flow produces a compatible pair)")
    return cfg_b, _tree_blend(var_a, var_b, alpha)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--psnr", required=True, help="pixel-trained model (.msgpack)")
    p.add_argument("--gan", required=True, help="GAN-finetuned model (.msgpack)")
    p.add_argument("--alpha", type=float, nargs="+", default=[0.8],
                   help="GAN weight(s) in [0, 1]; several values sweep")
    p.add_argument("--output", required=True,
                   help="output file (single alpha) or directory (sweep)")
    args = p.parse_args(argv)

    single = len(args.alpha) == 1 and not os.path.isdir(args.output) \
        and not args.output.endswith(os.sep)
    outputs = []
    for alpha in args.alpha:
        if not 0.0 <= alpha <= 1.0:
            raise SystemExit(f"alpha must be in [0,1], got {alpha}")
        cfg, blended = interpolate_models(args.psnr, args.gan, alpha)
        if single:
            out = args.output
        else:
            stem = os.path.splitext(os.path.basename(args.gan))[0]
            out = os.path.join(args.output, f"{stem}_a{alpha:g}.msgpack")
        serialization.save_model(cfg, blended, out)
        print(f"alpha={alpha:g} -> {out}")
        outputs.append(out)
    return outputs


if __name__ == "__main__":
    main()
