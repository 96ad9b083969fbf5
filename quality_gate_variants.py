#!/usr/bin/env python3
"""The quality gate's run on the card in variants, for the spread that
``chip_smoke.py`` phase 16 (b) argues its parity bound from.

    python3 quality_gate_variants.py VARIANT[,VARIANT...] [--init FILE]

Each variant runs ``tools.quality_check.main(4000, 2)`` on the card with
its generator changed: ``seed1`` (another initial draw), ``float32`` (no
bf16, so no trunk kernel), ``plain`` (bf16 with the trunk in plain
autograd) or ``init`` (the initial weights of FILE, as
``quality_gate_reference.py --save-init`` writes the JAX package's). It
prints one JSON line a variant: the step's ms, the launches and each
probe's PSNR gap to bicubic. It imports no JAX.
"""

import json
import sys
import time

import torch

import chip_smoke
from simplesr_tpu_torch.ops.kernels import _build
from simplesr_tpu_torch.tools import quality_check
from simplesr_tpu_torch.train import Generator

STEPS = 4000


def variant_kwargs(name, init):
    return {"seed1": dict(seed=1), "float32": dict(dtype="float32"), "plain": {},
            "init": dict(pretrained_model_path=init)}[name]


def main(names, init=None):
    _build.library()
    dev = torch.device("cuda")
    factory = Generator.srresnet
    try:
        for name in names:
            kw = variant_kwargs(name, init)

            def make(*args, _kw=kw, _plain=name == "plain", **kwargs):
                gen = factory(*args, **{**kwargs, **_kw})
                if _plain:
                    gen.model().uses_trunk_kernel = False
                return gen

            quality_check.Generator.srresnet = staticmethod(make)
            t = time.perf_counter()
            out, launches = chip_smoke.counted(lambda: quality_check.main(STEPS, 2, device=dev))
            held = [v for v in out["images"].values() if v["heldout"]]
            print(json.dumps({
                "variant": name, "step_ms": out["train_s"] / STEPS * 1e3,
                "seconds": time.perf_counter() - t, "launches": launches,
                "gap": {k: v["model_psnr"] - v["bicubic_psnr"] for k, v in out["images"].items()},
                "heldout_mean_gap": sum(v["model_psnr"] - v["bicubic_psnr"] for v in held)
                / len(held)}), flush=True)
    finally:
        quality_check.Generator.srresnet = staticmethod(factory)


if __name__ == "__main__":
    args = sys.argv[1:]
    init = args[args.index("--init") + 1] if "--init" in args else None
    main(args[0].split(","), init)
