#!/usr/bin/env python3
"""The JAX package's scores of the three committed denoising models, the
reference that ``chip_smoke.py`` phase 17 (b) and (c) hold the port's
``tools/jpg_noise_campaign.py`` to.

    JAX_PLATFORMS=cpu python3 jpg_noise_reference.py

It loads ``scripts/jpg_noise_campaign.py`` from its file and runs its own
``evaluate`` and ``domain_gap`` (``_clean_lr``, ``libjpeg_degrade_01``
through PIL, the DCT degrade of ``simplesr_tpu/ops/jpeg.py``, ``_metrics``)
on the four held-out gallery tiles (gt_1, gt_10, gt_13, gt_6), which stand
in for the reference's baboon and comic, at real-libjpeg qualities 30, 50,
75 and 90 and on clean inputs:

  - round 4's noise-trained model against its clean control against
    bicubic (``results/quality_r4/models/resnet_gen_srresnet_{jpg_rq,ctl}_x2_best``);
  - round 3's fixed-quality-50 model in the noise column against the same
    control (``results/quality_r3/models/resnet_gen_srresnet_jpg_x2_best``);
  - ``domain_gap`` of the round-4 noise model: per tile and quality the
    input PSNR between the DCT degrade and libjpeg, and the model's output
    PSNR on each.

Each model runs in the dtype its file names (bf16), on the CPU. Beside
them it scores the same models with the port's campaign
(``simplesr_tpu_torch/tools/jpg_noise_campaign.py``, its own JPEG encoder
and decoder, on the CPU) and reports the worst difference of each metric
(``port_cpu_worst``). It prints one JSON line. It imports JAX and PIL and
runs no CUDA: the card has neither.
"""

import importlib.util
import json
import time
from pathlib import Path

from simplesr_tpu.train import Generator

ROOT = Path(__file__).resolve().parent
HELDOUT = ("gt_1", "gt_10", "gt_13", "gt_6")
MODELS = {
    "round4_noise": "results/quality_r4/models/resnet_gen_srresnet_jpg_rq_x2_best.msgpack",
    "round4_control": "results/quality_r4/models/resnet_gen_srresnet_ctl_x2_best.msgpack",
    "round3_noise": "results/quality_r3/models/resnet_gen_srresnet_jpg_x2_best.msgpack",
}


def jax_campaign():
    """scripts/jpg_noise_campaign.py with the held-out gallery tiles as its
    probes and no train member evaluated."""
    spec = importlib.util.spec_from_file_location(
        "jax_jpg_noise_campaign", ROOT / "scripts/jpg_noise_campaign.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.EVAL_TRAIN_IMGS = {}
    module.HELDOUT_IMGS = {k: str(ROOT / "data/corpus/gallery" / f"{k}.png") for k in HELDOUT}
    return module


def main():
    jc = jax_campaign()
    models = {k: Generator.srresnet(upsample_factor=2, pretrained_model_path=str(ROOT / v))
              for k, v in MODELS.items()}
    t0 = time.perf_counter()
    round4 = jc.evaluate(models["round4_noise"], models["round4_control"], {})
    round3 = jc.evaluate(models["round3_noise"], models["round4_control"], {})
    gap = jc.domain_gap(models["round4_noise"], {})
    seconds = time.perf_counter() - t0
    print(json.dumps({"models": MODELS, "heldout": list(HELDOUT),
                      "qualities": list(jc.EVAL_QUALITIES), "round4": round4["images"],
                      "round3": round3["images"], "domain_gap": gap["domain_gap"],
                      "seconds": seconds,
                      "port_cpu_worst": port_cpu_worst(jc, round4, round3, gap)}), flush=True)


def port_cpu_worst(jc, round4, round3, gap):
    """The port's campaign on the CPU with the same models and tiles: the
    worst |port - JAX| of each row metric and of the domain gap's
    figures."""
    from simplesr_tpu_torch.tools import jpg_noise_campaign as pc
    from simplesr_tpu_torch.train import Generator as PortGenerator

    pc.DEVICE, pc.EVAL_TRAIN_IMGS, pc.HELDOUT_IMGS = "cpu", {}, dict(jc.HELDOUT_IMGS)
    models = {k: PortGenerator.srresnet(2, pretrained_model_path=ROOT / v, device="cpu")
              for k, v in MODELS.items()}
    got4 = pc.evaluate(models["round4_noise"], models["round4_control"], {})["images"]
    got3 = pc.evaluate(models["round3_noise"], models["round4_control"], {})["images"]
    got_gap = pc.domain_gap(models["round4_noise"], {})["domain_gap"]
    worst = {"psnr": 0.0, "psnr_y": 0.0, "ssim": 0.0, "gap_input": 0.0, "gap_outputs": 0.0}
    for got, want in ((got4, round4["images"]), (got3, round3["images"])):
        for tile, rows in want.items():
            for q, row in rows.items():
                if q == "heldout":
                    continue
                for col, m in row.items():
                    for k in ("psnr", "psnr_y", "ssim"):
                        worst[k] = max(worst[k], abs(got[tile][q][col][k] - m[k]))
    for tile, rows in gap["domain_gap"].items():
        for q, r in rows.items():
            g = got_gap[tile][q]
            worst["gap_input"] = max(worst["gap_input"], abs(
                g["input_dct_vs_libjpeg_psnr"] - r["input_dct_vs_libjpeg_psnr"]))
            for k in ("out_psnr_on_libjpeg", "out_psnr_on_dct"):
                worst["gap_outputs"] = max(worst["gap_outputs"], abs(g[k] - r[k]))
    return worst


if __name__ == "__main__":
    main()
