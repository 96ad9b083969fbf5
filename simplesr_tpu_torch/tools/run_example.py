"""Run one YAML file by its ``general.operation``, as the JAX package's
examples/run_example.py:

    python -m simplesr_tpu_torch.tools.run_example <config.yaml> [--device cpu]

``training`` builds the run with ``ConfigUtil.from_yaml`` and calls
``run_training``; ``evaluation`` runs ``evaluate_on_validationdata`` with
the metrics (PSNR, PSNR on Y, SSIM) and the config's grid, single and
half-split outputs; ``inference`` runs ``evaluate_on_testdata`` over the
test images. The models are served in their exact serving form, through the
x8 self-ensemble when the config's ``self_ensemble`` says so. On the card
unless ``--device cpu``; an unknown operation returns 1.
"""

import argparse
import sys
import time


def run_training_example(config_yaml, device):
    from simplesr_tpu_torch.config import ConfigUtil
    from simplesr_tpu_torch.train import run_training

    conf, pipeline, sr_model = ConfigUtil.from_yaml(config_yaml, device=device)
    return run_training(conf, pipeline, sr_model, device=device)


def run_evaluation_example(config_yaml, device):
    from simplesr_tpu_torch.config import ConfigUtil
    from simplesr_tpu_torch.eval.evaluation import evaluate_on_validationdata

    conf, pipeline = ConfigUtil.from_yaml(config_yaml, device=device)
    return evaluate_on_validationdata(
        config=conf, pipeline=pipeline, calc_stats=True, save_grid=conf.grid,
        save_single=conf.save_single, combine_halfs=conf.combine_halfs, device=device)


def run_inference_example(config_yaml, device):
    from simplesr_tpu_torch.config import ConfigUtil
    from simplesr_tpu_torch.eval.evaluation import evaluate_on_testdata

    conf, pipeline = ConfigUtil.from_yaml(config_yaml, device=device)
    start = time.perf_counter()
    outputs = evaluate_on_testdata(
        config=conf, pipeline=pipeline, save_single=conf.save_single,
        combine_halfs=conf.combine_halfs, interpolate=conf.interpolate, grid=conf.grid,
        with_original=conf.with_original, device=device)
    print(f"inference took {time.perf_counter() - start:.2f} sec")
    return outputs


OPERATIONS = {"training": run_training_example, "evaluation": run_evaluation_example,
              "inference": run_inference_example}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("config", help="YAML config path")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from simplesr_tpu_torch.config import yaml_helper
    from simplesr_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)
    conf_yaml = yaml_helper.load_yaml(args.config)
    operation = conf_yaml["general"]["operation"]
    if operation not in OPERATIONS:
        print(f"operation {operation!r} not recognized (choose training/evaluation/inference)")
        return 1
    OPERATIONS[operation](conf_yaml, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
