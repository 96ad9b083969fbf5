"""Training from a YAML file.

    python -m simplesr_tpu_torch.tools.train <config.yaml> [--resume]
        [--profile-dir D] [--device cpu]
    torchrun --nproc-per-node N -m simplesr_tpu_torch.tools.train <config.yaml>

As simplesr_tpu.tools.train: ``--resume`` continues the latest run under the
config's results tree (it sets ``general.resume: latest`` unless the YAML
names a run); a run preempted by SIGTERM saves a resume point and exits 75
(EX_TEMPFAIL), a finished one 0. ``--profile-dir`` writes a
``torch.profiler`` trace of the epoch loop there. The run is on the card
unless ``--device cpu`` is given. Under torchrun each rank initialises the
process group from torchrun's environment (NCCL on the cards, gloo with
``--device cpu``) and trains on ``cuda:LOCAL_RANK``; the YAML's
``data_parallel``, ``fsdp``, ``tensor_parallel`` and ``pipeline_parallel``
lay the ranks out.
"""

import argparse
import sys

EXIT_PREEMPTED = 75  # EX_TEMPFAIL: stopped on SIGTERM, resumable


def main(argv=None):
    p = argparse.ArgumentParser(description="Train from a YAML config (operation: training)")
    p.add_argument("config", help="YAML config path")
    p.add_argument("--resume", action="store_true",
                   help="continue the latest run under this config's results tree")
    p.add_argument("--profile-dir", default=None, help="capture a torch.profiler trace here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from simplesr_tpu_torch.config import ConfigUtil, yaml_helper
    from simplesr_tpu_torch.core.device import resolve_device
    from simplesr_tpu_torch.parallel.mesh import initialize_multihost, rank_device
    from simplesr_tpu_torch.train import run_training

    device = resolve_device(rank_device(args.device))
    if device.type == "cuda":
        import torch
        torch.cuda.set_device(device)
    initialize_multihost(device=device)
    conf_yaml = yaml_helper.load_yaml(args.config)
    operation = conf_yaml.get("general", {}).get("operation")
    if operation != "training":
        p.error(f"config's general.operation is {operation!r}, expected 'training'")
    if args.resume and not conf_yaml["general"].get("resume"):
        conf_yaml["general"]["resume"] = "latest"

    conf, pipeline, sr_model = ConfigUtil.from_yaml(conf_yaml, device=device)
    result = run_training(conf, pipeline, sr_model, profile_dir=args.profile_dir, device=device)
    return EXIT_PREEMPTED if result is None else 0


if __name__ == "__main__":
    sys.exit(main())
