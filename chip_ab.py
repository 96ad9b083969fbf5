#!/usr/bin/env python3
"""Compare two checkouts of this repo on one NVIDIA GPU, in alternating
runs, each run a fresh process.

    python3 chip_ab.py PARENT_DIR TREE_DIR [--pairs 10]

Each run times the production generator's ResNet-mode ``train_step`` (16 x
96^2 HR, Adam on the recipe's piecewise schedule, NaN guard) with the
``simplesr_tpu_torch`` of one directory: CUDA-event median of 50 steps
after 5 warm-up steps. Pairs alternate which side runs first. Each directory is a checkout or a
``git archive`` export of the repo. Prints one JSON line per run, then the
medians and quartiles of each side and the pairs each side won.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def time_step(root):
    """One run, in this process, with the package under ``root``."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    from simplesr_tpu_torch.train import Generator, SRModel

    dev = torch.device("cuda")
    gen = Generator.srresnet(4, num_blocks=16, num_filters=64, batch_norm=False,
                             dtype="bfloat16", seed=0, device=dev)
    schedule = {"piecewise_constant_decay": {"boundaries": [100000], "values": [1e-4, 1e-5]}}
    model = SRModel("resnet", gen, "Adam", {"learning_rate": schedule}, device=dev)
    g = torch.Generator().manual_seed(0)
    lr = torch.rand((16, 24, 24, 3), generator=g).to(dev)
    hr = (torch.rand((16, 96, 96, 3), generator=g) * 2 - 1).to(dev)
    for _ in range(5):
        model.train_step(lr, hr)
    torch.cuda.synchronize()
    times = []
    for _ in range(50):
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        model.train_step(lr, hr)
        end.record()
        end.synchronize()
        times.append(begin.elapsed_time(end))
    q1, _, q3 = statistics.quantiles(times, n=4)
    return {"median_ms": statistics.median(times), "q1": q1, "q3": q3}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("parent", nargs="?")
    p.add_argument("tree", nargs="?")
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--one", help=argparse.SUPPRESS)  # one run, in a fresh process
    args = p.parse_args(argv)
    if args.one:
        print(json.dumps({"root": args.one, **time_step(args.one)}), flush=True)
        return 0
    if not (args.parent and args.tree):
        p.error("need PARENT_DIR and TREE_DIR")
    results = {"parent": [], "tree": []}
    for i in range(args.pairs):
        order = ("parent", "tree") if i % 2 == 0 else ("tree", "parent")
        for side in order:
            root = getattr(args, side)
            proc = subprocess.run([sys.executable, __file__, "--one", root],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                print(proc.stdout[-2000:], proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode
            run = json.loads(proc.stdout.splitlines()[-1])
            print(json.dumps({"pair": i + 1, "side": side, **run}), flush=True)
            results[side].append(run["median_ms"])
    summary = {side: {"runs": v, "median": statistics.median(v),
                      "quartiles": statistics.quantiles(v, n=4) if len(v) > 1 else v}
               for side, v in results.items()}
    summary["tree_faster_pairs"] = sum(t < p for p, t in zip(results["parent"],
                                                             results["tree"]))
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
