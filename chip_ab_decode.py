#!/usr/bin/env python3
"""Compare two checkouts of this repo on one NVIDIA GPU in what the image
decoders add to ``chip_smoke.py``: the host loader's build and phase 18.

    python3 chip_ab_decode.py PARENT_DIR TREE_DIR

Runs parent, tree, tree, parent, each a fresh process with that
directory's ``simplesr_tpu_torch`` and ``chip_smoke.py``: it builds the
kernels, deletes that directory's host library and times its build
(``native_loader.library()``), then times its own phase 18
(``image_formats_phase``) serving this checkout's flagship. Each directory
is a checkout or a ``git archive`` export of the repo (the large
``results/`` campaigns may be left out: the flagship is read from here).
Prints one JSON line per run and writes them to
``chiprun_out/ab_decode.json``.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RUN = r'''
import json, subprocess, sys, tempfile, time
from pathlib import Path
tree = Path(sys.argv[1])
sys.path.insert(0, str(tree))
import torch
import chip_smoke
from simplesr_tpu_torch.data import native_loader
from simplesr_tpu_torch.ops.kernels import _build
chip_smoke.FLAGSHIP = sys.argv[2]
_build.library()
for old in native_loader.BUILD_DIR.glob("ssr_host_loader_*.so"):
    old.unlink()
t = time.perf_counter()
native_loader.library()
build_s = time.perf_counter() - t
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
with tempfile.TemporaryDirectory() as d:
    t = time.perf_counter()
    out = chip_smoke.image_formats_phase(torch.device("cuda"), Path(d), {}, card)
    phase_s = time.perf_counter() - t
print("AB " + json.dumps({"tree": str(tree), "build_s": build_s, "phase18_s": phase_s,
                          "card": card, "rates": out["one_thread_mpix_per_s"]}))
'''


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("parent")
    parser.add_argument("tree")
    args = parser.parse_args()
    flagship = str(ROOT / "results/quality_fastrecipe/models/resnet_gen_srresnet_x4_best.msgpack")
    rows = []
    for tree in (args.parent, args.tree, args.tree, args.parent):
        proc = subprocess.run([sys.executable, "-c", RUN, str(Path(tree).resolve()), flagship],
                              capture_output=True, text=True, timeout=600)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("AB ")]
        if proc.returncode or not line:
            print(proc.stdout[-3000:], proc.stderr[-3000:])
            raise SystemExit(f"{tree}: exit {proc.returncode}")
        rows.append(json.loads(line[0][3:]))
        print(line[0][3:], flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out/ab_decode.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
