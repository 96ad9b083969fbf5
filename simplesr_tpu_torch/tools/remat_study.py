"""What rematerialisation buys the production training step: peak device
memory and time, as scripts/remat_study.py measures them on the TPU.

    python -m simplesr_tpu_torch.tools.remat_study [--batch 16] [--crop 128]
        [--scale 4] [--steps N] [--configs srresnet:16,rrdb:16,rrdb:23]
        [--batch-norm {true,false}] [--device cpu]

For each ``arch:blocks`` of ``--configs``, with ``remat`` off and on, it
builds the port's ``SRModel`` (Adam at 1e-4, the model's default dtype) and
runs its full production step, ``train_step`` then ``after_train_batch``,
on seeded batches of ``--batch`` crops of ``--crop`` px. XLA's
``temp_size_in_bytes`` has no CUDA counterpart; a row reads instead:

- ``peak_bytes``: ``torch.cuda.max_memory_allocated()`` over one step,
  after ``reset_peak_memory_stats()`` just before it (on the card only);
- ``state_bytes``: what is allocated just before the step (the model, its
  optimiser state and the batch), the counterpart of XLA's
  ``argument_size_in_bytes``;
- ``peak_excess_bytes``: ``peak_bytes - state_bytes``, the step's own
  memory, the counterpart of ``temp_size_in_bytes``;
- ``saved_bytes``: the bytes autograd saves for the backward in one step
  (distinct storages, parameters left out), counted through
  ``torch.autograd.graph.saved_tensors_hooks`` on any device;
- ``ms_per_step`` with ``--steps N`` (median of N steps, CUDA events).

``--batch-norm`` sets the SRResNets' BatchNorm (on by default, as
``Generator.srresnet``): a BN-free bf16 SRResNet of 64 filters trains its
trunk through the kernel's ``TrunkFunction``, which stores only the trunk's
input whatever ``remat`` says. It prints the JAX script's table, with a
``ratio`` column (plain over remat), and one JSON line. The run is on the
card unless ``--device cpu`` is given (no peak there: ``saved_bytes`` and
host-clock times only).
"""

import argparse
import json
import tempfile

import numpy as np
import torch

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.tools.bench_timing import card_line, cuda_ms


def train_config(tmp):
    """The directories and early-stopping settings ``SRModel`` reads."""
    class Cfg:
        model_dir = tmp + "/m"
        checkpoint_dir = tmp + "/c"
        early_stop_metric = "psnr"
        early_stop_patience = 10**6
    return Cfg


def build_model(arch, remat, crop, scale, blocks, dev, batch_norm=True, tmp=None):
    from simplesr_tpu_torch.train import Generator, SRModel

    kw = dict(upsample_factor=scale, num_blocks=blocks, input_dims=(crop // scale,) * 2,
              remat=remat, device=dev)
    gen = (Generator.rrdb(**kw) if arch == "rrdb"
           else Generator.srresnet(batch_norm=batch_norm, **kw))
    return SRModel(model_type="resnet", generator=gen, generator_optimizer="Adam",
                   generator_optimizer_config={"learning_rate": 1e-4},
                   config=train_config(tmp or tempfile.mkdtemp()), device=dev)


def batch(batch_size, crop, scale, dev, seed=0):
    """Seeded (LR in [0, 1], HR in [-1, 1]) NHWC float32, on ``dev``."""
    rng = np.random.default_rng(seed)
    lr = rng.uniform(0, 1, (batch_size, crop // scale, crop // scale, 3)).astype(np.float32)
    hr = rng.uniform(-1, 1, (batch_size, crop, crop, 3)).astype(np.float32)
    return torch.from_numpy(lr).to(dev), torch.from_numpy(hr).to(dev)


def saved_bytes(run, params):
    """Bytes of the distinct storages autograd saves for the backward while
    ``run()`` runs, ``params``' own storages left out."""
    skip = {p.untyped_storage().data_ptr() for p in params}
    seen = {}

    def pack(t):
        storage = t.untyped_storage()
        if storage.data_ptr() not in skip:
            seen[storage.data_ptr()] = storage.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        run()
    return sum(seen.values())


def analyze(model, lr, hr, steps):
    """The row of one model: see the module docstring."""
    dev = lr.device

    def step():
        model.train_step(lr, hr)
        model.after_train_batch()

    model.before_epoch()
    step()  # the optimiser's state, cuDNN's choices
    row = {"saved_bytes": saved_bytes(step, model.generator().parameters())}
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = torch.cuda.memory_allocated()
        step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        row.update(peak_bytes=peak, state_bytes=state, peak_excess_bytes=peak - state)
    if steps:
        row["ms_per_step"] = cuda_ms(step, runs=steps, warmup=1, dev=dev)
    return row


def table(results, steps):
    """The JAX script's markdown table, over the port's fields."""
    pairs = {}
    for r in results:
        pairs.setdefault((r["arch"], r["blocks"]), {})[r["remat"]] = r
    fmt = lambda v: f"{v / 2**20:.1f} MiB" if v is not None else "not measured"
    ratio = lambda a, b: f"{a / b:.2f}x" if a is not None and b else "n/a"
    lines = ["| model | blocks | peak excess (plain) | peak excess (remat) | ratio |"
             " saved (plain) | saved (remat) | ratio | ms/step (plain -> remat) |",
             "|---|---|---|---|---|---|---|---|---|"]
    for (arch, blocks), pair in pairs.items():
        a, b = pair.get(False, {}), pair.get(True, {})
        ea, eb = a.get("peak_excess_bytes"), b.get("peak_excess_bytes")
        sa, sb = a.get("saved_bytes"), b.get("saved_bytes")
        ms = f"{a.get('ms_per_step')} -> {b.get('ms_per_step')}" if steps else "-"
        lines.append(f"| {arch} | {blocks} | {fmt(ea)} | {fmt(eb)} | {ratio(ea, eb)} "
                     f"| {fmt(sa)} | {fmt(sb)} | {ratio(sa, sb)} | {ms} |")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--crop", type=int, default=128, help="HR crop size")
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--steps", type=int, default=0, help="also time N real steps per config")
    p.add_argument("--configs", default="srresnet:16,rrdb:16,rrdb:23",
                   help="comma list of arch:blocks")
    p.add_argument("--batch-norm", choices=("true", "false"), default="true",
                   help="BatchNorm in the SRResNets")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    lr, hr = batch(args.batch, args.crop, args.scale, dev)
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for spec in args.configs.split(","):
            arch, _, blocks = spec.partition(":")
            blocks = int(blocks or 16)
            for remat in (False, True):
                model = build_model(arch, remat, args.crop, args.scale, blocks, dev,
                                    args.batch_norm == "true", tmp)
                row = analyze(model, lr, hr, args.steps)
                row.update(arch=arch, blocks=blocks, remat=remat, batch=args.batch,
                           crop=args.crop, batch_norm=arch == "srresnet"
                           and args.batch_norm == "true", device=str(dev))
                results.append(row)
                print(f"# {arch} b{blocks} remat={remat}: {row}", flush=True)
                del model
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
    print("\n" + table(results, args.steps))
    print(json.dumps({"remat_study": results, "card": card_line(dev)}), flush=True)
    return results


if __name__ == "__main__":
    main()
