#!/usr/bin/env python3
"""Smoke run of simplesr_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

It serves the committed SRResNet x4 flagship (16 blocks, 64 filters, BN-free,
bf16) through the port's entry points and holds every CUDA kernel against its
plain PyTorch version, in one process, with no arguments:

  0. the card's name and power limit;
  1. build the CUDA kernels from simplesr_tpu_torch/csrc (one nvcc call);
  2. trunk kernel vs its plain version at (8, 192, 192, 64) on the flagship's
     16 blocks, the tiled route's shape: each block on the same input (max
     relative error < 1e-2), and the 16-block chain against float64 sums;
     then each block at the shapes that the persistent loop and the edges
     exercise (fewer tiles than SMs, ragged on both axes, more tiles than
     CTAs times stages), to the same bound;
  3. patch-extraction kernel vs its plain version, bit-exact, at the tiled
     route's 1100 x 1040 x 3 image (128 px patches, 32 px overlap) and at an
     unaligned size;
  4. the main path, ``tools.upscale.upscale_files``: a gallery PNG (untiled)
     and a 1100 x 1040 LR PNG (the tiled route), each with the launch counts
     set to 0 just before and read just after; outputs checked for shape,
     finiteness and range, against the same routes on the plain versions,
     and against the CPU path on a small input;
  5. four requests of two shapes through ``tools.serve.SREngine``, with the
     launch counts set to 0 just before and read just after, checked against
     the one-shot path;
  6. timings with CUDA events: each kernel, its plain version and one
     PyTorch library call for the same function, as one call from Python
     between two events (``ms``, median of 25 runs) and also as device time
     (``device_ms``: many calls captured in one CUDA graph and replayed
     between two events, so that no host time between launches counts;
     median of 10 replays); the tiled upscale end to end (median of 20
     runs); each kernel's registers, spills and shared memory as
     ``cudaFuncGetAttributes`` reads them;
  7. training at full width through ``train.SRModel``: the production
     recipe's generator (x4, 16 blocks, 64 filters, BN-free, bf16 compute,
     float32 parameters, seeded), Adam on the recipe's piecewise schedule
     with the NaN guard, batches of 16 HR crops of 96 x 96 from the gallery
     PNGs (flips and 90 degree turns) and their 24 x 24 LR from the port's
     bicubic resize. Checks: the gradients through ``TrunkFunction`` (kernel
     forward) against autograd straight through the plain trunk; 30 steps
     with finite losses that fall; one trunk launch per ``train_step`` and
     ``validation_step`` and none in the backward; ``generate`` bit-equal to
     a module loaded from ``save_model``'s file; the flagship with grad
     enabled bit-equal to ``inference_mode``; a 128-wide model on CUDA
     against the CPU, with no trunk launch. Printed, not gated: the step's
     time (median of 30, CUDA events) and its forward, backward and
     optimizer parts, HR MPix/s, peak memory, and the same step with the
     trunk in plain autograd (cuDNN, activations stored); for each, a
     ``torch.profiler`` trace of 3 steps (device busy time, idle share, the
     kernels that take the most device time), taken after phase 8's timings;
  8. training from a YAML file: the production recipe
     (examples/training/srresnet_x4_paired_production.yaml), read by the
     port's YAML reader and written with these cuts, each printed in
     ``reduced``: the gallery PNGs as data, a temporary results directory,
     2 epochs, seed 0, and no ``paired_train``; run in-process through
     ``tools.train.main`` (ConfigUtil.from_yaml, DataPipeline, SRModel.init,
     run_training), with the launch counts set to 0 just before and read
     just after. Checks: exit 0; the save-dir tree and file names of the
     JAX package's run; finite histories and a lower epoch-mean loss in
     epoch 2; the ``_best`` file's output on a gallery crop bit-equal to
     the trained module's; one trunk launch per ``train_step``,
     ``validation_step`` and ``generate`` call (counted by the phase);
     ``--resume`` with 3 epochs starts at epoch 2 with the first run's
     histories and early-stopping state and runs one epoch; a run that gets
     SIGTERM after 10 steps exits 75 and leaves a resume point; the
     pipeline on the card against the CPU for the same config and seed (3
     training batches: HR bit-equal, LR max abs < 1e-4). Printed, not
     gated: seconds per epoch (from ``before_epoch`` to ``after_epoch``,
     validation and plots included), train steps per second, HR MPix/s end
     to end (pipeline included), the share of each epoch spent waiting on
     the pipeline's generators, the time to decode the 16 PNGs, peak
     memory, one epoch of the pipeline alone and of the bare steps on its
     batches, and a ``torch.profiler`` trace of 10 steps of the loop, taken
     last (a profiler session slows the launches after it, so phase 7's
     traces wait until phase 8's timings are done).

Torch's global TF32 flags are left as they are: the model sets the precision
of its one float32 conv itself (``core.dtypes.OUTPUT_CONV_TF32``).
Prints one JSON object per phase, then the kernels' JSON line, and last
``{"ok": true, "device": {...}}``. Any failure prints its traceback and exits
non-zero without that line; without a CUDA device it exits 2 at once.
"""

import contextlib
import copy
import faulthandler
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "results/quality_fastrecipe/models/resnet_gen_srresnet_x4_best.msgpack"
GALLERY_PNG = ROOT / "data/corpus/gallery/gt_3.png"
TILED_HW = (1100, 1040)   # an LR image over the 1000 x 1000 tiling threshold
TRUNK_SHAPE = (8, 192, 192)  # the trunk's input on the tiled route: batch 8 of 128 + 2 * 32 px
# Shapes for the trunk kernel's persistent loop and edges (tiles of 4 x 64 px,
# one CTA per SM, 3 stages): 1 tile; ragged rows and columns; 3,315 tiles.
TRUNK_EDGE_SHAPES = ((1, 1, 1), (2, 13, 37), (3, 200, 260))
CROP_HW = (96, 128)       # the engine's second request shape
SEED = 0
TIMING_RUNS = 25
WATCHDOG_S = 1100

# H100 SXM data-sheet peaks (dense), for the bounds.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# Trunk kernel vs plain version, max |diff| / max |plain|, each residual block
# on the same input: bf16 storage, f32 sums in another order.
TRUNK_REL_TOL = 1e-2
# The 16-block chain is not held to that bound: a rounding to bf16 that flips
# in one block spreads through the later ones, so any two f32 summation orders
# part by about 1.1e-2 after 16 blocks (the plain version with float64 sums
# does too). The chain is held to be as accurate as the plain version, against
# float64 sums, up to this factor on the relative Frobenius error:
TRUNK_CHAIN_FRO_RATIO = 1.5
# Phase 7: the production recipe (examples/training/srresnet_x4_paired_production.yaml)
# at its batch of 16 crops of 96 x 96; its paired_train: 2 packs two batch
# items into channels for the TPU's 128-lane matrix unit and is not ported.
TRAIN_BATCH = 16
TRAIN_HR = 96
TRAIN_STEPS = 30
TRAIN_SCHEDULE = {"piecewise_constant_decay": {"boundaries": [100000], "values": [1e-4, 1e-5]}}
# Gradients through TrunkFunction (kernel forward) vs autograd straight
# through the plain trunk, per parameter tensor, relative Frobenius error.
# Both backwards are the same recomputed plain version; they differ only
# through the forward, where kernel and plain version round the 32 bf16
# activations apart (phase 2: per block max rel ~5e-3, the 16-block chain
# ~9e-3 in Frobenius norm). That difference reaches every gradient through
# the tail and the trunk's incoming gradient, so 3e-2 is about 3x the chain's.
TRAIN_GRAD_FRO_TOL = 3e-2
# The loss is a mean of 442,368 squared errors: the same rounding
# differences average out; 1e-2 is far above them and far below a wrong trunk.
TRAIN_LOSS_REL_TOL = 1e-2
WIDE_FILTERS = 128  # fault check: widths other than 64 run ResBlocks on CUDA
# The 128-wide model on CUDA against the CPU: max abs under ROUTE_MAX_ABS_TOL,
# and its mean abs error against float64 sums (the same bf16 rounding points)
# at most this factor of the CPU's. Its mean abs difference from the CPU is
# printed and not gated: on this seeded model any two summation orders part
# by about 3.5e-3 after 16 blocks (float32 against float64 sums, on the CPU),
# above the 2e-3 of the route's bound.
WIDE_MEAN_RATIO = 1.5
ROUTE_MAX_ABS_TOL = 5e-2  # whole upscale on [-1, 1]: bf16 trunk differences through the tail
ROUTE_MEAN_ABS_TOL = 2e-3
ENGINE_MAX_ABS_TOL = 5e-2  # batched vs one-shot: cuDNN may pick other algorithms per batch
PNG_MAX_LEVELS = 1  # a written PNG vs the route's output, truncated to uint8
# Phase 8: the production recipe from its YAML file, cut to the gallery.
RECIPE = ROOT / "examples/training/srresnet_x4_paired_production.yaml"
YAML_EPOCHS = 2
PREEMPT_AFTER_STEPS = 10
PIPELINE_LR_TOL = 1e-4  # LR on [0, 1], card vs CPU: the resize's float32 sums
EXIT_PREEMPTED = 75
# The save-dir tree of the JAX package's run_training for 2 epochs, without
# the checkpoints' contents (orbax there, torch.save here) and the
# TensorBoard event files (tests/test_torch_training_loop.py holds the two
# trees equal on the CPU).
JAX_RUN_TREE = {
    ".", "checkpoints", "checkpoints/resnet_resume_meta.json", "config_logfile",
    "json_dump", "json_dump/resnet_train_batch_history.json",
    "json_dump/resnet_train_epoch_history.json", "json_dump/resnet_valid_batch_history.json",
    "json_dump/resnet_valid_epoch_history.json", "log", "logs", "logs/train",
    "logs/train/batch", "logs/train/epoch", "logs/val", "logs/val/batch", "logs/val/epoch",
    "models", "models/resnet_gen_1.msgpack", "models/resnet_gen_2.msgpack",
    "models/resnet_gen_best.msgpack", "perf_logfile", "pics", "pics/test", "pics/train",
    "pics/train/resnet", "pics/train/resnet/00002_000.png", "pics/val", "pics/val/resnet",
    "pics/val/resnet/00002_000.png", "results_logfile"}


def log(phase, **result):
    print(json.dumps({"phase": phase, **result}), flush=True)


def start(phase):
    print(f"--- phase {phase}", flush=True)


def cuda_ms(fn, runs=TIMING_RUNS, warmup=3):
    """Median time of ``fn`` in ms over ``runs`` runs, each between two CUDA
    events, after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        fn()
        end.record()
        end.synchronize()
        times.append(begin.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, calls, replays=10):
    """Device time of one ``fn()`` in ms: ``calls`` calls captured in one
    CUDA graph and replayed between two CUDA events (median of
    ``replays``). A single call of a kernel that runs for tens of
    microseconds is timed by the host's launch path instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as CUDA graphs need
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, runs=replays, warmup=1) / calls


@contextlib.contextmanager
def plain_kernels():
    """Run the serving route with the kernels' plain versions in place of the
    kernels, on the same device."""
    from simplesr_tpu_torch.ops import tiling
    from simplesr_tpu_torch.ops.kernels import (extract_overlapping_patches_reference,
                                                residual_trunk_reference, trunk)

    saved = trunk.residual_trunk, tiling.extract_overlapping_patches
    trunk.residual_trunk = residual_trunk_reference  # what TrunkFunction's forward runs
    tiling.extract_overlapping_patches = extract_overlapping_patches_reference
    try:
        yield
    finally:
        trunk.residual_trunk, tiling.extract_overlapping_patches = saved


def trunk_float64(x, weights):
    """The plain trunk with float64 sums, so that each rounding to bf16 is of
    the exact value."""
    from simplesr_tpu_torch.ops.kernels.trunk import _oihw

    h = x.permute(0, 3, 1, 2)
    for blk in range(weights.weight.shape[0]):
        w1, w2 = (_oihw(weights.weight[blk, j]).double() for j in (0, 1))
        t = F.conv2d(h.double(), w1, weights.b1[blk].double(), padding=1)
        alpha = weights.alpha[blk].double().view(1, -1, 1, 1)
        y = torch.where(t >= 0, t, alpha * t).to(torch.bfloat16)
        t = F.conv2d(y.double(), w2, weights.b2[blk].double(), padding=1)
        h = (h.double() + t).to(torch.bfloat16)
    return h.permute(0, 2, 3, 1)


def float64_sums(model, x):
    """``model`` (on the CPU) on ``x`` with every bf16 conv summed in float64
    and rounded to bf16 where the model rounds."""
    from simplesr_tpu_torch.models import blocks

    def conv2d(h, weight, bias, dtype):
        y = F.conv2d(h.to(dtype).double(), weight.to(dtype).double(),
                     padding=weight.shape[-1] // 2).to(dtype)
        return y + bias.to(dtype).view(1, -1, 1, 1)

    saved, blocks.conv2d = blocks.conv2d, conv2d
    try:
        return model(x)
    finally:
        blocks.conv2d = saved


def rel_errors(got, ref):
    """max |diff| / max |ref| and ||diff|| / ||ref||, in float32."""
    got, ref = got.float(), ref.float()
    diff = got - ref
    return ((diff.abs().max() / ref.abs().max()).item(), (diff.norm() / ref.norm()).item(),
            diff.abs().max().item())


def stage_ms(model, lr_nhwc):
    """CUDA-event times of the forward's stages on one batch, each on the
    input the previous stage gives."""
    from simplesr_tpu_torch.models.srresnet import output_conv

    times = {}
    h = lr_nhwc.permute(0, 3, 1, 2).to(model.dtype)
    stages = [("head", lambda t: model.head_act(model.head(t))), ("trunk", model._trunk)]
    stages.append(("trunk_out+skip", lambda t: model.trunk_out(t) + skip))
    stages += [(f"upsample_{i}", block) for i, block in enumerate(model.upsample)]
    stages.append(("out_conv_f32+tanh", lambda t: torch.tanh(output_conv(t, model.out))))
    skip = None
    for name, fn in stages:
        times[name] = cuda_ms(lambda: fn(h), runs=10, warmup=2)
        h = fn(h)
        if name == "head":
            skip = h
    return times


def library_trunk_weights(model):
    """The trunk's parameters in bf16, channels_last, for ``library_trunk``."""
    bf = lambda t: t.detach().to(torch.bfloat16)
    return [(bf(b.conv1.conv.weight).contiguous(memory_format=torch.channels_last),
             bf(b.conv1.conv.bias), bf(b.act.alpha),
             bf(b.conv2.conv.weight).contiguous(memory_format=torch.channels_last),
             bf(b.conv2.conv.bias)) for b in model.blocks]


def library_trunk(x_nchw, params):
    """The trunk as one PyTorch library conv per conv: bf16 ``F.conv2d`` in
    channels_last (the yardstick; the port never calls it)."""
    h = x_nchw
    for w1, b1, alpha, w2, b2 in params:
        y = F.prelu(F.conv2d(h, w1, b1, padding=1), alpha)
        h = h + F.conv2d(y, w2, b2, padding=1)
    return h


KERNEL_KEYS = {"residual_trunk": "trunk", "extract_overlapping_patches": "patches"}


def counted(run):
    """Run ``run()`` with every kernel's launch count set to 0 just before;
    return its result and the counts just after."""
    from simplesr_tpu_torch.ops.kernels import WRAPPERS

    for wrapper in WRAPPERS:
        wrapper.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {KERNEL_KEYS[w.__name__]: w.launches for w in WRAPPERS}


def training_batches(gen, images, count):
    """``count`` batches of TRAIN_BATCH (LR, HR) pairs, made on the card: a
    random TRAIN_HR crop of each gallery image (uint8 HWC on the card), each
    flipped up-down and left-right at random and turned by 90 or 180 degrees
    at random; HR in [-1, 1], LR the port's antialiased bicubic to a quarter
    of the side, in [0, 1]."""
    from simplesr_tpu_torch.core.ranges import normalize_01, normalize_11
    from simplesr_tpu_torch.ops.augment import flip_along_x, flip_along_y, rotate90
    from simplesr_tpu_torch.ops.crop import random_crops
    from simplesr_tpu_torch.ops.resize import resize

    batches = []
    for _ in range(count):
        crops = []
        for i in range(TRAIN_BATCH):
            crop = random_crops(gen, images[i % len(images)], 1, (TRAIN_HR, TRAIN_HR))[0]
            flips = torch.randint(0, 2, (2,), generator=gen)
            crop = flip_along_x(crop) if flips[0] else crop
            crop = flip_along_y(crop) if flips[1] else crop
            crops.append(rotate90(gen, crop))
        hr = torch.stack(crops).float()
        lr = resize(normalize_01(hr), (TRAIN_HR // 4, TRAIN_HR // 4), method="bicubic",
                    antialias=True)
        batches.append((lr.contiguous(), normalize_11(hr).contiguous()))
    return batches


def events_ms(parts, runs):
    """Median ms of each of a sequence of steps, timed as consecutive CUDA
    events around each, over ``runs`` runs of the whole sequence."""
    times = {name: [] for name, _ in parts}
    for _ in range(runs):
        marks = [torch.cuda.Event(enable_timing=True)]
        marks[0].record()
        for _, fn in parts:
            fn()
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        marks[-1].synchronize()
        for (name, _), a, b in zip(parts, marks, marks[1:]):
            times[name].append(a.elapsed_time(b))
    return {name: statistics.median(t) for name, t in times.items()}


def profile_steps(step, steps=3, top=8):
    """A ``torch.profiler`` trace of ``steps`` calls of ``step``: the
    device's busy time per step (the sum of the kernels' self device time),
    the wall time per step, the idle share, and the kernels that took the
    most device time (ms per step)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # the kernels themselves (not the operators that launched them, which
    # would count the same device time twice)
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA") and device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in events) / 1e3 / steps
    events.sort(key=device_us, reverse=True)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
            "top_kernels_ms": [[e.key[:80], device_us(e) / 1e3 / steps, e.count // steps]
                               for e in events[:top]]}


def train_phase(dev, work, gen, launches_by_path, card):
    """Phase 7: the training path through SRModel (see the docstring)."""
    from simplesr_tpu_torch.data.png import read_png
    from simplesr_tpu_torch.ops.kernels import WRAPPERS, residual_trunk, residual_trunk_reference
    from simplesr_tpu_torch.ops.kernels.trunk import pack_trunk_weights
    from simplesr_tpu_torch.train import Generator, SRModel, load_model

    start("7 training: SRModel, production recipe at full width")
    print("reduced: paired_train: 2 of the recipe (TPU channel packing) is not ported; "
          "the batch runs unpacked", flush=True)
    images = [torch.from_numpy(read_png(p)).to(dev)
              for p in sorted((ROOT / "data/corpus/gallery").glob("*.png"))]
    batches = training_batches(gen, images, 2 * TRAIN_STEPS + 1)

    class Dirs:
        model_dir = str(work / "train" / "models")
        checkpoint_dir = str(work / "train" / "checkpoints")

    generator = Generator.srresnet(4, num_blocks=16, num_filters=64, batch_norm=False,
                                   dtype="bfloat16", seed=SEED, device=dev)
    model = SRModel("resnet", generator, "Adam", {"learning_rate": TRAIN_SCHEDULE},
                    config=Dirs, device=dev)
    module = generator.model()
    params = list(module.parameters())

    def grads(lr, hr):
        module.train()
        loss, _ = generator.calculate_loss(module(lr).float(), hr, None, None)
        return loss, torch.autograd.grad(loss, params)

    # check 1: gradients through the kernel's forward vs straight through the plain trunk
    lr, hr = batches[-1]
    (loss_k, grads_k), counts_fwd_bwd = counted(lambda: grads(lr, hr))
    module._trunk = lambda h: residual_trunk_reference(
        h.permute(0, 2, 3, 1), pack_trunk_weights(module._block_parameters())).permute(0, 3, 1, 2)
    try:
        loss_p, grads_p = grads(lr, hr)
    finally:
        del module._trunk
    names = [n for n, _ in module.named_parameters()]
    grad_fro = {n: ((a - b).norm() / b.norm()).item() for n, a, b in zip(names, grads_k, grads_p)}
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    worst = max(grad_fro, key=grad_fro.get)
    log(7, check="gradients, TrunkFunction vs plain trunk in autograd", loss_rel=loss_rel,
        loss_rel_tol=TRAIN_LOSS_REL_TOL, max_grad_fro_rel=grad_fro[worst], worst=worst,
        trunk_grad_fro_rel_max=max(v for n, v in grad_fro.items() if n.startswith("blocks")),
        grad_fro_tol=TRAIN_GRAD_FRO_TOL, launches_forward_and_backward=counts_fwd_bwd)
    if not (loss_rel < TRAIN_LOSS_REL_TOL and grad_fro[worst] < TRAIN_GRAD_FRO_TOL):
        raise AssertionError(f"gradients through the trunk kernel disagree: loss {loss_rel}, "
                             f"{worst} {grad_fro[worst]}")
    if counts_fwd_bwd["trunk"] != 1:
        raise AssertionError(f"one forward and backward launched {counts_fwd_bwd}")

    # check 2 and 3: 30 steps through the lifecycle, one launch per step
    def train():
        model.before_epoch()
        per_step = []
        for lr, hr in batches[:TRAIN_STEPS]:
            before = residual_trunk.launches
            model.train_step(lr, hr)
            per_step.append(residual_trunk.launches - before)
            model.after_train_batch()
        return per_step

    per_step, train_counts = counted(train)
    launches_by_path["sr_model_train_step_x30"] = train_counts
    _, valid_counts = counted(lambda: (model.validation_step(*batches[-1]),
                                       model.after_validation_batch()))
    launches_by_path["sr_model_validation_step"] = valid_counts
    losses = [float(v) for v in model.histories()["train_batch"]["generator_loss"]]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    log(7, check="30 train steps", losses=losses, first5=first, last5=last,
        launches_per_step=sorted(set(per_step)), train_launches=train_counts,
        validation_launches=valid_counts, optimizer_count=model.optimizer.count)
    if not all(np.isfinite(losses)) or not last < first:
        raise AssertionError(f"training did not bring the loss down: {first} -> {last}")
    if per_step != [1] * TRAIN_STEPS or train_counts != {"trunk": TRAIN_STEPS, "patches": 0}:
        raise AssertionError(f"train_step launches {per_step}, {train_counts}")
    if valid_counts != {"trunk": 1, "patches": 0}:
        raise AssertionError(f"validation_step launches {valid_counts}")

    # check 4: generate vs the saved model file, bit for bit
    model.after_epoch()
    model.after_training()
    best = Path(Dirs.model_dir) / "resnet_gen_best.msgpack"
    x = batches[-1][0][:4]
    got = model.generate(x)
    with torch.inference_mode():
        ref = load_model(best, device=dev)(x)
    if not torch.equal(got, ref):
        raise AssertionError(f"generate vs the saved file: {(got - ref).abs().max().item()}")

    # check 5: the flagship with grad enabled equals inference_mode
    flagship = load_model(FLAGSHIP, device=dev)
    x = torch.rand((2, 40, 48, 3), generator=gen).to(dev)
    with_grad, grad_counts = counted(lambda: flagship(x))
    with torch.inference_mode():
        no_grad = flagship(x)
    if not (with_grad.requires_grad and torch.equal(with_grad.detach(), no_grad)
            and grad_counts["trunk"] == 1):
        raise AssertionError(f"flagship with grad enabled vs inference_mode: {grad_counts}")

    # check 6: a 128-wide model on CUDA runs its ResBlocks and matches the CPU
    wide_cpu = Generator.srresnet(4, num_blocks=16, num_filters=WIDE_FILTERS, batch_norm=False,
                                  dtype="bfloat16", seed=SEED, device="cpu").model()
    with torch.no_grad():
        for block in wide_cpu.blocks:
            block.act.alpha.uniform_(0.0, 0.3, generator=gen)
    wide_gpu = copy.deepcopy(wide_cpu).to(dev)
    x = torch.rand((1, 32, 32, 3), generator=gen)
    with torch.inference_mode():
        wide_out, wide_counts = counted(lambda: wide_gpu(x.to(dev)))
        wide_out, wide_ref = wide_out.cpu(), wide_cpu(x)
        exact = float64_sums(wide_cpu, x)
    wide = {"max_abs": (wide_out - wide_ref).abs().max().item(),
            "mean_abs": (wide_out - wide_ref).abs().mean().item(),
            "cuda_vs_float64_mean_abs": (wide_out - exact).abs().mean().item(),
            "cpu_vs_float64_mean_abs": (wide_ref - exact).abs().mean().item(),
            "launches": wide_counts}
    log(7, check="faults", generate_vs_saved_file_bit_equal=True,
        flagship_grad_vs_inference_mode_bit_equal=True, wide_128_cuda_vs_cpu=wide,
        tol_max_abs=ROUTE_MAX_ABS_TOL, mean_vs_float64_ratio_tol=WIDE_MEAN_RATIO)
    if not (wide["max_abs"] < ROUTE_MAX_ABS_TOL
            and wide["cuda_vs_float64_mean_abs"]
            <= WIDE_MEAN_RATIO * wide["cpu_vs_float64_mean_abs"]
            and wide_counts == {"trunk": 0, "patches": 0}):
        raise AssertionError(f"128-wide model on CUDA vs CPU: {wide}")

    # timings, printed and not gated
    timed = batches[TRAIN_STEPS:2 * TRAIN_STEPS]

    def step_times(label):
        it = iter(timed * 2)  # 3 warm-up steps and TRAIN_STEPS timed ones
        for _ in range(3):
            model.train_step(*next(it))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: model.train_step(*next(it)), runs=TRAIN_STEPS, warmup=0)
        return {f"{label}_step_ms": ms, f"{label}_hr_mpix_per_s":
                TRAIN_BATCH * TRAIN_HR ** 2 / 1e6 / (ms / 1e3),
                f"{label}_peak_mem_bytes": torch.cuda.max_memory_allocated()}

    result = step_times("trunk_function")
    state = {}  # the loss and gradients handed from one timed part to the next

    def forward():
        module.train()
        lr, hr = timed[0]
        state["loss"], _ = generator.calculate_loss(module(lr).float(), hr, None, None)

    def backward():
        before = residual_trunk.launches
        state["grads"] = torch.autograd.grad(state["loss"], params)
        state["backward_launches"] = residual_trunk.launches - before

    parts = events_ms([("forward", forward), ("backward", backward),
                       ("optimizer", lambda: model.optimizer.apply(params, state["grads"]))],
                      runs=10)
    if state["backward_launches"] != 0:
        raise AssertionError(f"the backward launched {state['backward_launches']} trunks")
    module.uses_trunk_kernel = False  # its ResBlocks: cuDNN bf16 convs, activations stored
    try:
        result.update(step_times("plain_autograd"))
    finally:
        module.uses_trunk_kernel = True
    log(7, **result, trunk_function_parts_ms=parts, backward_trunk_launches=0,
        batch=[TRAIN_BATCH, TRAIN_HR, TRAIN_HR, 3], runs=TRAIN_STEPS, card=card)

    def profile():
        """The profiler, run after every timing of the script: its hooks
        slow the launches that follow it."""
        traces = {}
        for label, kernel in (("trunk_function", True), ("plain_autograd", False)):
            module.uses_trunk_kernel = kernel
            try:
                it = iter(timed)
                traces[label] = profile_steps(lambda: model.train_step(*next(it)))
            finally:
                module.uses_trunk_kernel = True
        log(7, profiler_3_steps=traces, card=card)

    return profile


@contextlib.contextmanager
def patched(owner, name, make):
    """``owner.name`` replaced by ``make(original)`` inside the block."""
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def run_tree(root):
    """A run's relative paths, as JAX_RUN_TREE lists them."""
    out = set()
    for dirpath, _, filenames in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if rel.startswith("checkpoints" + os.sep):
            continue
        out.add(rel)
        if not rel.startswith("logs"):
            out.update(os.path.normpath(os.path.join(rel, f)) for f in filenames)
    return out


def yaml_phase(dev, work, launches_by_path, card):
    """Phase 8: training from a YAML file (see the docstring)."""
    import simplesr_tpu_torch.train as train_pkg
    from simplesr_tpu_torch.config import _yaml
    from simplesr_tpu_torch.data import DataPipeline
    from simplesr_tpu_torch.data.png import read_rgb_u8
    from simplesr_tpu_torch.ops.kernels import residual_trunk
    from simplesr_tpu_torch.tools import train as train_tool
    from simplesr_tpu_torch.train import SRModel, load_model

    start("8 training from a YAML file: the production recipe")
    t_phase = time.perf_counter()
    spec = _yaml.load(RECIPE)
    gallery = ROOT / "data/corpus/gallery"
    reduced = {"train_data_paths": f"{spec['general']['train_data_paths']} -> {gallery} "
                                   "(16 PNGs; the recipe's DIV2K is not in the repo)",
               "results_save_path": "a temporary directory",
               "num_epochs": f"{spec['general']['num_epochs']} -> {YAML_EPOCHS}",
               "random_seed": "unset -> 0",
               "paired_train": f"{spec['general'].pop('paired_train')} -> removed (the TPU's "
                               "packed layout is not ported; it is exact, so the loss and "
                               "gradients are those of the unpaired layout)"}
    spec["general"].update(train_data_paths=str(gallery), num_epochs=YAML_EPOCHS,
                           random_seed=0, results_save_path=str(work / "yaml_run"))
    kept = {k: spec["general"][k] for k in ("batch_size", "crop_size", "num_crops",
                                            "augmentations", "train_val_split", "scale")}
    log(8, recipe=str(RECIPE.relative_to(ROOT)), reduced=reduced, kept=kept,
        generator=spec["model"]["generator"], optimizer=spec["model"]["generator_optimizer"],
        optimizer_config=spec["model"]["generator_optimizer_config"])

    def write(name, **general):
        path = work / name
        run = copy.deepcopy(spec)
        run["general"].update(general)
        path.write_text(_yaml.dump(run))
        return path

    calls = {"train_step": 0, "validation_step": 0, "generate": 0}
    seen = {}  # the run's objects and timings, filled by the wrappers
    epochs = []  # (start, end) of each epoch on the host clock
    waits = []  # (start, seconds) of each call into the pipeline's generators

    def counting(name):
        def make(original):
            def wrapper(self, *a, **k):
                calls[name] += 1
                return original(self, *a, **k)
            return wrapper
        return make

    def timed_generator(original):
        def wrapper(self, *a, **k):
            it = iter(original(self, *a, **k))

            def gen():
                while True:
                    t = time.perf_counter()
                    try:
                        item = next(it)
                    except StopIteration:
                        waits.append((t, time.perf_counter() - t))
                        return
                    waits.append((t, time.perf_counter() - t))
                    yield item
            return gen()
        return wrapper

    def capture_run(original):
        def wrapper(conf, pipeline, sr_model, **k):
            seen.update(conf=conf, pipeline=pipeline, model=sr_model)
            return original(conf, pipeline, sr_model, **k)
        return wrapper

    def epoch_clock(which):
        def make(original):
            def wrapper(self, *a, **k):
                if which == "before":
                    epochs.append([time.perf_counter(), None])
                    return original(self, *a, **k)
                torch.cuda.synchronize()
                epochs[-1][1] = time.perf_counter()
                return original(self, *a, **k)
            return wrapper
        return make

    def resume_capture(original):
        def wrapper(self):
            seen["resumed_at"] = original(self)
            seen["resumed_histories"] = copy.deepcopy(self.histories()["train_epoch"])
            seen["resumed_early_stop"] = self._early_stopping_util.state_dict()
            return seen["resumed_at"]
        return wrapper

    instruments = [(SRModel, "train_step", counting("train_step")),
                   (SRModel, "validation_step", counting("validation_step")),
                   (SRModel, "generate", counting("generate")),
                   (SRModel, "before_epoch", epoch_clock("before")),
                   (SRModel, "after_epoch", epoch_clock("after")),
                   (SRModel, "resume_training", resume_capture),
                   (DataPipeline, "train_batch_generator", timed_generator),
                   (DataPipeline, "validation_batch_generator", timed_generator),
                   (train_pkg, "run_training", capture_run)]

    def instrumented(run):
        with contextlib.ExitStack() as stack:
            for owner, name, make in instruments:
                stack.enter_context(patched(owner, name, make))
            return run()

    t = time.perf_counter()
    decoded = [read_rgb_u8(p) for p in sorted(gallery.glob("*.png"))]
    decode_s = time.perf_counter() - t

    # the run
    first_yaml = write("run.yaml")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    code, launches = counted(lambda: instrumented(lambda: train_tool.main([str(first_yaml)])))
    run_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    launches_by_path["run_training_yaml_x2_epochs"] = launches
    conf, pipeline, model = seen["conf"], seen["pipeline"], seen["model"]
    first_calls, first_epochs, first_waits = dict(calls), list(epochs), list(waits)
    n_train = len(pipeline.train_imgs)
    per_epoch = -(-n_train * conf.num_crops * (1 + len(conf.augmentations)) // conf.batch_size)
    val_per_epoch = -(-len(pipeline.val_imgs) * conf.num_crops // conf.batch_size)
    # generate: test_and_plot of one train and one validation batch after
    # epoch 2, and the final evaluation's validation batches
    expected = {"train_step": YAML_EPOCHS * per_epoch,
                "validation_step": YAML_EPOCHS * val_per_epoch, "generate": 2 + val_per_epoch}
    tree = run_tree(conf.save_path)
    histories = model.histories()
    values = [float(v) for h in histories.values() for vs in h.values() for v in vs]
    epoch_loss = histories["train_epoch"]["generator_loss"]
    epoch_s = [b - a for a, b in first_epochs]
    steps_per_s = [per_epoch / s for s in epoch_s]
    epoch_wait_s = [sum(d for t, d in first_waits if a <= t < b) for a, b in first_epochs]
    result = {"exit": code, "launches": launches, "calls": first_calls, "expected": expected,
              "split": [n_train, len(pipeline.val_imgs)], "epoch_loss": epoch_loss,
              "run_s": run_s, "epoch_s": epoch_s, "train_steps_per_s": steps_per_s,
              "hr_mpix_per_s_end_to_end": [conf.batch_size * conf.crop_size[0]
                                           * conf.crop_size[1] * per_epoch / 1e6 / s
                                           for s in epoch_s],
              "pipeline_wait_share": sum(epoch_wait_s) / sum(epoch_s),
              "pipeline_wait_share_per_epoch": [w / s for w, s in zip(epoch_wait_s, epoch_s)],
              "decode_16_pngs_s": decode_s, "decoded_mpix": sum(d.size for d in decoded) / 3e6,
              "peak_mem_bytes": peak, "save_dir_tree_as_jax": tree == JAX_RUN_TREE}
    log(8, check="the run", **result, card=card)
    if code != 0:
        raise AssertionError(f"tools.train.main returned {code}")
    if tree != JAX_RUN_TREE:
        raise AssertionError(f"save-dir tree differs from the JAX package's: "
                             f"{sorted(tree ^ JAX_RUN_TREE)}")
    if not (all(np.isfinite(values)) and len(epoch_loss) == YAML_EPOCHS
            and epoch_loss[1] < epoch_loss[0]):
        raise AssertionError(f"histories: finite {all(np.isfinite(values))}, "
                             f"epoch losses {epoch_loss}")
    if first_calls != expected or launches["trunk"] != sum(expected.values()) \
            or launches["patches"] != 0:
        raise AssertionError(f"launches {launches} for calls {first_calls}, "
                             f"expected calls {expected}")

    # the _best file against the module that trained it
    crop = torch.from_numpy(decoded[2][:48, :64].astype(np.float32) / 255.0)[None].to(dev)
    best = Path(conf.model_dir) / "resnet_gen_best.msgpack"
    got = model.generate(crop)
    with torch.inference_mode():
        ref = load_model(best, device=dev)(crop)
    if not torch.equal(got, ref):
        raise AssertionError(f"_best file vs generate: {(got - ref).abs().max().item()}")

    # resume with a third epoch
    saved_history = copy.deepcopy(histories["train_epoch"])
    saved_early = model._early_stopping_util.state_dict()
    for key in calls:
        calls[key] = 0
    epochs.clear()
    resume_yaml = write("resume.yaml", num_epochs=YAML_EPOCHS + 1)
    code = instrumented(lambda: train_tool.main([str(resume_yaml), "--resume"]))
    resumed = seen["model"]
    log(8, check="--resume with 3 epochs", exit=code, resumed_at=seen["resumed_at"],
        epochs_run=len(epochs), calls=dict(calls),
        histories_as_first_run=seen["resumed_histories"] == saved_history,
        early_stop=seen["resumed_early_stop"], same_dir=seen["conf"].save_path == conf.save_path)
    if not (code == 0 and seen["resumed_at"] == YAML_EPOCHS and len(epochs) == 1
            and calls["train_step"] == per_epoch and seen["conf"].save_path == conf.save_path
            and seen["resumed_histories"] == saved_history
            and seen["resumed_early_stop"] == saved_early
            and len(resumed.histories()["train_epoch"]["generator_loss"]) == YAML_EPOCHS + 1):
        raise AssertionError("resume did not continue the run at its third epoch")

    # preemption: SIGTERM after 10 steps of the first epoch
    steps = [0]

    def preempting(original):
        def wrapper(self, *a, **k):
            out = original(self, *a, **k)
            steps[0] += 1
            if steps[0] == PREEMPT_AFTER_STEPS:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return wrapper

    preempt_yaml = write("preempt.yaml", results_save_path=str(work / "yaml_preempt"))
    handler = signal.getsignal(signal.SIGTERM)
    with patched(SRModel, "train_step", preempting):
        code = instrumented(lambda: train_tool.main([str(preempt_yaml)]))
    ckpt = Path(seen["conf"].checkpoint_dir)
    meta = json.loads((ckpt / "resnet_resume_meta.json").read_text())
    point = sorted(p.name for p in (ckpt / "resnet_resume").glob("step_*.pt"))
    log(8, check="SIGTERM after 10 steps", exit=code, steps=steps[0], resume_point=point,
        completed_epochs=meta["completed_epochs"],
        handler_restored=signal.getsignal(signal.SIGTERM) == handler)
    if not (code == EXIT_PREEMPTED and point == [f"step_{PREEMPT_AFTER_STEPS}.pt"]
            and meta["completed_epochs"] == 0 and signal.getsignal(signal.SIGTERM) == handler):
        raise AssertionError("a preempted run did not exit 75 with a resume point")

    # the pipeline on the card against the CPU
    def fresh_pipeline(device):
        """A new pipeline of the run's config, given the run's decoded PNGs
        (the decode is timed above; a second one would only cost time)."""
        fresh = DataPipeline.from_config(conf, device=device)
        fresh._decode_cache.update(pipeline._decode_cache)
        return fresh

    batches = {}
    for label, device in (("cpu", "cpu"), ("card", dev)):
        it = fresh_pipeline(device).train_batch_generator()
        batches[label] = [next(it) for _ in range(3)]
        it.close()
    pairs = list(zip(batches["card"], batches["cpu"]))
    hr_equal = all(torch.equal(g[1].cpu(), c[1]) for g, c in pairs)
    lr_err = max((g[0].cpu() - c[0]).abs().max().item() for g, c in pairs)
    log(8, check="pipeline on the card vs the CPU, 3 batches", hr_bit_equal=hr_equal,
        lr_max_abs=lr_err, tol=PIPELINE_LR_TOL)
    if not (hr_equal and lr_err < PIPELINE_LR_TOL):
        raise AssertionError(f"pipeline on the card vs the CPU: HR equal {hr_equal}, "
                             f"LR {lr_err}")

    # the epoch's parts: the pipeline alone (its decode cache warm) and the
    # bare steps on its batches, each over one epoch of 60 batches
    torch.cuda.synchronize()
    t = time.perf_counter()
    loop_batches = list(pipeline.train_batch_generator())
    torch.cuda.synchronize()
    pipeline_alone_s = time.perf_counter() - t
    t = time.perf_counter()
    for lr, hr in loop_batches:
        resumed.train_step(lr, hr)
    torch.cuda.synchronize()
    steps_alone_s = time.perf_counter() - t
    log(8, check="one epoch's parts", phase_s=time.perf_counter() - t_phase,
        batches=len(loop_batches),
        pipeline_alone_s=pipeline_alone_s, pipeline_ms_per_batch=pipeline_alone_s * 1e3
        / len(loop_batches), train_steps_alone_s=steps_alone_s,
        train_step_ms=steps_alone_s * 1e3 / len(loop_batches), card=card)

    def profile():
        """The profiler on 10 steps of the loop (pipeline included), run
        after every timing of the script."""
        it = fresh_pipeline(dev).train_batch_generator()
        trace = profile_steps(lambda: resumed.train_step(*next(it)), steps=10)
        it.close()
        log(8, profiler_10_steps_of_the_loop=trace, card=card)

    return profile


def main(work):
    from simplesr_tpu_torch.data.png import read_img, read_png, write_png
    from simplesr_tpu_torch.eval.evaluation import (_TILE_BATCH, _TILE_OVERLAP, _TILE_PATCH,
                                                    _as_predictor, _upscale)
    from simplesr_tpu_torch.ops.kernels import (_build, extract_overlapping_patches,
                                                extract_overlapping_patches_reference,
                                                residual_trunk, residual_trunk_reference)
    from simplesr_tpu_torch.ops.kernels.trunk import (TrunkWeights, pack_trunk_weights,
                                                      swizzle_trunk_weights)
    from simplesr_tpu_torch.ops.tiling import _pad_amounts
    from simplesr_tpu_torch.tools.serve import SREngine
    from simplesr_tpu_torch.tools.upscale import upscale_files
    from simplesr_tpu_torch.train.serialization import load_model

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    t_all = time.perf_counter()

    start("0 device")
    card_name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = [f"{card_name}, power limit not read ({type(e).__name__})"]
    smi_line = smi[0] if smi else f"{card_name}, power limit not read (nvidia-smi gave nothing)"
    print(smi_line, flush=True)
    log(0, device=card_name, count=torch.cuda.device_count(), nvidia_smi=smi_line,
        torch=torch.__version__, cuda=torch.version.cuda,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    start("1 build")
    t = time.perf_counter()
    built = not _build.library_path().exists()
    _build.library()
    log(1, build_s=round(time.perf_counter() - t, 2), built_now=built,
        library=_build.library_path().name)

    start("2 trunk kernel vs plain")
    model = load_model(FLAGSHIP, device=dev)
    weights = model.trunk_weights()
    lr_batch = torch.rand(TRUNK_SHAPE + (3,), generator=gen).to(dev)
    with torch.inference_mode():
        h = lr_batch.permute(0, 3, 1, 2).to(torch.bfloat16)
        trunk_in = model.head_act(model.head(h)).permute(0, 2, 3, 1).contiguous()
        block_rel, trunk_err, block_in = [], 0.0, trunk_in
        for blk in range(len(model.blocks)):
            one = TrunkWeights(*(t[blk:blk + 1] for t in weights))
            got = residual_trunk(block_in, one)
            torch.cuda.synchronize()
            block_in = residual_trunk_reference(block_in, one)
            rel, _, err = rel_errors(got, block_in)
            block_rel.append(rel)
            trunk_err = max(trunk_err, err)
        chain = residual_trunk(trunk_in, weights)
        torch.cuda.synchronize()
        exact = trunk_float64(trunk_in, weights)
        chain_vs_plain = rel_errors(chain, block_in)
        chain_vs_exact = rel_errors(chain, exact)
        plain_vs_exact = rel_errors(block_in, exact)
    log(2, shape=list(trunk_in.shape), blocks=len(model.blocks),
        per_block_max_rel=max(block_rel), per_block_max_abs=trunk_err, tol=TRUNK_REL_TOL,
        chain_max_rel_fro_rel={"kernel_vs_plain": chain_vs_plain[:2],
                               "kernel_vs_float64": chain_vs_exact[:2],
                               "plain_vs_float64": plain_vs_exact[:2]},
        chain_fro_ratio_tol=TRUNK_CHAIN_FRO_RATIO)
    if not max(block_rel) < TRUNK_REL_TOL:
        raise AssertionError(f"trunk kernel disagrees with its plain version: {block_rel}")
    if not chain_vs_exact[1] <= TRUNK_CHAIN_FRO_RATIO * plain_vs_exact[1]:
        raise AssertionError(f"trunk kernel chain less accurate than the plain version: "
                             f"{chain_vs_exact} vs {plain_vs_exact}")
    for shape in TRUNK_EDGE_SHAPES:
        edge_rel = []
        with torch.inference_mode():
            lr = torch.rand(shape + (3,), generator=gen).to(dev)
            x = model.head_act(model.head(lr.permute(0, 3, 1, 2).to(torch.bfloat16)))
            x = x.permute(0, 2, 3, 1).contiguous()
            for blk in range(len(model.blocks)):
                one = TrunkWeights(*(t[blk:blk + 1] for t in weights))
                got = residual_trunk(x, one)
                torch.cuda.synchronize()
                x = residual_trunk_reference(x, one)
                edge_rel.append(rel_errors(got, x)[0])
        log(2, shape=list(shape) + [trunk_in.shape[-1]], blocks=len(model.blocks),
            per_block_max_rel=max(edge_rel), tol=TRUNK_REL_TOL)
        if not max(edge_rel) < TRUNK_REL_TOL:
            raise AssertionError(f"trunk kernel disagrees with its plain version at {shape}: "
                                 f"{edge_rel}")

    start("3 patch kernel vs plain")
    # A 1100 x 1040 LR PNG from a gallery picture, resized and with seeded
    # noise; the main path reads it back as upscale_files does.
    tiled_img = F.interpolate(
        torch.from_numpy(read_png(ROOT / "data/corpus/gallery/gt_1.png")).permute(2, 0, 1)
        [None].float(), size=TILED_HW, mode="bilinear", align_corners=False)[0]
    tiled_img = (tiled_img.permute(1, 2, 0)
                 + 5.0 * torch.randn(tiled_img.shape[1:] + (3,), generator=gen)).clamp(0, 255)
    tiled_png = work / "tiled_lr.png"
    write_png(tiled_png, tiled_img.to(torch.uint8).numpy())
    tiled_lr = torch.from_numpy(read_img(tiled_png) / 255.0).to(dev)
    patch_err = 0.0
    unaligned = torch.rand((517, 389, 3), generator=gen).to(dev)
    for img, p, o in ((tiled_lr, _TILE_PATCH, _TILE_OVERLAP), (unaligned, 50, 8)):
        h_, w_, c_ = img.shape
        (top, bottom), (left, right) = _pad_amounts(h_, w_, p, p, o)
        padded = F.pad(img, (0, 0, left, right, top, bottom))
        if img is tiled_lr:
            padded_main = padded
        got = extract_overlapping_patches(padded, p, p, o)
        torch.cuda.synchronize()
        ref = extract_overlapping_patches_reference(padded, p, p, o)
        if got.shape != ref.shape or not torch.equal(got, ref):
            raise AssertionError(f"patch kernel is not bit-exact at {(h_, w_, c_)}, {p}/{o}")
        patch_err = max(patch_err, (got - ref).abs().max().item())
        if img is tiled_lr:
            n_tiles = got.shape[0]
        log(3, image=[h_, w_, c_], patch=p, overlap=o, patches=list(got.shape),
            bit_exact=True)

    start("4 main path: upscale_files, untiled gallery PNG and tiled LR PNG")
    launches_by_path = {}
    out_dir = work / "out"
    for label, png in (("upscale_files_untiled", GALLERY_PNG),
                       ("upscale_files_tiled", tiled_png)):
        t = time.perf_counter()
        (written,), launches = counted(lambda: upscale_files(FLAGSHIP, [png], out_dir, 4,
                                                             device=dev))
        launches_by_path[label] = launches
        log(4, path=label, launches=launches, seconds=round(time.perf_counter() - t, 3),
            written=Path(written).name)
    tiled_batches = -(-n_tiles // _TILE_BATCH)
    expected = {"upscale_files_untiled": {"trunk": 1, "patches": 0},
                "upscale_files_tiled": {"trunk": tiled_batches, "patches": 1}}
    for label, want in expected.items():
        if launches_by_path[label] != want:
            raise AssertionError(f"{label}: kernel launches {launches_by_path[label]}, "
                                 f"expected {want}")

    predict = _as_predictor(FLAGSHIP, device=dev)
    gallery_lr = torch.from_numpy(read_img(GALLERY_PNG) / 255.0).to(dev)
    sr_gallery = _upscale(predict, gallery_lr[None], 4)
    sr_tiled = _upscale(predict, tiled_lr[None], 4)
    h_g, w_g = gallery_lr.shape[:2]
    checks = [("gallery", sr_gallery, (1, 4 * h_g, 4 * w_g, 3), GALLERY_PNG),
              ("tiled", sr_tiled, (1, 4 * TILED_HW[0], 4 * TILED_HW[1], 3), tiled_png)]
    png_levels = {}
    for label, sr, shape, src in checks:
        if tuple(sr.shape) != shape or not torch.isfinite(sr).all() or sr.abs().max() > 1:
            raise AssertionError(f"{label}: bad output {tuple(sr.shape)} "
                                 f"max |x| {sr.abs().max().item()}")
        png = torch.from_numpy(read_png(out_dir / f"{src.stem}_x4.png")).int()
        u8 = ((sr[0] + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).int().cpu()
        if png.shape != u8.shape:
            raise AssertionError(f"{label}: written PNG has shape {tuple(png.shape)}")
        png_levels[label] = (png - u8).abs().max().item()
        if png_levels[label] > PNG_MAX_LEVELS:
            raise AssertionError(f"{label}: written PNG differs from the route's output by "
                                 f"{png_levels[label]} levels")
    with plain_kernels():
        plain_gallery = _upscale(predict, gallery_lr[None], 4)
        plain_tiled = _upscale(predict, tiled_lr[None], 4)
    route = {}
    for label, sr, plain in (("gallery", sr_gallery, plain_gallery),
                             ("tiled", sr_tiled, plain_tiled)):
        diff = (sr - plain).abs()
        route[label] = {"max_abs": diff.max().item(), "mean_abs": diff.mean().item()}
        if not (route[label]["max_abs"] < ROUTE_MAX_ABS_TOL
                and route[label]["mean_abs"] < ROUTE_MEAN_ABS_TOL):
            raise AssertionError(f"{label} route: kernels vs plain versions {route[label]}")
    small = gallery_lr[:32, :40][None]
    cpu_predict = _as_predictor(FLAGSHIP, device="cpu")
    cpu_diff = (predict(small).cpu() - cpu_predict(small.cpu())).abs().max().item()
    if not cpu_diff < ROUTE_MAX_ABS_TOL:
        raise AssertionError(f"GPU vs CPU path on a 32x40 input: {cpu_diff}")
    log(4, gallery_out=list(sr_gallery.shape), tiled_out=list(sr_tiled.shape),
        png_vs_route_max_levels=png_levels, kernels_vs_plain=route,
        gpu_vs_cpu_small_max_abs=cpu_diff, tol_max_abs=ROUTE_MAX_ABS_TOL,
        tol_mean_abs=ROUTE_MEAN_ABS_TOL)

    start("5 SREngine")
    crop = gallery_lr[:CROP_HW[0], :CROP_HW[1]].contiguous()
    one_shot = {tuple(gallery_lr.shape): sr_gallery[0], tuple(crop.shape): predict(crop[None])[0]}
    engine = SREngine(FLAGSHIP, 4, max_batch=4, max_wait_ms=50, device=dev)
    requests = [gallery_lr, crop, gallery_lr, crop]
    results = [None] * len(requests)
    errors = []

    def send(i):
        try:
            results[i] = engine.upscale(requests[i].cpu().numpy(), timeout=120)
        except Exception as e:  # reported below
            errors.append(repr(e))

    def serve():
        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(requests))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=150)
        if errors or any(th.is_alive() for th in threads):
            raise AssertionError(f"engine requests failed: {errors}")
        return engine.upscale_u8((crop.cpu().numpy() * 255).astype(np.uint8), timeout=120)

    try:
        u8, launches = counted(serve)
    finally:
        closed = engine.close()
    launches_by_path["sr_engine"] = launches
    engine_err = max((torch.from_numpy(r).to(dev) - one_shot[tuple(q.shape)]).abs().max().item()
                     for r, q in zip(results, requests))
    log(5, requests=[list(r.shape) for r in results], u8=[list(u8.shape), str(u8.dtype)],
        launches=launches, max_abs_vs_one_shot=engine_err, tol=ENGINE_MAX_ABS_TOL,
        closed=closed)
    # Two request shapes and the uint8 request need three batches at least.
    if launches["trunk"] < 3 or launches["patches"] != 0:
        raise AssertionError(f"sr_engine: kernel launches {launches}")
    if not engine_err < ENGINE_MAX_ABS_TOL or u8.dtype != np.uint8:
        raise AssertionError("engine results disagree with the one-shot path")

    start("6 timings")
    with torch.inference_mode():
        x_cl = trunk_in.permute(0, 3, 1, 2)  # channels_last NCHW view
        lib_params = library_trunk_weights(model)
        p, o = _TILE_PATCH, _TILE_OVERLAP
        win = p + 2 * o
        gh, gw = (padded_main.shape[0] - 2 * o) // p, (padded_main.shape[1] - 2 * o) // p
        rows = torch.arange(gh, device=dev)[:, None] * p + torch.arange(win, device=dev)
        cols = torch.arange(gw, device=dev)[:, None] * p + torch.arange(win, device=dev)
        rr, cc = rows[:, None, :, None], cols[None, :, None, :]
        # name: (one call, calls per CUDA graph)
        timed = {
            "trunk": (lambda: residual_trunk(trunk_in, weights), 5),
            "trunk_plain": (lambda: residual_trunk_reference(trunk_in, weights), 3),
            "trunk_library": (lambda: library_trunk(x_cl, lib_params), 5),
            "patches": (lambda: extract_overlapping_patches(padded_main, p, p, o), 50),
            "patches_plain": (
                lambda: extract_overlapping_patches_reference(padded_main, p, p, o), 20),
            "patches_library": (lambda: padded_main[rr, cc], 20),
        }
        call_ms = {name: cuda_ms(fn) for name, (fn, _) in timed.items()}
        device_ms = {name: graph_ms(fn, calls) for name, (fn, calls) in timed.items()}
        tiled_ms = cuda_ms(lambda: _upscale(predict, tiled_lr[None], 4), runs=20, warmup=2)
        stages = stage_ms(model, lr_batch)
        # the model's trunk (TrunkFunction under inference_mode: its packed
        # weights kept while the parameters stay as they are, then the
        # kernel), and packing and swizzling the weights alone
        for key, fn, calls in (
                ("trunk_model_path", lambda: model._trunk(x_cl), 5),
                ("trunk_packing", lambda: swizzle_trunk_weights(
                    pack_trunk_weights(model._block_parameters()).weight), 20)):
            call_ms[key], device_ms[key] = cuda_ms(fn), graph_ms(fn, calls)
    b, hh, ww, c = trunk_in.shape
    nb = len(model.blocks)
    trunk_flops = 2 * b * hh * ww * 9 * c * c * 2 * nb
    trunk_bytes = 2 * trunk_in.numel() * 2 + sum(t.numel() * t.element_size() for t in weights)
    patch_bytes = padded_main.numel() * 4 + gh * gw * win * win * 3 * 4
    trunk_bound = max(trunk_flops / PEAK_BF16_FLOPS, trunk_bytes / PEAK_BYTES_PER_S) * 1e3
    patch_bound = patch_bytes / PEAK_BYTES_PER_S * 1e3
    mpix = 16 * TILED_HW[0] * TILED_HW[1] / 1e6
    trunk_ms, patch_ms = call_ms["trunk"], call_ms["patches"]
    log(6, trunk_ms=trunk_ms, trunk_tflops=trunk_flops / trunk_ms / 1e9,
        trunk_bound_share=trunk_bound / trunk_ms, trunk_library_ms=call_ms["trunk_library"],
        patches_ms=patch_ms, patches_gb_s=patch_bytes / patch_ms / 1e6,
        patches_bound_share=patch_bound / patch_ms,
        patches_library_ms=call_ms["patches_library"], device_ms=device_ms,
        trunk_device_tflops=trunk_flops / device_ms["trunk"] / 1e9,
        patches_device_gb_s=patch_bytes / device_ms["patches"] / 1e6,
        trunk_model_path_ms=call_ms["trunk_model_path"],
        trunk_packing_ms=call_ms["trunk_packing"],
        tiled_upscale_ms=tiled_ms, tiled_output_mpix_per_s=mpix / (tiled_ms / 1e3),
        forward_stage_ms_one_tiled_batch=stages, runs=TIMING_RUNS, card=smi_line)

    profile_training = train_phase(dev, work, gen, launches_by_path, smi_line)
    profile_yaml_run = yaml_phase(dev, work, launches_by_path, smi_line)
    # the profilers of phases 7 and 8 last, after every timing
    profile_training()
    profile_yaml_run()

    def total(key):
        return sum(counts[key] for counts in launches_by_path.values())

    def by_path(key):
        return {label: counts[key] for label, counts in launches_by_path.items()}

    def times(key):
        """One call from Python (ms), and device time over a CUDA graph."""
        return {"ms": call_ms[key], "plain_ms": call_ms[f"{key}_plain"],
                "library_ms": call_ms[f"{key}_library"], "device_ms": device_ms[key],
                "device_plain_ms": device_ms[f"{key}_plain"],
                "device_library_ms": device_ms[f"{key}_library"]}

    kernels = [
        {"name": "residual_trunk", "route": "cuda",
         "source": "simplesr_tpu_torch/csrc/trunk.cu",
         "replaces": "simplesr_tpu/ops/pallas/trunk_kernel.py:161",
         "launches": total("trunk"), "launches_by_path": by_path("trunk"),
         "max_abs_err": trunk_err, **times("trunk"), "bound_ms": trunk_bound,
         "bound_by": "operations" if trunk_flops / PEAK_BF16_FLOPS
         >= trunk_bytes / PEAK_BYTES_PER_S else "bytes",
         "bound_share": trunk_bound / trunk_ms,
         "resources": {"conv1": _build.kernel_attributes("ssr_trunk_attributes", 0),
                       "conv2": _build.kernel_attributes("ssr_trunk_attributes", 1)}},
        {"name": "extract_overlapping_patches", "route": "cuda",
         "source": "simplesr_tpu_torch/csrc/patches.cu",
         "replaces": "simplesr_tpu/ops/pallas/tiling_kernel.py:73",
         "launches": total("patches"), "launches_by_path": by_path("patches"),
         "max_abs_err": patch_err, **times("patches"), "bound_ms": patch_bound,
         "bound_by": "bytes", "bound_share": patch_bound / patch_ms,
         "resources": _build.kernel_attributes("ssr_patches_attributes")},
    ]
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card_name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def run():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    with tempfile.TemporaryDirectory() as work:
        return main(Path(work))


if __name__ == "__main__":
    try:
        code = run()
    except Exception:  # report any failure, never the ok line
        traceback.print_exc()
        code = 1
    sys.exit(code)
