"""The residual trunk's three forms on the card, as
scripts/bench_trunk_kernel.py measures the Pallas kernel against XLA.

    python -m simplesr_tpu_torch.tools.bench_trunk_kernel [batch] [hw] [runs]
        [--device cpu]

At batch 16 x 128 x 128, C = 64 and 16 blocks (the JAX script's defaults),
on the same seeded BN-free bf16 SRResNet trunk and input, it times:

- ``trunk_cuda``: ``csrc/trunk.cu`` through ``ops.kernels.residual_trunk``;
- ``cudnn_channels_last``: one bf16 ``F.conv2d`` per conv in channels_last
  (``library_trunk``, the library yardstick; the port never calls it);
- ``plain``: ``residual_trunk_reference``, the kernel's plain version.

Each prints one JSON line: ``ms_per_fwd`` (one call between two CUDA events,
median of ``runs``), ``device_ms`` (a CUDA graph of calls; not measured on
the CPU), ``tflops_per_s``, ``tc_share`` of 989 TFLOP/s (on the card), and
the bound
from the trunk's operation count (2 x B x H x W x 9 x C^2 x 2 x blocks) and
bytes (input and output once, weights once). The JAX script's
``compile_s`` is ``build_s`` here (the kernels' build, once), and its
``band`` has no counterpart (trunk.cu has no band). The run is on the card
unless ``--device cpu`` is given; there every form is the plain version's
arithmetic and the times are the host's.
"""

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.models import SRResNet
from simplesr_tpu_torch.ops.kernels import residual_trunk, residual_trunk_reference
from simplesr_tpu_torch.tools.bench_timing import card_line, cuda_ms, emit, graph_ms, rates

C = 64
NUM_BLOCKS = 16


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


def trunk_cost(x, weights):
    """(FLOPs, bytes) of the trunk on NHWC ``x``: every conv's multiply-adds
    twice; the input read and the output written once, the weights once."""
    b, h, w, c = x.shape
    flops = 2 * b * h * w * 9 * c * c * 2 * weights.weight.shape[0]
    nbytes = 2 * x.numel() * x.element_size() + sum(t.numel() * t.element_size()
                                                     for t in weights)
    return flops, nbytes


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batch", type=int, nargs="?", default=16)
    p.add_argument("hw", type=int, nargs="?", default=128)
    p.add_argument("runs", type=int, nargs="?", default=25)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line(dev)

    torch.manual_seed(0)
    model = SRResNet(4, num_filters=C, num_res_blocks=NUM_BLOCKS, batch_norm=False,
                     dtype=torch.bfloat16).to(dev).eval()
    weights = model.trunk_weights()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 0.5, (args.batch, args.hw, args.hw, C))
                         .astype(np.float32)).to(dev, torch.bfloat16)
    x_cl = x.permute(0, 3, 1, 2)  # NCHW view, channels_last in memory
    lib = library_trunk_weights(model)
    flops, nbytes = trunk_cost(x, weights)

    t0 = time.perf_counter()
    with torch.inference_mode():
        residual_trunk(x, weights)  # builds the kernels on the card
        if dev.type == "cuda":
            torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        forms = {"trunk_cuda": (lambda: residual_trunk(x, weights), 5),
                 "cudnn_channels_last": (lambda: library_trunk(x_cl, lib), 5),
                 "plain": (lambda: residual_trunk_reference(x, weights), 3)}
        rows = []
        for label, (fn, calls) in forms.items():
            ms = cuda_ms(fn, runs=args.runs, dev=dev)
            device_ms = graph_ms(fn, calls) if dev.type == "cuda" else None
            row = {"kernel": label, "batch": args.batch, "hw": args.hw, "channels": C,
                   "blocks": NUM_BLOCKS, "ms_per_fwd": ms, "device_ms": device_ms,
                   **rates(ms, flops, nbytes, dev), "flops": flops, "bytes": nbytes,
                   "device": str(dev), "card": card}
            if label == "trunk_cuda":
                row["build_s"] = build_s
            rows.append(emit(row))
    return rows


if __name__ == "__main__":
    main()
