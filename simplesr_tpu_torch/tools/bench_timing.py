"""The port's timing harness, the counterpart of scripts/bench_timing.py.

Three ways to time a call on the card, each for its kind of path:

- ``cuda_ms``: one call between two CUDA events, median of ``runs``: what
  a caller sees, host launch path included;
- ``graph_ms``: device time of one call, from a CUDA graph of ``calls``
  calls replayed between two events, so that no host time between the
  launches counts;
- ``alternating_ms``: several functions run in turns, each between two
  events, for paths bound by the host, whose speed drifts within a run.

On a CPU device (``--device cpu``, the tests) the same functions read the
host's clock: their numbers then say how fast the CPU ran the call, never
the card's time, and every tool's row names the device it ran on.

``rates`` turns FLOPs and bytes into TFLOP/s and TB/s with their shares of
the H100 SXM's published dense peaks (989 TFLOP/s bf16, 3.35 TB/s HBM3,
which assume the full 700 W), and the bound (the larger of the two least
times); ``card_line`` gives ``nvidia-smi``'s name and power limit to write
beside them.
"""

import json
import statistics
import subprocess
import time
from pathlib import Path

import torch

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
TIMING_RUNS = 25


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Span:
    """One timed span: two CUDA events on a CUDA device, else the host's
    clock around a synchronised call."""

    def __init__(self, dev):
        self.dev = dev
        if dev.type == "cuda":
            self.begin = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)

    def __enter__(self):
        if self.dev.type == "cuda":
            self.begin.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.dev.type == "cuda":
            self.end.record()
            self.end.synchronize()
            self.ms = self.begin.elapsed_time(self.end)
        else:
            self.ms = (time.perf_counter() - self.t0) * 1e3


def cuda_ms(fn, runs=TIMING_RUNS, warmup=3, dev=None):
    """Median time of ``fn`` in ms over ``runs`` runs, each between two CUDA
    events (the host's clock on a CPU ``dev``), after ``warmup`` runs."""
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    for _ in range(warmup):
        fn()
    sync(dev)
    times = []
    for _ in range(runs):
        with Span(dev) as span:
            fn()
        times.append(span.ms)
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


def alternating_ms(fns, runs, warmup=2, dev=None):
    """Medians in ms of several functions (a dict), run in turns ``runs``
    times after ``warmup`` turns, each between two CUDA events (the host's
    clock on a CPU ``dev``)."""
    dev = torch.device("cuda") if dev is None else torch.device(dev)
    for _ in range(warmup):
        for fn in fns.values():
            fn()
    sync(dev)
    times = {name: [] for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            with Span(dev) as span:
                fn()
            times[name].append(span.ms)
    return {name: statistics.median(t) for name, t in times.items()}


def rates(ms, flops=None, nbytes=None, dev="cuda"):
    """TFLOP/s and TB/s of a call of ``ms`` that does ``flops`` operations
    and must move ``nbytes`` bytes; the H100's bound for that work: the
    larger of the two least times, and which one; and, for a time taken on
    a CUDA ``dev``, the shares of the bf16 and HBM peaks and of the bound
    (a host-clock time on the CPU is no share of the card's peaks)."""
    row, op_ms, byte_ms = {}, 0.0, 0.0
    if flops:
        row["tflops_per_s"] = flops / ms / 1e9
        op_ms = flops / PEAK_BF16_FLOPS * 1e3
    if nbytes:
        row["tb_per_s"] = nbytes / ms / 1e9
        byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    if not (flops or nbytes):
        return row
    row["bound_ms"] = max(op_ms, byte_ms)
    row["bound_by"] = "operations" if op_ms >= byte_ms else "bytes"
    if torch.device(dev).type == "cuda":
        if flops:
            row["tc_share"] = op_ms / ms
        if nbytes:
            row["hbm_share"] = byte_ms / ms
        row["bound_share"] = row["bound_ms"] / ms
    return row


def card_line(dev):
    """``nvidia-smi``'s name and power limit of the card, as
    ``--query-gpu=name,power.limit --format=csv,noheader`` prints them; on a
    CPU device, says so."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return "cpu (no card: host-clock times)"
    name = torch.cuda.get_device_name(dev)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{name}, power limit not read ({type(e).__name__})"
    index = dev.index or 0
    return out[index] if len(out) > index else f"{name}, power limit not read"


def emit(row):
    """Print ``row`` as one JSON line."""
    print(json.dumps(row), flush=True)
    return row


def write_json(out, name, payload):
    """Write ``payload`` as ``out/name`` (indented JSON); returns the path."""
    path = Path(out) / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=1) + "\n")
    return path


def markdown_table(rows, cols):
    """``rows`` (dicts) as a markdown table of ``cols``."""
    fmt = lambda v: "" if v is None else (f"{v:.6g}" if isinstance(v, float) else str(v))
    lines = ["| " + " | ".join(cols) + " |", "|" + "---|" * len(cols)]
    lines += ["| " + " | ".join(fmt(r.get(c)) for c in cols) + " |" for r in rows]
    return "\n".join(lines) + "\n"
