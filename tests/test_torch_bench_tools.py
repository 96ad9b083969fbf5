"""The port's benches and run tools (``tools/{bench_timing,bench_trunk_kernel,
bench_upsample_tail,bench_rrdb_tail,bench_serve,watched_run}``) on the CPU:
the tail forms against the JAX package's tails, each tool end to end at a
tiny size with the JAX script's row keys, and the stall watchdog's cases."""

import functools
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplesr_tpu.models import RRDBNet as JaxRRDBNet
from simplesr_tpu.models import SRResNet as JaxSRResNet
from simplesr_tpu_torch.models import RRDBNet, SRResNet
from simplesr_tpu_torch.tools import (bench_rrdb_tail, bench_serve, bench_timing,
                                      bench_trunk_kernel, bench_upsample_tail, watched_run)
from simplesr_tpu_torch.train.convert import from_flax_variables

# the port's tail forms against the JAX model on the same float32 weights:
# the same sums in other orders and, for the coarsened convs, over the
# structural zeros (measured under 3e-7 on [-1, 1])
TAIL_ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _tail_case(arch):
    """(port model, NHWC LR input, the JAX model's output on it) for a
    float32 x4 model of 1 block x 8 filters with the JAX init's weights."""
    x = np.random.default_rng(0).uniform(0, 1, (2, 6, 7, 3)).astype(np.float32)
    if arch == "srresnet":
        ref = JaxSRResNet(upsample_factor=4, num_res_blocks=1, num_filters=8,
                          batch_norm=False, dtype=jnp.float32)
        model = SRResNet(4, num_filters=8, num_res_blocks=1, batch_norm=False,
                         dtype=torch.float32)
    else:
        ref = JaxRRDBNet(upsample_factor=4, num_rrdb_blocks=1, num_filters=8,
                         dtype=jnp.float32)
        model = RRDBNet(4, num_filters=8, num_rrdb_blocks=1, dtype=torch.float32)
    variables = jax.jit(ref.init)(jax.random.key(0), jnp.asarray(x))
    out = np.asarray(jax.jit(ref.apply)(variables, jnp.asarray(x)))
    model.load_state_dict(from_flax_variables(model, variables))
    return model.eval(), x, out


@pytest.mark.parametrize("arch,form", [("srresnet", f) for f in bench_upsample_tail.FORMS]
                         + [("rrdb", f) for f in bench_rrdb_tail.FORMS])
def test_tail_form_equals_the_jax_tail(arch, form):
    """Each whole-tail form of ``bench_upsample_tail`` (SRResNet x4) and
    ``bench_rrdb_tail`` (RRDB x4) on the port model's features equals the
    JAX package's model on the same weights, to TAIL_ATOL."""
    model, x, ref = _tail_case(arch)
    build = (bench_upsample_tail.srresnet_tail_forms if arch == "srresnet"
             else bench_rrdb_tail.rrdb_tail_forms)
    forms, stages, tail = build(model)
    with torch.inference_mode():
        got = forms[form](model.features(torch.from_numpy(x))).numpy()
    assert got.shape == ref.shape == (2, 24, 28, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TAIL_ATOL)
    flops, useful = tail.count(forms[form], model.features(torch.from_numpy(x)))
    assert flops >= useful > 0
    assert (flops == useful) == (form in ("production", "prelu_before_d2s", "A_production"))


def test_bench_timing_on_the_cpu():
    """Host-clock medians on a CPU device; shares of the card's peaks only
    for a CUDA device; the bound is the larger of the two least times."""
    calls = []
    ms = bench_timing.cuda_ms(lambda: calls.append(1), runs=5, warmup=2, dev="cpu")
    assert ms >= 0 and len(calls) == 7
    both = bench_timing.alternating_ms({"a": lambda: None, "b": lambda: None}, runs=3, dev="cpu")
    assert set(both) == {"a", "b"}
    cpu = bench_timing.rates(2.0, flops=989e9, nbytes=3.35e9, dev="cpu")
    assert cpu["bound_ms"] == pytest.approx(1.0) and "tc_share" not in cpu
    card = bench_timing.rates(2.0, flops=989e9, nbytes=6.7e9, dev="cuda")
    assert card["bound_by"] == "bytes" and card["bound_ms"] == pytest.approx(2.0)
    assert card["tc_share"] == pytest.approx(0.5) and card["bound_share"] == pytest.approx(1.0)
    assert bench_timing.card_line("cpu").startswith("cpu")


TOOLS = [bench_trunk_kernel, bench_upsample_tail, bench_rrdb_tail, bench_serve,
         "remat_study", "train_roofline", "bf16_grad_study", "host_assembly_profile"]


@pytest.mark.parametrize("tool", TOOLS, ids=lambda t: getattr(t, "__name__", t).split(".")[-1])
def test_tools_need_a_card_unless_given_the_cpu(tool, monkeypatch):
    """Every measuring tool runs on the card by default and raises when
    there is none."""
    if isinstance(tool, str):
        tool = importlib.import_module(f"simplesr_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])


def test_bench_trunk_kernel_runs_on_the_cpu(monkeypatch):
    """The JAX script's keys (``compile_s`` is ``build_s``), three forms;
    2 blocks."""
    monkeypatch.setattr(bench_trunk_kernel, "NUM_BLOCKS", 2)
    rows = bench_trunk_kernel.main(["1", "8", "1", "--device", "cpu"])
    assert [r["kernel"] for r in rows] == ["trunk_cuda", "cudnn_channels_last", "plain"]
    for r in rows:
        assert {"batch", "hw", "tflops_per_s", "ms_per_fwd", "bound_ms", "bound_by"} <= set(r)
        assert r["device_ms"] is None and "bound_share" not in r
        assert r["flops"] == 2 * 64 * 9 * 64 * 64 * 2 * 2
    assert rows[0]["build_s"] >= 0


def test_tail_benches_run_on_the_cpu():
    """The JAX scripts' stage names, each with ``ms`` and TFLOP/s; the
    polyphase forms count their structural zeros."""
    rows = {r["stage"]: r for r in bench_upsample_tail.main(["1", "4", "1", "--device", "cpu"])}
    assert list(rows) == ["conv1_64to256@LR", "conv1+d2s", "conv1+d2s+prelu",
                          "conv2_64to256@2x", "conv2+d2s+prelu", "out_9x9_64to3@4x",
                          "full_tail_production", "tail_prelu_before_d2s",
                          "tail_coarse_output_conv", "tail_full_polyphase", "tail_phase_split",
                          "d2s_only_256ch@2x", "d2s4_only_48ch@LR"]
    assert rows["full_tail_production"]["zero_flops"] == 0
    assert rows["tail_full_polyphase"]["zero_flops"] > rows["tail_phase_split"]["zero_flops"] > 0
    rrdb = {r["stage"]: r for r in bench_rrdb_tail.main(["1", "4", "1", "--device", "cpu"])}
    assert list(rrdb) == list(bench_rrdb_tail.FORMS) + ["hr_conv_64to64@4x",
                                                        "out_conv_64to3@4x"]
    for r in list(rows.values()) + list(rrdb.values()):
        assert r["ms"] > 0 and r["device"] == "cpu"


def test_bench_serve_runs_on_the_cpu(monkeypatch):
    """Each level for 1 s (a 1-block x 8-filter model, 16 x 16 requests,
    batches of up to 2): the JAX script's stages and keys, every request
    answered."""
    monkeypatch.setattr(bench_serve, "MAX_BATCH", 2)
    monkeypatch.setattr(bench_serve, "BLOCKS", 1)
    monkeypatch.setattr(bench_serve, "FILTERS", 8)
    monkeypatch.setattr(bench_serve, "LR_HW", 16)
    rows = bench_serve.main(["2", "1", "--daemon-clients", "1", "--device", "cpu"])
    assert [(r["stage"], r["clients"]) for r in rows] == [
        ("engine_f32", 2), ("engine_u8", 2), ("engine_u8_paired2", 2),
        ("socket_png_persistent", 1), ("socket_png_reconnect", 1), ("http_png_keepalive", 1)]
    for r in rows:
        assert {"requests_per_s", "output_mpix_per_s", "max_batch", "latency_ms_p50",
                "latency_ms_p95"} <= set(r)
        assert r["requests"] > 0 and r["latency_ms_p95"] >= r["latency_ms_p50"] > 0


# the watchdog, case by case as tests/utils/test_watched_run.py holds the
# JAX script: (options, child's code, python's -u, exit code)
WATCH_CASES = {
    "healthy": (["--stall-seconds", "30", "--poll", "0.2"], "print('hi')", False, 0),
    "exit_code": (["--stall-seconds", "30", "--poll", "0.2"], "raise SystemExit(7)", False, 7),
    # prints once, then sleeps: the stall signature
    "stalled": (["--stall-seconds", "2", "--poll", "0.3", "--retries", "0"],
                "import time; print('start'); time.sleep(600)", True, 124),
    # prints every 0.5 s for 2.5 s: slower than the poll, faster than the
    # stall (interpreter start-up counts as silence, hence 15 s)
    "slow_but_alive": (["--stall-seconds", "15", "--poll", "0.2"],
                       "import time\nfor i in range(5): print(i, flush=True); time.sleep(0.5)",
                       True, 0),
    # no -u and no flush: the wrapper's PYTHONUNBUFFERED must keep the log
    # growing; the child runs 6.3 s, past the 5 s stall
    "block_buffered": (["--stall-seconds", "5", "--poll", "0.2", "--retries", "0"],
                       "import time\nfor i in range(7): print(i); time.sleep(0.9)", False, 0),
}


@pytest.mark.parametrize("case", list(WATCH_CASES))
def test_watched_run(case, tmp_path):
    opts, code, unbuffered, want = WATCH_CASES[case]
    log = tmp_path / "out.log"
    cmd = [sys.executable] + (["-u"] if unbuffered else []) + ["-c", code]
    assert watched_run.main(opts + ["--log", str(log), "--"] + cmd) == want
    if case == "healthy":
        assert b"hi" in log.read_bytes()


def test_watched_run_needs_a_command(tmp_path):
    with pytest.raises(SystemExit):
        watched_run.main(["--log", str(tmp_path / "out.log"), "--"])
