"""The serving stack under concurrent load, as scripts/bench_serve.py
measures the JAX daemon.

    python -m simplesr_tpu_torch.tools.bench_serve [clients] [seconds]
        [--daemon-clients 4,8,16] [--model M] [--device cpu]

Three levels, each reporting the JAX script's ``requests_per_s``,
``output_mpix_per_s``, ``latency_ms_p50`` and ``latency_ms_p95`` (and
p90, p99, max and mean latency beside them):

- the ``SREngine`` ceiling: ``clients`` threads in this process call
  ``upscale`` (float32, ``engine_f32``) or ``upscale_u8`` (``engine_u8``,
  and through the paired trunk, ``engine_u8_paired2``), no codecs;
- the Unix-socket daemon (``tools.serve.serve``): PNG bodies over one
  persistent connection a client (``socket_png_persistent``) and a new
  connection a request (``socket_png_reconnect``);
- the HTTP gateway (``tools.http_gateway.serve_http``), keep-alive POSTs
  (``http_png_keepalive``).

Each stage runs half of ``seconds`` unmeasured, then ``seconds`` measured.
A row counts its ``failed`` requests (a refused connection, an error
reply; ``failures`` shows up to three of their messages) and reports the
latency of the answered ones.
The daemon's and gateway's clients are ``load_generator``'s threads, in a
process of their own (no share of the server's interpreter lock), at each
count of ``--daemon-clients`` (the JAX script's ``max(4, clients // 2)``
by default). Requests are 128 x 128 LR PNGs, x4; the model is a seeded
SRResNet x4 of 16 blocks x 64 filters with BatchNorm, as the JAX script
builds it, or ``--model``'s file. The run is on the card unless
``--device cpu`` is given. The module imports no torch at its top, so that
the clients' process starts quickly.
"""

import argparse
import http.client
import json
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
LR_HW = 128
SCALE = 4
MAX_BATCH = 16
BLOCKS, FILTERS = 16, 64
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def make_model_file(tmpdir):
    """A seeded SRResNet x4 model file, as the JAX script writes one."""
    import torch

    from simplesr_tpu_torch.models import SRResNet
    from simplesr_tpu_torch.train import serialization
    from simplesr_tpu_torch.train.convert import to_flax_variables

    torch.manual_seed(0)
    model = SRResNet(SCALE, num_filters=FILTERS, num_res_blocks=BLOCKS)
    path = str(Path(tmpdir) / "gen.msgpack")
    serialization.save_model({"upsample_factor": SCALE, "architecture": "srresnet",
                              "num_blocks": BLOCKS, "num_filters": FILTERS},
                             to_flax_variables(model.state_dict()), path)
    return path


def _socket_call(address):
    """A persistent connection to the daemon at ``address``: a function that
    sends one body in the daemon's framing and returns (ok, reply)."""
    frame = struct.Struct(">Q")
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(address)
    reader = sock.makefile("rb")

    def call(body):
        sock.sendall(frame.pack(len(body)) + body)
        head = reader.read(1 + frame.size)
        payload = reader.read(frame.unpack(head[1:])[0])
        return head[:1] == b"\x00", payload

    call.close = lambda: (reader.close(), sock.close())
    return call


def _reconnect_call(address):
    """A new connection to the daemon for every request."""
    def call(body):
        one = _socket_call(address)
        try:
            return one(body)
        finally:
            one.close()

    call.close = lambda: None
    return call


def _http_call(port):
    """A keep-alive HTTP connection to the gateway on 127.0.0.1:``port``."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)

    def call(body):
        conn.request("POST", "/upscale", body=body)
        resp = conn.getresponse()
        return resp.status == 200, resp.read()

    call.close = conn.close
    return call


CONNECT = {"persistent": _socket_call, "reconnect": _reconnect_call, "http": _http_call}


def _load_client(connect, bodies, count, offset, latencies, failures, deadline):
    """One client: ``count`` bodies (or bodies until ``deadline``), each
    timed from its first byte sent to its reply's last byte read (the reply
    is checked, not decoded)."""
    try:
        call = connect()
        try:
            r = 0
            while (count is None or r < count) and (deadline is None
                                                    or time.monotonic() < deadline):
                body = bodies[(offset + r) % len(bodies)]
                t0 = time.perf_counter()
                ok, payload = call(body)
                latencies.append(time.perf_counter() - t0)
                if not ok or payload[:8] != PNG_MAGIC:
                    failures.append(f"request {r}: {payload[:200]!r}")
                r += 1
        finally:
            call.close()
    except Exception as e:  # reported by the caller
        failures.append(repr(e))


def load_generator(address, body_paths, levels, mode="persistent"):
    """Load on the daemon at ``address`` (a socket path; the gateway's port
    for ``mode="http"``): for each (clients, requests) or (clients, requests,
    seconds) of ``levels``, that many threads, one connection each
    (``"reconnect"``: one a request), the requests split over them, or each
    sending until ``seconds`` have passed. Returns [(clients, latencies in
    s, wall s, failures), ...]."""
    bodies = [Path(p).read_bytes() for p in body_paths]
    connect = lambda: CONNECT[mode](address)
    results = []
    for clients, requests, *seconds in levels:
        seconds = seconds[0] if seconds else None
        latencies, failures = [], []
        deadline = None if seconds is None else time.monotonic() + seconds
        count = None if seconds is not None else requests // clients
        threads = [threading.Thread(target=_load_client, args=(
            connect, bodies, count, c, latencies, failures, deadline)) for c in range(clients)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        results.append((clients, latencies, time.perf_counter() - t0, failures))
    return results


def run_load(address, body_paths, levels, mode="persistent", timeout=300):
    """``load_generator`` in a process of its own, as the daemon's users'
    clients are (no share of the server's interpreter lock)."""
    spec = {"address": address, "body_paths": [str(p) for p in body_paths],
            "levels": levels, "mode": mode}
    proc = subprocess.run(
        [sys.executable, "-c", "import json, sys; from simplesr_tpu_torch.tools.bench_serve "
         "import load_generator; print(json.dumps(load_generator(**json.loads(sys.argv[1]))))",
         json.dumps(spec)], cwd=REPO, capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        raise RuntimeError(f"the load generator exited {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.splitlines()[-1])


def latency_summary(latencies, wall):
    """requests/s and latency percentiles (ms) of one level."""
    ms = np.array(latencies) * 1e3
    return {"requests": len(latencies), "requests_per_s": len(latencies) / wall,
            "p50_ms": float(np.percentile(ms, 50)), "p90_ms": float(np.percentile(ms, 90)),
            "p95_ms": float(np.percentile(ms, 95)), "p99_ms": float(np.percentile(ms, 99)),
            "max_ms": float(ms.max()), "mean_ms": float(ms.mean())}


def _record(stage, clients, latencies, wall, failures, dev):
    from simplesr_tpu_torch.tools.bench_timing import emit

    if not latencies:
        raise RuntimeError(f"{stage} with {clients} clients: no request answered, "
                           f"failures {failures[:5]}")
    summary = latency_summary(latencies, wall)
    row = {"stage": stage, "clients": clients, "max_batch": MAX_BATCH,
           "latency_ms_p50": summary.pop("p50_ms"), "latency_ms_p95": summary.pop("p95_ms"),
           **summary, "failed": len(failures), "failures": sorted(set(failures))[:3],
           "device": str(dev)}
    row["output_mpix_per_s"] = row["requests_per_s"] * (LR_HW * SCALE) ** 2 / 1e6
    return emit(row)


def _threads_load(call, clients, seconds):
    """``clients`` threads of this process calling ``call`` for half of
    ``seconds`` (not measured), then for ``seconds``: (latencies, wall,
    failures) of the second run."""
    for measured in (False, True):
        latencies, failures = [], []
        deadline = time.monotonic() + (seconds if measured else seconds / 2)

        def client():
            try:
                while time.monotonic() < deadline:
                    t0 = time.perf_counter()
                    call()
                    latencies.append(time.perf_counter() - t0)
            except Exception as e:  # reported by the caller
                failures.append(repr(e))

        threads = [threading.Thread(target=client) for _ in range(clients)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
    return latencies, wall, failures


def bench_engine(model_path, seconds, clients, dev):
    from simplesr_tpu_torch.tools.serve import SREngine

    img_f32 = np.random.default_rng(0).uniform(0, 1, (LR_HW, LR_HW, 3)).astype(np.float32)
    img_u8 = (img_f32 * 255).astype(np.uint8)
    rows = []
    for stage, paired, call in (("engine_f32", 0, lambda e: e.upscale(img_f32)),
                                ("engine_u8", 0, lambda e: e.upscale_u8(img_u8)),
                                ("engine_u8_paired2", 2, lambda e: e.upscale_u8(img_u8))):
        engine = SREngine(model_path, SCALE, max_batch=MAX_BATCH, max_wait_ms=10,
                          paired=paired, device=dev)
        try:
            engine.warmup(shapes=((LR_HW, LR_HW),), u8=None if stage == "engine_f32" else True)
            rows.append(_record(stage, clients, *_threads_load(lambda: call(engine), clients,
                                                               seconds), dev))
        finally:
            engine.close()
    return rows


def _server(target, model_path, dev, **kw):
    """``target`` (serve or serve_http) in a thread, warm and ready:
    (thread, stop event)."""
    ready, stop = threading.Event(), threading.Event()
    thread = threading.Thread(target=target, args=(model_path, SCALE), kwargs=dict(
        max_batch=MAX_BATCH, max_wait_ms=10, ready_event=ready, stop_event=stop,
        warm_shapes=((LR_HW, LR_HW),), device=dev, **kw), daemon=True)
    thread.start()
    if not ready.wait(600):
        raise RuntimeError(f"{target.__name__} did not get ready")
    return thread, stop


def _daemon_rows(stage, address, body, mode, clients_list, seconds, dev):
    """One process of clients for the stage: at each count, half of
    ``seconds`` not measured, then ``seconds``."""
    levels = [[c, 0, s] for c in clients_list for s in (seconds / 2, seconds)]
    results = run_load(address, [body], levels, mode,
                       timeout=300 + 2 * seconds * len(clients_list))
    return [_record(stage, clients, lat, wall, fails, dev)
            for clients, lat, wall, fails in results[1::2]]


def bench_socket(model_path, seconds, clients_list, dev, body, tmp):
    from simplesr_tpu_torch.tools.serve import serve

    sock_path = str(Path(tmp) / "sr.sock")
    thread, stop = _server(serve, model_path, dev, socket_path=sock_path)
    try:
        return (_daemon_rows("socket_png_persistent", sock_path, body, "persistent",
                             clients_list, seconds, dev)
                + _daemon_rows("socket_png_reconnect", sock_path, body, "reconnect",
                               clients_list, seconds, dev))
    finally:
        stop.set()
        thread.join(timeout=60)


def bench_http(model_path, seconds, clients_list, dev, body):
    from simplesr_tpu_torch.tools.http_gateway import serve_http

    bound = {}
    thread, stop = _server(serve_http, model_path, dev, port=0,
                           on_server=lambda s: bound.update(port=s.server_address[1]))
    try:
        return _daemon_rows("http_png_keepalive", bound["port"], body, "http", clients_list,
                            seconds, dev)
    finally:
        stop.set()
        thread.join(timeout=60)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("clients", type=int, nargs="?", default=16)
    p.add_argument("seconds", type=float, nargs="?", default=10)
    p.add_argument("--daemon-clients", default=None,
                   help="comma list of client counts for the daemon and the gateway "
                        "(default max(4, clients // 2))")
    p.add_argument("--model", default=None, help="a model file (default: a seeded one)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from simplesr_tpu_torch.core.device import resolve_device
    from simplesr_tpu_torch.data.png import write_png
    from simplesr_tpu_torch.tools.bench_timing import card_line

    dev = resolve_device(args.device)
    daemon_clients = ([int(c) for c in args.daemon_clients.split(",")] if args.daemon_clients
                      else [max(4, args.clients // 2)])
    with tempfile.TemporaryDirectory(prefix="ssr") as tmp:
        model_path = args.model or make_model_file(tmp)
        body = Path(tmp) / "in.png"
        write_png(body, np.random.default_rng(1).integers(0, 256, (LR_HW, LR_HW, 3),
                                                          dtype=np.uint8))
        rows = bench_engine(model_path, args.seconds, args.clients, dev)
        rows += bench_socket(model_path, args.seconds, daemon_clients, dev, body, tmp)
        rows += bench_http(model_path, args.seconds, daemon_clients, dev, body)
    card = card_line(dev)
    print(card, flush=True)
    return [dict(r, card=card) for r in rows]


if __name__ == "__main__":
    main()
