"""Batched SR serving daemon, as simplesr_tpu.tools.serve: a long-lived
process that keeps one model warm on the card and serves upscale requests
over a Unix (or TCP) socket.

Design:
  * ``SREngine`` groups requests by (shape, dtype) and batches them up to
    ``max_batch``, within a ``max_wait_ms`` deadline: latency stays bounded
    and throughput comes from batching;
  * a batch is padded to the next power of two with repeats of its first
    image, so the set of batch sizes the convolution library plans for stays
    the ``warmup`` ladder (1, 2, 4, ... up to ``max_batch``); batch entries
    are independent through the convs, so a request gets what the one-shot
    ``tools.upscale`` path gives it, up to the library's choice of algorithm
    per batch size;
  * the model is served in its exact serving form by default (``fast``, the
    polyphase tail), optionally with the x8 self-ensemble or the paired
    trunk;
  * images larger than the tile threshold go one by one through the
    overlap-tiled route, as in offline upscaling;
  * with ``--mesh-dp N`` (``SREngine(mesh=...)``) one process holds a
    replica of the model on each of N devices and splits each batch
    across them.

Protocol (length-prefixed frames over one persistent connection; send any
number of requests, close to end the session):
  client -> server: uint64 big-endian length + PNG, JPEG or BMP bytes   (repeat)
  server -> client: 1 status byte (0 = ok, 1 = error)
                    + uint64 big-endian length
                    + payload: PNG bytes (ok) | UTF-8 error message (error)
A failed request (an undecodable image, a model error) gets status 1 and a
message; the connection stays usable. Bodies are decoded by the port's C++
decoders (``data/image.py``: PNG of every mode and JPEG, as PIL reads them)
and replies encoded by its PNG code; GIF, WebP and TIFF bodies get status 1.

Run:    python -m simplesr_tpu_torch.tools.serve --model m.msgpack --scale 4 \\
            --socket /tmp/sr.sock [--device cpu]
Client: python -m simplesr_tpu_torch.tools.serve --client /tmp/sr.sock \\
            in.png --output out/
Library client: ``with SRClient(addr) as c: c.upscale_file(p)``.
"""

import argparse
import os
import queue
import socket
import socketserver
import struct
import threading
import time

import numpy as np
import torch

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.data import native_loader
from simplesr_tpu_torch.data.image import decode_image as _decode
from simplesr_tpu_torch.data.png import as_rgb, decode_png, encode_png
from simplesr_tpu_torch.eval.evaluation import _as_predictor, _upscale
from simplesr_tpu_torch.parallel.mesh import LocalMesh, make_mesh

_LEN = struct.Struct(">Q")



# --------------------------------------------------------------- wire I/O

def _read_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf += chunk
    return buf


def _recv_blob(sock, allow_eof=False):
    """One length-prefixed blob; with ``allow_eof``, a clean close before
    the first byte returns None (the end of a persistent session)."""
    first = sock.recv(1)
    if not first:
        if allow_eof:
            return None
        raise ConnectionError("peer closed mid-message")
    (n,) = _LEN.unpack(first + _read_exact(sock, _LEN.size - 1))
    return _read_exact(sock, n)


def _send_blob(sock, data):
    sock.sendall(_LEN.pack(len(data)) + data)


STATUS_OK = b"\x00"
STATUS_ERROR = b"\x01"


def _send_reply(sock, status, payload):
    sock.sendall(status + _LEN.pack(len(payload)) + payload)


def _recv_reply(sock):
    """-> (ok, payload)."""
    status = _read_exact(sock, 1)
    (n,) = _LEN.unpack(_read_exact(sock, _LEN.size))
    return status == STATUS_OK, _read_exact(sock, n)


def decode_image(blob):
    """Request bytes (PNG, JPEG or BMP) -> uint8 RGB (H, W, 3), as PIL's
    ``convert("RGB")`` gives them; anything else raises ValueError."""
    return _decode(blob, "request")


# ----------------------------------------------------------------- engine

class _Request:
    __slots__ = ("img", "event", "result", "error")

    def __init__(self, img):
        # float32 HWC in [0, 1] (upscale) or uint8 HWC (upscale_u8); the
        # result has the request's dtype: float32 in [-1, 1] or uint8
        self.img = img
        self.event = threading.Event()
        self.result = None
        self.error = None


def _bucket(n, smallest=1):
    """The batch size ``n`` requests are padded to: ``smallest`` doubled
    until it holds them (the next power of two by default)."""
    target = smallest
    while target < n:
        target *= 2
    return target


class SREngine:
    """Shape-bucketed batching executor around one warm model.

    ``upscale`` takes and returns float32, ``upscale_u8`` uint8; the uint8
    route moves 1 byte per channel between host and device and converts on
    the device. ``fast``, ``ensemble`` and ``paired`` pick the serving form
    as ``eval.evaluation._as_predictor`` does. A request whose shorter side
    is over ``tile_threshold`` goes through the tiled route (which tiles an
    image whose shorter side is over 1000 px); any other is batched whole.

    ``mesh`` (a ``LocalMesh``, ``parallel.make_mesh(devices=[...])``) serves
    one replica of the model on each device along its first axis, as the
    JAX package shards the batch over that axis: a batch splits into equal
    parts, one a replica, and is at least that many requests (padded). The
    tiled route's batches of tiles split the same way. ``device`` is then
    the mesh's first device. Call ``close`` when done.
    """

    def __init__(self, model_path, scale, max_batch=8, max_wait_ms=5,
                 tile_threshold=1000, fast=True, ensemble=False, paired=0, mesh=None,
                 device="cuda"):
        if mesh is not None and not isinstance(mesh, LocalMesh):
            raise TypeError("mesh must be a LocalMesh of this process's devices "
                            f"(parallel.make_mesh(devices=[...])), got {type(mesh).__name__}")
        replicas = [resolve_device(device)] if mesh is None else \
            [resolve_device(d) for d in mesh.devices.reshape(mesh.devices.shape[0], -1)[:, 0]]
        self.device = replicas[0]
        self._replicas = [(d, _as_predictor(model_path, fast=fast, ensemble=ensemble,
                                            paired=paired, device=d)) for d in replicas]
        self._min_batch = len(replicas)
        self.scale = int(scale)
        self.max_batch = max(int(max_batch), self._min_batch)
        self.max_wait_s = max_wait_ms / 1000.0
        self.tile_threshold = tile_threshold
        self._queue = queue.SimpleQueue()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="SREngine-worker")
        self._worker.start()

    def upscale(self, img_01, timeout=120.0):
        """Blocking: float32 HWC [0, 1] -> float32 HWC [-1, 1] SR."""
        return self._submit(_Request(np.asarray(img_01, np.float32)), timeout)

    def upscale_u8(self, img_u8, timeout=120.0):
        """Blocking: uint8 HWC -> uint8 HWC SR."""
        return self._submit(_Request(np.asarray(img_u8, np.uint8)), timeout)

    def _submit(self, req, timeout):
        if self._stop.is_set():
            raise RuntimeError("SREngine is closed")
        self._queue.put(req)
        if not req.event.wait(timeout):
            raise TimeoutError("SR request timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def _predict(self, x):
        """The model on a batch on ``self.device``: whole on one replica, or
        split into equal parts (the last shorter when the batch does not
        divide), one a replica, run on every device before any is waited
        for, and gathered back."""
        if len(self._replicas) == 1:
            return self._replicas[0][1](x)
        parts = x.chunk(len(self._replicas))
        outs = [predict(part.to(d)) for part, (d, predict) in zip(parts, self._replicas)]
        return torch.cat([o.to(x.device) for o in outs])

    def batch_sizes(self):
        """The batch sizes ``_run`` can give the model: the mesh's replica
        count (1 without a mesh) doubled up to the first at or above
        ``max_batch``."""
        sizes = [self._min_batch]
        while sizes[-1] < self.max_batch:
            sizes.append(sizes[-1] * 2)
        return sizes

    def warmup(self, shapes=((64, 64), (128, 128)), u8=None):
        """Run every batch size of ``batch_sizes`` once for each LR (H, W)
        shape, so that the convolution library has planned each before a
        request comes; ``u8=None`` warms both request dtypes. Returns the
        (batch, H, W, dtype) buckets run."""
        dtypes = [np.uint8, np.float32] if u8 is None else [np.uint8 if u8 else np.float32]
        warmed = []
        for h, w in shapes:
            for n in self.batch_sizes():
                for dtype in dtypes:
                    self._forward(np.zeros((n, h, w, 3), dtype))
                    warmed.append((n, h, w, np.dtype(dtype).name))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return warmed

    def close(self, timeout=10.0):
        """Stop the worker; returns whether it has ended within ``timeout``."""
        self._stop.set()
        self._queue.put(None)
        self._worker.join(timeout=timeout)
        return not self._worker.is_alive()

    def _collect(self):
        """One batch of same-shape requests (deadline-bounded), and the
        requests of other shapes met meanwhile."""
        first = self._queue.get()
        if first is None:
            return [], []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        stragglers = []
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if req is None:
                break
            if req.img.shape == first.img.shape and req.img.dtype == first.img.dtype:
                batch.append(req)
            else:
                stragglers.append(req)  # another bucket: next round
        return batch, stragglers

    def _forward(self, stacked):
        """The model on a host batch (float32 [0, 1] or uint8), converted on
        the device; the host result in the batch's dtype."""
        u8 = stacked.dtype == np.uint8
        x = torch.from_numpy(stacked).to(self.device)
        if u8:
            x = x.float() / 255.0
        sr = self._predict(x)
        if u8:  # truncating cast, as the one-shot path quantises
            sr = torch.clamp((sr.float() + 1.0) * 127.5, 0.0, 255.0).to(torch.uint8)
        return sr.cpu().numpy()

    def _run(self):
        while not self._stop.is_set():
            batch, stragglers = self._collect()
            for req in stragglers:
                self._queue.put(req)
            if not batch:
                continue
            try:
                h, w = batch[0].img.shape[:2]
                u8 = batch[0].img.dtype == np.uint8
                if min(h, w) > self.tile_threshold:
                    # the tiled route is per image; keep requests independent
                    outs = []
                    for r in batch:
                        img = torch.from_numpy(r.img).to(self.device)
                        img = img.float() / 255.0 if u8 else img
                        sr = _upscale(self._predict, img[None], self.scale)[0]
                        if u8:
                            sr = torch.clamp((sr + 1.0) * 127.5, 0.0, 255.0).to(torch.uint8)
                        outs.append(sr.cpu().numpy())
                else:
                    stacked = np.stack([r.img for r in batch])
                    pad = _bucket(len(batch), self._min_batch) - len(batch)
                    if pad:
                        stacked = np.concatenate([stacked, np.repeat(stacked[:1], pad, 0)])
                    outs = self._forward(stacked)[:len(batch)]
                for req, out in zip(batch, outs):
                    req.result = out
            except Exception as e:  # report to the callers, keep serving
                for req in batch:
                    req.error = e
            finally:
                for req in batch:
                    req.event.set()


# ----------------------------------------------------------------- server

def serve(model_path, scale, socket_path=None, tcp_port=None, max_batch=8, max_wait_ms=5,
          ready_event=None, stop_event=None, warm_shapes=None, mesh=None, ensemble=False,
          paired=0, device="cuda"):
    """Run the daemon until ``stop_event`` is set (or forever). ``warm_shapes``
    (e.g. ((128, 128),)) runs those LR buckets in uint8, the dtype the socket
    serves, before readiness is signalled; ``ensemble`` and ``paired`` pick
    the serving form as ``SREngine`` does. The host decoder is built before
    anything else, so a failed build fails start-up and not each request.
    Returns the server object."""
    native_loader.library()
    engine = SREngine(model_path, scale, max_batch=max_batch, max_wait_ms=max_wait_ms,
                      ensemble=ensemble, paired=paired, mesh=mesh, device=device)
    try:
        if warm_shapes:
            engine.warmup(shapes=warm_shapes, u8=True)

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                # a persistent session: serve requests until the client closes
                while True:
                    try:
                        blob = _recv_blob(self.request, allow_eof=True)
                    except (ConnectionError, OSError):
                        return
                    if blob is None:
                        return  # clean close
                    try:
                        reply = (STATUS_OK, encode_png(engine.upscale_u8(decode_image(blob))))
                    except Exception as e:  # report why; keep the session alive
                        reply = (STATUS_ERROR,
                                 f"{type(e).__name__}: {e}".encode("utf-8", "replace")[:4096])
                    try:
                        _send_reply(self.request, *reply)
                    except OSError:
                        return

        if socket_path:
            if os.path.exists(socket_path):
                os.unlink(socket_path)
            server = _ThreadingUnixServer(socket_path, Handler)
        else:
            server = _ThreadingTCPServer(("127.0.0.1", tcp_port or 0), Handler)
    except BaseException:
        engine.close()
        raise
    if ready_event is not None:
        ready_event.set()
    try:
        if stop_event is None:
            server.serve_forever()
        else:
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            stop_event.wait()
    finally:
        server.shutdown()
        server.server_close()
        engine.close()
        if socket_path and os.path.exists(socket_path):
            os.unlink(socket_path)
    return server


class _ThreadingUnixServer(socketserver.ThreadingMixIn, socketserver.UnixStreamServer):
    daemon_threads = True


class _ThreadingTCPServer(socketserver.ThreadingMixIn, socketserver.TCPServer):
    daemon_threads = True
    allow_reuse_address = True


class SRError(RuntimeError):
    """A failure the server reported for one request (its message)."""


class SRClient:
    """Persistent-connection client: one socket, many requests.

    ``address`` is a Unix socket path or a (host, port) tuple. A request the
    server fails raises SRError with the server's message; the connection
    stays open for further requests."""

    def __init__(self, address):
        if isinstance(address, tuple):
            self._sock = socket.create_connection(address)
        else:
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                self._sock.connect(address)
            except OSError:
                self._sock.close()
                raise

    def upscale_bytes(self, img_bytes):
        """PNG bytes -> SR image as uint8 RGB (H, W, 3)."""
        _send_blob(self._sock, img_bytes)
        ok, payload = _recv_reply(self._sock)
        if not ok:
            raise SRError(payload.decode("utf-8", "replace")
                          or "server reported an error for this image")
        return as_rgb(decode_png(payload, "reply"))

    def upscale_file(self, image_path):
        with open(image_path, "rb") as f:
            return self.upscale_bytes(f.read())

    def close(self):
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def request_upscale(address, image_path):
    """One image file through a new connection; the SR image as uint8 RGB.
    For many images hold an SRClient open instead."""
    with SRClient(address) as client:
        return client.upscale_file(image_path)


def parse_warm(parser, spec):
    """``--warm HxW[,HxW...]`` -> ((H, W), ...); a bad entry is a parser
    error."""
    if not spec:
        return None
    warm = []
    for s in spec.split(","):
        dims = s.split("x")
        if len(dims) != 2 or not all(d.isdigit() and int(d) > 0 for d in dims):
            parser.error(f"--warm entries must be HxW (two positive ints), got {s!r}")
        warm.append((int(dims[0]), int(dims[1])))
    return tuple(warm)


def main(argv=None):
    from simplesr_tpu_torch.data.png import write_png

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", help="saved model (.msgpack) or zoo:<name> [server mode]")
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--socket", help="Unix socket path")
    p.add_argument("--port", type=int, help="TCP port (instead of --socket)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=5)
    p.add_argument("--warm", metavar="HxW[,HxW...]",
                   help="run these LR shape buckets before serving (e.g. 128x128,256x256)")
    p.add_argument("--mesh-dp", type=int, metavar="N",
                   help="shard request batches over N devices, one model replica each")
    p.add_argument("--ensemble", action="store_true",
                   help="serve through the x8 geometric self-ensemble (~8x the compute)")
    p.add_argument("--paired", type=int, default=0, metavar="W",
                   help="serve through the paired trunk (W batch items packed into "
                        "channels; exact rewrite, SRResNet/RRDB)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    p.add_argument("--client", metavar="ADDR", help="client mode: socket path (or host:port)")
    p.add_argument("--output", default=".", help="[client] output directory")
    p.add_argument("inputs", nargs="*", help="[client] PNG files")
    args = p.parse_args(argv)

    if args.client:
        addr = args.client
        if ":" in addr and not os.path.exists(addr):
            host, port = addr.rsplit(":", 1)
            addr = (host, int(port))
        os.makedirs(args.output, exist_ok=True)
        rc = 0
        with SRClient(addr) as client:  # one connection for the whole list
            for path in args.inputs:
                try:
                    arr = client.upscale_file(path)
                except SRError as e:
                    print(f"{path}: server error: {e}")
                    rc = 1
                    continue
                out = os.path.join(args.output,
                                   os.path.splitext(os.path.basename(path))[0] + "_sr.png")
                write_png(out, arr)
                print(f"{path} -> {out} {arr.shape[1]}x{arr.shape[0]}")
        return rc

    if not args.model or not (args.socket or args.port):
        p.error("server mode needs --model and --socket/--port")
    warm = parse_warm(p, args.warm)
    if args.paired and args.paired < 2:
        p.error(f"--paired must be >= 2, got {args.paired}")
    device = resolve_device(args.device)
    mesh = None
    if args.mesh_dp is not None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())] \
            if device.type == "cuda" else [device]
        if args.mesh_dp < 1:
            p.error(f"--mesh-dp must be >= 1, got {args.mesh_dp}")
        if args.mesh_dp > len(devices):  # don't silently serve at lower parallelism
            p.error(f"--mesh-dp {args.mesh_dp} but only {len(devices)} devices"
                    " are available")
        mesh = make_mesh(devices=devices[:args.mesh_dp])
    print(f"serving {args.model} x{args.scale} on "
          f"{args.socket or f'127.0.0.1:{args.port}'} ({device})", flush=True)
    # SIGTERM (systemd, docker stop) runs the same clean-up as Ctrl-C:
    # the socket is unlinked and the engine closed
    stop = _install_stop_handler()
    serve(args.model, args.scale, socket_path=args.socket, tcp_port=args.port,
          max_batch=args.max_batch, max_wait_ms=args.max_wait_ms, warm_shapes=warm,
          ensemble=args.ensemble, paired=args.paired, mesh=mesh, device=device,
          stop_event=stop)
    return 0


def _install_stop_handler():
    """SIGTERM / SIGINT -> a stop event the serve loop waits on (shared by
    the HTTP gateway)."""
    import signal

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    return stop


if __name__ == "__main__":
    raise SystemExit(main())
