"""HTTP gateway over the serving engine, as simplesr_tpu.tools.http_gateway.

    python -m simplesr_tpu_torch.tools.http_gateway --model gen.msgpack \\
        --scale 4 --port 8080 [--device cpu]
    curl -s --data-binary @input.jpg http://127.0.0.1:8080/upscale > out.png

Endpoints:
- ``POST /upscale``: the body is a PNG, JPEG, WebP, GIF, TIFF, BMP or
  netpbm image (``data/image.py``); the response is the SR result as PNG
  (200). A body that cannot be decoded gets 400, one over
  ``MAX_BODY_BYTES`` 413, a fault 500, each with a plain-text message.
- ``GET /healthz``: JSON liveness and the model, scale, ensemble and paired
  width served.

The gateway shares ``SREngine`` with the socket daemon (tools/serve.py), so
requests get the same shape-bucketed batching on the card and uint8
transfers. The HTTP layer is the standard library's ``ThreadingHTTPServer``:
one thread per request in flight, the device work batched underneath.
"""

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from simplesr_tpu_torch.data import native_loader
from simplesr_tpu_torch.data.png import encode_png

MAX_BODY_BYTES = 64 * 1024 * 1024  # refuse absurd uploads before decoding


def serve_http(model_path, scale, port, host="127.0.0.1", max_batch=8, max_wait_ms=5,
               ensemble=False, paired=0, warm_shapes=None, ready_event=None, stop_event=None,
               on_server=None, device="cuda"):
    """Run the HTTP gateway until ``stop_event`` is set (or forever).
    ``on_server(server)`` is called after binding and before readiness; with
    ``port=0`` the bound port is ``server.server_address[1]``. The host
    decoder is built before anything else, so a failed build fails start-up.
    Returns the server object."""
    from simplesr_tpu_torch.tools.serve import SREngine, decode_image

    native_loader.library()
    engine = SREngine(model_path, scale, max_batch=max_batch, max_wait_ms=max_wait_ms,
                      ensemble=ensemble, paired=paired, device=device)
    health = json.dumps({
        "status": "ok", "model": str(model_path), "scale": int(scale),
        "ensemble": bool(ensemble), "paired": int(paired),
    }).encode()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # keep-alive: many requests per connection

        def log_message(self, fmt, *args):  # quiet
            pass

        def _reply(self, code, body, ctype="text/plain"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/healthz", "/health"):
                self._reply(200, health, "application/json")
            else:
                self._reply(404, b"unknown path; POST /upscale or GET /healthz")

        def do_POST(self):
            if self.path != "/upscale":
                self._reply(404, b"unknown path; POST /upscale")
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                length = 0
            if length <= 0:
                self._reply(411, b"Content-Length required")
                return
            if length > MAX_BODY_BYTES:
                self.close_connection = True  # the body stays unread
                self._reply(413, f"body exceeds {MAX_BODY_BYTES} bytes".encode())
                return
            blob = self.rfile.read(length)
            try:
                img = decode_image(blob)
            except Exception as e:
                self._reply(400, f"cannot decode image: {e}".encode())
                return
            try:
                body = encode_png(engine.upscale_u8(img))
            except Exception as e:
                self._reply(500, f"{type(e).__name__}: {e}".encode())
                return
            self._reply(200, body, "image/png")

    try:
        if warm_shapes:
            engine.warmup(shapes=warm_shapes, u8=True)
        server = ThreadingHTTPServer((host, port), Handler)
    except BaseException:
        engine.close()
        raise
    server.daemon_threads = True
    if on_server is not None:
        on_server(server)
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
    return server


def main(argv=None):
    from simplesr_tpu_torch.core.device import resolve_device
    from simplesr_tpu_torch.tools.serve import _install_stop_handler, parse_warm

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, help="saved model (.msgpack) or zoo:<name>")
    p.add_argument("--scale", type=int, default=4)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=5)
    p.add_argument("--ensemble", action="store_true",
                   help="serve through the x8 geometric self-ensemble")
    p.add_argument("--paired", type=int, default=0, metavar="W",
                   help="serve through the paired trunk (W batch items packed into channels)")
    p.add_argument("--warm", metavar="HxW[,HxW...]",
                   help="run these LR shape buckets before serving")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)
    warm = parse_warm(p, args.warm)
    if args.paired and args.paired < 2:
        p.error(f"--paired must be >= 2, got {args.paired}")
    device = resolve_device(args.device)
    print(f"http gateway: {args.model} x{args.scale} on http://{args.host}:{args.port} "
          f"({device})", flush=True)
    serve_http(args.model, args.scale, args.port, host=args.host, max_batch=args.max_batch,
               max_wait_ms=args.max_wait_ms, ensemble=args.ensemble, paired=args.paired,
               warm_shapes=warm, stop_event=_install_stop_handler(), device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
