"""The port's serving daemon, its client and the HTTP gateway on the CPU:
outputs against the JAX package's ``upscale_files`` (within one level) and
the port's own (bit for bit), for PNG and JPEG bodies; failed requests (a
malformed JPEG among them) that leave the session usable,
the command line, the engine's batch ladder, and the PNG codec on bytes
against PIL."""

import functools
import io
import json
import struct
import threading
import urllib.error
import urllib.request
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from simplesr_tpu.tools.http_gateway import serve_http as jax_serve_http
from simplesr_tpu.tools.upscale import upscale_files as jax_upscale_files
from simplesr_tpu.train.generator import Generator
from simplesr_tpu.train.serialization import save_model as jax_save_model
from simplesr_tpu_torch.data.png import MAX_PIXELS, decode_png, encode_png, read_png, write_png
from simplesr_tpu_torch.tools import http_gateway, serve
from simplesr_tpu_torch.tools.upscale import upscale_files

ROOT = Path(__file__).resolve().parents[1]
GALLERY = sorted((ROOT / "data/corpus/gallery").glob("*.png"))
JPEG = b"\xff\xd8\xff\xe0\x00\x10JFIF\x00" + bytes(32)
# decompression bombs: a header over PIL's pixel limit, and 8 x 8 pixels
# whose image data inflates to 64 MiB
BOMBS = {"pixels": ((20000, 20000, 0), "exceeds the limit"),
         "inflate": ((8, 8, 64 << 20), "inflates past")}


@functools.lru_cache(maxsize=None)
def _bomb(kind):
    """PNG bytes of an 8-bit RGB header and one IDAT of zeros."""
    (width, height, raw), _ = BOMBS[kind]

    def chunk(name, body):
        return (struct.pack(">I", len(body)) + name + body
                + struct.pack(">I", zlib.crc32(name + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw), 9)) + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    """A 1-block, 8-filter float32 SRResNet x2 saved by simplesr_tpu."""
    gen = Generator.srresnet(upsample_factor=2, num_blocks=1, num_filters=8,
                             batch_norm=False, dtype=jnp.float32, input_dims=(16, 16))
    path = str(tmp_path_factory.mktemp("models") / "tiny.msgpack")
    jax_save_model(gen.module_config(), gen.variables, path)
    return path


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """Four gallery crops of two sizes."""
    folder = tmp_path_factory.mktemp("pngs")
    paths = []
    for i, (h, w) in enumerate([(20, 24), (20, 24), (16, 28), (20, 24)]):
        path = folder / f"c{i}.png"
        write_png(path, read_png(GALLERY[i])[10:10 + h, 30:30 + w, :3])
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def jpeg(tmp_path_factory):
    """A 20 x 24 gallery crop as a quality-90 JPEG (4:2:0)."""
    path = tmp_path_factory.mktemp("jpeg") / "c.jpg"
    Image.fromarray(read_png(GALLERY[5])[40:60, 50:74, :3]).save(path, quality=90)
    return path


@pytest.fixture
def daemon(tmp_path, model_path, monkeypatch):
    """The daemon on a Unix socket under tmp_path (a relative path, which
    any length of tmp_path leaves within AF_UNIX's 108 bytes), stopped at
    the end."""
    monkeypatch.chdir(tmp_path)
    sock = "sr.sock"
    ready, stop = threading.Event(), threading.Event()
    thread = threading.Thread(target=serve.serve, args=(model_path, 2), daemon=True, kwargs=dict(
        socket_path=sock, ready_event=ready, stop_event=stop, warm_shapes=((20, 24),),
        device="cpu"))
    thread.start()
    assert ready.wait(60)
    yield sock
    stop.set()
    thread.join(timeout=30)
    assert not thread.is_alive() and not (tmp_path / sock).exists()


def test_daemon_session_matches_upscale_files(daemon, pngs, jpeg, tmp_path, model_path):
    own = upscale_files(model_path, pngs, tmp_path / "port", 2, device="cpu")
    ref = jax_upscale_files(model_path, pngs, str(tmp_path / "jax"), 2)
    with serve.SRClient(daemon) as client:
        for i, path in enumerate(pngs):
            got = client.upscale_file(path)
            assert got.dtype == np.uint8 and got.shape == read_png(own[i]).shape
            np.testing.assert_array_equal(got, read_png(own[i]))
            levels = np.abs(got.astype(int) - read_png(ref[i])[:, :, :3].astype(int))
            assert levels.max() <= 1
            if i == 1:  # bad bodies get status 1 and leave the session usable
                for bad, why in ((b"not an image", "not a PNG"), (JPEG, "JPEG")):
                    with pytest.raises(serve.SRError, match=why):
                        client.upscale_bytes(bad)
    # a JPEG body, once refused, decodes as PIL decodes it
    own_jpeg = upscale_files(model_path, [jpeg], tmp_path / "port_jpeg", 2, device="cpu")[0]
    ref_jpeg = jax_upscale_files(model_path, [jpeg], str(tmp_path / "jax_jpeg"), 2)[0]
    with serve.SRClient(daemon) as client:
        got = client.upscale_file(jpeg)
    np.testing.assert_array_equal(got, read_png(own_jpeg))
    assert np.abs(got.astype(int) - read_png(ref_jpeg)[:, :, :3].astype(int)).max() <= 1
    np.testing.assert_array_equal(serve.request_upscale(daemon, pngs[2]), read_png(own[2]))


def test_cli_client_mode(daemon, pngs, tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"garbage")
    out = tmp_path / "cli"
    assert serve.main(["--client", daemon, str(pngs[0]), "--output", str(out)]) == 0
    assert read_png(out / "c0_sr.png").shape == (40, 48, 3)
    assert serve.main(["--client", daemon, str(bad), str(pngs[2]), "--output", str(out)]) == 1
    assert read_png(out / "c2_sr.png").shape == (32, 56, 3)


def test_bomb_bodies_are_refused_and_the_servers_go_on(daemon, model_path, pngs):
    with serve.SRClient(daemon) as client:
        for kind, (_, why) in BOMBS.items():
            with pytest.raises(serve.SRError, match=why):
                client.upscale_bytes(_bomb(kind))
        assert client.upscale_file(pngs[0]).shape == (40, 48, 3)
    url, stop, thread = _gateway(http_gateway.serve_http, model_path, device="cpu")
    try:
        for kind, (_, why) in BOMBS.items():
            code, _, msg = _http(url + "/upscale", _bomb(kind))
            assert code == 400 and why.encode() in msg
        assert _http(url + "/upscale", pngs[0].read_bytes())[0] == 200
    finally:
        stop.set()
        thread.join(timeout=30)
    assert not thread.is_alive()


@pytest.mark.parametrize("entry", ["upscale_files", "SREngine"])
def test_a_tile_threshold_other_than_the_routes_raises(entry, model_path, pngs, tmp_path):
    """``upscale_files`` refuses a threshold other than its route's own;
    ``SREngine`` routes by its threshold, as the JAX engine does
    (tests/test_torch_engine_mesh.py holds it against the JAX one)."""
    for threshold in (500, 2000):
        if entry == "SREngine":
            engine = serve.SREngine(model_path, 2, tile_threshold=threshold, device="cpu")
            try:
                assert engine.tile_threshold == threshold
                assert engine.upscale_u8(read_png(pngs[0])).shape == (40, 48, 3)
            finally:
                assert engine.close()
            continue
        with pytest.raises(ValueError, match="tile_threshold must be 1000"):
            upscale_files(model_path, pngs[:1], tmp_path / "out", 2, tile_threshold=threshold,
                          device="cpu")
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("argv,message", [
    (["--warm", "128x"], "--warm entries must be HxW"),
    (["--warm", "0x64"], "--warm entries must be HxW"),
    (["--paired", "1"], "--paired must be >= 2"),
    (["--mesh-dp", "2"], "--mesh-dp 2 but only 1 devices are available"),
    (["--mesh-dp", "0"], "--mesh-dp must be >= 1, got 0"),
])
def test_cli_refusals(argv, message, model_path, tmp_path, capsys):
    with pytest.raises(SystemExit):
        serve.main(["--model", model_path, "--socket", str(tmp_path / "s"), "--device", "cpu",
                    *argv])
    assert message in capsys.readouterr().err
    assert not (tmp_path / "s").exists()
    with pytest.raises((TypeError, ValueError), match="LocalMesh"):
        serve.SREngine(model_path, 2, mesh=object(), device="cpu")


def test_warmup_runs_the_pow2_ladder_and_batches_pad_to_it(model_path):
    engine = serve.SREngine(model_path, 2, max_batch=5, max_wait_ms=100, device="cpu")
    sizes = []
    inner = engine._predict
    engine._predict = lambda x: (sizes.append(int(x.shape[0])), inner(x))[1]
    try:
        warmed = engine.warmup(shapes=((8, 8),))
        assert engine.batch_sizes() == [1, 2, 4, 8]
        assert [w[0] for w in warmed] == [1, 1, 2, 2, 4, 4, 8, 8]
        assert sizes == [1, 1, 2, 2, 4, 4, 8, 8]
        sizes.clear()
        imgs = [np.random.default_rng(i).uniform(0, 1, (8, 8, 3)).astype(np.float32)
                for i in range(3)]
        results = [None] * 3
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, engine.upscale(imgs[i], timeout=60))) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert set(sizes) <= {1, 2, 4} and sum(sizes) >= 3
        single = inner(torch.from_numpy(imgs[2])[None])[0].numpy()
        np.testing.assert_allclose(results[2], single, rtol=0, atol=1e-6)
    finally:
        assert engine.close()


# no proxy from the environment: the gateway is on localhost
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _http(url, data=None):
    try:
        with _OPENER.open(urllib.request.Request(url, data=data), timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _gateway(serve_fn, model_path, **kwargs):
    ready, stop, box = threading.Event(), threading.Event(), {}
    thread = threading.Thread(target=serve_fn, args=(model_path, 2, 0), daemon=True, kwargs=dict(
        ready_event=ready, stop_event=stop, on_server=lambda s: box.update(s=s), **kwargs))
    thread.start()
    assert ready.wait(60)
    return f"http://127.0.0.1:{box['s'].server_address[1]}", stop, thread


def test_http_gateway(model_path, pngs, jpeg, tmp_path, monkeypatch):
    url, stop, thread = _gateway(http_gateway.serve_http, model_path, device="cpu")
    jax_url, jax_stop, jax_thread = _gateway(jax_serve_http, model_path)
    try:
        body = pngs[0].read_bytes()
        code, ctype, png = _http(url + "/upscale", body)
        assert (code, ctype) == (200, "image/png")
        own = upscale_files(model_path, [pngs[0]], tmp_path, 2, device="cpu")[0]
        np.testing.assert_array_equal(decode_png(png), read_png(own))
        code, _, msg = _http(url + "/upscale", b"garbage")
        assert code == 400 and b"cannot decode" in msg
        code, _, msg = _http(url + "/upscale", JPEG)
        assert code == 400 and b"JPEG" in msg
        code, ctype, png = _http(url + "/upscale", jpeg.read_bytes())
        assert (code, ctype) == (200, "image/png")
        own = upscale_files(model_path, [jpeg], tmp_path / "jpeg", 2, device="cpu")[0]
        np.testing.assert_array_equal(decode_png(png), read_png(own))
        monkeypatch.setattr(http_gateway, "MAX_BODY_BYTES", 16)
        code, _, _ = _http(url + "/upscale", body)
        assert code == 413
        code, ctype, health = _http(url + "/healthz")
        _, _, jax_health = _http(jax_url + "/healthz")
        assert (code, ctype) == (200, "application/json")
        assert json.loads(health) == json.loads(jax_health)
        assert _http(url + "/nothing")[0] == 404
    finally:
        stop.set()
        jax_stop.set()
        thread.join(timeout=30)
        jax_thread.join(timeout=30)
    assert not thread.is_alive() and not jax_thread.is_alive()


@pytest.mark.parametrize("entry", ["daemon", "gateway"])
def test_a_failed_decoder_build_fails_start_up(entry, model_path, tmp_path, monkeypatch):
    """The host decoder is built before readiness: without a compiler the
    server does not start, where it would otherwise fail each request."""
    from simplesr_tpu_torch.data import native_loader

    monkeypatch.setattr(native_loader, "_library", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setenv("PATH", str(tmp_path))
    ready = threading.Event()
    kwargs = dict(ready_event=ready, stop_event=threading.Event(), device="cpu")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        if entry == "daemon":
            serve.serve(model_path, 2, socket_path=str(tmp_path / "s.sock"), **kwargs)
        else:
            http_gateway.serve_http(model_path, 2, 0, **kwargs)
    assert not ready.is_set()


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_bytes_round_trip_and_agree_with_pil(channels):
    img = np.random.default_rng(channels).integers(0, 256, (13, 9, channels), dtype=np.uint8)
    data = encode_png(img)
    np.testing.assert_array_equal(decode_png(data), img)
    pil = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(pil.reshape(img.shape), img)
    buf = io.BytesIO()
    Image.fromarray(img[:, :, 0] if channels == 1 else img).save(buf, format="PNG")
    np.testing.assert_array_equal(decode_png(buf.getvalue()), img)
    with pytest.raises(ValueError):
        decode_png(b"\x89PNG\r\n\x1a\n" + bytes(4))
    with pytest.raises(ValueError):
        encode_png(img.astype(np.float32))


@pytest.mark.parametrize("kind", sorted(BOMBS))
def test_decode_png_refuses_bombs_as_pil_does(kind):
    with pytest.raises(ValueError, match=BOMBS[kind][1]):
        decode_png(_bomb(kind))
    assert MAX_PIXELS == 2 * Image.MAX_IMAGE_PIXELS
    if kind == "pixels":
        with pytest.raises(Image.DecompressionBombError):
            Image.open(io.BytesIO(_bomb(kind)))
