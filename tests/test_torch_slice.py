"""The port's serving slice on the CPU against simplesr_tpu: the upscale
tool, the overlap-tiled route, the predictor's serving forms and SREngine;
its PNG codec against PIL; and the rules the port keeps (no JAX-side
imports, no silent move to the CPU)."""

import ast
import os
import shutil
import subprocess
import sys
import threading
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from simplesr_tpu.eval.evaluation import _upscale as jax_upscale
from simplesr_tpu.models.polyphase import fast_inference as jax_fast_inference
from simplesr_tpu.train.generator import Generator
from simplesr_tpu.train.serialization import load_model as jax_load_model
from simplesr_tpu.train.serialization import save_model as jax_save_model
from _png_writer import write_png as write_adam7
from simplesr_tpu_torch.data.image import read_img, read_rgb_u8
from simplesr_tpu_torch.data.png import as_rgb, read_png, write_png
from simplesr_tpu_torch.eval.evaluation import _as_predictor, _upscale
from simplesr_tpu_torch.ops.kernels import _build
from simplesr_tpu_torch.tools.serve import SREngine
from simplesr_tpu_torch.tools.upscale import main as upscale_main
from simplesr_tpu_torch.tools.upscale import upscale_files

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP = ROOT / "results/quality_fastrecipe/models/resnet_gen_srresnet_x4_best.msgpack"
GALLERY = sorted((ROOT / "data/corpus/gallery").glob("*.png"))


@pytest.fixture(scope="module")
def small_model(tmp_path_factory):
    """A 1-block, 8-filter float32 SRResNet x2 saved by simplesr_tpu."""
    gen = Generator.srresnet(upsample_factor=2, num_blocks=1, num_filters=8,
                             batch_norm=False, dtype=jnp.float32, input_dims=(16, 16))
    path = str(tmp_path_factory.mktemp("models") / "small.msgpack")
    jax_save_model(gen.module_config(), gen.variables, path)
    return path


def _jax_predictor(path, fast=False):
    """The JAX package's predictor of a model file, eager: its training form,
    or with ``fast`` its serving form (what its ``_as_predictor`` serves by
    default)."""
    module, variables = jax_load_model(path)
    if fast:
        module, variables = jax_fast_inference(module, variables)
    return lambda x: module.apply(variables, x, train=False)


def test_upscale_files_matches_jax_upscale(tmp_path):
    crop = read_png(GALLERY[10])[40:64, 60:92]
    src = tmp_path / "crop.png"
    write_png(src, crop)
    out = upscale_files(FLAGSHIP, [src], tmp_path / "out", 4, device="cpu")
    got = read_png(out[0]).astype(np.int16)
    lr = jnp.asarray(crop.astype(np.float32) / 255.0)[None]
    # both packages' defaults: the polyphase serving form
    sr = np.asarray(jax_upscale(_jax_predictor(FLAGSHIP, fast=True), lr, 4)[0])
    ref = np.clip((sr + 1.0) * 127.5, 0, 255).astype(np.uint8).astype(np.int16)
    assert got.shape == ref.shape == (96, 128, 3)
    diff = np.abs(got - ref)
    # bf16 through 16 blocks, as in test_torch_srresnet: at most 0.1 on
    # [-1, 1] is 12.75 levels of 255; on average under 0.01, 1.3 levels
    assert diff.max() <= 13 and diff.mean() < 1.3, (diff.max(), diff.mean())


def test_cli_writes_pngs(tmp_path, small_model):
    src = tmp_path / "in.png"
    write_png(src, read_png(GALLERY[0])[:20, :28])
    assert upscale_main(["--model", small_model, "--scale", "2", "--device", "cpu",
                         "--output", str(tmp_path / "o"), str(src)]) == 0
    assert read_png(tmp_path / "o" / "in_x2.png").shape == (40, 56, 3)
    for flags in (["--no-fast"], ["--ensemble"], ["--paired", "2"]):
        assert upscale_main(["--model", small_model, "--scale", "2", "--device", "cpu",
                             "--output", str(tmp_path / flags[0]), str(src), *flags]) == 0
        assert read_png(tmp_path / flags[0] / "in_x2.png").shape == (40, 56, 3)
    with pytest.raises(SystemExit):  # as the JAX package's: --paired must be >= 2
        upscale_main(["--model", small_model, "--paired", "1", "--device", "cpu", str(src)])


def test_tiled_route_matches_jax(small_model):
    """An LR image over 1000 x 1000 goes through the overlap-tiled route
    (128 px patches, 32 px overlap, batches of 8) in both packages."""
    rng = np.random.default_rng(0)
    lr = rng.uniform(0, 1, (1001, 1003, 3)).astype(np.float32)
    got = _upscale(_as_predictor(small_model, device="cpu"), torch.from_numpy(lr)[None], 2)
    ref = jax_upscale(_jax_predictor(small_model), jnp.asarray(lr)[None], 2)
    assert got.shape == (1, 2002, 2006, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def test_predictor_forms_and_unported_options(small_model):
    """Every form builds, and each serving option (ported since) matches its
    reference: the polyphase form the training form, the ensemble the mean
    of the dihedral outputs, the paired trunk the unpaired one; float32, the
    same products summed in another order."""
    from simplesr_tpu_torch.ops.ensemble import self_ensemble
    from simplesr_tpu_torch.train.serialization import load_model

    x = torch.rand((3, 8, 8, 3))
    module = load_model(small_model, device="cpu")
    by_path = _as_predictor(small_model, device="cpu")(x)
    by_pair = _as_predictor((module, module.state_dict()), device="cpu")(x)
    assert torch.equal(by_path, by_pair)
    assert _as_predictor(torch.tanh)(x) is not None
    training_form = _as_predictor(small_model, fast=False, device="cpu")
    references = {"fast": training_form(x), "ensemble": self_ensemble(training_form, x),
                  "paired": training_form(x)}
    for option, value in (("fast", True), ("ensemble", True), ("paired", 2)):
        got = _as_predictor(small_model, device="cpu", **{option: value})(x)
        assert got.shape == (3, 16, 16, 3)
        torch.testing.assert_close(got, references[option], rtol=0, atol=1e-5)
    with pytest.raises(TypeError):
        _as_predictor(3, device="cpu")


def test_predictor_of_a_trained_model_ignores_fast(small_model):
    """An SRModel or a Generator serves its ``generate`` whatever ``fast``
    says, as the JAX package's ``_as_predictor`` does; ``fast=True`` on a
    path or a (module, state_dict) pair serves the polyphase form, as the
    JAX package's does."""
    from simplesr_tpu_torch.train import Generator as TorchGenerator
    from simplesr_tpu_torch.train import SRModel
    from simplesr_tpu_torch.train.serialization import load_model

    gen = TorchGenerator.srresnet(2, num_blocks=1, num_filters=8, batch_norm=False,
                                  device="cpu")
    model = SRModel("resnet", gen, device="cpu")
    x = torch.rand((2, 8, 8, 3))
    for fast in (True, False):
        assert torch.equal(_as_predictor(model, fast=fast, device="cpu")(x), model.generate(x))
        assert torch.equal(_as_predictor(gen, fast=fast, device="cpu")(x), gen.generate(x))
    module = load_model(small_model, device="cpu")
    jax_fast = _jax_predictor(small_model, fast=True)(jnp.asarray(x.numpy()))
    for form in (small_model, (module, module.state_dict())):
        got = _as_predictor(form, fast=True, device="cpu")(x)
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_fast), rtol=0, atol=1e-5)
        torch.testing.assert_close(got, _as_predictor(form, fast=False, device="cpu")(x),
                                   rtol=0, atol=1e-5)


def test_engine_batches_and_matches_one_shot(small_model):
    engine = SREngine(small_model, scale=2, max_batch=4, max_wait_ms=50, device="cpu")
    calls = []
    inner = engine._predict
    engine._predict = lambda x: (calls.append(tuple(x.shape)), inner(x))[1]
    rng = np.random.default_rng(1)
    imgs = [rng.uniform(0, 1, (16, 16, 3)).astype(np.float32) for _ in range(3)]
    imgs.append(rng.uniform(0, 1, (24, 16, 3)).astype(np.float32))
    results = [None] * len(imgs)

    def run(i):
        results[i] = engine.upscale(imgs[i], timeout=60)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(imgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    u8 = engine.upscale_u8((imgs[0] * 255).astype(np.uint8), timeout=60)
    assert engine.close()
    with pytest.raises(RuntimeError):
        engine.upscale(imgs[0])

    direct = _as_predictor(small_model, device="cpu")
    jax_direct = _jax_predictor(small_model)
    for img, out in zip(imgs, results):
        one_shot = direct(torch.from_numpy(img)[None])[0].numpy()
        np.testing.assert_allclose(out, one_shot, rtol=0, atol=1e-6)  # batch vs single
        np.testing.assert_allclose(out, np.asarray(jax_direct(jnp.asarray(img)[None])[0]),
                                   rtol=0, atol=1e-4)
    assert u8.dtype == np.uint8 and u8.shape == (32, 32, 3)
    batched = [s for s in calls if s[1:3] == (16, 16)]
    assert len(batched) <= 2 and sum(s[0] for s in batched) >= 3


def test_engine_reports_errors_and_keeps_serving(small_model):
    engine = SREngine(small_model, scale=2, max_wait_ms=1, device="cpu")
    try:
        with pytest.raises(Exception):
            engine.upscale(np.zeros((4, 4), np.float32), timeout=30)  # no channel axis
        assert engine.upscale(np.zeros((8, 8, 3), np.float32), timeout=30).shape == (16, 16, 3)
    finally:
        assert engine.close()


@pytest.mark.parametrize("path", GALLERY, ids=[p.name for p in GALLERY])
def test_read_img_matches_pil(path):
    ref = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32)
    got = read_img(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(read_rgb_u8(path, native=False), ref.astype(np.uint8))


def _png_with_filters(img, filters):
    """Encode ``img`` (uint8 HWC) with the given filter type on each row."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    out = bytearray()
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        cur, kind = rows[y], filters[y % len(filters)]
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out += bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur
    colour = {1: 0, 3: 2, 4: 6}[c]

    def chunk(kind, body):
        return (len(body).to_bytes(4, "big") + kind + body
                + (zlib.crc32(kind + body) & 0xFFFFFFFF).to_bytes(4, "big"))

    header = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, colour, 0, 0, 0])
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_all_filters_and_colour_types(tmp_path, channels):
    img = np.random.default_rng(channels).integers(0, 256, (11, 9, channels), dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_png_with_filters(img, [0, 1, 2, 3, 4, 4, 3, 2, 1]))
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)).reshape(img.shape), img)
    expect_rgb = np.repeat(img, 3, axis=2) if channels == 1 else img[:, :, :3]
    np.testing.assert_array_equal(read_img(path), expect_rgb.astype(np.float32))
    np.testing.assert_array_equal(read_rgb_u8(path, native=False), expect_rgb)
    write_png(tmp_path / "w.png", img)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "w.png")).reshape(img.shape), img)


@pytest.mark.parametrize("mode", ["P", "I;16", "LA"])
def test_png_unsupported_kinds_raise(tmp_path, mode):
    """Palette, 16-bit grey and grey+alpha PNGs, once refused, now decode as
    PIL's convert("RGB") gives them, in Python and through the dispatcher."""
    rng = np.random.default_rng(len(mode))
    rgb = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    if mode == "I;16":
        img = Image.fromarray(rng.integers(0, 600, (9, 11)).astype(np.uint16))
    else:
        img = Image.fromarray(rgb).convert(mode) if mode == "LA" else \
            Image.fromarray(rgb).quantize(7)
    path = tmp_path / "u.png"
    img.save(path)
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(as_rgb(read_png(path)), want)
    np.testing.assert_array_equal(read_rgb_u8(path), want)
    np.testing.assert_array_equal(read_img(path), want.astype(np.float32))


def test_png_interlaced_and_bad_input_raise(tmp_path):
    """An Adam7 PNG, once refused, decodes as PIL decodes it; a GIF and a
    float array still raise."""
    path = tmp_path / "i.png"
    img = np.random.default_rng(2).integers(0, 256, (13, 10, 3), dtype=np.uint8)
    data = bytearray(_png_with_filters(img, [0]))
    data[8 + 8 + 12] = 1  # IHDR interlace byte: the same bytes are no longer an image
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        read_png(path)
    path.write_bytes(write_adam7(img, 2, 8, interlace=1))
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(want, img)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(read_rgb_u8(path), img)
    np.testing.assert_array_equal(read_rgb_u8(path, native=False), img)
    path.write_bytes(b"GIF89a")
    with pytest.raises(ValueError):
        read_png(path)
    with pytest.raises(ValueError):
        read_rgb_u8(path)
    with pytest.raises(ValueError):
        write_png(tmp_path / "x.png", np.zeros((2, 2, 3), np.float32))


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "simplesr_tpu", "msgpack", "PIL",
             "yaml", "cv2", "tensorflow", "imageio", "ninja", "h5py", "tf_keras", "keras",
             "tensorboard", "tensorboardX"}
# modules forbidden by their full name: torch's TensorBoard writer needs the
# tensorboard package, which the GPU machine lacks
FORBIDDEN_DOTTED = ("torch.utils.tensorboard",)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{alias.name}" for alias in node.names)


# the GAN family's and the serving surface's modules, each held to the rule
# like every other file
GAN_MODULES = ["models/rrdb.py", "models/discriminator.py", "models/vgg.py",
               "losses/adversarial.py", "losses/vgg_loss.py", "losses/learned_perceptual.py",
               "train/discriminator.py"]
SERVING_MODULES = ["ops/polyphase.py", "models/polyphase.py", "ops/ensemble.py",
                   "ops/pairing.py", "models/paired.py", "eval/evaluation.py",
                   "tools/run_example.py", "tools/upscale.py", "tools/serve.py",
                   "tools/http_gateway.py", "zoo.py", "tools/interpolate.py", "data/png.py"]
TRAINING_SURFACE_MODULES = ["train/distill.py", "config/experiment.py", "tools/supervise.py"]
# the image-input layer, the Keras importer and the Keras exporter
IMAGE_INPUT_MODULES = ["data/image.py", "data/native_loader.py", "data/png.py",
                       "train/_hdf5.py", "tools/import_keras.py", "train/_hdf5_write.py",
                       "tools/export_keras.py"]
# the quality tooling and the BMP decoder it reads
QUALITY_MODULES = ["tools/quality_campaign.py", "tools/quality_check.py", "tools/gan_smoke.py",
                   "tools/standard_benchmarks.py", "data/bmp.py"]
# the image formats PIL opens beside PNG and JPEG: netpbm, ICO and CUR (the
# others are C++)
IMAGE_FORMAT_MODULES = ["data/pnm.py", "data/image.py", "data/bmp.py", "data/pipeline.py",
                        "data/ico.py"]
# the denoising path: the JPEG-noise campaign, the two studies and the
# encoder's binding
DENOISING_MODULES = ["tools/jpg_noise_campaign.py", "tools/ensemble_study.py",
                     "tools/ema_study.py", "data/native_loader.py"]
# the measurement and study tools and the timing harness they share
MEASURE_MODULES = ["tools/bench_timing.py", "tools/bench_trunk_kernel.py",
                   "tools/bench_upsample_tail.py", "tools/bench_rrdb_tail.py",
                   "tools/bench_serve.py", "tools/remat_study.py", "tools/train_roofline.py",
                   "tools/bf16_grad_study.py", "tools/host_assembly_profile.py",
                   "tools/watched_run.py"]
# the TensorBoard event writer and reader, and the config that builds the writers
TENSORBOARD_MODULES = ["utils/tensorboard.py", "config/config_util.py"]
PARALLEL_MODULES = ["parallel/__init__.py", "parallel/mesh.py", "parallel/comm.py",
                    "parallel/fsdp.py", "parallel/spatial.py", "parallel/tensor.py",
                    "parallel/pipeline.py"]


def test_port_imports_only_torch_numpy_and_stdlib():
    files = sorted((ROOT / "simplesr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    assert {ROOT / "simplesr_tpu_torch" / m
            for m in GAN_MODULES + SERVING_MODULES + TRAINING_SURFACE_MODULES
            + PARALLEL_MODULES + IMAGE_INPUT_MODULES + QUALITY_MODULES
            + DENOISING_MODULES + IMAGE_FORMAT_MODULES + MEASURE_MODULES
            + TENSORBOARD_MODULES} <= set(files)
    allowed = set(sys.stdlib_module_names) | {"torch", "numpy", "simplesr_tpu_torch"}
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN and top in allowed, f"{path}: imports {name}"
            assert not any(name == m or name.startswith(m + ".") for m in FORBIDDEN_DOTTED), \
                f"{path}: imports {name}"


def test_host_decoders_include_no_image_library():
    """The host C++ behind the image readers (PNG, JPEG with its arithmetic,
    lossless and smoothing paths, WebP, GIF, TIFF with JPEG strips and YCbCr)
    includes the standard library, zlib and its own header, and no decoder
    library (libjpeg, libpng, libtiff, libwebp, LittleCMS) or Python."""
    sources = sorted((ROOT / "simplesr_tpu_torch/csrc/host").glob("*.[ch]*"))
    assert {p.name for p in sources} >= {"loader.cpp", "tiff.cpp", "formats.h"}
    for path in sources:
        for line in path.read_text().splitlines():
            if line.startswith("#include"):
                header = line.split()[1].strip('<>"')
                assert header in ("zlib.h", "formats.h") or "." not in header, (path, header)


IMPORT_CHECK = """
import sys
import torch
import simplesr_tpu_torch, simplesr_tpu_torch.ops, simplesr_tpu_torch.models
import simplesr_tpu_torch.data, simplesr_tpu_torch.train, simplesr_tpu_torch.losses
import simplesr_tpu_torch.config, simplesr_tpu_torch.eval, simplesr_tpu_torch.tools.serve
import simplesr_tpu_torch.tools.train, simplesr_tpu_torch.parallel
from simplesr_tpu_torch.parallel import (make_mesh, tp_apply, pipeline_apply, leaf_spec,
                                         spatial_sharded_apply)
assert not torch.cuda.is_initialized(), "importing the port initialised CUDA"
assert not torch.distributed.is_initialized(), "importing the port made a process group"
assert "jax" not in sys.modules
print("IMPORT_CLEAN")
"""


def test_importing_the_port_initialises_no_backend():
    """The counterpart of tests/parallel/test_import_no_backend_init.py:
    ``initialize_multihost`` must come first, so importing the port (the
    parallel layer too) initialises neither CUDA nor a process group."""
    r = subprocess.run([sys.executable, "-c", IMPORT_CHECK], capture_output=True, text=True,
                       timeout=300, cwd=ROOT)
    assert r.returncode == 0 and "IMPORT_CLEAN" in r.stdout, r.stdout + r.stderr


@pytest.mark.parametrize("entry", ["upscale_files", "engine", "load_model", "build",
                                   "data_pipeline", "config_from_yaml", "train_tool",
                                   "run_training", "build_rrdb", "discriminator",
                                   "esrgan_generator", "gan_yaml", "serve", "serve_http",
                                   "zoo_load", "run_example", "evaluate_on_testdata",
                                   "engine_fast", "engine_ensemble", "build_distiller",
                                   "supervise", "quality_campaign", "quality_check",
                                   "gan_smoke", "standard_benchmarks",
                                   "jpg_noise_campaign", "ensemble_study", "ema_study"])
def test_entry_points_raise_without_cuda(entry, small_model, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from simplesr_tpu_torch import zoo
    from simplesr_tpu_torch.config import ConfigUtil, _yaml
    from simplesr_tpu_torch.data import DataPipeline
    from simplesr_tpu_torch.eval.evaluation import evaluate_on_testdata
    from simplesr_tpu_torch.models import build_generator_model
    from simplesr_tpu_torch.tools import gan_smoke, quality_campaign, quality_check
    from simplesr_tpu_torch.tools import ema_study, ensemble_study, jpg_noise_campaign
    from simplesr_tpu_torch.tools import standard_benchmarks
    from simplesr_tpu_torch.tools.http_gateway import serve_http
    from simplesr_tpu_torch.tools.run_example import main as run_example_main
    from simplesr_tpu_torch.tools.serve import serve
    from simplesr_tpu_torch.tools.supervise import main as supervise_main
    from simplesr_tpu_torch.tools.train import main as train_main
    from simplesr_tpu_torch.train import Discriminator, Generator, build_distiller, run_training
    from simplesr_tpu_torch.train.serialization import load_model

    spec = _yaml.load(str(ROOT / "examples/training/minimal_example.yaml"))
    spec["general"].update(train_data_paths=str(GALLERY[0].parent),
                           validation_data_path=str(GALLERY[0].parent),
                           results_save_path=str(tmp_path / "results"))
    yaml_path = tmp_path / "run.yaml"
    yaml_path.write_text(_yaml.dump(spec))
    gan = _yaml.load(str(ROOT / "examples/training/esrgan_x4.yaml"))
    gan["general"].update(spec["general"])
    gan_path = tmp_path / "gan.yaml"
    gan_path.write_text(_yaml.dump(gan))
    calls = {"upscale_files": lambda: upscale_files(small_model, [], tmp_path, 2),
             "engine": lambda: SREngine(small_model, 2),
             "load_model": lambda: load_model(small_model),
             "build": lambda: build_generator_model(2),
             "data_pipeline": lambda: DataPipeline(str(GALLERY[0].parent), 4),
             "config_from_yaml": lambda: ConfigUtil.from_yaml(str(yaml_path)),
             "train_tool": lambda: train_main([str(yaml_path)]),
             "run_training": lambda: run_training(*ConfigUtil.from_yaml(str(yaml_path),
                                                                        device="cpu")),
             "build_rrdb": lambda: build_generator_model(4, architecture="rrdb"),
             "discriminator": lambda: Discriminator.initialize_relativistic(),
             "esrgan_generator": lambda: Generator.esrgan_generator(4, num_blocks=1),
             "gan_yaml": lambda: train_main([str(gan_path)]),
             "serve": lambda: serve(small_model, 2, socket_path=str(tmp_path / "sr.sock")),
             "serve_http": lambda: serve_http(small_model, 2, 0),
             "zoo_load": lambda: zoo.load("srresnet_x4"),
             "run_example": lambda: run_example_main([str(inference_path)]),
             "evaluate_on_testdata": lambda: evaluate_on_testdata(ConfigUtil.evaluation_config(
                 str(GALLERY[0].parent), None, [small_model], str(tmp_path / "results"),
                 operation="inference", create_save_dirs=False)),
             "engine_fast": lambda: SREngine(small_model, 2, fast=True),
             "engine_ensemble": lambda: SREngine(small_model, 2, ensemble=True),
             "build_distiller": lambda: build_distiller(small_model),
             "supervise": lambda: supervise_main([str(yaml_path)]),
             "quality_campaign": lambda: quality_campaign.main(fast=True, tiny=True),
             "quality_check": lambda: quality_check.main(steps=1, tiny=True),
             "gan_smoke": lambda: gan_smoke.main(steps=1, tiny=True),
             "standard_benchmarks": lambda: standard_benchmarks.main(
                 ["--data-root", str(sets), "--models", small_model, "--out",
                  str(tmp_path / "results")]),
             "jpg_noise_campaign": lambda: jpg_noise_campaign.main(fast=True),
             "ensemble_study": lambda: ensemble_study.main(["--out", str(tmp_path / "results")]),
             "ema_study": lambda: ema_study.main(["--epochs", "1", "--out",
                                                 str(tmp_path / "results")])}
    sets = tmp_path / "sets"
    (sets / "Set5").mkdir(parents=True)
    shutil.copy(GALLERY[0], sets / "Set5" / GALLERY[0].name)
    inference = {"general": {"operation": "inference", "data_paths": str(GALLERY[0].parent),
                             "test_originals_path": None, "model_paths": [small_model],
                             "results_save_path": str(tmp_path / "results"), "scale": 2}}
    inference_path = tmp_path / "inference.yaml"
    inference_path.write_text(_yaml.dump(inference))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()
    assert not (tmp_path / "results").exists() or entry == "run_training"
    assert not (tmp_path / "sr.sock").exists()


def test_jpeg_encoder_binding_is_host_code():
    """``ssr_encode_jpeg`` (csrc/host/jpeg_encode.cpp) is built into the host
    loader's library with g++, bound through ctypes and freed by
    ``ssr_free``; it compiles no CUDA header and runs without a card."""
    import ctypes

    from simplesr_tpu_torch.data import native_loader

    source = (ROOT / "simplesr_tpu_torch/csrc/host/jpeg_encode.cpp").read_text()
    assert "cuda" not in " ".join(l for l in source.splitlines() if l.startswith("#include"))
    assert native_loader.ENCODER_SOURCE in native_loader.SOURCES
    lib = native_loader.library()
    assert lib.ssr_encode_jpeg.restype is ctypes.c_int and len(lib.ssr_encode_jpeg.argtypes) == 6
    body = native_loader.encode_jpeg(np.zeros((3, 5, 3), np.uint8), 50)
    assert body[:2] == b"\xff\xd8" and body[-2:] == b"\xff\xd9"
    np.testing.assert_array_equal(native_loader.decode_bytes(body), np.zeros((3, 5, 3)))


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script in (ROOT / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                              timeout=120, cwd=script.parent,
                              env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path == _build.library_path()
