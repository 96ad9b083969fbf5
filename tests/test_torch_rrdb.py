"""The port's RRDB generator against simplesr_tpu's: x2, x4 and x8 at a
small size with the default and an explicit growth width, ``remat``, the
committed RRDB and GAN model files at full width, and the upscale tool on
the tiled route of an RRDB file against its untiled output."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplesr_tpu.models import build_generator_model as jax_build
from simplesr_tpu.train.generator import Generator as JaxGenerator
from simplesr_tpu.train.serialization import load_model as jax_load_model
from simplesr_tpu.train.serialization import load_payload as jax_load_payload
from simplesr_tpu.train.serialization import save_model as jax_save_model
from simplesr_tpu_torch.data.image import read_img
from simplesr_tpu_torch.data.png import read_png, write_png
from simplesr_tpu_torch.eval.evaluation import _as_predictor, _upscale
from simplesr_tpu_torch.models import RRDBNet, build_generator_model
from simplesr_tpu_torch.tools.upscale import upscale_files
from simplesr_tpu_torch.train import Generator
from simplesr_tpu_torch.train.convert import from_flax_variables, to_flax_variables
from simplesr_tpu_torch.train.serialization import load_model

ROOT = Path(__file__).resolve().parents[1]
MODELS = ROOT / "results/quality_r5/models"
RRDB_FILES = [MODELS / "resnet_gen_rrdb_x4_best.msgpack",
              MODELS / "gan_gen_esrgan_x4_final.msgpack"]
SRGAN_FILE = MODELS / "gan_gen_srgan_x4_final.msgpack"


def _flat(variables):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(variables)}


def _run(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("scale", [2, 4, 8])
@pytest.mark.parametrize("growth", [None, 12], ids=["growth_default", "growth_12"])
def test_rrdb_matches_flax(scale, growth):
    """Float32, 2 RRDB blocks of 3 dense blocks x 4 convs, 8 filters: output
    to 1e-5 of flax's, the parameter tree bit-equal both ways."""
    cfg = dict(upsample_factor=scale, architecture="rrdb", num_blocks=2, num_filters=8,
               dtype="float32", growth_channels=growth)
    ref_module = jax_build(**cfg)
    x = np.random.default_rng(scale).uniform(0, 1, (2, 6, 7, 3)).astype(np.float32)
    variables = ref_module.init(jax.random.key(0), jnp.zeros((1, 6, 7, 3)))
    ref = np.asarray(ref_module.apply(variables, jnp.asarray(x)))
    module = build_generator_model(**cfg, device="cpu")
    module.load_state_dict(from_flax_variables(module, variables))
    got = _run(module, x)
    assert got.shape == ref.shape == (2, 6 * scale, 7 * scale, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    back, want = _flat(to_flax_variables(module.state_dict())), _flat(jax.device_get(variables))
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    conv = module.RRDBBlock_1.DenseBlock_2.Conv_3
    assert conv.weight.shape[:2] == ((growth or 4), 8 + 3 * (growth or 4))


def test_remat_gives_the_same_gradients():
    """``remat=True`` recomputes each RRDB block in the backward
    (torch.utils.checkpoint): the same output and gradients, bit for bit."""
    cfg = dict(upsample_factor=2, architecture="rrdb", num_blocks=2, num_filters=8,
               dtype="float32")
    plain = build_generator_model(**cfg, device="cpu")
    remat = build_generator_model(**cfg, remat=True, device="cpu")
    remat.load_state_dict(plain.state_dict())
    x = torch.rand((1, 6, 6, 3), generator=torch.Generator().manual_seed(0))
    grads = []
    for module in (plain, remat):
        module.train()
        out = module(x)
        grads.append(torch.autograd.grad(out.square().mean(), list(module.parameters())))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("path", RRDB_FILES, ids=lambda p: p.name)
def test_committed_rrdb_files_match_flax(path):
    """The committed 8-block, 64-filter bf16 RRDB files on a 12 x 16 image:
    within 0.15 max and 1e-2 mean of flax on [-1, 1], and no further from
    the float32 model than flax's own bf16 output is (mean, up to 1.5x):
    each of the 120 dense convs rounds to bf16, at other points in the two
    libraries. In float32 both agree to 1e-4."""
    module, variables = jax_load_model(path)
    config, _ = jax_load_payload(path)
    port = load_model(path, device="cpu")
    assert isinstance(port, RRDBNet) and config["num_blocks"] == 8
    x = np.random.default_rng(0).uniform(0, 1, (1, 12, 16, 3)).astype(np.float32)
    ref = np.asarray(module.apply(variables, jnp.asarray(x)))
    got = _run(port, x)
    f32 = dict(config, dtype="float32")
    ref32 = np.asarray(jax_build(**f32).apply(variables, jnp.asarray(x)))
    port32 = build_generator_model(**f32, device="cpu")
    port32.load_state_dict(from_flax_variables(port32, variables))
    diff = np.abs(got - ref)
    assert diff.max() < 0.15 and diff.mean() < 1e-2, (diff.max(), diff.mean())
    assert np.abs(got - ref32).mean() <= 1.5 * np.abs(ref - ref32).mean()
    np.testing.assert_allclose(_run(port32, x), ref32, rtol=0, atol=1e-4)


def test_esrgan_recipe_generator_matches_flax_on_a_gallery_crop():
    """The generator of examples/training/esrgan_x4.yaml (16 RRDB x 64,
    bf16) from a seeded init, on the 32 x 40 gallery crop that chip_smoke.py
    phase 10 serves on the card and the CPU: the port within 5e-4 max abs of
    flax on [-1, 1] (read: 9.8e-5; phase 10 holds the card against the CPU
    to the same bound, both being two summation orders of one bf16 model)."""
    cfg = dict(upsample_factor=4, architecture="rrdb", num_blocks=16, num_dense_blocks=3,
               num_convs=4, num_filters=64, residual_scaling=0.2)
    x = (read_img(ROOT / "data/corpus/gallery/gt_3.png")[:32, :40] / 255.0)[None]
    x = x.astype(np.float32)
    module = jax_build(**cfg)
    variables = module.init(jax.random.key(0), jnp.zeros((1, 32, 40, 3)))
    port = build_generator_model(**cfg, device="cpu")
    port.load_state_dict(from_flax_variables(port, variables))
    diff = np.abs(_run(port, x) - np.asarray(module.apply(variables, jnp.asarray(x))))
    assert diff.max() < 5e-4, diff.max()


def test_committed_srgan_file_matches_flax():
    """The committed SRGAN generator (BN-free 16 x 64 bf16 SRResNet) loads
    through load_model onto the trunk kernel's path: 0.1 max and 1e-2 mean
    on [-1, 1], as the flagship's bf16 bound in test_torch_srresnet."""
    module, variables = jax_load_model(SRGAN_FILE)
    port = load_model(SRGAN_FILE, device="cpu")
    assert port.uses_trunk_kernel
    x = np.random.default_rng(1).uniform(0, 1, (1, 12, 16, 3)).astype(np.float32)
    diff = np.abs(_run(port, x) - np.asarray(module.apply(variables, jnp.asarray(x))))
    assert diff.max() < 0.1 and diff.mean() < 1e-2, (diff.max(), diff.mean())


def test_generator_factories_load_committed_files():
    """The port's factories take the architecture from a pretrained file, as
    the JAX package does, and their module_config is the file's."""
    gen = Generator.esrgan_generator(4, pretrained_model_path=RRDB_FILES[1], device="cpu")
    assert isinstance(gen.model(), RRDBNet)
    assert gen.module_config() == jax_load_payload(RRDB_FILES[1])[0]
    assert [f.name for f in gen._loss_functions] == \
        ["mean_absolute_error", "ra_adversarial_loss", "vgg_loss"]
    srgan = Generator.srgan_generator(4, batch_norm=True, pretrained_model_path=SRGAN_FILE,
                                      device="cpu")
    assert srgan.model().uses_trunk_kernel
    assert srgan.module_config()["batch_norm"] is False
    ref = JaxGenerator.srgan_generator(4, batch_norm=True, pretrained_model_path=str(SRGAN_FILE))
    assert [type(f).__name__ for f in srgan._loss_functions] == \
        [type(f).__name__ for f in ref.loss_functions()]
    rrdb = Generator.rrdb(2, num_blocks=1, num_filters=8, device="cpu")
    assert rrdb.module_config()["architecture"] == "rrdb"
    assert [f.name for f in rrdb._loss_functions] == ["mean_absolute_error"]


def test_upscale_files_tiled_rrdb_matches_untiled(tmp_path):
    """A small float32 RRDB x2 file (1 block, 4 filters; its receptive field,
    8 LR px, is far inside the 32 px overlap): upscale_files sends an LR PNG
    over 1000 x 1000 through the tiled route with the patch step, and away
    from the image's edges (16 HR px, where the route's zero padding of the
    image and each conv's own zero padding differ) its output equals the
    untiled forward of the same image to 1e-5 (truncated to uint8 alike, at
    most 1 level apart); flax's untiled output agrees to 1e-4."""
    jgen = JaxGenerator.rrdb(2, num_blocks=1, num_dense_blocks=1, num_convs=2, num_filters=4,
                             dtype=jnp.float32, input_dims=(8, 8))
    path = str(tmp_path / "rrdb_x2.msgpack")
    jax_save_model(jgen.module_config(), jgen.variables, path)
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (1003, 1001, 3), dtype=np.uint8)
    src = tmp_path / "big.png"
    write_png(src, img)
    (out,) = upscale_files(path, [src], tmp_path / "out", 2, device="cpu")
    tiled = read_png(out).astype(np.int16)
    x = torch.from_numpy(img.astype(np.float32) / 255.0)[None]
    predict = _as_predictor(path, device="cpu")
    direct = predict(x)[0].numpy()
    inner = (slice(16, -16), slice(16, -16))
    np.testing.assert_allclose(_upscale(predict, x, 2)[0].numpy()[inner], direct[inner],
                               rtol=0, atol=1e-5)
    want = np.clip((direct + 1.0) * 127.5, 0, 255).astype(np.uint8).astype(np.int16)
    assert tiled.shape == (2006, 2002, 3)
    assert np.abs(tiled - want)[inner].max() <= 1
    crop = img[:40, :56].astype(np.float32)[None] / 255.0
    module, variables = jax_load_model(path)
    np.testing.assert_allclose(predict(torch.from_numpy(crop)).numpy(),
                               np.asarray(module.apply(variables, jnp.asarray(crop))),
                               rtol=0, atol=1e-4)
