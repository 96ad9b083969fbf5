"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked ``cuda``: they skip where torch sees no CUDA device. This file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from simplesr_tpu_torch.ops.kernels import (
    extract_overlapping_patches,
    extract_overlapping_patches_reference,
    TrunkWeights,
    pack_trunk_weights,
    residual_trunk,
    residual_trunk_reference,
)

pytestmark = pytest.mark.cuda

_FLAGSHIP = (Path(__file__).resolve().parents[1]
             / "results/quality_fastrecipe/models/resnet_gen_srresnet_x4_best.msgpack")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _trunk_weights(rng, num_blocks, c, device):
    blocks = []
    for _ in range(num_blocks):
        w1, w2 = (torch.from_numpy(rng.normal(0, 0.05, (c, c, 3, 3)).astype(np.float32))
                  for _ in range(2))
        b1, b2 = (torch.from_numpy(rng.normal(0, 0.1, (c,)).astype(np.float32))
                  for _ in range(2))
        alpha = torch.from_numpy(rng.uniform(0, 0.3, (c,)).astype(np.float32))
        blocks.append((w1, b1, alpha, w2, b2))
    return TrunkWeights(*(t.to(device) for t in pack_trunk_weights(blocks)))


# (1, 1, 1): fewer tiles (4 x 64 px) than SMs; (2, 13, 37) ragged on both
# axes; (3, 200, 260): 3,315 tiles, more than CTAs times stages.
@pytest.mark.parametrize("shape", [(1, 8, 32), (2, 13, 37), (3, 40, 17), (1, 1, 1),
                                   (3, 200, 260)])
def test_trunk_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(0)
    weights = _trunk_weights(rng, 2, 64, cuda)
    x = torch.from_numpy(rng.normal(0, 1, shape + (64,)).astype(np.float32))
    x = x.to(cuda, torch.bfloat16)
    before = residual_trunk.launches
    got = residual_trunk(x, weights).float()
    torch.cuda.synchronize()
    ref = residual_trunk_reference(x, weights).float()
    assert residual_trunk.launches == before + 1
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    assert rel < 1e-2  # one bf16 rounding apart at most, per conv


def test_trunk_kernel_refuses_what_it_cannot_run(cuda):
    weights = _trunk_weights(np.random.default_rng(0), 1, 64, cuda)
    x = torch.zeros((1, 8, 8, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        residual_trunk(x.float(), weights)
    with pytest.raises(ValueError):
        residual_trunk(x, weights._replace(weight=weights.weight[..., :32, :32].contiguous()))
    with pytest.raises(ValueError):
        residual_trunk(x.requires_grad_(), weights)


@pytest.mark.parametrize("shape", [(1, 4, 64), (2, 9, 130)])
@pytest.mark.parametrize("mode", [0, 1])
def test_one_trunk_conv_matches_conv2d(cuda, shape, mode):
    """One conv of the kernel (mode 0: PReLU(conv + b); mode 1: x + conv + b,
    in place) against float32 F.conv2d of the same bf16 values."""
    from simplesr_tpu_torch.ops.kernels import _build
    from simplesr_tpu_torch.ops.kernels.trunk import _oihw, swizzle_trunk_weights

    rng = np.random.default_rng(3)
    weights = _trunk_weights(rng, 1, 64, cuda)
    x = torch.from_numpy(rng.normal(0, 1, shape + (64,)).astype(np.float32))
    x = x.to(cuda, torch.bfloat16)
    prev = torch.from_numpy(rng.normal(0, 1, shape + (64,)).astype(np.float32))
    prev = prev.to(cuda, torch.bfloat16)
    dst = prev.clone()
    image = swizzle_trunk_weights(weights.weight)
    fn = _build.function("ssr_trunk_conv", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                         + [ctypes.c_void_p])
    _build.check(fn(x.data_ptr(), dst.data_ptr(), image[0, mode].data_ptr(),
                    weights.b1[0].data_ptr(), weights.alpha[0].data_ptr(), mode, *shape,
                    torch.cuda.current_stream().cuda_stream), "one trunk conv")
    torch.cuda.synchronize()
    t = F.conv2d(x.permute(0, 3, 1, 2).float(), _oihw(weights.weight[0, mode]), weights.b1[0],
                 padding=1)
    if mode == 0:
        t = torch.where(t >= 0, t, weights.alpha[0].view(1, -1, 1, 1) * t)
    else:
        t = prev.permute(0, 3, 1, 2).float() + t
    ref = t.to(torch.bfloat16).permute(0, 2, 3, 1).float()
    rel = ((dst.float() - ref).abs().max() / ref.abs().max()).item()
    assert rel < 1e-2  # one bf16 rounding apart at most


@pytest.mark.parametrize("size,patch,overlap", [
    ((300, 260, 3), 128, 32),
    ((97, 131, 3), 50, 8),
    ((64, 80, 5), 24, 4),
    ((70, 70, 1), 33, 0),
    # 48-px windows of 3 channels: 144-float rows, but the 399-float image
    # rows leave every other row start off 16 bytes, so one launch takes both
    # the float4 and the 4-byte copies.
    ((101, 133, 3), 40, 4),
])
def test_patch_kernel_bit_exact(cuda, size, patch, overlap):
    rng = np.random.default_rng(1)
    padded = torch.from_numpy(rng.uniform(0, 255, size).astype(np.float32)).to(cuda)
    before = extract_overlapping_patches.launches
    got = extract_overlapping_patches(padded, patch, patch, overlap)
    torch.cuda.synchronize()
    ref = extract_overlapping_patches_reference(padded, patch, patch, overlap)
    assert extract_overlapping_patches.launches == before + 1
    assert got.shape == ref.shape
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", [torch.float16, torch.uint8])
def test_patch_kernel_refuses_other_dtypes(cuda, dtype):
    padded = torch.zeros((40, 40, 3), device=cuda, dtype=dtype)
    with pytest.raises(ValueError):
        extract_overlapping_patches(padded, 16, 16, 4)


def test_model_on_cuda_matches_cpu(cuda):
    from simplesr_tpu_torch.models import build_generator_model

    torch.manual_seed(0)
    cpu = build_generator_model(2, num_blocks=2, num_filters=64, batch_norm=False,
                                dtype="bfloat16", device="cpu")
    with torch.no_grad():
        for block in cpu.blocks:
            block.act.alpha.uniform_(0, 0.3)
    gpu = build_generator_model(2, num_blocks=2, num_filters=64, batch_norm=False,
                                dtype="bfloat16", device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (2, 20, 28, 3))
                         .astype(np.float32))
    before = residual_trunk.launches
    with torch.inference_mode():
        got = gpu(x.to(cuda)).cpu()
        ref = cpu(x)
    assert residual_trunk.launches == before + 1
    assert (got - ref).abs().max().item() < 5e-2  # bf16 convolutions of two libraries


@pytest.mark.parametrize("width", [32, 128])
def test_width_other_than_64_matches_cpu(cuda, width):
    """Widths the kernel does not take run their ResBlocks on CUDA, as on
    the CPU, and launch no trunk kernel."""
    from simplesr_tpu_torch.models import build_generator_model

    torch.manual_seed(0)
    cpu = build_generator_model(2, num_blocks=2, num_filters=width, batch_norm=False,
                                dtype="bfloat16", device="cpu")
    with torch.no_grad():
        for block in cpu.blocks:
            block.act.alpha.uniform_(0, 0.3)
    gpu = build_generator_model(2, num_blocks=2, num_filters=width, batch_norm=False,
                                dtype="bfloat16", device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (2, 20, 28, 3))
                         .astype(np.float32))
    before = residual_trunk.launches
    with torch.inference_mode():
        got = gpu(x.to(cuda)).cpu()
        ref = cpu(x)
    assert residual_trunk.launches == before
    assert (got - ref).abs().max().item() < 5e-2  # bf16 convolutions of two libraries


def _seeded_model(device):
    from simplesr_tpu_torch.models import build_generator_model

    torch.manual_seed(0)
    model = build_generator_model(4, num_blocks=2, num_filters=64, batch_norm=False,
                                  dtype="bfloat16", device="cpu")
    with torch.no_grad():
        for block in model.blocks:
            block.act.alpha.uniform_(0, 0.3)
    return model.to(device).train()


def test_trunk_function_gradients_match_plain(cuda):
    """Gradients through TrunkFunction (the kernel's forward, the plain
    version recomputed in the backward) against autograd straight through
    the plain version, per parameter tensor."""
    model = _seeded_model(cuda)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.uniform(0, 1, (4, 24, 24, 3)).astype(np.float32)).to(cuda)
    hr = torch.from_numpy(rng.uniform(-1, 1, (4, 96, 96, 3)).astype(np.float32)).to(cuda)
    params = list(model.parameters())

    def loss_and_grads():
        loss = ((model(x) - hr) ** 2).mean()
        return loss, torch.autograd.grad(loss, params)

    before = residual_trunk.launches
    loss_k, grads_k = loss_and_grads()
    torch.cuda.synchronize()
    assert residual_trunk.launches == before + 1  # the forward only
    model._trunk = lambda h: residual_trunk_reference(
        h.permute(0, 2, 3, 1), pack_trunk_weights(model._block_parameters())).permute(0, 3, 1, 2)
    loss_p, grads_p = loss_and_grads()
    # bf16: kernel and plain forward round a few activations apart, which
    # reaches every gradient; see chip_smoke.py, TRAIN_GRAD_FRO_TOL
    assert abs(loss_k.item() - loss_p.item()) < 1e-2 * abs(loss_p.item())
    for a, b in zip(grads_k, grads_p):
        assert ((a - b).norm() / b.norm()).item() < 3e-2


def test_grad_enabled_call_equals_inference_mode(cuda):
    model = _seeded_model(cuda).eval()
    x = torch.from_numpy(np.random.default_rng(6).uniform(0, 1, (2, 17, 23, 3))
                         .astype(np.float32)).to(cuda)
    before = residual_trunk.launches
    with_grad = model(x)
    with torch.inference_mode():
        no_grad = model(x)
    assert residual_trunk.launches == before + 2
    assert with_grad.requires_grad
    assert torch.equal(with_grad.detach(), no_grad)


@pytest.mark.parametrize("global_tf32", [False, True])
def test_output_conv_precision_ignores_global_flag(cuda, global_tf32):
    from simplesr_tpu_torch.core.dtypes import OUTPUT_CONV_TF32
    from simplesr_tpu_torch.models import build_generator_model

    torch.manual_seed(0)
    model = build_generator_model(2, num_blocks=1, num_filters=64, batch_norm=False,
                                  dtype="bfloat16", device=cuda)
    x = torch.rand((1, 24, 24, 3), device=cuda)
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = OUTPUT_CONV_TF32
        with torch.inference_mode():
            want = model(x)
        torch.backends.cudnn.allow_tf32 = global_tf32
        with torch.inference_mode():
            got = model(x)
        assert torch.backends.cudnn.allow_tf32 == global_tf32  # restored after the call
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert torch.equal(got, want)


def test_kernel_images_do_not_pile_up_in_training(cuda):
    """Each step packs new trunk weights; their swizzled images are dropped
    with them, so the image cache does not grow step by step."""
    from simplesr_tpu_torch.ops.kernels.trunk import _images
    from simplesr_tpu_torch.train import Generator, SRModel

    gen = Generator.srresnet(4, num_blocks=2, num_filters=64, batch_norm=False, device=cuda)
    model = SRModel("resnet", gen, "Adam", {"learning_rate": 1e-4}, device=cuda)
    rng = np.random.default_rng(7)
    lr = rng.uniform(0, 1, (2, 12, 12, 3)).astype(np.float32)
    hr = rng.uniform(-1, 1, (2, 48, 48, 3)).astype(np.float32)
    model.train_step(lr, hr)
    held = len(_images)
    before = residual_trunk.launches
    for _ in range(5):
        model.train_step(lr, hr)
    torch.cuda.synchronize()
    assert residual_trunk.launches == before + 5
    assert len(_images) <= held


@pytest.mark.parametrize("resident", ["auto", False])
def test_pipeline_on_cuda_matches_cpu(cuda, resident):
    """The production recipe's pipeline (flips, 90 degree turns, 96 x 96
    crops, x4) for one seed: its first 3 training batches on the card
    against the CPU, HR bit-equal, LR max abs < 1e-4 on [0, 1]."""
    from pathlib import Path

    from simplesr_tpu_torch.data import DataPipeline

    gallery = str(Path(__file__).resolve().parents[1] / "data/corpus/gallery")
    kw = dict(hr_img_path=gallery, scale=4, train_val_split=0.05, batch_size=16,
              augmentations=["flip_along_x", "flip_along_y", "rotate90"],
              crop_size=(96, 96, 3), num_crops=16, random_seed=0,
              device_resident=resident)
    batches = {}
    for device in ("cpu", "cuda"):
        it = DataPipeline(device=device, **kw).train_batch_generator()
        batches[device] = [next(it) for _ in range(3)]
    for (cl, ch), (gl, gh) in zip(batches["cpu"], batches["cuda"]):
        assert gh.device.type == "cuda" and gh.shape == (16, 96, 96, 3)
        assert torch.equal(gh.cpu(), ch)
        assert (gl.cpu() - cl).abs().max().item() < 1e-4


@pytest.mark.parametrize("global_tf32", [False, True])
def test_vgg_runs_in_float32_whatever_the_global_flag(cuda, global_tf32):
    """The VGG taps and their gradient run with TF32 off whatever cuDNN's
    global flag says (the JAX package's precision="highest"), and leave the
    flag as they found it: both within 1e-5 of float64 on the CPU (relative
    Frobenius; TF32's 10-bit mantissa would part by about 1e-3)."""
    from simplesr_tpu_torch.models.vgg import VGGFeatures, init_vgg_params
    from simplesr_tpu_torch.train.convert import from_flax_variables

    module = VGGFeatures("vgg19", ("block2_conv2", "block3_conv4"))
    module.load_state_dict(from_flax_variables(module, init_vgg_params()))
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(0)) * 255.0

    def taps_and_grad(m, x):
        x = x.clone().requires_grad_(True)
        taps = m(x)
        grad, = torch.autograd.grad(sum(t.square().mean() for t in taps.values()), x)
        return taps["block3_conv4"].detach(), grad

    want = taps_and_grad(module.double(), x.double())
    saved = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = global_tf32
        got = taps_and_grad(module.float().to(cuda), x.to(cuda))
        assert torch.backends.cudnn.allow_tf32 == global_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for g, w in zip(got, want):
        assert ((g.cpu().double() - w).norm() / w.norm()).item() < 1e-5


def test_rrdb_and_critic_on_cuda_match_cpu(cuda):
    """A float32 RRDB x4 and a critic at 32 x 48 on the card against the
    CPU: 1e-4 (float32 convolutions summed in other orders; the generator's
    output conv with TF32, as the model sets it); no kernel launches."""
    from simplesr_tpu_torch.models import Discriminator, build_generator_model

    torch.manual_seed(0)
    rrdb = build_generator_model(4, architecture="rrdb", num_blocks=2, num_filters=16,
                                 dtype="float32", device="cpu")
    critic = Discriminator(num_filters=8, dtype=torch.float32, input_dims=(32, 48)).eval()
    x = torch.rand((2, 8, 12, 3))
    with torch.inference_mode():
        want = rrdb(x), critic(x.repeat_interleave(4, 1).repeat_interleave(4, 2))
    before = residual_trunk.launches
    rrdb, critic = rrdb.to(cuda), critic.to(cuda)
    with torch.inference_mode():
        got = rrdb(x.to(cuda)), critic(x.to(cuda).repeat_interleave(4, 1).repeat_interleave(4, 2))
    torch.cuda.synchronize()
    assert residual_trunk.launches == before
    assert (got[0].cpu() - want[0]).abs().max().item() < 1e-2  # TF32 output conv on the card
    assert (got[1].cpu() - want[1]).abs().max().item() < 1e-4


def test_gan_step_on_cuda_matches_cpu(cuda, monkeypatch):
    """One SRGAN step (float32 SRResNet, MSE + adversarial, the standard
    critic) on the card against the CPU from the same weights and batch,
    TF32 off everywhere (the critic's input gradient amplifies rounding, so
    TF32's would show): parameters of both networks to 1e-4 after one SGD
    step."""
    import copy

    from simplesr_tpu_torch.losses import AdversarialLoss, MeanSquaredError
    from simplesr_tpu_torch.models import srresnet
    from simplesr_tpu_torch.train import Discriminator, Generator, SRModel

    monkeypatch.setattr(srresnet, "OUTPUT_CONV_TF32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)

    models = {}
    for device in ("cpu", cuda):
        torch.manual_seed(0)
        gen = Generator.srresnet(4, loss_function=[MeanSquaredError(), AdversarialLoss(
            weighted=True, loss_weight=1e-3)], num_blocks=2, num_filters=16, batch_norm=False,
            dtype="float32", device="cpu")
        disc = Discriminator.initialize_standard(num_filters=8, input_dims=(32, 32),
                                                 dtype="float32", device="cpu")
        models[str(device)] = SRModel("gan", gen.to(device), "SGD", {"learning_rate": 0.05},
                                      disc.to(device), "SGD", {"learning_rate": 0.05},
                                      device=device)
    rng = np.random.default_rng(3)
    lr = rng.uniform(0, 1, (2, 8, 8, 3)).astype(np.float32)
    hr = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    for model in models.values():
        model.train_step(lr, hr)
    cpu, card = models["cpu"], models[str(cuda)]
    for part in (lambda m: m.generator(), lambda m: m.discriminator_wrapper().model()):
        want = copy.deepcopy(part(cpu).state_dict())
        for k, v in part(card).state_dict().items():
            assert (v.cpu().float() - want[k].float()).abs().max().item() < 1e-4, k


@pytest.mark.parametrize("option", [{}, {"fast": False}, {"ensemble": True}, {"paired": 2},
                                    {"paired": 2, "fast": False}])
def test_serving_forms_on_cuda_match_cpu(cuda, tmp_path, option):
    """The predictor's serving forms of a BN-free bf16 SRResNet of 64
    filters on the card against the CPU: the trunk kernel on the polyphase
    form and the training form (one launch a call, two under the ensemble),
    none on the paired trunk (128 wide)."""
    from simplesr_tpu_torch.eval.evaluation import _as_predictor
    from simplesr_tpu_torch.models import build_generator_model
    from simplesr_tpu_torch.train import save_model, to_flax_variables

    torch.manual_seed(0)
    cpu = build_generator_model(4, num_blocks=2, num_filters=64, batch_norm=False,
                                dtype="bfloat16", device="cpu")
    with torch.no_grad():
        for block in cpu.blocks:
            block.act.alpha.uniform_(0, 0.3)
    path = tmp_path / "m.msgpack"
    save_model({"upsample_factor": 4, "architecture": "srresnet", "num_blocks": 2,
                "num_filters": 64, "batch_norm": False, "dtype": "bfloat16"},
               to_flax_variables(cpu.state_dict()), path)
    x = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (3, 20, 28, 3))
                         .astype(np.float32))
    before = residual_trunk.launches
    got = _as_predictor(path, device=cuda, **option)(x.to(cuda)).cpu()
    launches = residual_trunk.launches - before
    ref = _as_predictor(path, device="cpu", **option)(x)
    assert launches == (0 if option.get("paired") else 2 if option.get("ensemble") else 1)
    assert (got - ref).abs().max().item() < 5e-2  # bf16 convolutions of two libraries


def test_daemon_on_cuda_answers_a_request(cuda, tmp_path, monkeypatch):
    import threading

    from simplesr_tpu_torch.data.png import encode_png
    from simplesr_tpu_torch.tools import serve

    monkeypatch.chdir(tmp_path)  # a short, relative socket path
    ready, stop = threading.Event(), threading.Event()
    thread = threading.Thread(target=serve.serve, daemon=True, args=(str(_FLAGSHIP), 4),
                              kwargs=dict(socket_path="sr.sock", ready_event=ready,
                                          stop_event=stop, device=cuda))
    thread.start()
    try:
        assert ready.wait(120)
        img = np.random.default_rng(0).integers(0, 256, (24, 20, 3), dtype=np.uint8)
        with serve.SRClient("sr.sock") as client:
            out = client.upscale_bytes(encode_png(img))
        assert out.shape == (96, 80, 3) and out.dtype == np.uint8
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not thread.is_alive()
