"""The trunk kernel's weight image (``swizzle_trunk_weights``) read back the
way the kernel addresses it, on the flagship's weights and a seeded set."""

from pathlib import Path

import numpy as np
import pytest
import torch

from simplesr_tpu_torch.ops.kernels import pack_trunk_weights
from simplesr_tpu_torch.ops.kernels.trunk import (TAP_BYTES, _images, _kernel_image,
                                                  swizzle_trunk_weights)
from simplesr_tpu_torch.train.serialization import load_model

ROOT = Path(__file__).resolve().parents[1]
FLAGSHIP = ROOT / "results/quality_fastrecipe/models/resnet_gen_srresnet_x4_best.msgpack"


def kernel_offset(out_channel, in_channel):
    """Element offset in a tap's 8 KB at which csrc/trunk.cu finds weight
    (in, out): wgmma's B row n is the accumulator column 8i + 2q + e that
    thread q's epilogue writes as channel 16q + 2i + e, and the 16-byte
    chunk j of a 128-byte row n sits at chunk j ^ (n & 7)."""
    q, rest = divmod(out_channel, 16)
    i, e = divmod(rest, 2)
    n = 8 * i + 2 * q + e
    return n * 64 + ((in_channel // 8) ^ (n & 7)) * 8 + in_channel % 8


def read_back(image):
    """The logical (..., 9, C_in, C_out) weights, element by element."""
    flat = image.reshape(-1, 9, 64 * 64)
    out = torch.empty(flat.shape[0], 9, 64, 64, dtype=image.dtype)
    for cin in range(64):
        for cout in range(64):
            out[:, :, cin, cout] = flat[:, :, kernel_offset(cout, cin)]
    return out.reshape(image.shape)


def seeded_weights(num_blocks):
    rng = np.random.default_rng(11)
    blocks = []
    for _ in range(num_blocks):
        w1, w2 = (torch.from_numpy(rng.normal(0, 0.05, (64, 64, 3, 3)).astype(np.float32))
                  for _ in range(2))
        b1, b2, alpha = (torch.from_numpy(rng.normal(0, 0.1, (64,)).astype(np.float32))
                         for _ in range(3))
        blocks.append((w1, b1, alpha, w2, b2))
    return pack_trunk_weights(blocks)


@pytest.fixture(scope="module", params=["flagship", "seeded_2_blocks"])
def weights(request):
    if request.param == "flagship":
        return load_model(FLAGSHIP, device="cpu").trunk_weights()
    return seeded_weights(2)


def test_image_reads_back_as_the_logical_weights(weights):
    assert torch.equal(read_back(swizzle_trunk_weights(weights.weight)), weights.weight)


def test_image_is_a_permutation_of_each_tap(weights):
    image = swizzle_trunk_weights(weights.weight)
    assert image.shape == weights.weight.shape
    assert image.dtype == torch.bfloat16
    per_conv = image[0, 0].numel() * image.element_size()
    assert per_conv == 9 * TAP_BYTES == 73_728
    taps = weights.weight.reshape(-1, 64 * 64).view(torch.int16)
    image = image.reshape(-1, 64 * 64).view(torch.int16)
    assert torch.equal(taps.sort(dim=1).values, image.sort(dim=1).values)


def test_offsets_are_a_bijection():
    offsets = {kernel_offset(o, i) for o in range(64) for i in range(64)}
    assert offsets == set(range(64 * 64))


def test_swizzle_refuses_other_widths():
    with pytest.raises(ValueError):
        swizzle_trunk_weights(torch.zeros((1, 2, 9, 32, 32), dtype=torch.bfloat16))


def test_kernel_image_is_built_once_per_weight_tensor():
    weight = seeded_weights(1).weight
    image = _kernel_image(weight)
    assert _kernel_image(weight) is image
    weight.mul_(2)  # written in place: built again
    assert torch.equal(_kernel_image(weight), swizzle_trunk_weights(weight))
    key = id(weight)
    del weight
    assert key not in _images
