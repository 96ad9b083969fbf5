"""Rank body of tests/test_torch_parallel_spatial.py: spatially-sharded
inference of the port on a gloo group of the CPU."""

import torch
import torch.nn.functional as F

from simplesr_tpu_torch.models.polyphase import polyphase_model
from simplesr_tpu_torch.parallel import (DATA_AXIS, SPATIAL_AXIS, halo_exchange, make_mesh,
                                         spatial_sharded_apply, spatial_sharded_apply_batched)
from simplesr_tpu_torch.parallel.mesh import axis_group
from simplesr_tpu_torch.train.serialization import load_model


def blur_up(x):
    """A 3x3 box blur, then nearest x2: receptive field 1."""
    c = x.shape[-1]
    k = torch.full((c, 1, 3, 3), 1.0 / 9.0)
    y = F.conv2d(x.permute(0, 3, 1, 2), k, padding=1, groups=c).permute(0, 2, 3, 1)
    return y.repeat_interleave(2, 1).repeat_interleave(2, 2)


def body(rank, world, workdir, inputs):
    out = {}
    sp = make_mesh({SPATIAL_AXIS: world})
    x = torch.from_numpy(inputs["ring"])
    rows = x.shape[0] // world
    out["halo"] = halo_exchange(x[rank * rows:(rank + 1) * rows], 2,
                                axis_group(sp, SPATIAL_AXIS)).numpy()
    with torch.no_grad():
        out["local"] = spatial_sharded_apply(blur_up, inputs["blur_img"], sp, 2, halo=2).numpy()
        module = load_model(inputs["gen"], device="cpu")
        img = torch.from_numpy(inputs["img"])
        out["srresnet"] = spatial_sharded_apply(module, img, sp, 2, halo=16).numpy()
        poly, _ = polyphase_model(module)
        out["polyphase"] = spatial_sharded_apply(poly, img, sp, 2, halo=16).numpy()
        two = make_mesh({DATA_AXIS: 2, SPATIAL_AXIS: world // 2})
        out["batched"] = spatial_sharded_apply_batched(
            module, torch.from_numpy(inputs["imgs"]), two, 2, halo=16).numpy()
    errors = {}
    for key, call in (
            ("height", lambda: spatial_sharded_apply(blur_up, torch.zeros(30, 16, 3), sp, 2, 2)),
            ("batch", lambda: spatial_sharded_apply_batched(blur_up, torch.zeros(3, 64, 16, 3),
                                                            two, 2, halo=2)),
            ("batched_height", lambda: spatial_sharded_apply_batched(
                blur_up, torch.zeros(2, 31, 16, 3), two, 2, halo=2))):
        try:
            call()
        except ValueError as e:
            errors[key] = str(e)
    out["errors"] = errors
    return out
