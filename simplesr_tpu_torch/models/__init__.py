"""Model family. SRResNet is ported; RRDB/ESRGAN, the discriminator and VGG
features are not yet (ROADMAP.md, Queue 1)."""

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.core.dtypes import dtype_from_name
from simplesr_tpu_torch.models.blocks import ConvLayer, PReLU, SubpixelConvBlock
from simplesr_tpu_torch.models.srresnet import ResBlock, SRResNet


def build_generator_model(upsample_factor, architecture="srresnet", num_blocks=16,
                          num_filters=64, kernel_size=3, residual_scaling=0.2,
                          batch_norm=True, num_convs=4, num_dense_blocks=3,
                          dtype=None, growth_channels=None, remat=False,
                          device="cuda"):
    """Build a generator from a saved model's config, in eval mode, on
    ``device``. Takes the same keys as simplesr_tpu's builder; the RRDB keys
    are accepted and unused until RRDB is ported, and ``remat`` (memory
    against recompute in the backward) changes nothing: the kernel's trunk
    recomputes in its backward anyway, and other models store their
    activations."""
    device = resolve_device(device)
    if architecture == "rrdb":
        raise NotImplementedError(
            "RRDB / ESRGAN is not ported yet: ROADMAP.md, Queue 1, GAN and RRDB family")
    if architecture != "srresnet":
        raise ValueError("architecture not recognized")
    module = SRResNet(upsample_factor=upsample_factor, num_filters=num_filters,
                      num_res_blocks=num_blocks, batch_norm=batch_norm,
                      dtype=dtype_from_name(dtype))
    return module.to(device).eval()

__all__ = ["SRResNet", "ResBlock", "PReLU", "ConvLayer", "SubpixelConvBlock",
           "build_generator_model"]
