"""Model family: SRResNet, RRDB (ESRGAN), the discriminator and VGG
features; the polyphase and paired serving forms of the generators."""

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.core.dtypes import dtype_from_name
from simplesr_tpu_torch.models.blocks import ConvLayer, PReLU, SubpixelConvBlock
from simplesr_tpu_torch.models.discriminator import Discriminator
from simplesr_tpu_torch.models.paired import (RRDBNetPaired, SRResNetPaired,
                                              SRResNetPairedPolyphase)
from simplesr_tpu_torch.models.polyphase import (RRDBNetPolyphase, SRResNetPolyphase,
                                                 fast_inference)
from simplesr_tpu_torch.models.rrdb import DenseBlock, RRDBBlock, RRDBNet
from simplesr_tpu_torch.models.srresnet import ResBlock, SRResNet
from simplesr_tpu_torch.models.vgg import (VGGFeatures, init_vgg_params, load_vgg_weights_npz,
                                           vgg_layer_names)


def build_generator_model(upsample_factor, architecture="srresnet", num_blocks=16,
                          num_filters=64, kernel_size=3, residual_scaling=0.2,
                          batch_norm=True, num_convs=4, num_dense_blocks=3,
                          dtype=None, growth_channels=None, remat=False,
                          device="cuda"):
    """Build a generator from a saved model's config, in eval mode, on
    ``device``. Takes the same keys as simplesr_tpu's builder. ``remat``
    recomputes each RRDB block or SRResNet ResBlock in the backward
    (``blocks.checkpointed``); an SRResNet whose trunk runs the kernel
    recomputes in ``TrunkFunction``'s backward whatever the flag says."""
    device = resolve_device(device)
    dtype = dtype_from_name(dtype)
    if architecture == "rrdb":
        module = RRDBNet(upsample_factor=upsample_factor, num_filters=num_filters,
                         num_rrdb_blocks=num_blocks, num_dense_blocks=num_dense_blocks,
                         num_convs=num_convs, kernel_size=kernel_size,
                         residual_scaling=residual_scaling, dtype=dtype,
                         growth_channels=growth_channels, remat=remat)
    elif architecture == "srresnet":
        module = SRResNet(upsample_factor=upsample_factor, num_filters=num_filters,
                          num_res_blocks=num_blocks, batch_norm=batch_norm, dtype=dtype,
                          remat=remat)
    else:
        raise ValueError("architecture not recognized")
    return module.to(device).eval()


__all__ = ["SRResNet", "ResBlock", "RRDBNet", "RRDBBlock", "DenseBlock", "Discriminator",
           "VGGFeatures", "vgg_layer_names", "load_vgg_weights_npz", "init_vgg_params",
           "PReLU", "ConvLayer", "SubpixelConvBlock", "build_generator_model",
           "SRResNetPolyphase", "RRDBNetPolyphase", "SRResNetPaired", "SRResNetPairedPolyphase",
           "RRDBNetPaired", "fast_inference"]
