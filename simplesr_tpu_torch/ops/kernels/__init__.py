"""Hand-written CUDA kernels for the H100, each beside its plain PyTorch
version. A wrapper takes the plain version for a tensor on the CPU and
launches its kernel for a tensor on a CUDA device; ``wrapper.launches``
counts the launches."""

from simplesr_tpu_torch.ops.kernels.patches import (
    extract_overlapping_patches,
    extract_overlapping_patches_reference,
)
from simplesr_tpu_torch.ops.kernels.trunk import (
    TrunkFunction,
    TrunkWeights,
    pack_trunk_weights,
    residual_trunk,
    residual_trunk_reference,
)

WRAPPERS = (residual_trunk, extract_overlapping_patches)

__all__ = [
    "TrunkFunction",
    "TrunkWeights",
    "pack_trunk_weights",
    "residual_trunk",
    "residual_trunk_reference",
    "extract_overlapping_patches",
    "extract_overlapping_patches_reference",
    "WRAPPERS",
]
