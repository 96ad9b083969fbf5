"""simplesr_tpu_torch: the PyTorch and CUDA port of simplesr_tpu, for an
NVIDIA H100.

It serves the models that simplesr_tpu trains and trains SRResNet in ResNet
mode: model files are read and written without JAX, the SRResNet runs in
PyTorch, and the two hot spots that simplesr_tpu wrote as Pallas TPU kernels
(the residual trunk, also under autograd, and the overlapping patch
extraction of tiled inference) run as CUDA kernels built from ``csrc/`` at
first use. The layout mirrors simplesr_tpu's (``core``,
``models``, ``ops``, ``train``, ``eval``, ``tools``, ``data``) so that each
module's counterpart is found under the same name.

It imports torch, numpy and the standard library only. Entry points run on
the GPU (``device="cuda"``) unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
