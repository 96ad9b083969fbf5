"""Mixed-precision policy, as simplesr_tpu.core.dtypes: parameters and
outputs in float32, convolutions in bfloat16 unless a model says otherwise."""

import contextlib
import dataclasses
import threading

import torch

# The generators' float32 output conv runs with TF32 on a CUDA device (inputs
# rounded to a 10-bit mantissa, float32 sums), whatever torch's global flags
# say, forward and backward. That is finer than the JAX package's float32 conv
# at its default precision on a TPU (one bfloat16 pass), and well under one
# uint8 level of the [-1, 1] output. The trunk's backward, which recomputes
# its plain version in float32 convolutions of bf16 values, runs at the same
# setting: TF32 holds bf16 operands exactly, and its gradients are rounded to
# bf16 at every activation.
OUTPUT_CONV_TF32 = True

_CUDNN_FLAG_LOCK = threading.RLock()  # a nested context restores its own value


@contextlib.contextmanager
def cudnn_tf32(device, enabled):
    """On a CUDA device, cuDNN's TF32 flag set to ``enabled`` for the
    convolutions launched inside. The flag is global and read when a conv is
    launched, so a lock keeps two threads from restoring each other's value.
    Elsewhere, nothing."""
    if torch.device(device).type != "cuda":
        yield
        return
    with _CUDNN_FLAG_LOCK:
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = enabled
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = saved


def model_conv_precision(device):
    """``cudnn_tf32`` at the generators' ``OUTPUT_CONV_TF32``."""
    return cudnn_tf32(device, OUTPUT_CONV_TF32)


@dataclasses.dataclass(frozen=True)
class Policy:
    """Dtypes of parameters, of the convolutions, and of model outputs."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, x):
        return x.to(self.compute_dtype)

    def cast_to_output(self, x):
        return x.to(self.output_dtype)


def default_policy(mixed=True):
    """bf16 compute by default; all float32 when ``mixed=False``."""
    if mixed:
        return Policy()
    return Policy(compute_dtype=torch.float32)


def dtype_from_name(name):
    """A model config's dtype name (``"bfloat16"``, ``"float32"``) or None
    (the policy's compute dtype) as a ``torch.dtype``."""
    if name is None:
        return default_policy().compute_dtype
    if isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype
