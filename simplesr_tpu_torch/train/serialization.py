"""Model files, as simplesr_tpu.train.serialization: the format that both
packages read and write.

A model file is one msgpack map ``{"config": json, "variables": bytes}``,
where the variables are flax's msgpack encoding of the
``{"params": ..., "batch_stats": ...}`` tree. ``save_model`` writes the
bytes that flax writes for the same tree. A path may be a ``zoo:<name>``
spec, the committed zoo model of that name (``simplesr_tpu_torch.zoo``).
"""

import json
import os

from simplesr_tpu_torch.train._msgpack import packb, unpackb
from simplesr_tpu_torch.train.convert import _sorted, from_flax_variables

MODEL_EXT = ".msgpack"


def save_model(module_config, variables, path):
    """Write ``{config, variables}`` to ``path`` (directories created).
    ``variables`` is a flax-layout tree of numpy arrays or CPU tensors, as
    ``convert.to_flax_variables`` gives it; its keys are written in flax's
    (sorted) order."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = {"config": json.dumps(module_config), "variables": packb(_sorted(variables))}
    with open(path, "wb") as f:
        f.write(packb(payload))


def resolve_model_spec(path):
    """``zoo:<name>`` -> the committed zoo model's file path; any other path
    as it is."""
    path = str(path)
    if path.startswith("zoo:"):
        from simplesr_tpu_torch import zoo
        return zoo.resolve(path[len("zoo:"):]).path
    return path


def load_payload(path):
    """Read a model file (or a ``zoo:`` spec) -> (config dict, variables
    tree of arrays)."""
    with open(resolve_model_spec(path), "rb") as f:
        payload = unpackb(f.read())
    config = json.loads(payload["config"])
    variables = unpackb(payload["variables"])
    return config, variables


def load_model(path, device="cuda"):
    """Read a model file -> the generator with its weights, in eval mode, on
    ``device``."""
    from simplesr_tpu_torch.models import build_generator_model

    config, variables = load_payload(path)
    module = build_generator_model(**config, device=device)
    module.load_state_dict(from_flax_variables(module, variables))
    return module
