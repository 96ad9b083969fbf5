"""The parallel layer, as simplesr_tpu.parallel, in torch.distributed: mesh
construction, data-parallel training helpers, FSDP (ZeRO-3) state sharding,
spatially-sharded (halo-exchange) inference, tensor-parallel (Megatron
channel-split) and pipeline-parallel (GPipe staged-trunk) forwards, and the
process group's initialisation. One process per rank; importing the package
initialises neither CUDA nor a process group.

The names load with their module on first use (the models import
``parallel.comm``, and ``parallel.tensor`` imports the models)."""

import importlib

_EXPORTS = {
    "mesh": ["make_mesh", "data_sharding", "spatial_sharding", "replicated", "shard_batch",
             "initialize_multihost", "local_batch_slice", "global_batch", "DATA_AXIS",
             "SPATIAL_AXIS", "LocalMesh"],
    "spatial": ["halo_exchange", "spatial_sharded_apply", "spatial_sharded_apply_batched"],
    "fsdp": ["leaf_spec", "state_shardings", "shard_count"],
    "tensor": ["tp_apply", "tp_param_specs", "MODEL_AXIS"],
    "pipeline": ["pipeline_apply", "stack_block_params", "STAGE_AXIS"],
}
_MODULE_OF = {name: module for module, names in _EXPORTS.items() for name in names}

__all__ = list(_MODULE_OF)


def __getattr__(name):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_MODULE_OF[name]}"), name)


def __dir__():
    return sorted(list(globals()) + __all__)
