"""Device meshes and the batch helpers, as simplesr_tpu.parallel.mesh.

One process per rank, as PyTorch runs several devices: ``initialize_multihost``
brings the process group up from torchrun's environment (NCCL on CUDA, gloo
on the CPU), ``make_mesh`` lays the group's ranks out as a named
``DeviceMesh`` under the JAX package's rules (``{"data": world}`` by
default, a ``-1`` entry absorbing the rest, a ``ValueError`` when the sizes
do not cover the ranks), and ``local_batch_slice`` / ``shard_batch`` /
``global_batch`` are a rank's part of a global batch and its all-gather.

A mesh of devices that one process drives itself (the serving engine's
replicas, one per device) is a ``LocalMesh``: ``make_mesh(devices=[...])``
with ``torch.device`` entries (or their names) builds one.

Importing this module initialises neither CUDA nor a process group.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


class LocalMesh:
    """A mesh of devices driven by this one process: ``devices`` (an array
    of ``torch.device`` shaped as the axes), ``axis_names`` and ``shape``
    (a dict, as a JAX mesh's)."""

    def __init__(self, devices, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def __repr__(self):
        return f"LocalMesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def _axis_sizes(axis_sizes, n):
    """The JAX package's rules: names and sizes covering ``n`` entries."""
    if axis_sizes is None:
        axis_sizes = {DATA_AXIS: n}
    names, sizes = list(axis_sizes), list(axis_sizes.values())
    n_fixed = int(np.prod([s for s in sizes if s != -1]))
    sizes = [n // n_fixed if s == -1 else int(s) for s in sizes]
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} does not cover {n} devices")
    return names, sizes


def _is_device(entry):
    return isinstance(entry, (torch.device, str))


def make_mesh(axis_sizes=None, devices=None):
    """A named mesh over the process group's ranks (``devices`` None, or a
    list of ranks): a ``DeviceMesh``, whose device type follows the group's
    backend (``cuda`` under NCCL, ``cpu`` under gloo, which also carries
    CUDA tensors). Given ``torch.device`` entries instead, a ``LocalMesh``
    of those devices in this process. ``axis_sizes`` as in the JAX package:
    ``{"data": n}`` by default, a ``-1`` entry absorbing the rest."""
    if devices is not None and len(devices) and all(_is_device(d) for d in devices):
        devs = np.empty(len(devices), dtype=object)
        devs[:] = [torch.device(d) for d in devices]
        names, sizes = _axis_sizes(axis_sizes, devs.size)
        return LocalMesh(devs.reshape(sizes), names)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh over ranks needs the process group: call "
                           "initialize_multihost() first (or pass torch.device entries "
                           "for a mesh of this process's devices)")
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    names, sizes = _axis_sizes(axis_sizes, len(ranks))
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(sizes),
                      mesh_dim_names=tuple(names))


def mesh_shape(mesh):
    """{axis name: size} of a ``DeviceMesh`` or a ``LocalMesh``."""
    if isinstance(mesh, LocalMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, axis):
    """The size of ``axis`` in ``mesh`` (1 when the mesh is None or lacks it)."""
    return 1 if mesh is None else mesh_shape(mesh).get(axis, 1)


def axis_group(mesh, axis):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)


def axis_index(mesh, axis):
    """This rank's coordinate along ``axis`` (0 when the mesh lacks it)."""
    if mesh is None or axis not in mesh_shape(mesh):
        return 0
    return mesh.get_local_rank(axis)


def check_rank_mesh(mesh):
    """``mesh`` if it is a rank mesh (a ``DeviceMesh`` with named axes),
    else a TypeError."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or not mesh.mesh_dim_names:
        raise TypeError(f"mesh must be a DeviceMesh with named axes (make_mesh), "
                        f"got {type(mesh).__name__}")
    return mesh


def rank_device(device="cuda"):
    """This rank's device: ``cuda:LOCAL_RANK`` (torchrun's variable, 0 when
    unset) for ``cuda``, the device as given otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def initialize_multihost(coordinator_address=None, num_processes=None, process_id=None,
                         device="cuda"):
    """Initialise the default process group: from the arguments where given,
    else from torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``). NCCL for a CUDA ``device``, gloo for the CPU.
    A no-op when the group is already up or the world is 1. Returns the
    world size."""
    if dist.is_initialized():
        return dist.get_world_size()
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    if world <= 1:
        return 1
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    return world


def _data_line(mesh, axis):
    """(size, index) of this rank along ``axis``, or of the world without a
    mesh."""
    if mesh is not None:
        return axis_size(mesh, axis), axis_index(mesh, axis)
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def local_batch_slice(global_batch_size, mesh=None, axis=DATA_AXIS):
    """This rank's slice of a global batch: its index along the mesh's data
    axis (the world's rank without a mesh) times the per-rank size."""
    n, i = _data_line(mesh, axis)
    per = global_batch_size // n
    return slice(i * per, (i + 1) * per)


def shard_batch(mesh, batch, axis=DATA_AXIS):
    """This rank's shard of a global batch, split along its leading dim over
    ``axis``; a batch that does not divide raises ValueError."""
    n = axis_size(mesh, axis)
    if batch.shape[0] % n:
        raise ValueError(f"batch {batch.shape[0]} not divisible by mesh axis {axis}={n}")
    return batch[local_batch_slice(batch.shape[0], mesh, axis)]


def global_batch(mesh, local_batch, axis=DATA_AXIS):
    """The global batch from every rank's local shard along ``axis`` (an
    all-gather, concatenated in the axis's order); a mesh without the axis
    hands the local batch back."""
    from simplesr_tpu_torch.parallel.comm import all_gather_cat

    if axis_size(mesh, axis) == 1:
        return local_batch
    return all_gather_cat(torch.as_tensor(local_batch), 0, axis_group(mesh, axis))


def data_sharding(mesh=None, axis=DATA_AXIS):
    """The spec of a batch split along its leading dim over ``axis`` (the
    spec tuples of ``parallel.fsdp``; ``shard_batch`` applies it)."""
    return (axis,)


def spatial_sharding(mesh=None, axis=SPATIAL_AXIS):
    """The spec of one (H, W, C) image split along its rows over ``axis``
    (``spatial_sharded_apply`` applies it)."""
    return (axis,)


def replicated(mesh=None):
    """The spec of a tensor held whole on every rank."""
    return ()
