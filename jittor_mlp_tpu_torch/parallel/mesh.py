"""The ('data', 'model') device mesh (counterpart of
``jittor_mlp_tpu/parallel/mesh.py``).

The JAX package runs one process over many devices; the port runs one
process per device under ``torch.distributed`` (NCCL on cards, gloo on the
CPU). ``make_mesh`` lays the world's ranks out as the JAX ``make_mesh``
reshapes its devices: rank = data_index · model_parallel + model_index, so
a model group is ``model_parallel`` consecutive ranks. The batch splits
over 'data'; the 'model' axis carries pipeline stages and token shards.

The helpers read what the JAX code reads off its mesh: ``axis_size(mesh,
"model")`` is ``mesh.shape["model"]``, ``axis_index`` a rank's coordinate
(``lax.axis_index``), ``axis_group`` the process group of the rank's
line along a dim (the ranks a ``psum`` over that axis reaches), and
``mesh_device`` the device the rank computes on.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

AXES = ("data", "model")


def _device_type():
    """The device type of the default process group's backend: "cuda" for
    NCCL, "cpu" for gloo."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: start the processes with torchrun and call "
            "parallel.multihost.initialize() (or torch.distributed.init_process_group) "
            "before building a mesh")
    backend = dist.get_backend()
    if backend == "nccl":
        return "cuda"
    if backend == "gloo":
        return "cpu"
    raise RuntimeError(f"unsupported process-group backend {backend!r} (nccl or gloo)")


def make_mesh(n_devices=None, model_parallel=1, devices=None):
    """The ('data', 'model') ``DeviceMesh`` over the default process group.

    ``n_devices`` (default: the world size) must be the world size: every
    process holds one device of the mesh. ``devices``, if given, is the
    device type the caller expects ("cuda" or "cpu"); it must be the
    backend's (NCCL: "cuda", each rank on ``cuda:{LOCAL_RANK}``; gloo:
    "cpu"), else ValueError."""
    kind = _device_type()
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"n_devices={n_devices}: the port's mesh spans the whole world of "
                         f"{world} processes, one device each")
    if devices is not None and torch.device(devices).type != kind:
        raise ValueError(f"devices={devices!r}, but the {dist.get_backend()} process group "
                         f"computes on {kind!r}")
    if model_parallel < 1 or n_devices % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide {n_devices} devices")
    if kind == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        if torch.cuda.current_device() != local:
            torch.cuda.set_device(local)
    return init_device_mesh(kind, (n_devices // model_parallel, model_parallel),
                            mesh_dim_names=AXES)


def require_axis(axis, want="model"):
    """``axis`` itself, or ValueError unless it is ``want``. The JAX
    functions take the mesh axis by name; the port keeps the names, but
    its step scales the loss, reduces the gradients and assigns stages
    over 'model' (and splits the batch over 'data'), so no other axis
    would give correct gradients."""
    if axis != want:
        raise ValueError(f"axis={axis!r}: the port runs this over the {want!r} axis only")
    return axis


def _dim(mesh, axis):
    if axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh axis {axis!r} not in {mesh.mesh_dim_names}")
    return mesh.mesh_dim_names.index(axis)


def axis_size(mesh, axis):
    """The number of ranks along ``axis`` (the JAX ``mesh.shape[axis]``)."""
    return int(mesh.mesh.shape[_dim(mesh, axis)])


def axis_index(mesh, axis):
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    return int(mesh.get_coordinate()[_dim(mesh, axis)])


def axis_group(mesh, axis):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(_dim(mesh, axis))


def mesh_device(mesh):
    """The device this rank computes on: ``cuda:{current device}`` on an
    NCCL mesh, the CPU on a gloo one."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def check_device(mesh, device, what="the model"):
    """ValueError unless ``device`` is the mesh's device type: no tensor of
    a mesh computes on another device than its rank's."""
    if torch.device(device).type != mesh.device_type:
        raise ValueError(f"{what} is on {torch.device(device)}, the mesh on "
                         f"{mesh.device_type!r}: place it on the rank's device")
