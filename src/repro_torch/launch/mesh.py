"""Meshes over ``torch.distributed``. Port of ``repro/launch/mesh.py``.

Each function builds a ``torch.distributed.device_mesh.DeviceMesh`` with
the reference's axis names over the ranks of the default process group,
which the caller initialises first (``init_process_group`` with its
address, world size and rank; NCCL for one rank a card, gloo for several
ranks on one card or on the CPU). The mesh's size must equal the world
size. A mesh axis's process group is ``mesh.get_group(name)``;
``core/distributed.axis_group`` also gives a tuple of axes one group.

Single pod:  (16, 16)      axes ("data", "model")
Multi-pod:   (2, 16, 16)   axes ("pod", "data", "model")

Batch-parallel axes are ("pod", "data"); the reps' axis is "model" (or
"rep" on the fit mesh). The meshes live on ``device_type`` ``"cuda"``
unless the caller asks for ``"cpu"``.
"""
from __future__ import annotations

import math


def _mesh(shape: tuple, names: tuple, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs the default process group: call torch.distributed."
            "init_process_group(backend, init_method=..., world_size=..., "
            "rank=...) on every rank first")
    n, world = math.prod(shape), dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {n} ranks, "
                         f"the world has {world}")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported mesh device type {device_type!r}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def _world(n_devices: int | None) -> int:
    import torch.distributed as dist
    if n_devices:
        return int(n_devices)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("init_process_group first: the mesh's size "
                           "defaults to the world size")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_host_mesh(n_devices: int | None = None, model_axis: int = 1, *,
                   device_type: str = "cuda"):
    """("data", "model") mesh over ``n_devices`` ranks (default: the world
    size), ``model_axis`` of them along "model"."""
    n = _world(n_devices)
    if n % model_axis:
        raise ValueError(f"model_axis={model_axis} does not divide {n}")
    return _mesh((n // model_axis, model_axis), ("data", "model"),
                 device_type)


def make_fit_mesh(n_devices: int | None = None, rep_axis: int = 1, *,
                  device_type: str = "cuda"):
    """(data × rep) mesh for the FitEngine: batch columns split over
    "data" (summed gradients), the R repetitions (params, AdamW moments,
    affinity, k-choice, assign) split over "rep". ``rep_axis`` must divide
    the rank count and the config's n_reps."""
    n = _world(n_devices)
    if n % rep_axis:
        raise ValueError(f"rep_axis={rep_axis} does not divide {n}")
    return _mesh((n // rep_axis, rep_axis), ("data", "rep"), device_type)


def batch_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axes of a mesh made above."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def batch_size_divisor(mesh) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    n = 1
    for a in batch_axes(mesh):
        n *= int(sizes[a])
    return n
