"""The architecture registry's protocol. Port of ``repro/configs/base.py``.

Every architecture module exposes ``get_arch() -> ArchDef``: what a
launcher needs to build an (arch x shape) cell on any mesh:

  - ``abstract_params()``: the params' tree of meta or fake tensors
    (shapes and dtypes, no memory), where the reference has
    ``ShapeDtypeStruct``s;
  - ``rules()``: ``ShardRules`` mapping param paths to specs (the port's
    per-dimension tuples, ``models/module.Spec``);
  - ``opt``: the train cells' optimizer ("adamw" | "adamw_nomaster" |
    "adafactor");
  - ``cells``: {shape name: CellDef}; ``CellDef.skip`` gives the reason a
    cell is skipped (e.g. long_500k on pure full-attention archs).

Input specs are functions of the mesh, so that batch axes adapt to the
single- and multi-pod meshes. A mesh is a ``torch.distributed``
DeviceMesh (``mesh_dim_names``, ``mesh.shape``) or anything with those
two attributes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.models.module import (ShardRules, Spec, data_axes,
                                       mesh_sizes, tensor_tree)


@dataclasses.dataclass
class CellDef:
    kind: str                                   # "train" | "serve"
    inputs: Optional[Callable[[Any], dict]] = None   # mesh -> {name: meta}
    in_specs: Optional[Callable[[Any], dict]] = None  # mesh -> {name: spec}
    step: Optional[Callable[..., Callable]] = None    # () -> step fn
    skip: Optional[str] = None                  # reason if cell is skipped
    note: str = ""
    params: Optional[Callable[[Any], Any]] = None       # mesh -> meta tree
    param_specs: Optional[Callable[[Any, Any], Any]] = None  # (mesh, meta)
    step_with_mesh: bool = False                # step(mesh) instead of step()


@dataclasses.dataclass
class ArchDef:
    name: str
    family: str
    abstract_params: Callable[[], Any]
    rules: Callable[[], ShardRules]
    cells: dict[str, CellDef]
    opt: str = "adamw"
    opt_kw: dict = dataclasses.field(default_factory=dict)
    model_flops_per_token: Optional[int] = None   # 6*N(_active) for LM
    notes: str = ""


def dp(mesh) -> tuple:
    """Data-parallel axes for specs: ("pod", "data") or ("data",)."""
    return data_axes(mesh)


def dp_size(mesh) -> int:
    sizes = mesh_sizes(mesh)
    out = 1
    for a in dp(mesh):
        out *= sizes[a]
    return out


def grid_axes(mesh) -> tuple:
    """All mesh axes flattened (for row-sharding giant embedding tables)."""
    return tuple(mesh.mesh_dim_names)


def sds(shape, dtype=torch.float32) -> torch.Tensor:
    """A meta tensor: shape and dtype, no memory (the reference's
    ``jax.ShapeDtypeStruct``)."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def abstract(init_fn: Callable, *args, **kwargs) -> Any:
    """An init function run under ``FakeTensorMode`` -> its params' tree
    (``tensor_tree``) of fake tensors: shapes and dtypes, no memory (the
    reference's ``jax.eval_shape``). Call it with ``device="cpu"``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return tensor_tree(init_fn(*args, **kwargs))


# ------------------------------------------------------------ ZeRO states ---
def zero_state_spec(param_spec: Spec, shape: tuple, data_axis: str = "data",
                    axis_size: int = 16) -> Spec:
    """Additionally shard an optimizer-state leaf over the data axis: pick
    the first dim that is unsharded and divisible (ZeRO-1/2 style)."""
    spec = list(param_spec) + [None] * (len(shape) - len(param_spec))
    used = set()
    for s in spec:
        if s is None:
            continue
        for a in (s if isinstance(s, tuple) else (s,)):
            used.add(a)
    if data_axis in used:
        return tuple(spec)
    for i, s in enumerate(spec):
        if s is None and shape[i] % axis_size == 0 and shape[i] >= axis_size:
            spec[i] = data_axis
            return tuple(spec)
    return tuple(spec)
