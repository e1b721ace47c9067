"""Parameter-tree helpers of the model families (LM, recsys).

Port of the forward's part of ``repro/models/module.py``. The reference
keeps params as nested dicts of arrays; the port keeps the same nesting as
``nn.ParameterDict`` (a dict of tensors) inside ``nn.ModuleDict`` /
``nn.ModuleList`` (:func:`as_module`), so ``p["q_proj"]["kernel"]`` reads
as in the reference and the parameter names follow its paths
(``layers.0.attn.q_proj.kernel``). The mesh machinery (``ShardRules``,
``constrain``, ``constrain_first``) is not ported: without a mesh it is a
no-op in the reference too.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch.checkpoint.checkpointer import flatten_with_paths

__all__ = ["as_module", "cast_floating", "device_of", "flatten_with_paths",
           "param_bytes", "param_count"]


def as_module(tree: Any) -> nn.Module:
    """A nested dict (or list) of tensors -> the same nesting as modules: a
    dict of tensors becomes an ``nn.ParameterDict``, a dict of dicts an
    ``nn.ModuleDict``, a list an ``nn.ModuleList``. The tensors become
    parameters without gradients (the port's LM path is inference only)."""
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList([as_module(t) for t in tree])
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    if any(isinstance(v, torch.Tensor) for v in tree.values()):
        raise ValueError(f"a params dict mixes tensors and subtrees: "
                         f"{sorted(tree)}")
    return nn.ModuleDict({k: as_module(v) for k, v in tree.items()})


def _leaves(params) -> list[torch.Tensor]:
    if isinstance(params, nn.Module):
        return list(params.parameters())
    return [v for _, v in flatten_with_paths(params)]


def device_of(params) -> torch.device:
    """The device of a module's or nested dict's first leaf."""
    return _leaves(params)[0].device


def param_count(params) -> int:
    """Elements of every leaf of a module or nested dict."""
    return sum(int(v.numel()) for v in _leaves(params))


def param_bytes(params) -> int:
    return sum(int(v.numel()) * v.element_size() for v in _leaves(params))


def cast_floating(params, dtype: torch.dtype):
    """Floating leaves cast to ``dtype``, integer leaves kept. A module is
    cast in place (``nn.Module.to`` casts only floating parameters) and
    returned; a nested dict gives a new one."""
    if isinstance(params, nn.Module):
        return params.to(dtype)
    if isinstance(params, dict):
        return {k: cast_floating(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.is_floating_point() else params
