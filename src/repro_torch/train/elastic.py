"""Elastic re-meshing: restore a checkpoint onto a DIFFERENT rank count or
mesh shape. Port of ``repro/train/elastic.py``.

Checkpoints hold whole arrays (the Trainer gathers a mesh run's state
before it writes), so an elastic restore is data movement only: each rank
keeps its own block of every leaf under the param sharding RULES
(``models/module.ShardRules``), which name logical mesh axes and so fit any
mesh shape. A dimension split over axes (a, b) of sizes (na, nb) is cut
into na·nb contiguous blocks, and the rank at coordinates (i, j) on them
keeps block i·nb + j (the order of ``jax.sharding.NamedSharding``). The
result is a tree of this rank's local tensors, as the port's mesh code
holds them (the fit engine's ``shard_state``), not DTensors.
"""
from __future__ import annotations

import torch

from repro_torch.checkpoint.checkpointer import CheckpointManager
from repro_torch.kernels import resolve_device
from repro_torch.models.module import (ShardRules, map_with_paths,
                                       mesh_sizes, spec_axes)


def _coords(mesh) -> dict[str, int]:
    """This rank's coordinate on each axis of a DeviceMesh."""
    return {n: int(mesh.get_local_rank(n)) for n in mesh.mesh_dim_names}


def shard_leaf(leaf: torch.Tensor, spec, sizes: dict[str, int],
               coords: dict[str, int]) -> torch.Tensor:
    """This rank's block of ``leaf`` under ``spec``; the whole leaf when a
    named axis is missing or does not divide its dimension (the
    reference's fallback to replication, which keeps downsizing working)."""
    index = []
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = spec_axes(part)
        if any(a not in sizes for a in axes) or dim >= leaf.ndim:
            return leaf
        total, at = 1, 0
        for a in axes:
            total *= sizes[a]
            at = at * sizes[a] + coords[a]
        if leaf.shape[dim] % total:
            return leaf
        index.append((dim, at, leaf.shape[dim] // total))
    for dim, at, n in index:
        leaf = leaf.narrow(dim, at * n, n)
    return leaf.contiguous()


def reshard_tree(tree, mesh, rules: ShardRules,
                 device: str | torch.device = "cuda"):
    """A whole host tree (numpy or tensors) -> this rank's blocks on
    ``device`` per ``rules`` on ``mesh`` (a DeviceMesh)."""
    dev = resolve_device(device)
    sizes, coords = mesh_sizes(mesh), _coords(mesh)

    def place(path, leaf):
        t = torch.as_tensor(leaf)
        return shard_leaf(t, rules.spec_for(path), sizes, coords).to(dev)

    return map_with_paths(place, tree)


def elastic_restore(ckpt_dir: str, mesh, rules: ShardRules, step=None, *,
                    device: str | torch.device = "cuda"):
    """(this rank's tree, manifest) of checkpoint ``step`` (default: the
    newest) under ``ckpt_dir``, resharded for ``mesh``."""
    cm = CheckpointManager(ckpt_dir)
    step = step if step is not None else cm.latest_step()
    assert step is not None, "no checkpoint to restore"
    tree, manifest = cm.restore(step)
    return reshard_tree(tree, mesh, rules, device), manifest
