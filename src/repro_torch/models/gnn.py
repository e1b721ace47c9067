"""SchNet (continuous-filter convolution GNN): segment-sum message passing.

Port of ``repro/models/gnn.py``. SchNet [arXiv:1706.08566]: per-edge
filter W(r_ij) = MLP(RBF(d_ij)); message m_ij = (W x_j); node update by
atom-wise dense layers. Message passing is an edge-index gather, an
elementwise product and a scatter-sum (``index_add_``, which the card runs
with atomics: the card and the CPU agree to a tolerance, not to bits).

For non-geometric graphs the data pipeline synthesizes deterministic 3-D
positions per node so the RBF filter path runs at full fidelity
(``data/synthetic.random_graph``); molecule batches carry their own.
The params are a plain nested dict of tensors, the reference's tree.
On a mesh (DTensor inputs, the registry's cells) each rank runs its own
node and edge blocks, ``h`` gathered whole and the messages' sums
reduce-scattered onto the node blocks (``_schnet_mesh``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.module import is_dtensor


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    d_in: int = 0          # 0 => integer atom types; > 0 => dense feats
    n_types: int = 100     # atom-type vocab when d_in == 0
    n_out: int = 1         # 1 => energy regression; >1 => node classification
    readout: str = "sum"   # sum (energy) | none (node-level outputs)
    param_dtype: str = "float32"


def shifted_softplus(x):
    """softplus(x) - log 2, softplus as ``jax.nn.softplus`` (log(1 + e^x)
    with no linear cut-off)."""
    return (torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                           device=x.device))
            - torch.tensor(math.log(2.0), dtype=x.dtype))


def rbf_expand(dist, n_rbf: int, cutoff: float):
    """Gaussian radial basis: [E] -> [E, n_rbf] fp32."""
    centers = torch.linspace(0.0, cutoff, n_rbf, dtype=torch.float32,
                             device=dist.device)
    gamma = n_rbf / cutoff
    d = dist[:, None].to(torch.float32) - centers[None, :]
    return torch.exp(-gamma * torch.square(d))


def _segment_sum(x, ids, n: int):
    out = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add(0, ids.long(), x)


def schnet_init(cfg: SchNetConfig, *, seed: int = 0,
                device: str | torch.device = "cuda") -> dict:
    """{"embed", "int{i}": {"filter", "in_proj", "out1", "out2"}, "head":
    {"fc0", "fc1"}}, random on ``device`` with the reference's
    distributions (an atom-type table normal · 0.1)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, cfg.param_dtype)
    d = cfg.d_hidden
    p = {}
    if cfg.d_in > 0:
        p["embed"] = L.dense_init(gen, cfg.d_in, d, dt)
    else:
        p["embed"] = {"table": L._normal(gen, (cfg.n_types, d), 0.1, dt)}
    for i in range(cfg.n_interactions):
        p[f"int{i}"] = {
            "filter": L.mlp_init(gen, [cfg.n_rbf, d, d], dt),     # W(r_ij)
            "in_proj": L.dense_init(gen, d, d, dt, use_bias=False),
            "out1": L.dense_init(gen, d, d, dt),
            "out2": L.dense_init(gen, d, d, dt),
        }
    p["head"] = {"fc0": L.dense_init(gen, d, d // 2, dt),
                 "fc1": L.dense_init(gen, d // 2, cfg.n_out, dt)}
    return p


def schnet_apply(p, cfg: SchNetConfig, node_in, edge_src, edge_dst,
                 edge_dist, graph_ids=None, n_graphs: int = 1):
    """node_in [N, d_in] float or [N] int; edges (src -> dst) [E] each;
    edge_dist [E]; graph_ids [N] for batched graphs -> [n_graphs, n_out]
    (readout "sum") or [N, n_out] (readout "none"). DTensor inputs (a
    mesh) run on each rank's blocks (:func:`_schnet_mesh`)."""
    if is_dtensor(node_in):
        return _schnet_mesh(p, cfg, node_in, edge_src, edge_dst, edge_dist,
                            graph_ids, n_graphs)
    N = node_in.shape[0]
    out = _schnet(p, cfg, node_in, edge_src, edge_dst, edge_dist,
                  lambda h: h, lambda msg, dst: _segment_sum(msg, dst, N))
    if cfg.readout == "sum":
        if graph_ids is None:
            return out.sum(0, keepdim=True)
        return _segment_sum(out, graph_ids, n_graphs)
    return out


def _schnet(p, cfg: SchNetConfig, node_in, edge_src, edge_dst, edge_dist,
            whole, scatter):
    """The interactions and the head on this rank's nodes -> [N_loc,
    n_out]: ``whole(h)`` gives every node's h as the edges' ``src`` (global
    ids) read it, ``scatter(msg, dst)`` the messages' sums on this rank's
    nodes."""
    if cfg.d_in > 0:
        x = shifted_softplus(L.dense_apply(p["embed"], node_in))
    else:
        x = torch.nn.functional.embedding(node_in, p["embed"]["table"])

    rbf = rbf_expand(edge_dist, cfg.n_rbf, cfg.cutoff).to(x.dtype)
    # smooth cutoff envelope
    env = 0.5 * (torch.cos(math.pi * torch.clamp(edge_dist / cfg.cutoff,
                                                 0, 1)) + 1.0)
    src = edge_src.long()
    for i in range(cfg.n_interactions):
        ip = p[f"int{i}"]
        w = L.mlp_apply(ip["filter"], rbf, act="tanh", final_act=False)
        w = shifted_softplus(w) * env[:, None].to(x.dtype)        # [E, d]
        h = L.dense_apply(ip["in_proj"], x)                        # [N, d]
        msg = whole(h)[src] * w                          # gather ⊙ filter
        agg = scatter(msg, edge_dst)                               # scatter
        v = shifted_softplus(L.dense_apply(ip["out1"], agg))
        x = x + L.dense_apply(ip["out2"], v)                       # residual

    h = shifted_softplus(L.dense_apply(p["head"]["fc0"], x))
    return L.dense_apply(p["head"]["fc1"], h)                     # [N, n_out]


def _schnet_mesh(p, cfg: SchNetConfig, node_in, edge_src, edge_dst,
                 edge_dist, graph_ids, n_graphs: int):
    """``schnet_apply`` of DTensor inputs, nodes and edges split on their
    first dimension in one layout (``configs/schnet``: over every mesh
    axis, or whole on every rank for a small graph), params replicated.
    Per-node work runs on the rank's node block and messages on its edge
    block: ``h`` is all-gathered (its gradient, partial over the split
    axes, reduce-scattered back), each rank's [N, d] message sums are
    reduce-scattered onto the node blocks, and the graph readout's [G,
    n_out] partial sums all-reduced -> a DTensor: [N, n_out] in the
    nodes' layout, or [G, n_out] whole on every rank."""
    from torch.distributed.tensor import Replicate

    from repro_torch.models.module import (is_row_sharded, local_params,
                                           rows_dtensor, rows_partial)
    mesh, pl = node_in.device_mesh, tuple(node_in.placements)
    N = node_in.shape[0]
    rows = (mesh, pl, N)
    partial = rows_partial(pl)
    every = [Replicate()] * mesh.ndim

    if is_row_sharded(node_in):
        def whole(h):
            return rows_dtensor(h, rows).redistribute(mesh, every).to_local(
                grad_placements=partial)

        def scatter(msg, dst):
            return rows_dtensor(_segment_sum(msg, dst, N),
                                (mesh, partial, N)).redistribute(
                                    mesh, pl).to_local()
    else:
        def whole(h):
            return h

        def scatter(msg, dst):
            return _segment_sum(msg, dst, N)

    out = _schnet(local_params(p, pl), cfg, node_in.to_local(), edge_src.to_local(),
                  edge_dst.to_local(), edge_dist.to_local(), whole, scatter)
    if cfg.readout != "sum":
        return rows_dtensor(out, rows)
    if graph_ids is None:
        part = out.sum(0, keepdim=True)
    else:
        part = _segment_sum(out, graph_ids.to_local(), n_graphs)
    return rows_dtensor(part, (mesh, partial, part.shape[0])).redistribute(
        mesh, every)
