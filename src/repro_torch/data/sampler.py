"""GNN neighbour sampler (GraphSAGE-style fanout): the ``minibatch_lg``
cell's 2-hop fanout (15, 10) over a 233k-node graph. Numpy copy of
``repro/data/sampler.py``, kept so that the port imports nothing of the
JAX package; the same seed gives the same arrays.

The CSR adjacency is built once; each minibatch samples seed nodes, then
per-hop uniform neighbour samples, and emits a compact padded subgraph:
  nodes:     [n_sub]  original node ids (padded with 0)
  node_mask: [n_sub]
  src/dst:   [n_sub_edges] indices INTO the subgraph node list
  dist:      [n_sub_edges] synthesized geometric distances (padded edges
             1e6: beyond the cutoff)
Fixed output shapes: every batch has the same tensor shapes.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray   # [N+1]
    indices: np.ndarray  # [E]
    pos: np.ndarray      # [N, 3] synthesized positions

    @property
    def n_nodes(self) -> int:
        return self.indptr.shape[0] - 1


def build_csr(n_nodes: int, src: np.ndarray, dst: np.ndarray,
              pos: np.ndarray | None = None, seed: int = 0) -> CSRGraph:
    order = np.argsort(src, kind="stable")
    s, d = src[order], dst[order]
    counts = np.bincount(s, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    if pos is None:
        rng = np.random.default_rng(seed)
        pos = rng.normal(size=(n_nodes, 3)).astype(np.float32) * 3.0
    return CSRGraph(indptr, d.astype(np.int32), pos)


class NeighborSampler:
    """Uniform fanout sampler. fanouts=(15, 10) => 2-hop."""

    def __init__(self, graph: CSRGraph, fanouts: tuple[int, ...],
                 batch_nodes: int, seed: int = 0):
        self.g = graph
        self.fanouts = fanouts
        self.batch_nodes = batch_nodes
        self.rng = np.random.default_rng(seed)
        # static output sizes (padded)
        self.max_nodes = batch_nodes
        self.max_edges = 0
        frontier = batch_nodes
        for f in fanouts:
            self.max_edges += frontier * f
            frontier = frontier * f
            self.max_nodes += frontier

    def sample(self) -> dict:
        g = self.g
        seeds = self.rng.integers(0, g.n_nodes,
                                  self.batch_nodes).astype(np.int32)
        nodes = list(seeds)
        node_of = {int(n): i for i, n in enumerate(seeds)}
        src_l, dst_l = [], []
        frontier = seeds
        for f in self.fanouts:
            next_frontier = []
            for u in frontier:
                lo, hi = g.indptr[u], g.indptr[u + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = min(f, int(deg))
                picks = g.indices[lo + self.rng.choice(deg, take,
                                                       replace=False)]
                for v in picks:
                    vi = node_of.get(int(v))
                    if vi is None:
                        vi = len(nodes)
                        node_of[int(v)] = vi
                        nodes.append(int(v))
                        next_frontier.append(v)
                    # message flows neighbour(v) -> centre(u)
                    src_l.append(vi)
                    dst_l.append(node_of[int(u)])
            frontier = np.asarray(next_frontier, np.int32)
            if frontier.size == 0:
                break

        n, e = len(nodes), len(src_l)
        nodes_arr = np.zeros(self.max_nodes, np.int32)
        nodes_arr[:n] = np.asarray(nodes, np.int32)
        node_mask = np.zeros(self.max_nodes, np.float32)
        node_mask[:n] = 1.0
        src = np.zeros(self.max_edges, np.int32)
        dst = np.zeros(self.max_edges, np.int32)
        emask = np.zeros(self.max_edges, np.float32)
        src[:e] = np.asarray(src_l, np.int32)
        dst[:e] = np.asarray(dst_l, np.int32)
        emask[:e] = 1.0
        p = g.pos[nodes_arr]
        dist = np.linalg.norm(p[src] - p[dst], axis=1).astype(np.float32)
        dist = dist * emask + 1e6 * (1 - emask)  # padded edges: beyond cutoff
        return {"nodes": nodes_arr, "node_mask": node_mask, "src": src,
                "dst": dst, "edge_mask": emask, "dist": dist,
                "seeds": seeds, "n_real_nodes": n, "n_real_edges": e}
