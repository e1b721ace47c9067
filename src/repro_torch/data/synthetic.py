"""Synthetic ANN data: a numpy copy of the reference's ``clustered_ann``
(``repro/data/synthetic.py``), which the port keeps so that it imports
nothing of the JAX package. The same seed gives the same arrays.

GloVe/SIFT-like dense vectors with planted, power-law-sized clusters and
exact top-k ground-truth neighbours (brute force): the ANN labels of IRLI
§3.2 ("100 exact near neighbours ... generated beforehand").
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ANNData:
    base: np.ndarray        # [N, d] corpus
    queries: np.ndarray     # [Q, d]
    train_queries: np.ndarray  # [Tq, d]
    gt: np.ndarray          # [Q, k] exact neighbours of queries in base
    train_gt: np.ndarray    # [Tq, k_train] neighbours used as labels
    metric: str


def _topk_l2(base: np.ndarray, q: np.ndarray, k: int, metric: str,
             block: int = 2048) -> np.ndarray:
    """Exact top-k neighbour ids (brute force, blocked)."""
    out = np.empty((q.shape[0], k), np.int32)
    b2 = (base ** 2).sum(-1)
    for s in range(0, q.shape[0], block):
        qb = q[s:s + block]
        if metric == "angular":
            sim = qb @ base.T
            idx = np.argpartition(-sim, k, axis=1)[:, :k]
            order = np.take_along_axis(-sim, idx, 1).argsort(1)
        else:
            d2 = b2[None, :] - 2 * (qb @ base.T)
            idx = np.argpartition(d2, k, axis=1)[:, :k]
            order = np.take_along_axis(d2, idx, 1).argsort(1)
        out[s:s + block] = np.take_along_axis(idx, order, 1)
    return out


def clustered_vectors(n_base: int = 20000, n_queries: int = 500,
                      n_train: int | None = None, d: int = 32,
                      n_clusters: int = 50, metric: str = "angular",
                      seed: int = 0):
    """The vectors of :func:`clustered_ann` without its brute-force
    neighbours -> (base [n_base, d], queries [n_queries, d], train_queries)
    float32, from the same random stream. At sizes where the host's brute
    force is too slow, compute the neighbours on the card instead
    (``core/query.exact_topk``)."""
    rng = np.random.default_rng(seed)
    # power-law cluster sizes — reproduces the skew that breaks k-means/LSH
    sizes = rng.zipf(1.3, n_clusters).astype(np.float64)
    sizes = np.maximum(sizes / sizes.sum() * n_base, 2).astype(np.int64)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32) * 3.0
    parts = [rng.normal(size=(int(s), d)).astype(np.float32) * 0.7 + centers[i]
             for i, s in enumerate(sizes)]
    base = np.concatenate(parts)[:n_base]
    while base.shape[0] < n_base:  # top up if rounding lost rows
        base = np.concatenate([base, base[: n_base - base.shape[0]]])
    rng.shuffle(base)
    if metric == "angular":
        base /= np.linalg.norm(base, axis=1, keepdims=True) + 1e-9

    def make_queries(n):
        idx = rng.integers(0, n_base, n)
        q = base[idx] + rng.normal(size=(n, d)).astype(np.float32) * 0.05
        if metric == "angular":
            q /= np.linalg.norm(q, axis=1, keepdims=True) + 1e-9
        return q.astype(np.float32)

    queries = make_queries(n_queries)
    train_queries = base if n_train is None else make_queries(n_train)
    return base, queries, train_queries


def clustered_ann(n_base: int = 20000, n_queries: int = 500,
                  n_train: int | None = None, d: int = 32,
                  n_clusters: int = 50, k_gt: int = 10, k_train: int = 20,
                  metric: str = "angular", seed: int = 0) -> ANNData:
    """n_train=None (paper mode): the base vectors ARE the train queries,
    each labelled with its k_train exact neighbours (IRLI §3.2 ANN
    scenario)."""
    base, queries, train_queries = clustered_vectors(
        n_base, n_queries, n_train, d, n_clusters, metric, seed)
    gt = _topk_l2(base, queries, k_gt, metric)
    train_gt = _topk_l2(base, train_queries, k_train, metric)
    return ANNData(base, queries, train_queries, gt, train_gt, metric)
