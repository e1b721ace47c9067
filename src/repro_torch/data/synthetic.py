"""Synthetic data: numpy copies of the reference's ``clustered_ann``,
``zipf_xml``, ``criteo_stream``, ``behavior_stream``, ``random_graph`` and
``molecule_batch`` (``repro/data/synthetic.py``), which
the port keeps so that it imports nothing of the JAX package. The same seed
gives the same arrays.

``clustered_ann``: GloVe/SIFT-like dense vectors with planted,
power-law-sized clusters and exact top-k ground-truth neighbours (brute
force): the ANN labels of IRLI §3.2 ("100 exact near neighbours ...
generated beforehand"). ``behavior_stream``: DIEN's user-history
sequences (Zipf item ids). ``criteo_stream``: DLRM's CTR batches (Zipf
sparse ids, a linear label). ``random_graph``: a power-law graph with
features and synthesized 3-D positions (SchNet's geometric adaptation);
``molecule_batch``: small molecules flattened into one graph with
graph ids. ``zipf_xml``: extreme multi-label data whose
co-occurring labels share geometry and whose label frequencies are Zipf
(the XML scenario of IRLI §3.2, Def. 1).
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


# ------------------------------------------------------------------- XML ----
@dataclasses.dataclass
class XMLData:
    x_train: np.ndarray     # [N, d]
    y_train: list           # list of np.ndarray label ids per point
    x_test: np.ndarray
    y_test: list
    n_labels: int
    label_freq: np.ndarray  # [L]


def zipf_xml(n_train: int = 8000, n_test: int = 1000, d: int = 32,
             n_labels: int = 2000, labels_per_point: int = 3,
             seed: int = 0) -> XMLData:
    """Multi-label data where co-occurring labels share geometry (so a
    learned partition CAN put them together) and frequencies are
    Zipf-distributed."""
    rng = np.random.default_rng(seed)
    label_vecs = rng.normal(size=(n_labels, d)).astype(np.float32)
    pop = 1.0 / np.arange(1, n_labels + 1) ** 1.1      # Zipf popularity
    pop /= pop.sum()

    def make(n):
        xs = np.empty((n, d), np.float32)
        ys = []
        anchor = rng.choice(n_labels, size=n, p=pop)
        for i in range(n):
            a = anchor[i]
            # correlated co-labels: nearest label vectors to the anchor
            sim = label_vecs @ label_vecs[a]
            near = np.argpartition(-sim, labels_per_point + 1)[
                :labels_per_point + 1]
            labs = near[near != a][: labels_per_point - 1]
            labs = np.concatenate([[a], labs]).astype(np.int32)
            ys.append(labs)
            xs[i] = label_vecs[labs].mean(0) + rng.normal(size=d) * 0.3
        return xs, ys

    x_train, y_train = make(n_train)
    x_test, y_test = make(n_test)
    freq = np.zeros(n_labels)
    for labs in y_train:
        freq[labs] += 1
    return XMLData(x_train, y_train, x_test, y_test, n_labels, freq)


# ---------------------------------------------------------------- recsys ----
def criteo_stream(batch: int, n_dense: int, vocab_sizes, seed: int = 0):
    """Infinite CTR batches: {"dense" [B, nd] f32, "sparse" [B, ns] int32,
    "label" [B] f32}."""
    rng = np.random.default_rng(seed)
    vocab_sizes = np.asarray(vocab_sizes, np.int64)
    while True:
        dense = rng.normal(size=(batch, n_dense)).astype(np.float32)
        # Zipf ids clipped per field (power-law access: the hot-row problem)
        z = rng.zipf(1.2, size=(batch, len(vocab_sizes)))
        sparse = (z % vocab_sizes[None, :]).astype(np.int32)
        w = rng.normal(size=(n_dense,)).astype(np.float32)
        label = (dense @ w + rng.normal(size=batch) * 0.1 > 0).astype(
            np.float32)
        yield {"dense": dense, "sparse": sparse, "label": label}


def behavior_stream(batch: int, seq_len: int, item_vocab: int,
                    cate_vocab: int, seed: int = 0):
    """Infinite DIEN batches: Zipf(1.2) history and target items, their
    categories (item mod cate_vocab), a 90% history mask and random labels,
    as numpy arrays."""
    rng = np.random.default_rng(seed)
    while True:
        hist = (rng.zipf(1.2, size=(batch, seq_len)) % item_vocab
                ).astype(np.int32)
        cates = (hist % cate_vocab).astype(np.int32)
        target = (rng.zipf(1.2, size=batch) % item_vocab).astype(np.int32)
        mask = (rng.random((batch, seq_len)) < 0.9).astype(np.float32)
        label = rng.integers(0, 2, batch).astype(np.float32)
        yield {"hist_items": hist, "hist_cates": cates,
               "target_item": target,
               "target_cate": (target % cate_vocab).astype(np.int32),
               "hist_mask": mask, "label": label}


# ----------------------------------------------------------------- graphs ---
def random_graph(n_nodes: int, n_edges: int, d_feat: int, seed: int = 0,
                 n_classes: int = 16) -> dict:
    """Power-law random graph with features and synthesized 3-D positions
    (the SchNet geometric adaptation): {"feats", "src", "dst", "dist",
    "labels", "pos"} as numpy."""
    rng = np.random.default_rng(seed)
    # preferential-attachment-ish degree skew
    p = 1.0 / np.arange(1, n_nodes + 1) ** 0.5
    p /= p.sum()
    src = rng.choice(n_nodes, size=n_edges, p=p).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    feats = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    pos = rng.normal(size=(n_nodes, 3)).astype(np.float32) * 3.0
    dist = np.linalg.norm(pos[src] - pos[dst], axis=1).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    return {"feats": feats, "src": src, "dst": dst, "dist": dist,
            "labels": labels, "pos": pos}


def molecule_batch(batch: int, n_nodes: int, n_edges: int,
                   seed: int = 0) -> dict:
    """Batched small molecules flattened into one graph with graph ids:
    {"types", "src", "dst", "dist", "graph_ids", "energy"} as numpy."""
    rng = np.random.default_rng(seed)
    types = rng.integers(0, 10, (batch, n_nodes)).astype(np.int32)
    pos = rng.normal(size=(batch, n_nodes, 3)).astype(np.float32) * 2.0
    src = rng.integers(0, n_nodes, (batch, n_edges)).astype(np.int32)
    dst = rng.integers(0, n_nodes, (batch, n_edges)).astype(np.int32)
    offs = (np.arange(batch) * n_nodes).astype(np.int32)
    flat_src = (src + offs[:, None]).reshape(-1)
    flat_dst = (dst + offs[:, None]).reshape(-1)
    pf = pos.reshape(-1, 3)
    dist = np.linalg.norm(pf[flat_src] - pf[flat_dst], axis=1).astype(
        np.float32)
    graph_ids = np.repeat(np.arange(batch), n_nodes).astype(np.int32)
    energy = rng.normal(size=batch).astype(np.float32)
    return {"types": types.reshape(-1), "src": flat_src, "dst": flat_dst,
            "dist": dist, "graph_ids": graph_ids, "energy": energy}
