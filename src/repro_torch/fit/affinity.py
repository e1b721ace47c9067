"""Streaming top-K affinity — the [R, L, B] table never exists.
Port of ``repro/fit/affinity.py``.

Re-partitioning only consumes each label's top-K affinity buckets:

  Def. 2 (ANN):  per label-vector chunk, the scorer's first layer
                 (``torch.matmul``), then the output layer and its top-K in
                 one launch of the ``irli_topk`` kernel (with the rows'
                 log-sum-exp for softmax): no [R, chunk, B] block exists on
                 the card. Probabilities are taken of the K logits only:
                 ``exp(v - lse)`` (softmax) or ``sigmoid(v)``, both monotone,
                 so the ranking is the logits'. (The reference ranks the
                 probabilities; a row whose fp32 probabilities round two
                 distinct logits equal may order them otherwise: a near tie.)
  Def. 1 (XML):  incidence pairs pre-bucketed by label chunk (host side,
                 once); per chunk, the pair points' probabilities summed per
                 label (``index_add_``) into [R, chunk, B], then the stable
                 top-K (``core/topk.py``). No kernel in the reference either.

The only state carried across chunks is the running (values, ids) pair
[R, L, K].
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.network import scorer_hidden, scorer_probs
from repro_torch.core.topk import topk_stable
from repro_torch.kernels.irli_topk.ops import scorer_topk


def ann_chunks(label_vecs: torch.Tensor, chunk: int):
    """Pad + reshape label vectors into [n_chunks, chunk, d] (the last
    chunk zero-padded) -> (chunks, chunk)."""
    L, d = label_vecs.shape
    chunk = min(chunk, L)
    pad = (-L) % chunk
    lv = torch.nn.functional.pad(label_vecs, (0, 0, 0, pad))
    return lv.reshape((L + pad) // chunk, chunk, d), chunk


def topk_probs(params: dict, x: torch.Tensor, K: int,
               loss_kind: str = "softmax_bce"):
    """The top-K bucket probabilities of rows x [n, d] -> (vals [R, n, K]
    f32 descending, ids [R, n, K] int32), through the fused output layer +
    top-K (``irli_topk``; its plain version on the CPU)."""
    h = scorer_hidden(params, x)                                # [R, n, H]
    w2, b2 = params["w2"], params["b2"]
    softmax = loss_kind == "softmax_bce"
    out = scorer_topk(h.to(w2.dtype), w2, b2, m=K, lse=softmax)
    if softmax:
        v, i, lse = out
        return torch.exp(v - lse[..., None]), i
    v, i = out
    return torch.sigmoid(v), i


def affinity_topk_ann_chunks(params: dict, xs: torch.Tensor, K: int,
                             loss_kind: str = "softmax_bce"):
    """Def. 2 over pre-chunked label vectors xs [n_chunks, chunk, d] ->
    (vals f32, ids int32) [R, n_chunks·chunk, K] (padded rows included)."""
    n_chunks, chunk, _ = xs.shape
    R = params["w1"].shape[0]
    vals = torch.empty((R, n_chunks * chunk, K), dtype=torch.float32,
                       device=xs.device)
    idxs = torch.empty((R, n_chunks * chunk, K), dtype=torch.int32,
                       device=xs.device)
    for c in range(n_chunks):
        v, i = topk_probs(params, xs[c], K, loss_kind)
        vals[:, c * chunk:(c + 1) * chunk] = v
        idxs[:, c * chunk:(c + 1) * chunk] = i
    return vals, idxs


def affinity_topk_ann(params: dict, label_vecs: torch.Tensor, K: int,
                      loss_kind: str = "softmax_bce", chunk: int = 4096):
    """Def. 2, streamed: top-K of ``f_r(label_vec_l)`` without [R, L, B]
    -> (vals, ids) [R, L, K], descending per label."""
    L = label_vecs.shape[0]
    xs, _ = ann_chunks(label_vecs, chunk)
    vals, idxs = affinity_topk_ann_chunks(params, xs, K, loss_kind)
    return vals[:, :L], idxs[:, :L]


def chunk_xml_pairs(pair_point, pair_label, n_labels: int, chunk: int):
    """Host side, once per fit: bucket (point, label) incidence pairs by
    label chunk and pad each chunk to the max pair count. Returns
    ((points, label_local, weight) [n_chunks, Pmax] CPU tensors, chunk);
    weight 0 marks padding pairs. A copy of the reference's numpy routine:
    the stable sort keeps each label's pair order."""
    pp = np.asarray(pair_point, np.int32).reshape(-1)
    pl = np.asarray(pair_label, np.int32).reshape(-1)
    chunk = min(chunk, n_labels)
    n_chunks = -(-n_labels // chunk)
    cid = pl // chunk
    counts = np.bincount(cid, minlength=n_chunks)
    pmax = max(1, int(counts.max()) if counts.size else 1)
    points = np.zeros((n_chunks, pmax), np.int32)
    locs = np.zeros((n_chunks, pmax), np.int32)
    w = np.zeros((n_chunks, pmax), np.float32)
    order = np.argsort(cid, kind="stable")
    start = 0
    for c in range(n_chunks):
        k = int(counts[c])
        sel = order[start:start + k]
        points[c, :k] = pp[sel]
        locs[c, :k] = pl[sel] - c * chunk
        w[c, :k] = 1.0
        start += k
    return tuple(torch.from_numpy(a) for a in (points, locs, w)), chunk


def affinity_topk_xml_chunks(params: dict, x: torch.Tensor, chunked_pairs,
                             chunk: int, K: int,
                             loss_kind: str = "softmax_bce"):
    """Def. 1 over pre-bucketed pairs -> (vals f32, ids int32)
    [R, n_chunks·chunk, K] (padded label rows included). Each chunk's pair
    points are re-scored: neither [R, L, B] nor [R, N, B] exists."""
    points, locs, w = (t.to(x.device) for t in chunked_pairs)
    n_chunks = points.shape[0]
    R = params["w1"].shape[0]
    B = params["w2"].shape[2]
    vals = torch.empty((R, n_chunks * chunk, K), dtype=torch.float32,
                       device=x.device)
    idxs = torch.empty((R, n_chunks * chunk, K), dtype=torch.int32,
                       device=x.device)
    for c in range(n_chunks):
        p = scorer_probs(params, x[points[c].long()], loss_kind)  # [R, P, B]
        p.mul_(w[c][None, :, None])
        seg = torch.zeros((R, chunk, B), dtype=p.dtype, device=x.device)
        seg.index_add_(1, locs[c].long(), p)
        del p
        v, i = topk_stable(seg, K)
        vals[:, c * chunk:(c + 1) * chunk] = v
        idxs[:, c * chunk:(c + 1) * chunk] = i.to(torch.int32)
    return vals, idxs


def affinity_topk_xml(params: dict, x: torch.Tensor, chunked_pairs,
                      n_labels: int, K: int, loss_kind: str = "softmax_bce",
                      chunk: int = 4096):
    """Def. 1, streamed: top-K of ``Σ_{i: l ∈ y_i} f_r(x_i)`` -> (vals, ids)
    [R, n_labels, K]. ``chunked_pairs`` / ``chunk`` come from
    :func:`chunk_xml_pairs`."""
    vals, idxs = affinity_topk_xml_chunks(params, x, chunked_pairs, chunk,
                                          K, loss_kind)
    return vals[:, :n_labels], idxs[:, :n_labels]
