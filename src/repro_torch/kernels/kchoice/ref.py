"""Plain PyTorch version of the exact power-of-K re-assignment kernel.

The reference's ``kchoice_exact`` (``repro/core/repartition.py``) is a
``lax.scan`` over the labels in insertion order: each label goes to the
FIRST of its K candidate buckets that holds the least load, and that
bucket's float32 load grows by the label's weight. This version walks the
same sequence, one step for all reps at once, on the CPU.

With ``slots`` = S > 1 (the MoE router's top-k, models/moe.py) each
label takes S distinct candidates in turn, in the same walk: its slot j is
the first least-loaded of the candidates its slots before j did not take,
and each pick adds the label's weight. The walk is then the sequence of
(label, slot) picks, each of a label's picks waiting on the one before.

Two more plain helpers describe the kernel's schedule; the tests and
``chip_smoke.py`` use them, the main path never does:
``kchoice_windows`` walks the kernel's conflict-checked windows of 32
labels (and its in-register walk of a window whose clean prefix is short)
and counts its rounds, and ``dependence_depth`` measures the longest chain
of labels that each placement really waits on (the kernel's bound).
"""
from __future__ import annotations

import torch


def kchoice_ref(topk_idx, order, load0=None, weights=None, *, B: int,
                slots: int = 1):
    """topk_idx [G, L, K] int (descending affinity per label), order [G, L]
    (the insertion order, a permutation of 0..L-1 per rep), load0 [G, B] f32
    or None (zeros), weights [L] f32 or None (ones) -> assign [G, L] int32
    (``slots`` = 1) or [G, L, slots] int32 (each label's picks in slot
    order), on topk_idx's device. Runs on host copies: the walk is
    sequential."""
    dev = topk_idx.device
    G, L, K = topk_idx.shape
    if not 1 <= slots <= K:
        raise ValueError(f"kchoice: slots={slots} must lie in [1, K={K}]")
    seq, o, load, inc = _host_inputs(topk_idx, order, load0, weights, B)
    g = torch.arange(G)
    # [L, G, K]: step s holds every rep's s-th label's candidates
    seq = seq.transpose(0, 1).contiguous()
    inc = inc.T.contiguous()
    if slots == 1:
        placed = torch.empty((L, G), dtype=torch.int64)
        for s in range(L):
            cand = seq[s]                                    # [G, K]
            # lexicographic (load, choice-rank): argmin takes the FIRST
            # slot at the minimum load
            b = cand[g, load.gather(1, cand).argmin(dim=1)]
            placed[s] = b
            load[g, b] += inc[s]
        out = torch.empty((G, L), dtype=torch.int64).scatter_(1, o,
                                                              placed.T)
        return out.to(torch.int32).to(dev)
    placed = torch.empty((L, G, slots), dtype=torch.int64)
    inf = torch.tensor(float("inf"))
    for s in range(L):
        cand = seq[s]                                        # [G, K]
        taken = torch.zeros((G, K), dtype=torch.bool)
        for j in range(slots):
            # the first least-loaded candidate not taken yet
            v = torch.where(taken, inf, load.gather(1, cand))
            r = v.argmin(dim=1)
            b = cand[g, r]
            taken[g, r] = True
            placed[s, :, j] = b
            load[g, b] += inc[s]
    out = torch.empty((G, L, slots), dtype=torch.int64).scatter_(
        1, o[..., None].expand(G, L, slots), placed.transpose(0, 1))
    return out.to(torch.int32).to(dev)


def _host_inputs(topk_idx, order, load0, weights, B):
    """Host copies in insertion order: candidates [G, L, K] int64, order
    [G, L] int64, loads [G, B] f32 (a fresh copy), weights [G, L] f32."""
    G, L, _ = topk_idx.shape
    t = topk_idx.detach().cpu().long()
    o = order.detach().cpu().long()
    load = (torch.zeros((G, B), dtype=torch.float32) if load0 is None
            else load0.detach().cpu().float().clone().expand(G, B).clone())
    seq = t[torch.arange(G)[:, None], o]
    inc = (torch.ones((G, L), dtype=torch.float32) if weights is None
           else weights.detach().cpu().float()[o])
    return seq, o, load, inc


#: the walk's policy, which ops.kchoice passes to the kernel with each
#: launch: the rest of a window is walked in registers when fewer of its
#: labels than WALK_BELOW (at most 32) are clean and K <= WALK_MAX_K (at
#: most 16, the candidates a lane of kchoice.cu holds)
WALK_BELOW, WALK_MAX_K = 8, 16


def kchoice_windows(topk_idx, order, load0=None, weights=None, *, B: int,
                    W: int = 32, slots: int = 1):
    """The kernel's schedule, written plainly: each rep walks its labels
    in windows of W from ``start``. Every label of a window takes the first
    least-loaded of its candidates at the window's starting loads; a label
    is dirty when an earlier label of the window chose one of its
    candidates; the labels before the first dirty one commit. When fewer
    than WALK_BELOW are clean (and K <= WALK_MAX_K) the rest of the window
    is placed one label after another, and the next window starts past it;
    otherwise it starts at the first dirty label. Same arguments as
    :func:`kchoice_ref` -> (assign [G, L] int32, equal to kchoice_ref's,
    and rounds [G] int64: each rep's windows plus the walks' steps, one a
    label walked), on topk_idx's device.

    With ``slots`` = S > 1 the walk's steps are the (label, slot) picks,
    and a label's later picks always wait on its first: each window holds
    the picks of W // S whole labels (the last one fewer) and is walked
    from its first pick, so a rep's rounds are its windows plus its
    L·S picks; assign is [G, L, S]."""
    dev = topk_idx.device
    G, L, K = topk_idx.shape
    if slots > 1:
        n = L * slots
        win = W // slots * slots
        rounds = torch.full((G,), -(-n // win) + n, dtype=torch.int64)
        return (kchoice_ref(topk_idx, order, load0, weights, B=B,
                            slots=slots), rounds.to(dev))
    seq, o, load, inc = _host_inputs(topk_idx, order, load0, weights, B)
    placed = torch.empty((G, L), dtype=torch.int64)
    start = torch.zeros(G, dtype=torch.int64)
    rounds = torch.zeros(G, dtype=torch.int64)
    lane = torch.arange(W)
    earlier = lane[None, :] < lane[:, None]               # [i, j]: j < i
    while bool((start < L).any()):
        g = torch.nonzero(start < L)[:, 0]
        pos = start[g, None] + lane                       # [n, W]
        live = pos < L
        pos = pos.clamp(max=L - 1)
        cand = seq[g[:, None], pos]                       # [n, W, K]
        choice = cand.gather(2, load[g[:, None, None], cand].argmin(
            2, keepdim=True))[..., 0]                     # [n, W]
        # lane i is dirty if a live lane j < i chose one of i's candidates
        hit = (cand[:, :, None, :] == choice[:, None, :, None]).any(3)
        dirty = (hit & earlier & live[:, None, :]).any(2) & live
        n_live = live.sum(1)
        first = torch.where(dirty.any(1), dirty.int().argmax(1), n_live)
        commit = lane < first[:, None]                    # [n, W]
        gi = g[:, None].expand(-1, W)[commit]
        bi, pi = choice[commit], pos[commit]
        load[gi, bi] += inc[gi, pi]                       # distinct buckets
        placed[gi, pi] = bi
        walked = (first < n_live) & (first < WALK_BELOW) & (K <= WALK_MAX_K)
        for t in range(W):                      # the walk, label by label
            r = torch.nonzero(walked & (t >= first) & (t < n_live))[:, 0]
            if len(r) == 0:
                continue
            gr, pr = g[r], pos[r, t]
            c = seq[gr, pr]                                # [m, K]
            b = c.gather(1, load[gr[:, None], c].argmin(1, keepdim=True))[:, 0]
            load[gr, b] += inc[gr, pr]
            placed[gr, pr] = b
        start[g] += torch.where(walked, n_live, first)
        rounds[g] += 1 + torch.where(walked, n_live - first, 0)
    out = torch.empty((G, L), dtype=torch.int64).scatter_(1, o, placed)
    return out.to(torch.int32).to(dev), rounds.to(dev)


def dependence_depth(topk_idx, order, assign, *, B: int):
    """The longest chain of dependent placements of each rep: label i's
    depth is 1 + the largest depth of the last label before it (in
    insertion order) placed in one of its candidates, 1 where there is
    none. topk_idx [G, L, K], order [G, L], assign [G, L] (the
    placements) or [G, L, S] (S picks a label, in slot order: each pick
    of a label is a step of the chain, and its later picks wait on its
    earlier ones) -> [G] int64, on topk_idx's device."""
    dev = topk_idx.device
    G, L, _ = topk_idx.shape
    seq, o, _, _ = _host_inputs(topk_idx, order, None, None, B)
    g = torch.arange(G)
    a = assign.detach().cpu().long()
    a = a if a.ndim == 3 else a[..., None]
    placed = a[g[:, None], o]                                 # [G, L, S]
    last = torch.zeros((G, B), dtype=torch.int64)   # depth of b's last pick
    depth = torch.zeros(G, dtype=torch.int64)
    for s in range(L):
        for j in range(placed.shape[2]):
            d = last.gather(1, seq[:, s]).amax(1) + 1
            last[g, placed[:, s, j]] = d
            torch.maximum(depth, d, out=depth)
    return depth.to(dev)
