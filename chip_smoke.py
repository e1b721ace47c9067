#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It builds the six hand-written kernels from the repository's .cu sources
(one nvcc each, in parallel), holds each against its plain PyTorch version
on the card, and drives the port's two paths at the irli-deep1b widths:

  * search (Alg. 2) through ``IRLIIndex.search``: the compact path
    (``mode="compact"``, int8 store: irli_topk, freq_topc and quant_rerank,
    one launch each) and the fused path (``mode="auto"``, which resolves to
    ``"mega"`` here: one launch of mega_query and no other kernel, by the
    counters and a torch.profiler trace), then the other store kinds, l2,
    adaptive m and an exact tier at Q = 64;
  * the fit (Alg. 1) through ``IRLIIndex.fit``, ANN mode, sigmoid_bce: per
    train step one bce_logits launch, per affinity label chunk one
    irli_topk launch, per round one kchoice launch; its round 1 again with
    the plain versions in place of the three kernels (no launch), held
    against the kernel fit's round 1; then one round of a softmax_bce fit
    (the paper's loss: no bce_logits); recall@10 of the fitted index
    against exact search, above the hash partition's.

Each path's counters are set to 0 just before it runs and read just after.
Every search is held against the same search with the plain versions
(kernels/mega_query/ref.mega_search_ref), on the card: ids equal outside
the rows with a near tie (|a - b| <= 1e-5 + 1e-5·|b|) at the m, k' or k cut,
scores to 1e-5. The fit's kernels are held against their plain versions at
the fit's shapes, and the formerly refused shapes (irli_topk at m = 128,
40,000-wide freq_topc rows through its wide variant, quant_rerank at
topC = 20,000) against theirs. bce_logits' gradient is held in the units
of σ(x) - y (each element divided by its row's scale·w), where TOL bounds
a value of size up to 1. Then it times every stage and kernel with CUDA
events.

Its last line is ``{"ok": true, "device": {...}}``; the line before it holds
the per-kernel record (launches, error, times, bounds). Any failure raises
and exits non-zero with no ``ok`` line; so does a run without a card, or
from a directory that holds this file and nothing else of the repository.
``python3 chip_smoke.py --fit-recall L N`` runs only the fit cell's fit and
recall, at L labels and N training queries, and prints them as JSON.

Widths (configs/irli_deep1b.py): D=96, B=20000, R=32, H=1024. Search, the
serve_query cell: int8 block 32, m=5, tau=2, k=10, topC=1024, refine_k auto
(40); reduced in scale to one card: L = 2,000,000 corpus rows (of 2^27), so
that max_load = 2·L/B = 200 and the gathered width C0 = R·m·max_load =
32,000 sorts in one block's shared memory (freq_topc's MAX_WIDTH 32,768);
Q = 1024 queries per call
(of 4096); data, queries and weights random, from a seed. The fit: K =
FIT_K = 10, 100 exact-neighbour labels a point (K_NEIGH), lr 1e-3, ANN mode
(Def. 2); reduced in scale: L = N = 131,072 labels and training points (of
2^27; each base vector a training query labelled with its 100 exact
neighbours, computed on the card), batch 4096 (of FIT_BATCH 32,768, whose
targets alone would be 84 GB), 2 rounds (of 5) of 1 epoch (of 5), affinity
chunk FIT_AFFINITY_CHUNK = 65,536; data by clustered_ann's recipe at these
sizes from SEED. The softmax_bce fit: one round over N = L = 16,384 at
batch 1024 (its autograd keeps several [R, batch, B] tensors). More labels
a bucket do not lift the fit's recall on this data: at L = 2,000,000 and
N = 131,072 (``--fit-recall 2000000 131072``) the partition collapses
alike, so the cell keeps L/B = 6.55 and its time (PERF.md).
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 0
D, B, R, H = 96, 20000, 32, 1024
L = 2_000_000
Q = 1024
Q_SMALL = 64
BLOCK = 32
M, TAU, K, TOPC = 5, 2, 10, 1024
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_FLOPS = 67e12                 # H100 SXM fp32 outside the tensor cores
TOL = 1e-5                         # |a - b| <= TOL + TOL·|b| for fp32 values
KERNELS = ("irli_topk", "freq_topc", "quant_rerank", "mega_query",
           "bce_logits", "kchoice")
# the fit cell
FIT_L = 131_072
FIT_K, K_NEIGH, FIT_BATCH, FIT_ROUNDS, FIT_CHUNK = 10, 100, 4096, 2, 65_536
SOFT_L, SOFT_BATCH = 16_384, 1024


def log(*args):
    print(*args, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, n: int = 15, warmup: int = 3) -> float:
    """Median of n CUDA-event timings of fn(), after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float):
    """The least time the card could take: the larger of the operations at
    the fp32 peak and the bytes at the memory rate -> (ms, bound_by)."""
    return max((flops / FP32_FLOPS * 1e3, "operations"),
               (nbytes / HBM_BYTES_PER_S * 1e3, "bytes"))


def bce_grad_err(gk, gp, wt, scale, rows=8192) -> float:
    """max |gk - gp| / (scale·w[row mod N]) over the rows of two [R·N, B]
    bce_logits gradients whose rows carry weight w [N] -- the error of
    σ(x) - y itself -- taken 8192 rows at a time; raises unless a
    zero-weight row's gradient is exactly 0 in both."""
    import torch
    N = wt.shape[0]
    err = 0.0
    for s in range(0, gk.shape[0], rows):
        n = min(rows, gk.shape[0] - s)
        w = wt[(s + torch.arange(n, device=gk.device)) % N]
        d = (gk[s:s + rows] - gp[s:s + rows]).abs()
        if bool((gk[s:s + rows][w == 0] != 0).any()
                or (gp[s:s + rows][w == 0] != 0).any()):
            raise AssertionError("bce_logits: a zero-weight row has a "
                                 "gradient")
        live = w > 0
        if bool(live.any()):
            err = max(err, float((d[live] / (scale * w[live, None])).max()))
    return err


def neighbours(torch, dev, base, q, k):
    """Exact top-k ids of q in base on the card (core/query.exact_topk),
    1024 queries at a time."""
    from repro_torch.core.query import exact_topk
    tomb = torch.zeros(base.shape[0], dtype=torch.bool, device=dev)
    return torch.cat([exact_topk(q[s:s + 1024], base, tomb, k=k)
                      for s in range(0, q.shape[0], 1024)])


def fit_config(n_labels: int, **over):
    """The fit cell's IRLIConfig at n_labels labels (sigmoid_bce, ANN mode,
    FIT_ROUNDS rounds of 1 epoch at batch FIT_BATCH), with overrides."""
    from repro_torch.core.index import IRLIConfig
    kw = dict(d=D, n_labels=n_labels, n_buckets=B, n_reps=R, d_hidden=H,
              K=FIT_K, rounds=FIT_ROUNDS, epochs_per_round=1,
              batch_size=FIT_BATCH, lr=1e-3, loss="sigmoid_bce",
              affinity_chunk=FIT_CHUNK, seed=SEED)
    return IRLIConfig(**{**kw, **over})


def fit_run(torch, dev, n_labels: int, n_train: int) -> dict:
    """The fit cell's data, its fit through IRLIIndex.fit and recall@K of Q
    held-out queries before the fit (the hash partition) and after it.
    n_train == n_labels is the paper's ANN mode, every base vector a
    training query; fewer train on clustered_ann's held-apart training
    queries. Each is labelled with its K_NEIGH exact neighbours, computed on
    the card. Checks the launches (bce_logits a train step, irli_topk an
    affinity chunk, kchoice a round), that round 2's loss is below round
    1's and that the fit's recall is above the hash partition's."""
    from repro_torch.core.index import IRLIIndex
    from repro_torch.core.search_api import SearchParams
    from repro_torch.data.synthetic import clustered_vectors
    from repro_torch.fit.engine import FitEngine
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.store.quantized import encode

    t0 = time.perf_counter()
    paper = n_train == n_labels
    base, fq, tq = clustered_vectors(
        n_base=n_labels, n_queries=Q, n_train=None if paper else n_train,
        d=D, seed=SEED)
    base, fq = torch.from_numpy(base).to(dev), torch.from_numpy(fq).to(dev)
    train = base if paper else torch.from_numpy(tq).to(dev)
    labels = neighbours(torch, dev, base, train, K_NEIGH)      # [N, 100]
    gt = neighbours(torch, dev, base, fq, K)                    # [Q, 10]
    store = encode(base, "int8", BLOCK)
    torch.cuda.synchronize()
    log(f"fit data: clustered_ann's recipe, {n_labels} x {D} base (the "
        f"labels), {n_train} training queries "
        f"({'the base itself' if paper else 'near base vectors'}) with "
        f"{K_NEIGH} exact neighbours each, and the {Q} held-out queries' "
        f"top-{K}, on the card: {time.perf_counter() - t0:.2f} s")

    cfg = fit_config(n_labels)
    idx = IRLIIndex(cfg, device=dev)
    sp = SearchParams(m=M, tau=TAU, k=K, topC=TOPC, store_dtype="int8")

    def recall():
        """recall@K of the held-out queries, the search's mode, and the
        share of (rep, label) slots the index holds: build_index keeps at
        most max_load = 2·L/B labels a bucket."""
        idx.build_index()
        res = idx.search(fq, store, sp)
        hit = ((res.ids[:, :, None] == gt[:, None, :])
               & (res.ids[:, :, None] >= 0)).any(-1).sum(1)
        kept = float((idx.index.members >= 0).sum()) / (R * n_labels)
        return float(hit.float().mean()) / K, res.mode, kept

    r_hash, mode, k_hash = recall()
    rows, round0 = [], {}

    class RoundLog:
        def log(self, row, step):
            rows.append(row)
            if step == 0:                      # round 1's outcome, kept
                round0.update(row, assign=idx.assign.clone())

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    stats = idx.fit(train, labels, label_vecs=base, log=RoundLog())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {n: c for n, c in LAUNCHES.items() if c}
    eng = FitEngine(cfg, idx.scorer_cfg)
    n_rounds = len(stats.round_idx)
    steps = eng.batch_plan(n_train)[0]
    want = {"bce_logits": steps * n_rounds,
            "irli_topk": -(-n_labels // FIT_CHUNK) * n_rounds,
            "kchoice": n_rounds}
    for row in rows:
        log(f"fit round {row['round']}: {row['seconds']:.3f} s, loss "
            f"{row['loss']:.6f}, reassigned {row['n_reassigned']} (churn "
            f"{row['churn']:.4f}), load std {row['load_std']:.4f}, min "
            f"{row['load_min']:.0f}, max {row['load_max']:.0f}, KL "
            f"{row['load_kl']:.5f}, grad norm {row['grad_norm']:.5f}")
    log(f"fit: {n_rounds} rounds of {steps} steps in {fit_s:.2f} s; "
        f"launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"the fit launched {launches}, expected {want}")
    if n_rounds < 2 or not stats.train_loss[1] < stats.train_loss[0]:
        raise AssertionError(f"round 2's loss is not below round 1's: "
                             f"{stats.train_loss}")
    r_fit, mode, k_fit = recall()
    log(f"recall@{K} of {Q} held-out queries (IRLIIndex.search, mode='auto' "
        f"-> {mode!r}, m={M}, tau={TAU}, topC={TOPC}, int8 store) against "
        f"exact_topk: hash partition {r_hash:.4f}, after the fit "
        f"{r_fit:.4f}; (rep, label) slots in the index (max_load "
        f"{idx.index.members.shape[2]}): hash {k_hash:.4f}, fit {k_fit:.4f}")
    if not r_fit > r_hash:
        raise AssertionError(f"the fitted index's recall {r_fit} is not above "
                             f"the hash partition's {r_hash}")
    return dict(idx=idx, eng=eng, cfg=cfg, base=base, train=train,
                labels=labels, rows=rows, round0=round0, launches=launches,
                recall=(r_hash, r_fit))


@contextlib.contextmanager
def plain_versions():
    """Route the fit's three kernel dispatch sites to their plain versions
    while the block runs, on the card too: bce_logits' forward
    (kernels/bce_logits/ops.weighted_bce), the affinity's output layer and
    top-K (fit/affinity.scorer_topk) and the re-assignment
    (core/repartition.kchoice_assign). Only for the comparison of a whole
    round with its kernel-free twin."""
    import repro_torch.core.repartition as rp
    import repro_torch.fit.affinity as aff
    from repro_torch.kernels.bce_logits import ops as bops
    from repro_torch.kernels.bce_logits.ref import weighted_bce_ref
    from repro_torch.kernels.irli_topk.ref import irli_topk_ref
    from repro_torch.kernels.kchoice.ref import kchoice_ref
    saved = bops.weighted_bce, aff.scorer_topk, rp.kchoice_assign
    bops.weighted_bce = (lambda x, y, w=None, *, scale=1.0:
                         weighted_bce_ref(x, y, w, scale))
    aff.scorer_topk, rp.kchoice_assign = irli_topk_ref, kchoice_ref
    try:
        yield
    finally:
        bops.weighted_bce, aff.scorer_topk, rp.kchoice_assign = saved


def plain_round_check(torch, dev, run: dict) -> float:
    """Round 1 of the fit again, from the same start (the weights, batches
    and insertion orders all come from cfg.seed), with the plain versions in
    place of the three kernels and no launch; held against the kernel fit's
    round 1: its mean loss to 1e-4 relative (the tolerance of
    tests/test_torch_fit.py for a round against the reference), its load
    std to 1%, and the assignment equal in at least 95% of the (rep, label)
    slots. The rest may rightly differ: two of a label's top-K buckets whose
    logits are a near tie (the sums run in another order) swap places, and
    where both hold the least load at the label's turn the walk takes the
    first, so the label goes elsewhere and the walk carries that on. A wrong
    kernel moves far more. The plain affinity holds one [R, chunk, B] logit
    block, so it runs at chunk 2048. -> the share of slots assigned
    alike."""
    from repro_torch.core.index import IRLIIndex
    from repro_torch.kernels import LAUNCHES, reset_launches
    n_labels = run["base"].shape[0]
    pidx = IRLIIndex(fit_config(n_labels, rounds=1, affinity_chunk=2048),
                     device=dev)
    rows = []

    class RoundLog:
        def log(self, row, step):
            rows.append(row)

    reset_launches()
    t0 = time.perf_counter()
    with plain_versions():
        pidx.fit(run["train"], run["labels"], label_vecs=run["base"],
                 log=RoundLog())
    torch.cuda.synchronize()
    k0, p0 = run["round0"], rows[0]
    same = float((pidx.assign == k0["assign"]).float().mean())
    loss_rel = abs(p0["loss"] - k0["loss"]) / abs(k0["loss"])
    std_rel = abs(p0["load_std"] - k0["load_std"]) / k0["load_std"]
    log(f"fit round 1 with the plain versions (no launch: "
        f"{sum(LAUNCHES.values())} launches), {time.perf_counter() - t0:.1f}"
        f" s: loss {p0['loss']:.6f} (kernels {k0['loss']:.6f}, relative "
        f"{loss_rel:.3g}), load std {p0['load_std']:.4f} (kernels "
        f"{k0['load_std']:.4f}), assignment equal in {same:.6f} of the "
        f"(rep, label) slots")
    if sum(LAUNCHES.values()) or not (loss_rel <= 1e-4 and std_rel <= 0.01
                                      and same >= 0.95):
        raise AssertionError("the fit's round 1 through the kernels differs "
                             "from its plain twin")
    del pidx
    return same


def fit_cell(torch, dev, check_irli) -> dict:
    """The fit cell: IRLIIndex.fit at the irli-deep1b widths (sigmoid_bce,
    ANN mode, fit_run), its kernels against their plain versions at the
    fit's shapes, its round 1 against a kernel-free twin, the stage times;
    then one round of a softmax_bce fit. Returns the kernels' launches on
    the fit's path, their records, times and bounds."""
    import torch.nn.functional as F

    from repro_torch.core import partition as PT
    from repro_torch.core.index import IRLIConfig, IRLIIndex
    from repro_torch.core.network import (scorer_hidden, scorer_logits,
                                          scorer_loss_parts)
    from repro_torch.core.repartition import insertion_orders
    from repro_torch.data.synthetic import clustered_vectors
    from repro_torch.fit.engine import FitData
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.bce_logits import ops as bops
    from repro_torch.kernels.bce_logits.ref import weighted_bce_ref
    from repro_torch.kernels.kchoice import ops as kops
    from repro_torch.kernels.kchoice.ref import kchoice_ref
    from repro_torch.optim.optimizers import apply_clip, global_norm_sq

    run = fit_run(torch, dev, FIT_L, FIT_L)
    idx, eng = run.pop("idx"), run["eng"]
    base, train, labels = run["base"], run["train"], run["labels"]
    rows, launches = run["rows"], run["launches"]
    build_ms = time_ms(torch, idx.build_index, n=5)

    # ---- one train step: bce_logits against the plain loss, and fp64 ----
    params, keys = idx.params, sorted(idx.params)
    idx_b, w_b = eng.round_batches(FIT_L, SEED, 0)
    ones = torch.ones((FIT_BATCH, K_NEIGH), device=dev)

    def step_grads(n, plain=False, dtype=torch.float32):
        sel, wt = idx_b[0, :n].to(dev), w_b[0, :n].to(dev)
        tg = PT.bucket_targets(idx.assign, labels[sel], ones[:n], B)
        p = {k: v.detach().to(dtype).requires_grad_(True)
             for k, v in params.items()}
        scale = 1.0 / (R * max(float(wt.sum()), 1.0))
        x, tg, wt = train[sel].to(dtype), tg.to(dtype), wt.to(dtype)
        if plain:
            lg = scorer_logits(p, x)
            per = lg.clamp_min(0) - lg * tg + torch.log1p(torch.exp(-lg.abs()))
            s = (per.sum(-1) * wt).sum() * scale
        else:
            s, _ = scorer_loss_parts(p, idx.scorer_cfg, x, tg, wt,
                                     scale=scale)
        g = torch.autograd.grad(s, [p[k] for k in keys])
        return s.detach(), dict(zip(keys, g))

    sk, gk = step_grads(512)
    sp_, gp = step_grads(512, plain=True)
    s64, g64 = step_grads(512, plain=True, dtype=torch.float64)
    if abs(float(sk) - float(sp_)) > 1e-5 * abs(float(sp_)):
        raise AssertionError(f"train step loss: kernel {float(sk)}, plain "
                             f"{float(sp_)}")
    rel = {k: float((gk[k] - gp[k]).abs().max() / gp[k].abs().max())
           for k in keys}
    rel64 = {k: float((gk[k].double() - g64[k]).abs().max()
                      / g64[k].abs().max()) for k in keys}
    log(f"one train step (512 rows): loss kernel {float(sk):.8f}, plain "
        f"{float(sp_):.8f}, fp64 {float(s64):.8f}; gradients kernel vs plain "
        f"max |err| / max |g|: {rel}; fp32 kernel vs fp64: {rel64}")
    if max(rel.values()) > 1e-5:
        raise AssertionError(f"train step gradients off the plain ones: {rel}")
    if max(rel64.values()) > 1e-4:
        raise AssertionError(f"train step gradients off fp64 by {rel64}: "
                             f"are the GEMMs in TF32?")
    del gk, gp, g64

    # ---- bce_logits at the fit step's shape [R·4096, B] ----
    sel, wt = idx_b[0].to(dev), w_b[0].to(dev)
    scale = 1.0 / (R * max(float(wt.sum()), 1.0))
    with torch.no_grad():
        xb = scorer_logits(params, train[sel]).reshape(-1, B)
        yb = PT.bucket_targets(idx.assign, labels[sel], ones, B).reshape(
            -1, B)
    lk, gk = bops.bce_logits(xb, yb, wt, scale=scale)
    lp, gp = weighted_bce_ref(xb, yb, wt, scale)
    torch.cuda.synchronize()
    # each gradient element is scale·w·(σ(x) - y), at most 7.6e-6 here: hold
    # it in σ(x) - y's own units, where TOL means what it says
    loss_rel = abs(float(lk) - float(lp)) / abs(float(lp))
    grad_err = bce_grad_err(gk, gp, wt, scale)
    bce_err = max(loss_rel, grad_err)
    log(f"bce_logits {tuple(xb.shape)}: loss kernel {float(lk):.8f}, plain "
        f"{float(lp):.8f} (relative error {loss_rel:.3g}); gradient max "
        f"|kernel - plain| / (scale·w), the error in σ(x) - y: "
        f"{grad_err:.3g} (zero-weight rows exactly 0)")
    if not (loss_rel <= TOL and grad_err <= TOL):
        raise AssertionError("bce_logits differs from its plain version")
    del gk, gp
    torch.cuda.empty_cache()
    bce_ms = time_ms(torch, lambda: bops.bce_logits(xb, yb, wt, scale=scale),
                     n=10)
    bce_plain = time_ms(torch, lambda: weighted_bce_ref(xb, yb, wt, scale),
                        n=3, warmup=1)

    def bce_library():
        return (F.binary_cross_entropy_with_logits(xb, yb, reduction="sum"),
                torch.sigmoid(xb) - yb)

    bce_lib = time_ms(torch, bce_library, n=3, warmup=1)
    n_el = xb.numel()
    bce_bound = bound(12 * n_el, 12 * n_el + 4 * wt.numel())
    log(f"bce_logits: {12 * n_el / 1e9:.2f} GB in+out -> bound "
        f"{bce_bound[0]:.4f} ms ({bce_bound[1]}); kernel {bce_ms:.4f} ms "
        f"({12 * n_el / bce_ms / 1e6:.1f} GB/s), plain {bce_plain:.4f} ms, "
        f"library (binary_cross_entropy_with_logits + sigmoid - y) "
        f"{bce_lib:.4f} ms")
    del xb, yb
    torch.cuda.empty_cache()

    # ---- the affinity pass: peak memory, time, a chunk against plain ----
    data = FitData.build(train, labels, label_vecs=base, n_labels=FIT_L,
                         chunk=FIT_CHUNK, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    vals, ids = eng.affinity_topk(params, data)
    e1.record()
    e1.synchronize()
    aff_ms = e0.elapsed_time(e1)
    peak = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    # what the streamed design holds: the label vectors cut into chunks, one
    # chunk's [R, chunk, H] hidden layer, the running [R, L, K] top-K
    # (values and ids) and one chunk's irli_topk output and probabilities
    n_lab = data.label_vecs.shape[0]
    n_pad = -(-n_lab // FIT_CHUNK) * FIT_CHUNK
    design = (n_pad * D * 4 + R * FIT_CHUNK * H * 4 + R * n_pad * FIT_K * 8
              + R * FIT_CHUNK * (FIT_K * 12 + 4)) / 1e9
    block = R * FIT_CHUNK * B * 4 / 1e9
    log(f"affinity pass ({n_lab} labels, chunk {FIT_CHUNK}): {aff_ms:.2f} ms; "
        f"peak device memory {peak:.3f} GB above its inputs, against "
        f"{design:.3f} GB that the streamed design holds (limit 1.1 x that; "
        f"one [R, chunk, B] fp32 block would be {block:.1f} GB)")
    if not peak <= 1.1 * design:
        raise AssertionError(f"the affinity pass peaked at {peak} GB, past "
                             f"1.1 x the {design} GB its design holds")
    h = scorer_hidden(params, base[:2048])
    irli_err = check_irli(f"fit affinity chunk (2048 labels, m=K={FIT_K})",
                          h, params["w2"], params["b2"], FIT_K)
    del h, vals

    # ---- kchoice against the plain loop at the fit's shape ----
    orders = insertion_orders(R, FIT_L, dev,
                              torch.Generator().manual_seed(SEED)).int()
    ids = ids.contiguous()
    ak = kops.kchoice(ids, orders, B=B)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ap = kchoice_ref(ids, orders, B=B)
    torch.cuda.synchronize()
    k_plain = (time.perf_counter() - t0) * 1e3
    if not torch.equal(ak, ap):
        raise AssertionError(f"kchoice differs from the plain loop in "
                             f"{int((ak != ap).sum())} placements")
    k_ms = time_ms(torch, lambda: kops.kchoice(ids, orders, B=B), n=5)
    # its bound: the chain of dependent steps, each at least one
    # shared-memory read-add-write and ceil(log2 K) shuffle-and-min levels,
    # both latencies measured on this card (kchoice.cu), at the SM's top clock
    rmw, level = kops.step_cycles(dev)
    n_lab = ids.shape[1]
    step = rmw + math.ceil(math.log2(FIT_K)) * level
    sm_clock = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    k_bytes = R * n_lab * (FIT_K + 2) * 4
    k_bound = max((n_lab * step / sm_clock * 1e3, "operations"),
                  (k_bytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    log(f"kchoice {list(ids.shape)}: bit-equal to the plain loop; kernel "
        f"{k_ms:.4f} ms ({k_ms * 1e-3 / n_lab * sm_clock:.1f} clocks a "
        f"label, the reps in parallel), plain (host loop over the labels, "
        f"reps vectorised) {k_plain:.1f} ms; bound: {n_lab} dependent steps "
        f"x ({rmw:.1f} clocks a shared-memory read-add-write + "
        f"{math.ceil(math.log2(FIT_K))} x {level:.1f} a shuffle-and-min "
        f"level, measured) at {sm_clock / 1e6:.0f} MHz = "
        f"{n_lab * step / sm_clock * 1e3:.4f} ms (the bytes, "
        f"{k_bytes / 1e6:.1f} MB: {k_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms)"
        f" -> {k_bound[0]:.4f} ms")
    del ak, ap

    # ---- one train step split into its stages (CUDA events) ----
    x_in = train[sel]

    def split_step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        tg = PT.bucket_targets(idx.assign, labels[sel], ones, B)
        ev[1].record()
        for k in keys:
            params[k].requires_grad_(True)
        hh = scorer_hidden(params, x_in)
        ev[2].record()
        lg = torch.bmm(hh, params["w2"]).add_(params["b2"][:, None, :])
        ev[3].record()
        loss = bops.sigmoid_bce_loss(lg, tg, wt, scale=scale)
        del lg, tg
        ev[4].record()
        g = torch.autograd.grad(loss, [params[k] for k in keys])
        for k in keys:
            params[k].requires_grad_(False)
        ev[5].record()
        g = dict(zip(keys, g))
        apply_clip(g, torch.sqrt(global_norm_sq(g)), 1.0)
        eng.opt.update(params, g, idx.opt_state)
        ev[6].record()
        ev[6].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(6)]

    split_step()
    runs = [split_step() for _ in range(3)]
    names = ["targets (bucket_targets)", "first layer (matmul)",
             "output GEMM (bmm + bias)", "bce_logits (loss + gradient)",
             "backward (autograd GEMMs)", "clip + AdamW"]
    med = [statistics.median(r[i] for r in runs) for i in range(6)]
    for name, ms in zip(names, med):
        log(f"fit stage {name}: {ms:.4f} ms")
    log(f"fit stage whole train step: {sum(med):.4f} ms; affinity pass "
        f"{aff_ms:.4f} ms; kchoice {k_ms:.4f} ms; build_index "
        f"{build_ms:.4f} ms; whole round (host clock, from the fit) "
        f"{', '.join('%.1f' % (r['seconds'] * 1e3) for r in rows)} ms")

    # ---- round 1 again, kernel-free ----
    del idx, params, data, ids, x_in
    torch.cuda.empty_cache()
    same = plain_round_check(torch, dev, run)
    del run
    torch.cuda.empty_cache()

    # ---- one round of the paper's softmax_bce ----
    sbase, _, _ = clustered_vectors(n_base=SOFT_L, n_queries=1, d=D,
                                    seed=SEED + 1)
    sbase = torch.from_numpy(sbase).to(dev)
    slabels = neighbours(torch, dev, sbase, sbase, K_NEIGH)
    scfg = IRLIConfig(d=D, n_labels=SOFT_L, n_buckets=B, n_reps=R,
                      d_hidden=H, K=FIT_K, rounds=1, epochs_per_round=1,
                      batch_size=SOFT_BATCH, lr=1e-3, loss="softmax_bce",
                      affinity_chunk=FIT_CHUNK, seed=SEED)
    sidx = IRLIIndex(scfg, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    sst = sidx.fit(sbase, slabels, label_vecs=sbase)
    torch.cuda.synchronize()
    slaunch = {n: c for n, c in LAUNCHES.items() if c}
    log(f"softmax_bce fit, 1 round over {SOFT_L} labels at batch "
        f"{SOFT_BATCH}: {time.perf_counter() - t0:.2f} s, loss "
        f"{sst.train_loss}, reassigned {sst.n_reassigned}, load std "
        f"{sst.load_std}; launches {slaunch}")
    if slaunch != {"irli_topk": 1, "kchoice": 1}:
        raise AssertionError(f"the softmax_bce fit launched {slaunch}")
    if not all(torch.isfinite(v).all() for v in sidx.params.values()):
        raise AssertionError("the softmax_bce fit left non-finite weights")
    del sidx, base, train, labels
    torch.cuda.empty_cache()
    return {"launches": launches,
            "record": {"bce_logits": {"max_abs_err": bce_err},
                       "kchoice": {"max_abs_err": 0.0}},
            "times": {"bce_logits": (bce_ms, bce_plain, bce_lib),
                      "kchoice": (k_ms, k_plain, None)},
            "bounds": {"bce_logits": bce_bound, "kchoice": k_bound},
            "irli_err": irli_err}


def main() -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fit-recall", nargs=2, type=int, metavar=("L", "N"),
                    help="only the fit cell's fit and recall, at L labels "
                         "and N training queries (N = L: the paper's mode)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (sets allow_tf32=False)
    if args.fit_recall:
        log(f"nvidia-smi: {nvidia_smi('name,power.limit')}")
        run = fit_run(torch, torch.device("cuda", 0), *args.fit_recall)
        print(json.dumps({"fit_recall": {
            "labels": args.fit_recall[0], "train": args.fit_recall[1],
            "recall_hash": run["recall"][0], "recall_fit": run["recall"][1],
            "rounds": run["rows"]}}), flush=True)
        return 0
    from repro_torch.core.index import IRLIConfig, IRLIIndex
    from repro_torch.core.network import scorer_hidden, scorer_logits
    from repro_torch.core.query import (gather_members, probe_keep_mask,
                                        rerank_gathered)
    from repro_torch.core.search_api import SearchParams
    from repro_torch.core.topk import topk_stable
    from repro_torch.kernels import LAUNCHES, _build, reset_launches
    from repro_torch.kernels.freq_topc import ops as fops
    from repro_torch.kernels.freq_topc.ref import freq_topc_ref
    from repro_torch.kernels.irli_topk import ops as iops
    from repro_torch.kernels.irli_topk.ref import (irli_topk_ref, near,
                                                   same_topm)
    from repro_torch.kernels.mega_query import ops as mops
    from repro_torch.kernels.mega_query.ref import mega_search_ref
    from repro_torch.kernels.quant_rerank import ops as qops
    from repro_torch.kernels.quant_rerank.ref import (quant_rerank_ref,
                                                      same_topk)
    from repro_torch.store.quantized import QuantizedStore, encode
    from repro_torch.store.rerank import refine_stage, resolve_refine_k

    # ---------------------------------------------------- 1. environment --
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi("name,power.limit")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    log(f"nvidia-smi: {smi}")

    # ---------------------------------------------------------- 2. build --
    t0 = time.perf_counter()
    libs = _build.build(*KERNELS)
    log(f"build: {time.perf_counter() - t0:.2f} s, nvcc "
        f"{' '.join(_build.NVCC_FLAGS)}: " + ", ".join(
            f"{_build.KERNELS_DIR / n / (n + '.cu')} -> {p}"
            for n, p in libs.items()))

    # -------------------------------------------------------------- data --
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    corpus = torch.randn((L, D), generator=gen, device=dev)
    corpus /= corpus.norm(dim=1, keepdim=True)
    src = torch.randint(0, L, (Q,), generator=gen, device=dev)
    queries = corpus[src] + 0.05 * torch.randn((Q, D), generator=gen,
                                               device=dev)
    queries /= queries.norm(dim=1, keepdim=True)
    store8 = encode(corpus, "int8", BLOCK)
    store16 = encode(corpus, "bf16", BLOCK)
    cfg = IRLIConfig(d=D, n_labels=L, n_buckets=B, n_reps=R, d_hidden=H,
                     seed=SEED)
    idx = IRLIIndex(cfg, device=dev)
    idx.build_index()
    torch.cuda.synchronize()
    members = idx.index.members
    params = idx.params
    w2, b2 = params["w2"], params["b2"]
    log(f"setup: {time.perf_counter() - t0:.2f} s; members "
        f"{tuple(members.shape)} ({members.numel() * 4 / 1e6:.0f} MB), "
        f"w2 {w2.numel() * 4 / 1e9:.2f} GB, int8 codes+scales "
        f"{store8.nbytes() / 1e6:.0f} MB, max bucket load "
        f"{int(idx.index.load.max())}")

    # ----------------------------------- 3. kernels against plain versions --
    record = {}

    def freq_err(ids, cnt, rids, rcnt):
        """Largest |kernel - plain| over the ids and the counts."""
        return max(float((ids - rids).abs().max()),
                   float((cnt - rcnt).abs().max()))

    def check_freq(name, cands, C):
        ids, cnt = fops.freq_topc(cands, C=C)
        rids, rcnt = freq_topc_ref(cands, C=C)
        e = freq_err(ids, cnt, rids, rcnt)
        if e != 0.0:
            bad = int((ids != rids).any(1).sum())
            raise AssertionError(f"freq_topc {name}: {bad} rows differ, "
                                 f"max |err| {e}")
        log(f"freq_topc {name} {tuple(cands.shape)} C={C}: bit-exact "
            f"(max |err| {e})")
        return e

    rng = torch.Generator(device=dev).manual_seed(SEED + 1)
    C0 = R * M * 2 * (L // B)
    wide = torch.randint(-1, 200_000, (Q, C0), generator=rng, device=dev,
                         dtype=torch.int32)
    err = check_freq("main shape", wide, TOPC)
    del wide
    edge = torch.randint(-1, 50, (8, 777), generator=rng, device=dev,
                         dtype=torch.int32)
    edge[0] = -1                                       # all pads
    edge[1] = 7                                        # one id repeated
    err = max(err, check_freq("edges (all-pad, one id, width 777)", edge,
                              1024),
              check_freq("C > distinct ids", edge[2:], 64))
    # rows wider than MAX_WIDTH: the wide variant (sorts in global scratch)
    wide40 = torch.randint(-1, 30_000, (64, 40_000), generator=rng,
                           device=dev, dtype=torch.int32)
    err = max(err, check_freq("40,000-wide rows (the wide variant)", wide40,
                              TOPC))
    wide_ms = time_ms(torch, lambda: fops.freq_topc(wide40, C=TOPC), n=5)
    wide_plain = time_ms(torch, lambda: freq_topc_ref(wide40, C=TOPC), n=5)
    log(f"freq_topc 40,000-wide rows {tuple(wide40.shape)} (not on a main "
        f"path): kernel {wide_ms:.4f} ms, plain {wide_plain:.4f} ms")
    del wide40
    record["freq_topc"] = {"max_abs_err": err}

    def check_quant(name, store, metric, cid, cnt, tau, kp, q=None):
        q = queries if q is None else q
        ids, vals = qops.quant_rerank(q, store.codes, store.scales,
                                      cid, cnt, tau=tau, k=kp, metric=metric)
        rids, rvals = quant_rerank_ref(q, store.codes, store.scales,
                                       cid, cnt, tau=tau, k=kp, metric=metric)
        _, wide_s = quant_rerank_ref(q, store.codes, store.scales,
                                     cid, cnt, tau=tau, k=kp + 1,
                                     metric=metric)
        torch.cuda.synchronize()
        flagged = same_topk(ids, rids, vals, rvals, wide_s, TOL)
        fin = torch.isfinite(rvals)
        e = float((vals[fin] - rvals[fin]).abs().max()) if fin.any() else 0.
        log(f"quant_rerank {name}: max |err| {e:.3g}, {flagged} near-tie "
            f"rows exempt, {int((ids != rids).any(1).sum())} rows in "
            f"another order, {int((rids < 0).all(1).sum())} empty rows")
        return e

    kp = resolve_refine_k(0, K, TOPC)
    cid = torch.randint(-1, L, (Q, TOPC), generator=rng, device=dev,
                        dtype=torch.int32)
    cnt = torch.randint(0, 4, (Q, TOPC), generator=rng, device=dev
                        ).float()
    cid[-3:] = -1                                      # all-invalid rows
    cnt[-4] = 1.0                                      # all below tau
    qerr = 0.0
    for dtype, store in (("int8", store8), ("bf16", store16)):
        for metric in ("angular", "l2"):
            qerr = max(qerr, check_quant(f"{dtype} {metric} tau={TAU}",
                                         store, metric, cid, cnt, TAU, kp))
    # topC = 20,000: past one block's shared memory, the multi-pass kernel
    cid20 = torch.randint(-1, L, (256, 20_000), generator=rng, device=dev,
                          dtype=torch.int32)
    cnt20 = torch.randint(0, 4, (256, 20_000), generator=rng, device=dev
                          ).float()
    qerr = max(qerr, check_quant(
        f"int8 angular topC=20000 (passes of {qops.pass_slots(20_000, D)} "
        f"slots)",
        store8, "angular", cid20, cnt20, TAU, kp, queries[:256]))
    del cid20, cnt20
    record["quant_rerank"] = {"max_abs_err": qerr}

    hidden = scorer_hidden(params, queries)            # [R, Q, H]

    def check_irli(name, h, w, b, m):
        """Kernel vs plain top-m: values and lse to TOL, ids by
        ref.same_topm (near ties at the m cut exempt)."""
        vals, ids, lse = iops.irli_topk(h, w, b, m=m, lse=True)
        wv, wi, rlse = irli_topk_ref(h, w, b, m=m + 1, lse=True)
        torch.cuda.synchronize()
        cut, order = same_topm(vals, ids, wv, wi, TOL)
        if not bool(near(lse, rlse, TOL).all()):
            raise AssertionError(f"irli_topk {name}: lse off the plain one "
                                 f"by {float((lse - rlse).abs().max())}")
        e = float((vals - wv[..., :m]).abs().max())
        log(f"irli_topk {name} h {tuple(h.shape)} w2 {tuple(w.shape)} "
            f"{h.dtype} m={m}: max |err| {e:.3g} (lse "
            f"{float((lse - rlse).abs().max()):.3g}); {cut} of "
            f"{vals.numel() // m} (rep, query) rows exempt (near tie at the "
            f"m cut), {order} in another order among near values")
        del wv, wi
        return e

    ierr = check_irli("main shape", hidden, w2, b2, M)
    ierr = max(ierr, check_irli(
        "bf16 (4 reps)", hidden[:4].bfloat16(), w2[:4].bfloat16(),
        b2[:4].bfloat16(), M))
    ierr = max(ierr, check_irli(
        "ragged (Q=1000, B=19999, 2 reps)", hidden[:2, :1000].contiguous(),
        w2[:2, :, :19999].contiguous(), b2[:2, :19999].contiguous(), M))
    ierr = max(ierr, check_irli("m=128 (radix-select variant)", hidden, w2,
                                b2, 128))
    record["irli_topk"] = {"max_abs_err": ierr}

    # --------------------------------------- plain search with its cut ties --
    def plain_search(p, base, q):
        """The search with the plain versions (mega_search_ref), and the
        rows whose result may rightly differ: a near tie at the m cut of
        any rep (the kernels' logits are summed in another order), at the
        k' cut of the coarse scores, or at the k cut of the final scores.
        -> ((ids, scores, n_cand), exempt [Q] bool, m-cut exempt [Q])."""
        res = mega_search_ref(
            params, members, base, q, m=p.m, tau=p.tau, topC=p.topC, k=p.k,
            refine_k=p.refine_k, metric=p.metric, adaptive_m=p.adaptive_m,
            probe_mass=p.probe_mass)
        logits = scorer_logits(params, q)
        vals, bidx = topk_stable(logits, p.m + 1)
        mcut = near(vals[..., p.m - 1], vals[..., p.m], TOL).any(dim=0)
        adaptive = p.adaptive_m and p.probe_mass < 1.0
        keep = (probe_keep_mask(logits, vals[..., :p.m], p.probe_mass)
                if adaptive else None)
        del logits
        cands = gather_members(members, bidx[..., :p.m], probe_keep=keep)
        pcid, pcnt = freq_topc_ref(cands, C=p.topC)
        store = base if isinstance(base, QuantizedStore) else None
        if store is not None and store.dtype != "fp32":
            kq = resolve_refine_k(p.refine_k, p.k, p.topC)
            pc, pv = quant_rerank_ref(q, store.codes, store.scales, pcid,
                                      pcnt, tau=p.tau, k=kq + 1,
                                      metric=p.metric)
            cut = torch.isfinite(pv[:, kq]) & near(pv[:, kq - 1], pv[:, kq],
                                                   TOL)
            _, fs = refine_stage(q, store, pc[:, :kq], k=p.k + 1,
                                 metric=p.metric)
        else:
            rows = store.codes if store is not None else base
            _, fs = rerank_gathered(q, rows, pcid, pcnt, p.tau, p.k + 1,
                                    p.metric)
            cut = torch.zeros_like(mcut)
        if fs.shape[1] > p.k:
            cut |= torch.isfinite(fs[:, p.k]) & near(fs[:, p.k - 1],
                                                     fs[:, p.k], TOL)
        return res, mcut | cut, mcut

    def agree(name, got, plain, exempt, mcut):
        """ids and n_candidates equal outside the exempt rows (ids may
        differ in order among near final scores), scores to TOL."""
        ids, scores, nc = got
        pids, pscores, pnc = plain
        w = pids.shape[1]
        if w < ids.shape[1]:                    # the kernel pads k > C
            assert bool((ids[:, w:] == -1).all())
            ids, scores = ids[:, :w], scores[:, :w]
        assert torch.equal(torch.isfinite(scores), ids >= 0), name
        if not torch.equal(nc[~mcut], pnc[~mcut]):
            raise AssertionError(f"{name}: n_candidates differ outside the "
                                 f"m-cut near ties")
        same = (ids == pids).all(dim=1)
        same_set = (torch.sort(ids, 1).values
                    == torch.sort(pids, 1).values).all(dim=1)
        fin = torch.isfinite(pscores)
        close = torch.where(fin, near(scores, pscores, TOL),
                            scores == pscores).all(dim=1)
        bad = ~exempt & ~(close & (same | same_set))
        if bool(bad.any()):
            raise AssertionError(
                f"{name}: {int(bad.sum())} rows differ from the plain "
                f"search outside the near-tie rows")
        ok = ~exempt
        e = (float((scores[ok] - pscores[ok])[fin[ok]].abs().max())
             if bool(fin[ok].any()) else 0.0)
        log(f"{name}: ids equal to the plain search ({int(exempt.sum())} "
            f"near-tie rows of {len(ids)} exempt, {int((~same & ok).sum())} "
            f"in another order among near scores), scores within {TOL} "
            f"(max |err| {e:.3g}); survivors/query mean "
            f"{float(pnc.float().mean()):.1f}, rows with a result "
            f"{int((pids[:, 0] >= 0).sum())}/{len(ids)}")
        return e

    def run_path(p, base, q, want):
        """One search through IRLIIndex.search with the counters set to 0
        just before and read just after; the counters must show exactly
        the kernels ``want`` (name -> launches)."""
        reset_launches()
        res = idx.search(q, base, p)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        if {n: c for n, c in launches.items() if c} != want:
            raise AssertionError(f"search {p}: launches {launches}, "
                                 f"expected {want}")
        got = (res.ids, res.scores, res.n_candidates)
        assert res.ids.shape == (len(q), p.k)
        assert res.ids.dtype == torch.int32 and res.scores.dtype == \
            torch.float32 and res.n_candidates.dtype == torch.int32
        assert not torch.isnan(res.scores).any()
        return res, got, launches

    # ------------------------------------------- 4. the compact main path --
    compact = SearchParams(m=M, tau=TAU, k=K, topC=TOPC, store_dtype="int8",
                           mode="compact", metric="angular")
    want_compact = {"irli_topk": 1, "freq_topc": 1, "quant_rerank": 1}
    main_launches = {}
    compact_out = {}
    for tau in (TAU, 1):
        p = compact.replace(tau=tau)
        _, got, launches = run_path(p, store8, queries, want_compact)
        if tau == TAU:
            main_launches.update(launches)
        plain, exempt, mcut = plain_search(p, store8, queries)
        agree(f"compact path tau={tau} (launches {launches})", got, plain,
              exempt, mcut)
        compact_out[tau] = (got, plain, exempt, mcut)

    # --------------------------------------------- 5. the fused main path --
    auto = SearchParams(m=M, tau=TAU, k=K, topC=TOPC, store_dtype="int8")
    resolved = auto.resolve(L, Q)
    if resolved.mode != "mega":
        raise AssertionError(f"mode='auto' resolved to {resolved.mode!r} at "
                             f"the cell, expected 'mega'")
    smem = mops.mega_smem_bytes(M, TOPC, 0, K, geom=dict(
        R=R, B=B, ML=members.shape[2], d=D, D=D))
    log(f"mode='auto' resolves to {resolved.mode!r} at L={L}, Q={Q}: "
        f"mega_fits, {smem} B of shared memory a block")
    mega_err = 0.0
    for tau in (TAU, 1):
        p = auto.replace(tau=tau)
        res, got, launches = run_path(p, store8, queries, {"mega_query": 1})
        assert res.mode == "mega", res.mode
        if tau == TAU:
            main_launches["mega_query"] = launches["mega_query"]
        cgot, plain, exempt, mcut = compact_out[tau]
        mega_err = max(mega_err, agree(
            f"fused path tau={tau} (launches {launches})", got, plain,
            exempt, mcut))
        both = ((got[0] == cgot[0]).all(dim=1) | exempt
                | (torch.sort(got[0], 1).values
                   == torch.sort(cgot[0], 1).values).all(dim=1))
        log(f"fused vs compact-on-card tau={tau}: same ids in "
            f"{int(both.sum())}/{Q} rows (the rest exempt near ties)")
        assert bool(both.all())

    # one warm fused search under torch.profiler: one kernel, nothing else
    from torch.profiler import ProfilerActivity, profile
    idx.search(queries, store8, auto)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        idx.search(queries, store8, auto)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        raise AssertionError("torch.profiler traced no device activity on "
                             "this machine: the one-kernel claim is not "
                             "shown")
    names = sorted({e.name for e in dev_events})
    log(f"profiler: one warm fused search ran {len(dev_events)} device "
        f"activities: {names}")
    if len(dev_events) != 1 or "mega_query" not in dev_events[0].name:
        raise AssertionError(f"the fused search ran {names} on the card, "
                             f"not the one mega_query kernel")

    # the other kinds at Q = 64: fp32 store, bf16, l2, adaptive m, exact tier
    qs = queries[:Q_SMALL].contiguous()
    exact8 = QuantizedStore("int8", store8.block, store8.codes,
                            store8.scales, corpus)
    kinds = [
        ("fp32 store", dict(store_dtype="fp32"), corpus),
        ("bf16 store", dict(store_dtype="bf16"), store16),
        ("int8 l2", dict(metric="l2"), store8),
        ("int8 adaptive m (probe_mass 0.9)",
         dict(adaptive_m=True, probe_mass=0.9), store8),
        ("int8 exact tier", {}, exact8),
    ]
    for name, over, base in kinds:
        p = auto.replace(**over)
        res, got, _ = run_path(p, base, qs, {"mega_query": 1})
        assert res.mode == "mega", res.mode
        plain, exempt, mcut = plain_search(p, base, qs)
        mega_err = max(mega_err, agree(f"fused {name} Q={Q_SMALL}", got,
                                       plain, exempt, mcut))
        _, cgot, _ = run_path(p.replace(mode="compact"), base, qs,
                              {"irli_topk": 1, "freq_topc": 1,
                               **({} if over.get("store_dtype") == "fp32"
                                  else {"quant_rerank": 1})})
        agree(f"compact {name} Q={Q_SMALL}", cgot, plain, exempt, mcut)
    record["mega_query"] = {"max_abs_err": mega_err}
    del compact_out

    # -------------------------------------------------------- 6. times --
    bidx = iops.irli_topk(hidden, w2, b2, m=M)[1]
    cands = gather_members(members, bidx)
    cid_m, cnt_m = fops.freq_topc(cands, C=TOPC)
    cids_m = qops.quant_rerank(queries, store8.codes, store8.scales, cid_m,
                               cnt_m, tau=TAU, k=kp)[0]
    st = {
        "first layer (matmul)": lambda: scorer_hidden(params, queries),
        "irli_topk": lambda: iops.irli_topk(hidden, w2, b2, m=M),
        "gather": lambda: gather_members(members, bidx),
        "freq_topc": lambda: fops.freq_topc(cands, C=TOPC),
        "coarse (quant_rerank)": lambda: qops.quant_rerank(
            queries, store8.codes, store8.scales, cid_m, cnt_m, tau=TAU,
            k=kp),
        "refine": lambda: refine_stage(queries, store8, cids_m, k=K),
        "whole compact search": lambda: idx.search(queries, store8, compact),
        "whole fused search": lambda: idx.search(queries, store8, auto),
        "mega_query": lambda: mops.mega_query(
            params, members, store8.codes, store8.scales, None, queries,
            m=M, tau=TAU, topC=TOPC, k=K),
    }
    slow = ("irli_topk", "whole compact search", "whole fused search",
            "mega_query")
    stage_ms = {name: time_ms(torch, fn, n=10 if name in slow else 20)
                for name, fn in st.items()}
    for name, ms in stage_ms.items():
        log(f"stage {name}: {ms:.4f} ms")

    # irli_topk: plain (matmul + bias + stable top-m) and the library pair
    plain_irli = time_ms(torch, lambda: irli_topk_ref(hidden, w2, b2, m=M),
                         n=5, warmup=2)

    def library_pair():
        logits = torch.bmm(hidden, w2) + b2[:, None, :]
        return torch.topk(logits, M, dim=-1)

    library_irli = time_ms(torch, library_pair, n=5, warmup=2)
    irli_flops = 2 * R * Q * H * B
    irli_bytes = (R * Q * H + R * H * B + R * B) * 4 + R * Q * M * 8
    bounds = {"irli_topk": bound(irli_flops, irli_bytes)}
    log(f"irli_topk: {irli_flops / 1e12:.4f} TFLOP, {irli_bytes / 1e9:.3f} "
        f"GB -> bound {bounds['irli_topk'][0]:.4f} ms "
        f"({bounds['irli_topk'][1]}); kernel {stage_ms['irli_topk']:.4f} ms "
        f"({irli_flops / stage_ms['irli_topk'] / 1e9:.1f} TFLOP/s), plain "
        f"{plain_irli:.4f} ms, library (torch.bmm + bias + torch.topk) "
        f"{library_irli:.4f} ms")
    wide_ms = time_ms(torch, lambda: iops.irli_topk(hidden, w2, b2, m=128),
                      n=3, warmup=1)
    log(f"irli_topk m=128 (radix-select variant, not on a main path): "
        f"{wide_ms:.4f} ms")

    plain_freq = time_ms(torch, lambda: freq_topc_ref(cands, C=TOPC), n=10)
    freq_bytes = cands.numel() * 4 + Q * TOPC * 8
    bounds["freq_topc"] = bound(0, freq_bytes)
    n = fops.sort_width(cands.shape[1])
    passes = n.bit_length() * (n.bit_length() - 1) // 2      # per sort
    smem_reads = Q * 2 * passes * n * 4
    sm_clock = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    smem_rate = torch.cuda.get_device_properties(0).multi_processor_count \
        * 128 * sm_clock                       # 32 banks x 4 B a clock
    log(f"freq_topc: {freq_bytes / 1e6:.1f} MB in+out -> bound "
        f"{bounds['freq_topc'][0] * 1e3:.1f} us; kernel "
        f"{stage_ms['freq_topc']:.4f} ms, plain {plain_freq:.4f} ms; its "
        f"2 sorts x {passes} passes read {smem_reads / 1e9:.1f} GB of shared "
        f"memory -> {smem_reads / smem_rate * 1e3:.3f} ms at "
        f"{smem_rate / 1e12:.1f} TB/s")

    def quant_bound(tau):
        """Least time for the coarse stage on this run's inputs: the ids,
        counts and queries read once, each distinct valid row's codes and
        scales once, the outputs written once; 2·D flops a valid slot."""
        valid = (cid_m >= 0) & (cnt_m >= tau)
        rows = int(torch.unique(cid_m[valid]).numel())
        nbytes = (Q * D * 4 + Q * TOPC * 8 + rows * (D + D // BLOCK * 4)
                  + Q * kp * 8)
        flops = int(valid.sum()) * 2 * D
        b = bound(flops, nbytes)
        return b, (f"{int(valid.sum())} valid slots, {rows} distinct "
                   f"rows, {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} "
                   f"GFLOP -> bound {b[0] * 1e3:.1f} us ({b[1]})")

    def quant_call(tau, fn):
        return lambda: fn(queries, store8.codes, store8.scales, cid_m, cnt_m,
                          tau=tau, k=kp)

    plain_quant = time_ms(torch, quant_call(TAU, quant_rerank_ref), n=10)
    bounds["quant_rerank"], text = quant_bound(TAU)
    log(f"quant_rerank tau={TAU}: {text}; kernel "
        f"{stage_ms['coarse (quant_rerank)']:.4f} ms, plain "
        f"{plain_quant:.4f} ms")
    _, text = quant_bound(1)
    log(f"quant_rerank tau=1 (all 1024 slots): {text}; kernel "
        f"{time_ms(torch, quant_call(1, qops.quant_rerank), n=20):.4f} ms, "
        f"plain {time_ms(torch, quant_call(1, quant_rerank_ref), n=10):.4f}"
        f" ms")

    # mega_query: plain = mega_search_ref on the card; bound from this
    # run's data: both GEMMs, the probed member rows, the distinct valid
    # code rows, the k' refine rows, once each
    plain_mega = time_ms(torch, lambda: mega_search_ref(
        params, members, store8, queries, m=M, tau=TAU, topC=TOPC, k=K),
        n=5, warmup=2)
    valid = (cid_m >= 0) & (cnt_m >= TAU)
    n_buckets = int(torch.unique(
        bidx.long() + torch.arange(R, device=dev)[:, None, None] * B).numel())
    code_rows = int(torch.unique(cid_m[valid]).numel())
    refine_rows = int(torch.unique(cids_m[cids_m >= 0]).numel())
    mega_flops = (2 * R * Q * (D * H + H * B)
                  + (int(valid.sum()) + int((cids_m >= 0).sum())) * 2 * D)
    mega_bytes = ((R * D * H + R * H + R * H * B + R * B + Q * D) * 4
                  + n_buckets * members.shape[2] * 4
                  + (code_rows + refine_rows) * (D + D // BLOCK * 4)
                  + Q * (2 * K + 1) * 4)
    bounds["mega_query"] = bound(mega_flops, mega_bytes)
    log(f"mega_query: {mega_flops / 1e12:.4f} TFLOP, {mega_bytes / 1e9:.3f} "
        f"GB ({n_buckets} probed buckets, {code_rows} code rows, "
        f"{refine_rows} refine rows) -> bound {bounds['mega_query'][0]:.4f} "
        f"ms ({bounds['mega_query'][1]}); kernel {stage_ms['mega_query']:.4f}"
        f" ms, whole fused search {stage_ms['whole fused search']:.4f} ms, "
        f"plain (mega_search_ref on the card) {plain_mega:.4f} ms")

    # peak device memory of one search of each path, above what it found
    def peak_gb(p):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        idx.search(queries, store8, p)
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    logits_gb = R * Q * B * 4 / 1e9
    peaks = {"compact": peak_gb(compact), "fused": peak_gb(auto)}
    for name, gb in peaks.items():
        log(f"peak device memory of one {name} search: {gb:.3f} GB above "
            f"its inputs (an [R, Q, B] fp32 logit tensor is {logits_gb:.2f} "
            f"GB)")
        if gb >= logits_gb:
            raise AssertionError(f"the {name} search may hold the [R, Q, B] "
                                 f"logits: peak {gb:.3f} GB")
    log(f"nvidia-smi clocks.sm,power.draw,power.limit,temperature.gpu: "
        f"{nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    # ------------------------------------------------------- 7. the fit --
    search_irli = main_launches["irli_topk"]
    del (idx, members, params, w2, b2, hidden, corpus, store8, store16,
         exact8, cands, cid_m, cnt_m, cids_m, bidx, st)
    torch.cuda.empty_cache()
    fit = fit_cell(torch, dev, check_irli)
    main_launches.update(fit["launches"])
    main_launches["irli_topk"] = search_irli + fit["launches"]["irli_topk"]
    by_path = {"irli_topk": {"compact search": search_irli,
                             "fit": fit["launches"]["irli_topk"]}}
    record.update(fit["record"])
    bounds.update(fit["bounds"])
    ierr = max(record["irli_topk"]["max_abs_err"], fit["irli_err"])
    record["irli_topk"] = {"max_abs_err": ierr}
    log(f"nvidia-smi clocks.sm,power.draw,power.limit,temperature.gpu: "
        f"{nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    times = {
        "irli_topk": (stage_ms["irli_topk"], plain_irli, library_irli),
        "freq_topc": (stage_ms["freq_topc"], plain_freq, None),
        "quant_rerank": (stage_ms["coarse (quant_rerank)"], plain_quant,
                         None),
        "mega_query": (stage_ms["mega_query"], plain_mega, None),
        **fit["times"],
    }
    replaces = {
        "irli_topk": "src/repro/kernels/irli_topk/irli_topk.py:82",
        "freq_topc": "src/repro/kernels/freq_topc/freq_topc.py:126",
        "quant_rerank": "src/repro/kernels/quant_rerank/quant_rerank.py:75",
        "mega_query": "src/repro/kernels/mega_query/mega_query.py:250",
        "bce_logits": "src/repro/kernels/bce_logits/bce_logits.py:31",
        # no TPU kernel: the reference's lax.scan over the labels
        "kchoice": "src/repro/core/repartition.py:93",
    }
    kernels = [
        {"name": n, "route": "cuda",
         "source": f"src/repro_torch/kernels/{n}/{n}.cu",
         "replaces": replaces[n], "launches": main_launches[n],
         "max_abs_err": record[n]["max_abs_err"], "ms": times[n][0],
         "plain_ms": times[n][1], "bound_ms": bounds[n][0],
         "bound_by": bounds[n][1], "library_ms": times[n][2],
         **({"launches_by_path": by_path[n]} if n in by_path else {})}
        for n in KERNELS]
    if any(k["launches"] < 1 for k in kernels):
        raise AssertionError(f"a kernel did not run on its path: {kernels}")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
