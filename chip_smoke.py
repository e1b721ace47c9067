#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It builds the four hand-written kernels from the repository's .cu sources
(one nvcc each, in parallel), holds each against its plain PyTorch version
on the card, and serves the Alg. 2 query at the irli-deep1b widths through
``IRLIIndex.search`` on both paths:

  * the compact path (``mode="compact"``, int8 store): the irli_topk,
    freq_topc and quant_rerank kernels, one launch each;
  * the fused path (``mode="auto"``, which resolves to ``"mega"`` here): one
    launch of the mega_query kernel and no other kernel (launch counters and
    a torch.profiler trace), then the other store kinds, l2, adaptive m and
    an exact tier at Q = 64.

Each path's counters are set to 0 just before it runs and read just after.
Every search is held against the same search with the plain versions
(kernels/mega_query/ref.mega_search_ref), on the card: ids equal outside
the rows with a near tie (|a - b| <= 1e-5 + 1e-5·|b|) at the m, k' or k cut,
scores to 1e-5. Then it times every stage and kernel with CUDA events.

Its last line is ``{"ok": true, "device": {...}}``; the line before it holds
the per-kernel record (launches, error, times, bounds). Any failure raises
and exits non-zero with no ``ok`` line; so does a run without a card, or
from a directory that holds this file and nothing else of the repository.

Widths (configs/irli_deep1b.py, the serve_query cell): D=96, B=20000, R=32,
H=1024, int8 block 32, m=5, tau=2, k=10, topC=1024, refine_k auto (40).
Reduced in scale to one card: L = 2,000,000 corpus rows (of 2^27), so that
max_load = 2·L/B = 200 and the gathered width C0 = R·m·max_load = 32,000
stays within the freq_topc kernel's 32,768; Q = 1024 queries per call (of
4096). Data, queries and weights are random, made from a seed.
"""
from __future__ import annotations

import json
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
KERNELS = ("irli_topk", "freq_topc", "quant_rerank", "mega_query")


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (sets allow_tf32=False)
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
    record["freq_topc"] = {"max_abs_err": err}

    def check_quant(name, store, metric, cid, cnt, tau, kp):
        ids, vals = qops.quant_rerank(queries, store.codes, store.scales,
                                      cid, cnt, tau=tau, k=kp, metric=metric)
        rids, rvals = quant_rerank_ref(queries, store.codes, store.scales,
                                       cid, cnt, tau=tau, k=kp, metric=metric)
        _, wide_s = quant_rerank_ref(queries, store.codes, store.scales,
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

    times = {
        "irli_topk": (stage_ms["irli_topk"], plain_irli, library_irli),
        "freq_topc": (stage_ms["freq_topc"], plain_freq, None),
        "quant_rerank": (stage_ms["coarse (quant_rerank)"], plain_quant,
                         None),
        "mega_query": (stage_ms["mega_query"], plain_mega, None),
    }
    replaces = {
        "irli_topk": "src/repro/kernels/irli_topk/irli_topk.py:82",
        "freq_topc": "src/repro/kernels/freq_topc/freq_topc.py:126",
        "quant_rerank": "src/repro/kernels/quant_rerank/quant_rerank.py:75",
        "mega_query": "src/repro/kernels/mega_query/mega_query.py:250",
    }
    kernels = [
        {"name": n, "route": "cuda",
         "source": f"src/repro_torch/kernels/{n}/{n}.cu",
         "replaces": replaces[n], "launches": main_launches[n],
         "max_abs_err": record[n]["max_abs_err"], "ms": times[n][0],
         "plain_ms": times[n][1], "bound_ms": bounds[n][0],
         "bound_by": bounds[n][1], "library_ms": times[n][2]}
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
