#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It builds the hand-written kernels from the repository's .cu sources, holds
each against its plain PyTorch version on the card, serves the Alg. 2 query
(compact mode over an int8 store) at the irli-deep1b widths through
``IRLIIndex.search``, shows through the launch counters that the search ran
the kernels, recomputes the search with the plain versions stage by stage,
and times every stage and kernel with CUDA events.

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
BLOCK = 32
M, TAU, K, TOPC = 5, 2, 10, 1024
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_FLOPS = 67e12                 # H100 SXM fp32 outside the tensor cores
TOL = 1e-5                         # |a - b| <= TOL + TOL·|b| for fp32 scores


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (sets allow_tf32=False)
    from repro_torch.core.index import IRLIConfig, IRLIIndex
    from repro_torch.core.network import scorer_logits
    from repro_torch.core.query import gather_members
    from repro_torch.core.search_api import SearchParams
    from repro_torch.kernels import LAUNCHES, _build, reset_launches
    from repro_torch.kernels.freq_topc import ops as fops
    from repro_torch.kernels.freq_topc.ref import freq_topc_ref
    from repro_torch.kernels.quant_rerank import ops as qops
    from repro_torch.kernels.quant_rerank.ref import (near_tie_rows,
                                                      quant_rerank_ref,
                                                      same_topk)
    from repro_torch.store.quantized import encode
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
    libs = _build.build("freq_topc", "quant_rerank")
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
    log(f"setup: {time.perf_counter() - t0:.2f} s; members "
        f"{tuple(members.shape)} ({members.numel() * 4 / 1e6:.0f} MB), "
        f"w2 {idx.params['w2'].numel() * 4 / 1e9:.2f} GB, int8 codes+scales "
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
    edge = torch.randint(-1, 50, (8, 777), generator=rng, device=dev,
                         dtype=torch.int32)
    edge[0] = -1                                       # all pads
    edge[1] = 7                                        # one id repeated
    err = max(err, check_freq("edges (all-pad, one id, width 777)", edge,
                              1024),
              check_freq("C > distinct ids", edge[2:], 64))

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
    record["freq_topc"] = {"max_abs_err": err}

    # ------------------------------------------------- 4. the main path --
    params = SearchParams(m=M, tau=TAU, k=K, topC=TOPC, store_dtype="int8",
                          mode="compact", metric="angular")
    pipe = params.pipeline()

    def search_and_check(p):
        reset_launches()
        res = idx.search(queries, store8, p)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        if launches["freq_topc"] < 1 or launches["quant_rerank"] < 1:
            raise AssertionError(f"the search did not run the kernels: "
                                 f"{launches}")
        ids, scores, n_cand = res.ids, res.scores, res.n_candidates
        assert ids.shape == (Q, K) and ids.dtype == torch.int32
        assert scores.dtype == torch.float32 and n_cand.dtype == torch.int32
        assert torch.equal(torch.isfinite(scores), ids >= 0)
        assert not torch.isnan(scores).any()
        # the same search with the plain versions, stage by stage
        pp = p.pipeline()
        cands = pp.candidates(idx.params, members, queries)
        pcid, pcnt = freq_topc_ref(cands, C=TOPC)
        kcid, kcnt = fops.freq_topc(cands, C=TOPC)
        e = freq_err(kcid, kcnt, pcid, pcnt)
        if e != 0.0:
            raise AssertionError(f"freq_topc differs on the main path: max "
                                 f"|err| {e}")
        record["freq_topc"]["max_abs_err"] = max(
            record["freq_topc"]["max_abs_err"], e)
        pcids, pvals = quant_rerank_ref(queries, store8.codes, store8.scales,
                                        pcid, pcnt, tau=p.tau, k=kp + 1,
                                        metric=p.metric)
        pids, pscores = refine_stage(queries, store8, pcids[:, :kp], k=K,
                                     metric=p.metric)
        pn = ((pcid >= 0) & (pcnt >= p.tau)).sum(1).int()
        torch.cuda.synchronize()
        tie = near_tie_rows(pvals, kp, TOL)
        assert torch.equal(n_cand, pn)
        if not torch.equal(ids[~tie], pids[~tie]):
            bad = int((ids != pids).any(1)[~tie].sum())
            raise AssertionError(f"search ids differ from the plain path "
                                 f"in {bad} rows")
        torch.testing.assert_close(scores[~tie], pscores[~tie], rtol=TOL,
                                   atol=TOL)
        log(f"main path tau={p.tau}: launches {launches}; ids equal to the "
            f"plain path ({int(tie.sum())} near-tie rows exempt), scores "
            f"within {TOL}; C0={cands.shape[1]}, survivors/query mean "
            f"{float(n_cand.float().mean()):.1f}, coarse slots scored "
            f"{int(((pcid >= 0) & (pcnt >= p.tau)).sum())}, rows with a "
            f"result {int((ids[:, 0] >= 0).sum())}/{Q}")
        return launches, cands

    launches, cands = search_and_check(params)
    search_and_check(params.replace(tau=1))

    # -------------------------------------------------------- 5. times --
    peak0 = torch.cuda.max_memory_allocated()
    logits = scorer_logits(idx.params, queries)
    bidx, _ = pipe.top_m(logits)
    cid_m, cnt_m = fops.freq_topc(cands, C=TOPC)
    cids_m = qops.quant_rerank(queries, store8.codes, store8.scales, cid_m,
                               cnt_m, tau=TAU, k=kp)[0]
    st = {
        "scorer GEMMs": lambda: scorer_logits(idx.params, queries),
        "top-m": lambda: pipe.top_m(logits),
        "gather": lambda: gather_members(members, bidx),
        "freq_topc": lambda: fops.freq_topc(cands, C=TOPC),
        "coarse (quant_rerank)": lambda: qops.quant_rerank(
            queries, store8.codes, store8.scales, cid_m, cnt_m, tau=TAU,
            k=kp),
        "refine": lambda: refine_stage(queries, store8, cids_m, k=K),
        "whole search": lambda: idx.search(queries, store8, params),
    }
    stage_ms = {name: time_ms(torch, fn, n=10 if name in (
        "scorer GEMMs", "whole search") else 20) for name, fn in st.items()}
    gemm_flops = 2 * R * Q * (D * H + H * B)
    for name, ms in stage_ms.items():
        extra = ""
        if name == "scorer GEMMs":
            extra = (f"  ({gemm_flops / 1e12:.3f} TFLOP; fp32 bound "
                     f"{gemm_flops / FP32_FLOPS * 1e3:.2f} ms at 67 TFLOP/s; "
                     f"{gemm_flops / ms / 1e9:.1f} TFLOP/s achieved)")
        log(f"stage {name}: {ms:.4f} ms{extra}")

    plain_freq = time_ms(torch, lambda: freq_topc_ref(cands, C=TOPC), n=10)
    freq_bytes = cands.numel() * 4 + Q * TOPC * 8
    bounds = {"freq_topc": (freq_bytes / HBM_BYTES_PER_S * 1e3, "bytes")}
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
        bound = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                    (flops / FP32_FLOPS * 1e3, "operations"))
        return bound, (f"{int(valid.sum())} valid slots, {rows} distinct "
                       f"rows, {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} "
                       f"GFLOP -> bound {bound[0] * 1e3:.1f} us "
                       f"({bound[1]})")

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
    log(f"peak device memory {peak0 / 1e9:.2f} GB; "
        f"nvidia-smi clocks.sm,power.draw,power.limit,temperature.gpu: "
        f"{nvidia_smi('clocks.sm,power.draw,power.limit,temperature.gpu')}")

    kernels = [
        {"name": "freq_topc", "route": "cuda",
         "source": "src/repro_torch/kernels/freq_topc/freq_topc.cu",
         "replaces": "src/repro/kernels/freq_topc/freq_topc.py:126",
         "launches": launches["freq_topc"],
         "max_abs_err": record["freq_topc"]["max_abs_err"],
         "ms": stage_ms["freq_topc"], "plain_ms": plain_freq,
         "bound_ms": bounds["freq_topc"][0],
         "bound_by": bounds["freq_topc"][1], "library_ms": None},
        {"name": "quant_rerank", "route": "cuda",
         "source": "src/repro_torch/kernels/quant_rerank/quant_rerank.cu",
         "replaces": "src/repro/kernels/quant_rerank/quant_rerank.py:75",
         "launches": launches["quant_rerank"],
         "max_abs_err": record["quant_rerank"]["max_abs_err"],
         "ms": stage_ms["coarse (quant_rerank)"], "plain_ms": plain_quant,
         "bound_ms": bounds["quant_rerank"][0],
         "bound_by": bounds["quant_rerank"][1], "library_ms": None},
    ]
    log(smi)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
