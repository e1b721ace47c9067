#!/usr/bin/env python3
"""Time kernels against the same kernels of an earlier checkout, on one
NVIDIA card, at the inputs the port's main paths hand them.

    python3 tools/kernel_ab.py OTHER_ROOT [KERNEL ...]

KERNEL is any of freq_topc, embedding_bag and quant_rerank (all three when
none is named). OTHER_ROOT is the root of another checkout of this
repository (unpack one with ``git archive``), whose kernels keep the C
interfaces named below. The script builds the other checkout's sources
with this checkout's nvcc flags into build/ab/, makes the inputs as
chip_smoke.py does (its seeds and widths), holds both versions to the plain
version on them, and times them in turns (other, this, this, other;
CUDA-event medians):

  * freq_topc (``freq_topc_launch`` of the radix kernel, with this
    checkout's ``radix_plan`` scratch): the candidates that the compact
    search ([1024, 32,000]) and the streaming search ([1024, 65,280]) hand
    it;
  * embedding_bag (``embedding_bag_launch``): DIEN's item and category
    history sums (configs/dien.CONFIG's tables, random weights from
    ``dien_init``) at serve_bulk's [262,144, 100] and serve_p99's
    [512, 100] ids and mask from ``behavior_stream``;
  * quant_rerank (``quant_rerank_launch``, its slots in one pass of
    pow2(C)): the compact search's coarse stage (the search's candidates
    through freq_topc, topC = 1024, int8 block 32, k' = 40) at tau = 2 and
    at tau = 1.

Its last line is one JSON object with the times and the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ("freq_topc", "embedding_bag", "quant_rerank")


def other_lib(root: Path, name: str):
    """The other checkout's kernel ``name``, built into build/ab/."""
    from repro_torch.kernels import _build
    src = root / f"src/repro_torch/kernels/{name}/{name}.cu"
    out = ROOT / "build" / "ab" / f"lib{name}_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True)
    return ctypes.CDLL(str(out))


def other_freq_topc(root: Path, torch):
    """-> fn(cands [Q, C0] int32, C) -> (ids, counts), the other checkout's
    kernel through this checkout's launch plan (its scratch a row)."""
    from repro_torch.kernels.freq_topc import ops as fops
    fn = other_lib(root, "freq_topc").freq_topc_launch
    fn.argtypes = fops._lib().freq_topc_launch.argtypes

    def run(cands, C):
        Q, C0 = cands.shape
        dev = cands.device
        ids = torch.empty((Q, C), dtype=torch.int32, device=dev)
        cnt = torch.empty((Q, C), dtype=torch.float32, device=dev)
        need = fops.radix_plan(C0, -1)["scratch_ints"]
        scratch = (torch.empty((Q, need), dtype=torch.int32, device=dev)
                   if need else None)
        err = fn(cands.data_ptr(), Q, C0, C,
                 None if scratch is None else scratch.data_ptr(),
                 ids.data_ptr(), cnt.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"the other freq_topc: cudaError {err}")
        return ids, cnt

    return run


def other_embedding_bag(root: Path, torch):
    """-> fn(ids, weights, table) -> out, the other checkout's kernel."""
    fn = other_lib(root, "embedding_bag").embedding_bag_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]

    def run(ids, weights, table):
        N, P = ids.shape
        V, D = table.shape
        out = torch.empty((N, D), dtype=table.dtype, device=table.device)
        err = fn(ids.data_ptr(), weights.data_ptr(), table.data_ptr(), N, P,
                 V, D, 0 if table.dtype == torch.float32 else 1,
                 out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other embedding_bag: cudaError {err}")
        return out

    return run


def other_quant_rerank(root: Path, torch):
    """-> fn(queries, codes, scales, cid, cnt, tau, kp) -> (ids, scores),
    the other checkout's int8 angular kernel with its slots in one pass."""
    fn = other_lib(root, "quant_rerank").quant_rerank_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]

    def run(queries, codes, scales, cid, cnt, tau, kp):
        Q, C = cid.shape
        D = codes.shape[1]
        P = 1
        while P < C:
            P *= 2
        ids = torch.empty((Q, kp), dtype=torch.int32, device=cid.device)
        vals = torch.empty((Q, kp), dtype=torch.float32, device=cid.device)
        err = fn(queries.data_ptr(), codes.data_ptr(), 0, scales.data_ptr(),
                 scales.shape[1], D // scales.shape[1], cid.data_ptr(),
                 cnt.data_ptr(), Q, C, P, D, float(tau), kp, 0, None,
                 ids.data_ptr(), vals.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other quant_rerank: cudaError {err}")
        return ids, vals

    return run


def turns(torch, cs, other, this, check, n=10):
    """Times of other, this, this, other, each checked first."""
    times = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        fn = other if who == "other" else this
        check(who, fn())
        times[who].append(cs.time_ms(torch, fn, n=n, warmup=2))
    return times


def search_inputs(torch, cs, dev, with_stream: bool):
    """The serve cell's corpus, queries, index and the rows the compact
    search (and, with_stream, the streaming search) hand freq_topc."""
    from repro_torch.core.index import IRLIConfig, IRLIIndex
    from repro_torch.core.network import scorer_hidden
    from repro_torch.core.query import gather_members
    from repro_torch.core.search_api import SearchParams
    from repro_torch.kernels.freq_topc import ops as fops
    from repro_torch.kernels.irli_topk import ops as iops
    from repro_torch.stream import MutableIRLIIndex

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    corpus = torch.randn((cs.L, cs.D), generator=gen, device=dev)
    corpus /= corpus.norm(dim=1, keepdim=True)
    src = torch.randint(0, cs.L, (cs.Q,), generator=gen, device=dev)
    queries = corpus[src] + 0.05 * torch.randn((cs.Q, cs.D), generator=gen,
                                               device=dev)
    queries /= queries.norm(dim=1, keepdim=True)
    idx = IRLIIndex(IRLIConfig(d=cs.D, n_labels=cs.L, n_buckets=cs.B,
                               n_reps=cs.R, d_hidden=cs.H, seed=cs.SEED),
                    device=dev)
    idx.build_index()
    p = idx.params
    bidx = iops.irli_topk(scorer_hidden(p, queries), p["w2"], p["b2"],
                          m=cs.M)[1]
    rows = {"search": gather_members(idx.index.members, bidx)}
    if with_stream:
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 2)
        new = torch.randn((cs.N_INSERT, cs.D), generator=gen, device=dev)
        new /= new.norm(dim=1, keepdim=True)
        dead = torch.cat([
            torch.randperm(cs.L, generator=gen, device=dev)[:cs.N_DEL_BASE],
            cs.L + torch.randperm(cs.N_INSERT, generator=gen,
                                  device=dev)[:cs.N_DEL_NEW]])
        midx = MutableIRLIIndex(idx, corpus, store_dtype="int8")
        for s in range(0, cs.N_INSERT, cs.INSERT_BATCH):
            midx.insert(new[s:s + cs.INSERT_BATCH])
        midx.delete(dead)
        launch = fops.freq_topc

        def capture(cands, *, C):
            rows["stream"] = cands
            return launch(cands, C=C)

        fops.freq_topc = capture
        try:
            midx.search(queries, SearchParams(m=cs.M, tau=cs.TAU, k=cs.K,
                                              store_dtype="int8"))
        finally:
            fops.freq_topc = launch
        del midx
    return corpus, queries, rows


def ab_freq_topc(torch, cs, root, rows):
    from repro_torch.kernels.freq_topc import ops as fops
    from repro_torch.kernels.freq_topc.ref import freq_topc_ref
    other = other_freq_topc(root, torch)
    out = {}
    for name, cands in rows.items():
        ref = freq_topc_ref(cands, C=cs.TOPC)

        def check(who, got):
            if not (torch.equal(got[0], ref[0])
                    and torch.equal(got[1], ref[1])):
                raise AssertionError(f"freq_topc {who} differs from the "
                                     f"plain version at the {name} rows")

        out[name] = {"shape": list(cands.shape), **turns(
            torch, cs, lambda: other(cands, cs.TOPC),
            lambda: fops.freq_topc(cands, C=cs.TOPC), check)}
        print(f"freq_topc at the {name} rows {tuple(cands.shape)}: "
              f"{out[name]}", flush=True)
    return out


def ab_quant_rerank(torch, cs, root, corpus, queries, cands):
    from repro_torch.kernels.freq_topc import ops as fops
    from repro_torch.kernels.quant_rerank import ops as qops
    from repro_torch.kernels.quant_rerank.ref import (quant_rerank_ref,
                                                      same_topk)
    from repro_torch.store.quantized import encode
    from repro_torch.store.rerank import resolve_refine_k
    other = other_quant_rerank(root, torch)
    store = encode(corpus, "int8", cs.BLOCK)
    cid, cnt = fops.freq_topc(cands, C=cs.TOPC)
    kp = resolve_refine_k(0, cs.K, cs.TOPC)
    out = {}
    for tau in (cs.TAU, 1):
        rids, rvals = quant_rerank_ref(queries, store.codes, store.scales,
                                       cid, cnt, tau=tau, k=kp)
        _, wide = quant_rerank_ref(queries, store.codes, store.scales, cid,
                                   cnt, tau=tau, k=kp + 1)

        def check(who, got):
            same_topk(got[0], rids, got[1], rvals, wide, cs.TOL)

        name = f"tau={tau}"
        out[name] = {"shape": list(cid.shape), "kp": kp, **turns(
            torch, cs,
            lambda: other(queries, store.codes, store.scales, cid, cnt, tau,
                          kp),
            lambda: qops.quant_rerank(queries, store.codes, store.scales,
                                      cid, cnt, tau=tau, k=kp), check,
            n=20)}
        print(f"quant_rerank at the compact search's inputs, {name}: "
              f"{out[name]}", flush=True)
    return out


def ab_embedding_bag(torch, cs, root, dev):
    from repro_torch.configs.dien import BATCHES, CONFIG
    from repro_torch.data.synthetic import behavior_stream
    from repro_torch.kernels.embedding_bag import ops as eops
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.models.recsys import dien_init
    other = other_embedding_bag(root, torch)
    params = dien_init(CONFIG, seed=cs.SEED, device=dev)
    tables = {"item": params["item_emb"]["table"],
              "category": params["cate_emb"]["table"]}
    out = {}
    for cell in ("serve_bulk", "serve_p99"):
        host = next(behavior_stream(BATCHES[cell], CONFIG.seq_len,
                                    CONFIG.item_vocab, CONFIG.cate_vocab,
                                    seed=cs.SEED))
        mask = torch.as_tensor(host["hist_mask"], device=dev)
        for t, key in (("item", "hist_items"), ("category", "hist_cates")):
            if cell == "serve_p99" and t == "category":
                continue
            ids = torch.as_tensor(host[key], device=dev)
            table = tables[t]
            want = embedding_bag_ref(ids, mask, table)

            def check(who, got):
                cs.close_err(torch, f"embedding_bag {who}", got, want)

            name = f"{cell} {t}"
            out[name] = {"shape": list(ids.shape), "table":
                         list(table.shape), **turns(
                             torch, cs, lambda: other(ids, mask, table),
                             lambda: eops.embedding_bag(ids, mask, table),
                             check, n=15)}
            print(f"embedding_bag at {name}: {out[name]}", flush=True)
    return out


def main() -> int:
    import torch
    names = sys.argv[2:] or list(KERNELS)
    if (len(sys.argv) < 2 or not torch.cuda.is_available()
            or not set(names) <= set(KERNELS)):
        raise SystemExit(__doc__.split("\n\n")[1])
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    root = Path(sys.argv[1]).resolve()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    if "embedding_bag" in names:
        out["embedding_bag"] = ab_embedding_bag(torch, cs, root, dev)
        torch.cuda.empty_cache()
    if {"freq_topc", "quant_rerank"} & set(names):
        corpus, queries, rows = search_inputs(torch, cs, dev,
                                              "freq_topc" in names)
        if "freq_topc" in names:
            out["freq_topc"] = ab_freq_topc(torch, cs, root, rows)
        if "quant_rerank" in names:
            out["quant_rerank"] = ab_quant_rerank(torch, cs, root, corpus,
                                                  queries, rows["search"])
    print(json.dumps({"kernel_ab": out,
                      "card": cs.nvidia_smi("name,power.limit")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
