"""Open loop: independent users behind ``IRLIServer``. One client thread
sends single-query requests at Poisson arrivals of a fixed rate
(``rate_per_s``), whatever the server's speed, every request at the
configuration's search parameters. The gaps are the exponential
distribution's quantiles at (j + 1/2)/n, in an order drawn from the run's
seed: every seed offers the same set of gaps, and so the same load, in
another order. The run's seed also draws the queries, the corpus and the
index.

Each request is timed from when it was due to when its future resolved,
so a late client or a queue counts in the latency; how late the client
sent each request is kept apart (the generator's lag). A request that
fails or never comes counts in ``failed`` and lies beyond every
percentile. The check compares a sample of the window's answers, drawn
from the seed (``check_requests``), with the reference.
"""
from __future__ import annotations

import functools
import gc
import math
import random
import threading
import time

import numpy as np
import torch

from irli_bench import check, data, measure, system, tracing
from irli_bench.cost import search_step
from irli_bench.reference import search as ref

#: how long after the window's close an answer may still come
LATE_S = 60.0


class Spans:
    """The index as the server sees it: the rows of each call of its entry
    point, ``IRLIIndex.search``, kept while ``on`` (the benchmark's own
    span around the entry layer); every other attribute is the index's.
    One thread, the server's batcher, calls it."""

    def __init__(self, index):
        self._index = index
        self.on = False
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._index, name)

    def search(self, queries, base, params, *, cache=None):
        if self.on:
            self.calls.append(int(queries.shape[0]))
        return self._index.search(queries, base, params, cache=cache)


def schedule(seed: int, stream: str, n: int, rate: float) -> np.ndarray:
    """Due times [n] in s from the first: the exponential quantiles as
    gaps, shuffled by the seed."""
    gaps = [-math.log(1.0 - (j + 0.5) / n) / rate for j in range(n)]
    random.Random(data.subseed(seed, stream)).shuffle(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


def offer(server, queries, due, params, keep=()) -> dict:
    """Submit request i at due[i] s from now and wait until every answer
    has come, or LATE_S after the last send -> {"t0", "sent", "done"
    (inf where it failed or did not come), "kept": {i: SearchResult} for
    the indices in ``keep``}. Only the kept answers stay alive, so the
    collector's passes do not grow with the window."""
    n = len(due)
    done = [math.inf] * n
    sent = [0.0] * n
    kept, keep = {}, set(keep)
    left, lock, all_done = [n], threading.Lock(), threading.Event()

    def resolved(f, i):
        ok = f.exception() is None
        with lock:
            if ok:
                done[i] = time.perf_counter()
                if i in keep:
                    kept[i] = f.result()
            left[0] -= 1
            if not left[0]:
                all_done.set()

    t0 = time.perf_counter()
    for i in range(n):
        wait = t0 + due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        sent[i] = time.perf_counter()
        server.submit(queries[i], params).add_done_callback(
            functools.partial(resolved, i=i))
    all_done.wait(timeout=LATE_S)
    with lock:
        return {"t0": t0, "sent": sent, "done": list(done),
                "kept": dict(kept)}


def step_flops(cfg: dict, result) -> int:
    """The search step's operations for one served request."""
    s = cfg["search"]
    n = int(result.n_candidates)
    return search_step.flops(cfg, 1, m=s["m"], valid=n,
                             refined=search_step.refined(
                                 [n], s["k"], s["topC"],
                                 s.get("refine_k", 0)))


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        started: float) -> dict:
    from repro_torch.serve.server import IRLIServer

    cfg, mix = cell["config"], cell["traffic"]
    ref.ieee_matmul()
    phases = measure.Phases(started, device)
    phases.mark("imports")
    inputs = data.make_inputs(cfg, seed, device)
    phases.mark("inputs")
    idx, store = system.frozen_index(cfg, inputs, device)
    phases.mark("index")
    params = system.search_params(cfg)
    rate = mix["rate_per_s"]
    n = max(1, round(rate * seconds))
    n_trace = round(rate * mix["trace_seconds"]) if trace else 0
    pool = data.query_batch(cfg, inputs, seed, "served", 0, n).cpu().numpy()
    warm_q = data.query_batch(cfg, inputs, seed, "warm", 0,
                              mix["max_batch"]).cpu().numpy()
    spans = Spans(idx)
    server = IRLIServer(spans, params=params, base=store,
                        max_batch=mix["max_batch"],
                        max_wait_ms=mix["max_wait_ms"], probe_stats=True)
    try:
        # every pad size, then single requests
        for nb in server.buckets:
            for f in [server.submit(q, params) for q in warm_q[:nb]]:
                f.result(timeout=600)
        for _ in range(4):
            server.submit(warm_q[0], params).result(timeout=600)
        if trace:
            tracing.warm_profiler()
        # what set-up made lives as long as the process: out of the
        # collector's passes, as a server does after start-up, so that a
        # pass in the window scans only what the window makes
        gc.collect()
        gc.freeze()
        setup_s = phases.mark("warm") - started

        due = schedule(seed, "window", n, rate)
        picks = measure.sample(seed, "check", n, mix["check_requests"])
        before = server.stats
        window = offer(server, pool, due, params, keep=picks)
        after = server.stats

        summary, traced_flops = None, 0
        if trace:
            tpool = data.query_batch(cfg, inputs, seed, "trace", 0,
                                     n_trace).cpu().numpy()
            with tracing.SubWindow(mix["trace_launch_slack"]) as tw:
                spans.on = True
                traced = offer(server, tpool,
                               schedule(seed, "trace", n_trace, rate),
                               params, keep=range(n_trace))["kept"]
                spans.on = False
            summary = tw.summary
            traced_flops = sum(step_flops(cfg, r) for r in traced.values())
    finally:
        server.close()
    peak = measure.memory_peak(device)
    served_calls = spans.calls
    del server, spans, idx, store
    measure.release(device)

    t0 = window["t0"]
    latency = [d - (t0 + u) for d, u in zip(window["done"], due)]
    failed = sum(math.isinf(x) for x in latency)

    # the check: a sample of the window's answers drawn from the seed,
    # every one of them due in the window
    numbers = compare(cfg, inputs, pool[picks],
                      [window["kept"].get(i) for i in picks], device)

    delta = {k: after[k] - before[k]
             for k in ("batches", "requests", "pad_waste", "param_groups")}
    return {"attempted": n, "failed": failed, "missing": failed,
            "numbers": numbers, "memory_peak_bytes": peak,
            "trace": summary, "setup_split": phases.split(),
            "readings": {"cfg": cfg, "traffic": mix, "setup_s": setup_s,
                         "latency_s": latency, "window_s": seconds,
                         "late_s": LATE_S, "server": delta,
                         "gen_lag_s": [s - (t0 + u)
                                       for s, u in zip(window["sent"], due)],
                         "trace": summary, "traced_flops": traced_flops,
                         "served_calls": served_calls}}


def compare(cfg: dict, inputs: dict, queries, results, device,
            precision: str = "fp32") -> dict:
    """Each answered request (its query, the served SearchResult or None)
    against the reference -> the check's numbers. At another
    ``precision`` the reference at that precision stands in for the server
    (the control; ``results`` None)."""
    index = ref.build(inputs, cfg)
    kw = dict(cfg["search"])
    rows = [i for i in range(len(queries))
            if results is None or results[i] is not None]
    if not rows:
        return {"mismatch": 1.0, "score_gap": 0.0}
    q = torch.as_tensor(queries[rows], device=device)
    want = ref.search(index, q, **kw)[:3]
    if results is None:
        got = ref.search(index, q, precision=precision, **kw)[:3]
    else:
        got = (torch.as_tensor(np.stack([results[i].ids for i in rows])),
               torch.as_tensor(np.stack([results[i].scores for i in rows])),
               torch.as_tensor(np.array([results[i].n_candidates
                                         for i in rows])))
    return check.compare([got], [want],
                         [ref.rescore(index, q, got[0], kw["metric"])])


def control(cell: dict, seed: int, seconds: float, device,
            precision: str = "tf32") -> dict:
    """The check's numbers with the reference at ``precision`` in the
    server's place, over the requests a run of ``seconds`` compares."""
    cfg, mix = cell["config"], cell["traffic"]
    ref.ieee_matmul()
    inputs = data.make_inputs(cfg, seed, device)
    n = max(1, round(mix["rate_per_s"] * seconds))
    picks = measure.sample(seed, "check", n, mix["check_requests"])
    queries = data.query_batch(cfg, inputs, seed, "served", 0,
                               n).cpu().numpy()
    return compare(cfg, inputs, queries[picks], None, device, precision)
