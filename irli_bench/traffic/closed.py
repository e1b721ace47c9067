"""Closed loop: one caller searches batch after batch through
``IRLIIndex.search`` and reads each result back to the host before it sends
the next, as a bulk search job does. The mix gives the batch's size
(``queries_per_call``), the warm-up calls, the calls of the traced
sub-window and how many of the window's calls the reference checks.

The window runs until ``seconds`` have passed and the call in flight has
ended; the readings are every query it completed and its whole length.
"""
from __future__ import annotations

import time

from irli_bench import check, data, measure, system, tracing
from irli_bench.cost import search_step
from irli_bench.reference import search as ref


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        started: float) -> dict:
    cfg, mix = cell["config"], cell["traffic"]
    ref.ieee_matmul()
    phases = measure.Phases(started, device)
    phases.mark("imports")
    inputs = data.make_inputs(cfg, seed, device)
    phases.mark("inputs")
    idx, store = system.frozen_index(cfg, inputs, device)
    phases.mark("index")
    params = system.search_params(cfg)
    Q = mix["queries_per_call"]

    def call(stream: str, i: int):
        q = data.query_batch(cfg, inputs, seed, stream, i, Q)
        res = idx.search(q, store, params)
        return res.ids.cpu(), res.scores.cpu(), res.n_candidates.cpu()

    for i in range(mix["warm_calls"]):
        call("warm", i)
    if trace:
        tracing.warm_profiler()
    setup_s = phases.mark("warm") - started

    window = []
    t0 = time.perf_counter()
    while not window or time.perf_counter() - t0 < seconds:
        window.append(call("window", len(window)))
    window_s = time.perf_counter() - t0

    traced, summary = [], None
    if trace:
        with tracing.SubWindow() as tw:
            for i in range(mix["trace_calls"]):
                traced.append(call("trace", i))
        summary = tw.summary
    peak = measure.memory_peak(device)
    del idx, store
    measure.release(device)

    # the check, once the window has closed and the program's state is
    # freed: the reference over a seeded sample of the window's calls and
    # over the traced calls (whose work it also counts for the rooflines)
    picks = [("window", i, window[i]) for i in measure.sample(
        seed, "check", len(window), mix["check_calls"])]
    picks += [("trace", i, out) for i, out in enumerate(traced)]
    numbers, work = compare(cfg, mix, inputs, seed, picks)
    traced_work = work[len(picks) - len(traced):]

    s = cfg["search"]
    flops = sum(search_step.flops(
        cfg, Q, m=s["m"], valid=int(n.sum()),
        refined=search_step.refined(n.tolist(), s["k"], s["topC"],
                                    s.get("refine_k", 0)))
        for _, _, n in window)
    n_done = Q * len(window)
    return {"attempted": n_done, "failed": 0, "missing": 0,
            "numbers": numbers, "memory_peak_bytes": peak,
            "trace": summary, "setup_split": phases.split(),
            "readings": {"cfg": cfg, "traffic": mix, "setup_s": setup_s,
                         "completed": n_done, "window_s": window_s,
                         "step_flops": flops, "trace": summary,
                         "traced_calls": traced_work}}


def compare(cfg: dict, mix: dict, inputs: dict, seed: int, picks: list,
            precision: str = "fp32"):
    """Each picked call (stream, i, the program's answers) against the
    reference over the same queries -> (the check's numbers, the work each
    call's queries need). At another ``precision`` the reference at that
    precision stands in for the program (the control)."""
    index = ref.build(inputs, cfg)
    kw = dict(cfg["search"])
    got, want, rescored, work = [], [], [], []
    for stream, i, out in picks:
        q = data.query_batch(cfg, inputs, seed, stream, i,
                             mix["queries_per_call"])
        r_ids, r_scores, r_n, stats = ref.search(index, q, **kw)
        if precision != "fp32":
            out = ref.search(index, q, precision=precision, **kw)[:3]
        got.append(out)
        want.append((r_ids, r_scores, r_n))
        rescored.append(ref.rescore(index, q, out[0], kw["metric"]))
        work.append(dict(stats, Q=q.shape[0]))
    numbers = check.compare(got, want, rescored)
    return numbers, work


def control(cell: dict, seed: int, seconds: float, device,
            precision: str = "tf32") -> dict:
    """The check's numbers with the reference at ``precision`` in the
    program's place, over as many calls as a traced run compares."""
    cfg, mix = cell["config"], cell["traffic"]
    ref.ieee_matmul()
    inputs = data.make_inputs(cfg, seed, device)
    picks = [("window", i, None) for i in range(mix["check_calls"])]
    picks += [("trace", i, None) for i in range(mix["trace_calls"])]
    return compare(cfg, mix, inputs, seed, picks, precision)[0]
