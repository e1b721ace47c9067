"""The traced sub-window of a ``--trace 1`` run: torch.profiler over a
bounded stretch of the cell's own traffic, after the measured window.

torch.profiler drops the first kernels of a long window, so it runs over a
short one, after lead-in kernels that take that loss, and every port kernel
it sees is held to the launch counters of the port's wrappers
(``kernels.LAUNCHES``): a count that differs fails the run. From the trace:
the device's busy seconds in the window (kernels, copies and sets, their
union), each port kernel's launches and seconds, the device operations
that took most time, and the idle gaps by the host operation that
overlapped them most.
"""
from __future__ import annotations

import time

#: lead-in kernels before the window (torch.cuda._sleep's spin_kernel)
LEAD_IN, LEAD_IN_KERNEL = 128, "spin_kernel"
#: the host range that marks the window in the trace
WINDOW = "irli_bench.window"
#: the port's kernels: the wrapper's name -> parts of its device kernels'
#: names
PORT_KERNELS = {"mega_query": ("mega_query_kernel",),
                "irli_topk": ("irli_topk_kernel", "irli_topk_wide_kernel"),
                "freq_topc": ("freq_topc_kernel", "freq_topc_wide_kernel"),
                "quant_rerank": ("quant_rerank_kernel",),
                "kchoice": ("kchoice_kernel",)}


def port_kernel(name: str) -> str | None:
    for kernel, parts in PORT_KERNELS.items():
        if any(p in name for p in parts):
            return kernel
    return None


def warm_profiler() -> None:
    """Start and stop the profiler once in set-up: its first start loads
    CUPTI, which would otherwise land in the traced window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class SubWindow:
    """``with SubWindow(launch_slack) as tw: <traffic>``; then ``tw.summary``.

    ``launch_slack``: how far a port kernel's traced count may differ from
    its counter's. 0 where one thread launches every kernel; a few where
    another thread (the server's batcher) may launch across the window's
    edges, between the profiler's start and the counters' read."""

    def __init__(self, launch_slack: int = 0):
        self.launch_slack = launch_slack
        self.summary = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.kernels import LAUNCHES
        self._launches = LAUNCHES
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        for _ in range(LEAD_IN):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        self._before = dict(LAUNCHES)
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self._range.__exit__(None, None, None)
        launched = {k: v - self._before[k] for k, v in self._launches.items()
                    if v != self._before[k]}
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(self._prof.events(), window_s,
                                     launched, self.launch_slack)
        return False


def summarize(events, window_s: float, launched: dict,
              launch_slack: int) -> dict:
    """The trace's reading of the window -> {"window_s", "busy_s",
    "kernels": {port kernel: {"launches", "seconds"}}, "device_ops",
    "idle_gaps"}. Raises when a port kernel's traced
    launches differ from its counter by more than ``launch_slack``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    marks = [e for e in events if e.name == WINDOW
             and e.device_type != cuda]
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} window marks")
    w0, w1 = marks[0].time_range.start, marks[0].time_range.end
    dev, host = [], []
    for e in events:
        if e.device_type == cuda:
            # the window's own range shows on the device's timeline too,
            # as an annotation over the kernels its thread launched
            if LEAD_IN_KERNEL not in e.name and e.name != WINDOW:
                dev.append(e)
        elif e.name != WINDOW and w0 <= e.time_range.start <= w1:
            host.append(e)
    spans = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
             for e in dev]
    busy = _union([s for s in spans if s[1] > s[0]])
    kernels, ops = {}, {}
    for e in dev:
        dur = e.time_range.elapsed_us() / 1e6
        ops[e.name] = ops.get(e.name, 0.0) + dur
        k = port_kernel(e.name)
        if k is not None:
            kk = kernels.setdefault(k, {"launches": 0, "seconds": 0.0})
            kk["launches"] += 1
            kk["seconds"] += dur
    for k in set(kernels) | set(launched):
        traced = kernels.get(k, {}).get("launches", 0)
        if abs(traced - launched.get(k, 0)) > launch_slack:
            raise RuntimeError(
                f"the profiler traced {traced} {k} launches, the wrappers "
                f"counted {launched.get(k, 0)}: the trace lost kernels")
    gaps, at = {}, w0
    for s, e in busy + [[w1, w1]]:
        if s > at:
            name = _host_op(host, at, s)
            gaps[name] = gaps.get(name, 0.0) + (s - at) / 1e6
        at = max(at, e)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": window_s,
            "busy_s": sum(e - s for s, e in busy) / 1e6,
            "kernels": kernels,
            "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": sorted(([n, s] for n, s in gaps.items()),
                                key=lambda kv: -kv[1])[:10]}


def _host_op(host, s: float, e: float) -> str:
    """The host operation that overlapped (s, e) most; among equal
    overlaps the shortest (the innermost)."""
    best, key = "no host operation recorded", (0.0, 0.0)
    for h in host:
        ov = min(e, h.time_range.end) - max(s, h.time_range.start)
        if ov > 0:
            k = (ov, -h.time_range.elapsed_us())
            if k > key:
                best, key = h.name, k
    return best
