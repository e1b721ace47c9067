"""Op-trace recorder: the analyser behind every "this intermediate never
exists" contract of the port (compact-query [Q, L], store fp32 [L, D], fit
[.., L, B]), the per-contract peak-intermediate report and the launch
counts of the single-launch proof. Port of ``repro/analysis/jaxpr.py``.

The reference traces abstractly and walks the jaxpr. PyTorch runs eagerly,
so this module runs the call once and records what actually happens:

  * every aten op's output tensors (op, shape, dtype, bytes), under a
    ``TorchDispatchMode``. A view is not a materialisation: an op whose
    schema return carries ``alias_info`` (``expand``, ``slice``,
    ``permute``, an in-place op or an ``out=`` variant) only aliases a
    tensor that exists already. Factories (``empty``, ``zeros``, ``full``)
    count: on the card they are the kernels' output buffers and
    workspaces. The mode sees the backward too (the autograd engine runs
    it with the caller's dispatch modes);
  * the kernel dispatch sites entered (:data:`DISPATCH_SITES`, the public
    entries of each ``kernels/<name>/ops.py``, whichever version they run),
    counted at the top level only, as the reference counts top-level
    ``pjit``/``pallas_call`` equations: a site entered inside another
    site is one dispatch with it. Watched with ``sys.monitoring`` on those
    functions' code alone, for the call's duration;
  * the port's own launch counters (``kernels.LAUNCHES``) over the call;
  * the collectives (:mod:`repro_torch.analysis.collectives`);
  * on the card, when asked (``profile``: the single-launch proof), the
    CUDA kernels that ``torch.profiler`` sees inside the call after one
    warm-up call (every kernel: torch's own and the ctypes-launched ones),
    with memcpy and memset apart.

Nothing here is imported or run on the serving path: a recorder costs only
the calls it wraps. Negative proofs built on :func:`materializes_dims` are
vacuous without a control that trips them; ``analysis.contracts``
enforces the pairing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import os
import sys
from typing import Any, Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: each kernel's dispatch sites: the public entries of its ops.py, the
#: dispatch function that picks the version and the launcher
DISPATCH_SITES = {
    "irli_topk": ("scorer_topk", "irli_topk"),
    "freq_topc": ("frequent_topc", "freq_topc"),
    "quant_rerank": ("quant_coarse_topk", "quant_rerank"),
    "mega_query": ("mega_search", "mega_query"),
    "bce_logits": ("sigmoid_bce_loss", "fused_bce", "weighted_bce",
                   "bce_logits"),
    "kchoice": ("kchoice_assign", "kchoice"),
    "distance_topk": ("rerank_topk", "distance_topk"),
    "flash_attention": ("causal_attention", "flash_attention"),
    "embedding_bag": ("bag_lookup_reduce", "embedding_bag"),
}


#: the part of a kernel's CUDA function names that names it, where that
#: is not its own name (flash_bf16_wgmma_kernel, flash_f32_kernel)
KERNEL_STEMS = {"flash_attention": "flash_"}


def dtype_name(dtype) -> str:
    """``torch.float32``, ``np.float32``, ``"float32"`` -> ``"float32"``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One output tensor of one recorded op."""
    op: str              # e.g. "aten.mm.default"
    shape: tuple
    dtype: str           # e.g. "float32"
    bytes: int
    view: bool           # aliases a tensor that exists already


@dataclasses.dataclass(frozen=True)
class PeakIntermediate:
    """The largest single materialised intermediate and where it came
    from (the reference's name for the producing op: ``primitive``)."""
    bytes: int
    shape: tuple
    dtype: str
    primitive: str


@dataclasses.dataclass
class CallTrace:
    """What one call did: its op records, the top-level dispatch sites it
    entered, the port's launches and, on the card, the CUDA kernels and
    memory copies/sets torch.profiler saw; its collectives; its result."""
    ops: list = dataclasses.field(default_factory=list)
    sites: list = dataclasses.field(default_factory=list)
    launches: dict = dataclasses.field(default_factory=dict)
    collectives: list = dataclasses.field(default_factory=list)
    kernels: list | None = None          # CUDA kernel names (card only)
    copies: list | None = None           # memcpy / memset names (card only)
    lead_in: int = 0                     # lead-in kernels the profiler saw
    result: Any = None

    def materialized(self):
        """The records that are not views."""
        return [r for r in self.ops if not r.view]

    def sightings(self, dims, dtype=None) -> list:
        """Materialised records whose shape holds every value of ``dims``
        (optionally of one dtype)."""
        want = None if dtype is None else dtype_name(dtype)
        return [r for r in self.materialized()
                if r.shape and (want is None or r.dtype == want)
                and all(d in r.shape for d in dims)]

    def unseen(self) -> dict:
        """{kernel: (launches, kernels seen)} for each port kernel that
        launched more often in the call than torch.profiler saw kernels
        of its name, and for the lead-in when the profiler saw none of it:
        a count that went blind (empty off the card). The profiler drops a
        prefix of a window, so one lead-in kernel seen shows that no kernel
        of the call was dropped, torch's own included."""
        if self.kernels is None:
            return {}
        out = {} if self.lead_in else {LEAD_IN_KERNEL: (LEAD_IN, 0)}
        for name, n in self.launches.items():
            stem = KERNEL_STEMS.get(name, name)
            seen = sum(stem in k for k in self.kernels)
            if seen < n:
                out[name] = (n, seen)
        return out

    def peak(self) -> PeakIntermediate:
        best = PeakIntermediate(0, (), "", "")
        for r in self.materialized():
            if r.bytes > best.bytes:
                best = PeakIntermediate(r.bytes, r.shape, r.dtype, r.op)
        return best


class _OpRecorder(TorchDispatchMode):
    """Records every op's output tensors into a CallTrace; collectives
    (the ``c10d`` namespace, and the functional collectives DTensor issues)
    go to its collective record instead. An op on DTensors is handed back
    (``NotImplemented``) so that DTensor runs it and the local ops and
    collectives it turns into come here, as torch's ``CommDebugMode``
    does; the global-shape ops of its sharding propagation are not
    recorded (:func:`in_sharding_propagation`): the records are the
    rank's own, on local shapes."""

    def __init__(self, trace: CallTrace):
        super().__init__()
        self.trace = trace
        self.dtensors = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if DTENSOR is not None and any(issubclass(t, DTENSOR)
                                       for t in types):
            self.dtensors = True
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if self.dtensors and in_sharding_propagation():
            return out
        name = str(func)
        from repro_torch.analysis.collectives import is_collective, note
        if is_collective(func.namespace, name):
            note(self.trace.collectives, name, out)
            return out
        for t, alias in op_outputs(func, out):
            self.trace.ops.append(OpRecord(
                name, tuple(t.shape), dtype_name(t.dtype),
                t.numel() * t.element_size(), alias))
        return out


def op_outputs(func, out):
    """(tensor, aliases) for each strided output tensor of one op:
    ``aliases`` when the op's schema return carries ``alias_info`` (a
    view, an in-place op or an ``out=`` variant: no new tensor)."""
    rets = func._schema.returns
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for i, o in enumerate(outs):
        alias = (rets[min(i, len(rets) - 1)].alias_info is not None
                 if rets else False)
        for t in (o if isinstance(o, (tuple, list)) else (o,)):
            if isinstance(t, torch.Tensor) and t.layout == torch.strided:
                yield t, alias


def in_sharding_propagation() -> bool:
    """Whether the current op runs inside DTensor's sharding propagation:
    the ops it runs on fake tensors of the GLOBAL shapes to learn its
    output's metadata (``torch/distributed/tensor/_sharding_prop.py``),
    which are not the rank's work. The walk up the stack stops at the
    first frame of code that is not torch's, the standard library's or
    this package's recorders'."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.endswith("_sharding_prop.py"):
            return True
        if not path.startswith(_INFRA):
            return False
        f = f.f_back
    return False


#: the code an op's dispatch passes through: torch, the standard library
#: and the recorders of this package
_INFRA = (os.path.dirname(torch.__file__), os.path.dirname(os.__file__),
          os.path.dirname(os.path.abspath(__file__)))


def _dtensor_type():
    if not torch.distributed.is_available():
        return None
    from torch.distributed.tensor import DTensor
    return DTensor


#: the DTensor class (None where torch.distributed is not available)
DTENSOR = _dtensor_type()


def site_functions() -> dict:
    """{code object: "kernel.function"} of every dispatch site (imports the
    ops modules: call at record time, never at import time)."""
    codes = {}
    for kernel, names in DISPATCH_SITES.items():
        mod = importlib.import_module(f"repro_torch.kernels.{kernel}.ops")
        for fname in names:
            codes[getattr(mod, fname).__code__] = f"{kernel}.{fname}"
    return codes


class _SiteWatch:
    """Top-level dispatch-site entries during a ``with`` block, through
    ``sys.monitoring`` PY_START events on the sites' code objects only: an
    entry counts when no other site is on the calling thread's stack."""

    def __init__(self, sites: list):
        self.sites = sites
        self.codes = site_functions()
        self.tool = None

    def _start(self, code, offset):
        name = self.codes.get(code)
        if name is None:
            return None
        f = sys._getframe(1).f_back
        while f is not None:
            if f.f_code in self.codes:
                return None
            f = f.f_back
        self.sites.append(name)
        return None

    def __enter__(self):
        mon = sys.monitoring
        free = [i for i in range(6) if mon.get_tool(i) is None]
        if not free:
            raise RuntimeError("no free sys.monitoring tool id")
        self.tool = free[-1]
        mon.use_tool_id(self.tool, "repro_torch.analysis")
        mon.register_callback(self.tool, mon.events.PY_START, self._start)
        for code in self.codes:
            mon.set_local_events(self.tool, code, mon.events.PY_START)
        return self

    def __exit__(self, *exc):
        mon = sys.monitoring
        for code in self.codes:
            mon.set_local_events(self.tool, code, 0)
        mon.register_callback(self.tool, mon.events.PY_START, None)
        mon.free_tool_id(self.tool)
        return False


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def record_call(fn: Callable, args: tuple = (), *, device=None,
                profile: bool = True) -> CallTrace:
    """Run ``fn(*args)`` once under every recorder -> its CallTrace. On a
    CUDA ``device`` with ``profile``, the call runs once before (kernel
    builds, library loads and lazy set-up stay out of the count) and the
    recorded call runs under torch.profiler, after LEAD_IN lead-in kernels
    (``CallTrace.unseen`` tells when the profiler still missed a port
    kernel's launch)."""
    from repro_torch.kernels import LAUNCHES
    prof = contextlib.nullcontext()
    on_card = profile and device is not None and torch.device(
        device).type == "cuda"
    if on_card:
        from torch import profiler
        fn(*args)
        _sync(device)
        prof = profiler.profile(activities=[
            profiler.ProfilerActivity.CPU, profiler.ProfilerActivity.CUDA])
    tr = CallTrace()
    with prof as prof:
        if on_card:
            _lead_in(device)
        before = dict(LAUNCHES)
        with _SiteWatch(tr.sites), _OpRecorder(tr):
            tr.result = fn(*args)
            _sync(device)
    tr.launches = {n: c - before.get(n, 0) for n, c in LAUNCHES.items()
                   if c - before.get(n, 0)}
    if prof is not None:
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        tr.lead_in = sum(LEAD_IN_KERNEL in n for n in names)
        names = [n for n in names if LEAD_IN_KERNEL not in n]
        tr.copies = [n for n in names if n.startswith(("Memcpy", "Memset"))]
        tr.kernels = [n for n in names
                      if not n.startswith(("Memcpy", "Memset"))]
    return tr


#: lead-in kernels launched at the start of each profiled window: in a
#: long run the profiler drops a window's first kernels (up to 15, PERF.md
#: §7), so these take that loss; they are not counted
LEAD_IN, LEAD_IN_KERNEL = 128, "spin_kernel"


def _lead_in(device) -> None:
    with torch.cuda.device(device):
        for _ in range(LEAD_IN):
            torch.cuda._sleep(100)          # at::cuda::sleep: spin_kernel
        _sync(device)


# ------------------------------------------------ the reference's surface --
def traced_shapes(fn, args, dtype=None, device=None) -> list:
    """All materialised intermediate shapes (optionally of one dtype) of
    fn(*args)."""
    want = None if dtype is None else dtype_name(dtype)
    return [r.shape for r in record_call(fn, args, device=device).ops
            if not r.view and r.shape and (want is None or r.dtype == want)]


def materializes_dims(fn, args, *dims, dtype=None, device=None) -> bool:
    """True iff some materialised intermediate's shape contains ALL the
    given distinctive dims (optionally of one dtype): the detector behind
    the [Q, L] / [L, D] / [.., L, B] proofs. Pair a negative assertion
    with a positive control, or it is vacuous."""
    return bool(record_call(fn, args, device=device).sightings(dims, dtype))


def count_dispatches(fn, args, device=None) -> int:
    """Top-level kernel dispatch sites entered by ``fn(*args)``."""
    return len(record_call(fn, args, device=device).sites)


def peak_report(fn, *args, device=None) -> PeakIntermediate:
    """Largest single materialised intermediate with its producing op."""
    return record_call(fn, args, device=device).peak()


def peak_intermediate_bytes(fn, *args, device=None) -> int:
    """Largest single materialised intermediate, in bytes."""
    return peak_report(fn, *args, device=device).bytes
