"""Cost model of one eager call: FLOPs, HBM bytes, collectives, memory,
kernel launches and host reads, per rank. Port of the cost model of
``repro/analysis/hlo.py`` (``analyze_hlo``, ``:360-376``).

The reference parses a compiled XLA module. Here the call runs once,
eagerly, under :class:`CostRecorder` (a ``TorchDispatchMode``), on real
tensors or on fake ones (``FakeTensorMode``: shapes and dtypes, no
memory; the dry run, ``launch/dryrun.py``), and every aten op it issues
is billed as it happens:

  flops             mm, bmm, addmm, baddbmm, convolution and SDPA by
                    ``torch.utils.flop_counter``'s formulas (2 · result ·
                    contraction, the reference's ``_dot_flops`` and
                    ``_conv_flops``); a kernel call by its declared work,
                    its ops module's ``cost()`` (``kernels.billing``),
                    and none of the ops inside it (the plain version's on
                    the CPU, the launch's allocations on the card): the
                    reference bills a custom call as one op
  hbm_bytes         the UNFUSED traffic model: every materialised op
                    result (``analysis/trace.py``'s records: views and
                    in-place ops free, factories billed), each kernel's
                    declared bytes and each collective's result. Eager
                    runs unfused, so an elementwise chain bills every
                    intermediate the reference's fusion would keep on chip
  collectives       result bytes on this rank of each collective
                    (``analysis/collectives.py``), by the reference's five
                    kinds (any other kind, such as a broadcast, under its
                    own name), and their count
  argument_bytes    the local tensors of the call's arguments (params,
                    optimizer state, inputs: a DTensor's local shard)
  peak_bytes        the arguments plus the most bytes of storage the call
                    held alive at once: each new storage an op returns,
                    tallied until it is freed (autograd's saved tensors
                    included); ``temp_bytes`` is peak less arguments
  output_bytes      the local tensors of the result
  launches          kernel calls billed, by kernel (one a launch on the
                    card)
  host_reads        reads of a card tensor's value by the host
                    (``.item()``, ``bool()``, ``float()``), by site (the
                    host's own counters, such as the optimizer's step, are
                    not the card's)

Every count is per rank, on local shapes: an op on DTensors is handed back
to DTensor (as ``CommDebugMode`` does), which runs it as local ops and
collectives that come back here; the global-shape ops of DTensor's
sharding propagation are not counted. A Python loop needs no trip count:
eager runs each iteration, so the reference's ``trip_count``,
``split_computations`` and its parse warnings have no counterpart.
"""
from __future__ import annotations

import os
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import trace
from repro_torch.analysis.collectives import is_collective, note
from repro_torch.models.module import is_dtensor

#: the reference's collective kinds (hlo.py ``COLLECTIVES``)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HERE = os.path.abspath(__file__)
_TORCH = os.path.dirname(os.path.abspath(torch.__file__))
#: the ops by which the host reads a tensor's value (``item()``, ``int()``,
#: ``float()``, ``bool()``)
_READS = (torch.ops.aten._local_scalar_dense.default,
          torch.ops.aten.item.default, torch.ops.aten.is_nonzero.default)


def _flop_registry() -> dict:
    from torch.utils.flop_counter import flop_registry
    return flop_registry


_HANDLERS = ("__torch_function__", "__torch_dispatch__")


def caller_site() -> str:
    """The port's innermost frame on the stack outside this module, torch
    and any mode's handler, as "core/topk.py:topk_stable" (the
    package-relative file and the function's qualified name)."""
    f = sys._getframe(1)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path != _HERE and not path.startswith(_TORCH) and \
                f.f_code.co_name not in _HANDLERS:
            if path.startswith(_PKG):
                return (f"{os.path.relpath(path, _PKG)}:"
                        f"{f.f_code.co_qualname}")
            return f"{os.path.basename(path)}:{f.f_code.co_qualname}"
        f = f.f_back
    return "?"


def _no_data(t) -> bool:
    from repro_torch.kernels import holds_no_data
    return holds_no_data(t)


#: DTensor's modules whose ops are its metadata planning, not a rank's
#: work: their host tensors run for real in a dry run (not the sharding
#: propagation's global-shape fake ops, nor the dispatcher's local ops)
_DTENSOR_DIR = os.path.join(_TORCH, "distributed", "tensor") + os.sep
_DTENSOR_FAKE = ("_sharding_prop.py", "_op_schema.py", "_dispatch.py")


def _plain_meta(args, kwargs) -> bool:
    """Whether an op's tensors are all meta tensors outside any fake
    mode."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils._pytree import tree_leaves
    ts = [a for a in tree_leaves((args, kwargs))
          if isinstance(a, torch.Tensor)]
    return bool(ts) and all(t.is_meta and not isinstance(t, FakeTensor)
                            for t in ts)


def _dtensor_host_math(args, kwargs) -> bool:
    """Whether an op is DTensor's host arithmetic: called from its own
    modules (but for those of :data:`_DTENSOR_FAKE`), on no tensor
    without data."""
    from torch.utils._pytree import tree_leaves
    if any(isinstance(a, torch.Tensor) and _no_data(a)
           for a in tree_leaves((args, kwargs))):
        return False
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_DTENSOR_DIR):
            return not path.endswith(_DTENSOR_FAKE)
        if not path.startswith(_HOST_INFRA) or "distributed" in path:
            return False
        f = f.f_back
    return False


#: the code between an op and its caller: torch's dispatch and this
#: package's recorders (a composite op decomposed under the recorder)
_HOST_INFRA = (_TORCH, os.path.dirname(_HERE))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for k in tree.__dataclass_fields__:
            yield from _tensors(getattr(tree, k))


def local_bytes(tree) -> int:
    """Bytes of every tensor of a nested dict / list / dataclass, a
    DTensor counted by its local shard: what one rank holds."""
    total = 0
    for t in _tensors(tree):
        if is_dtensor(t):
            t = t.to_local()
        total += t.numel() * t.element_size()
    return total


class CostRecorder(TorchDispatchMode):
    """The cost record of the ops run inside a ``with`` block (see the
    module docstring); :meth:`record` gives it as the reference's keys
    plus the port's.

    ``device`` is the billed device's type: the work, memory and reads of
    its tensors are billed, and no other's (the host's own arithmetic on
    CPU tensors of a card's call is not the card's). ``dry``: a dry run
    under ``FakeTensorMode``, which bills only tensors without data; a
    real tensor there is host arithmetic, and DTensor's own (its
    placement and redistribution planning) runs for real, outside the
    fake mode, whose fake values it could not read. ``answers`` ({site:
    value}, for a dry run): a host read of a tensor without data at one of
    these sites returns the value (and is counted); any other such read
    raises, naming its site."""

    def __init__(self, *, device="cuda", dry: bool = False,
                 answers: dict | None = None):
        super().__init__()
        self.device = torch.device(device).type
        self.dry = dry
        self.answers = answers or {}
        self.flops = 0
        self.hbm_bytes = 0
        self.coll = dict.fromkeys(COLLECTIVES, 0)
        self.coll_count = 0
        self.launches: dict[str, int] = {}
        self.host_reads: dict[str, int] = {}
        self.live = self.peak = 0
        self._held: dict[int, int] = {}
        self._kernel_depth = 0
        self._depth = 0
        self._dtensors = False

    # -------------------------------------------------- kernels.billing --
    def enter_kernel(self, name: str, cost: dict) -> None:
        if self._kernel_depth == 0:
            self.launches[name] = self.launches.get(name, 0) + 1
            self.flops += cost["flops"]
            self.hbm_bytes += cost["bytes"]
        self._kernel_depth += 1

    def exit_kernel(self) -> None:
        self._kernel_depth -= 1

    def __enter__(self):
        from repro_torch.kernels import RECORDERS
        if self._depth == 0:
            RECORDERS.append(self)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import RECORDERS
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                RECORDERS.remove(self)

    # ------------------------------------------------------------ memory --
    def hold_arguments(self, tree) -> None:
        """Mark the storages of a call's arguments as held from before it:
        an op that hands one back (an in-place collective) allocates
        nothing."""
        for t in _tensors(tree):
            if is_dtensor(t):
                t = t.to_local()
            self._held.setdefault(t.untyped_storage()._cdata, 0)

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    # ---------------------------------------------------------- dispatch --
    def _billed(self, t: torch.Tensor) -> bool:
        """Whether ``t`` is the billed device's (in a dry run, a tensor
        without data: a real one there is host arithmetic)."""
        if t.device.type != self.device:
            return False
        return not self.dry or _no_data(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if trace.DTENSOR is not None and any(
                issubclass(t, trace.DTENSOR) for t in types):
            self._dtensors = True
            return NotImplemented
        if self.dry and _dtensor_host_math(args, kwargs):
            from torch._subclasses.fake_tensor import unset_fake_temporarily
            with unset_fake_temporarily():
                return func(*args, **kwargs)
        if func in _READS:
            return self._read(func, args)
        if self.dry and _plain_meta(args, kwargs):
            # ``torch.tensor(data, device="meta")`` makes a meta tensor
            # that is not the fake mode's; its own meta kernels serve it
            from torch._subclasses.fake_tensor import unset_fake_temporarily
            with unset_fake_temporarily():
                return self._bill(func, args, kwargs,
                                  func(*args, **kwargs))
        if func.namespace == "aten" and \
                func._overloadpacket not in _flop_registry():
            # a composite op (matmul, to) reaches the mode whole where
            # autograd is off: bill the ops it stands for, as
            # FlopCounterMode does
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        return self._bill(func, args, kwargs, func(*args, **kwargs))

    def _bill(self, func, args, kwargs, out):
        if self._dtensors and trace.in_sharding_propagation():
            return out
        name = str(func)
        outs = [t for t, view in trace.op_outputs(func, out) if not view]
        if is_collective(func.namespace, name):
            rec: list = []
            note(rec, name, out)
            c = rec[0]
            self.coll[c.kind] = self.coll.get(c.kind, 0) + c.bytes
            self.coll_count += 1
            self.hbm_bytes += c.bytes
            for t in outs:
                if self._billed(t):
                    self._hold(t)
            return out
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            return out                          # wait_tensor and wrappers
        if self._kernel_depth == 0:
            count = _flop_registry().get(func._overloadpacket)
            if count is not None and (not outs or self._billed(outs[0])):
                # the formulas take the tensors positionally: an overload's
                # trailing scalar (bmm.dtype's out_dtype) would bind to
                # their out_shape
                last = max(i for i, a in enumerate(args)
                           if isinstance(a, torch.Tensor))
                self.flops += count(*args[:last + 1], **kwargs,
                                    out_val=out)
        for t in outs:
            if self._billed(t):
                if self._kernel_depth == 0:
                    self.hbm_bytes += t.numel() * t.element_size()
                self._hold(t)
        return out

    def _read(self, func, args):
        t = args[0]
        site = caller_site()
        if _no_data(t) and site in self.answers:
            val = self.answers[site]
        else:
            try:
                val = func(*args)
            except Exception as e:
                if not _no_data(t):
                    raise
                raise RuntimeError(
                    f"a host read of a tensor without data at {site}: the "
                    f"dry run has no answer for it ({type(e).__name__})"
                ) from None
        if self._billed(t):
            self.host_reads[site] = self.host_reads.get(site, 0) + 1
        return val

    # ------------------------------------------------------------ record --
    def record(self, argument_bytes: int = 0, output_bytes: int = 0) -> dict:
        """The reference's keys (``flops``, ``hbm_bytes``,
        ``collective_bytes``, ``collectives``, ``collective_count``) and
        the port's (``argument_bytes``, ``output_bytes``, ``peak_bytes``,
        ``temp_bytes``, ``launches``, ``host_reads``)."""
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": sum(self.coll.values()),
            "collectives": dict(self.coll),
            "collective_count": self.coll_count,
            "argument_bytes": argument_bytes,
            "output_bytes": output_bytes,
            "peak_bytes": argument_bytes + self.peak,
            "temp_bytes": self.peak,
            "launches": dict(self.launches),
            "host_reads": dict(self.host_reads),
        }


def analyze_call(fn, args: tuple = (), *, device=None, dry: bool = False,
                 answers: dict | None = None):
    """Run ``fn(*args)`` once under a :class:`CostRecorder` -> (record,
    result); the record also carries ``seconds``, the call's wall time
    under the recorder. ``device``: the billed device (default: that of
    the arguments' first tensor)."""
    if device is None:
        first = next(_tensors(args), None)
        if is_dtensor(first):
            first = first.to_local()
        device = "cpu" if first is None else first.device
    t0 = time.perf_counter()
    rec = CostRecorder(device=device, dry=dry, answers=answers)
    rec.hold_arguments(args)
    with rec:
        result = fn(*args)
    out = rec.record(local_bytes(args), local_bytes(result))
    out["seconds"] = time.perf_counter() - t0
    return out, result
