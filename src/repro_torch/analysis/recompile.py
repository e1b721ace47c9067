"""Recompile detector: counts the distinct argument signatures a callable
runs on. Port of ``repro/analysis/recompile.py``.

The reference counts jit TRACES: an entry point should trace once per
(static config, argument structure) key, and an extra trace (a python
float where a ``jnp.float32`` scalar belongs, an int that became an int64,
a ``None`` member that became an array) is latency and a cache-key bug
that functional tests cannot see, because the result is the same. PyTorch
runs eagerly and traces nothing, so the port counts what a trace would
specialise on: the :func:`signature` of the arguments, the shape and dtype
of every tensor leaf plus the structure around them. A CUDA graph or a
compiled program keyed on it would be rebuilt exactly where the count
rises.

  :class:`SignatureCounter`  wraps a callable; ``.count`` ticks on each
                             argument signature it has not run on before
                             (the counterpart of ``TraceCounter``).
                             ``search_api.PipelineCache`` counts its
                             ``compiles`` by the same :func:`signature`.

``jit_cache_size`` has no counterpart: nothing here keeps a compile
cache of its own to read. :func:`sweep` runs a callable over variants and
:func:`diagnose_drift` explains a failed sweep.
"""
from __future__ import annotations

import dataclasses

import torch


def signature(x):
    """What a trace would specialise on, for one argument: a tensor's
    shape and dtype, the keys and order of dicts, lists and tuples, a
    dataclass's type and fields, a string's value, a python number's type
    (not its value: the reference's weak-typed scalars), None where
    nothing was passed."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    if isinstance(x, dict):
        return tuple((k, signature(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return type(x).__name__, tuple(signature(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x).__name__, tuple(
            (f.name, signature(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    if isinstance(x, str):
        return "str", x
    if isinstance(x, (bool, int, float)):
        return type(x).__name__
    raise TypeError(f"no signature for an argument of type "
                    f"{type(x).__name__}")


class SignatureCounter:
    """Wrap ``fn`` so that ``.count`` ticks once per argument signature it
    has not run on before; calls on a known signature do not tick."""

    def __init__(self, fn):
        self.fn = fn
        self.count = 0
        self._seen: set = set()

    def __call__(self, *args, **kwargs):
        sig = signature((args, kwargs))
        if sig not in self._seen:
            self._seen.add(sig)
            self.count += 1
        return self.fn(*args, **kwargs)


@dataclasses.dataclass(frozen=True)
class SweepReport:
    """Signature accounting of one parameter sweep."""
    traces: int                 # distinct signatures counted over the sweep
    expected: int               # distinct keys the sweep should compile
    per_variant: tuple          # (label, traces_after_this_variant) pairs

    @property
    def ok(self) -> bool:
        return self.traces <= self.expected

    @property
    def extra(self) -> int:
        return max(0, self.traces - self.expected)

    def first_offender(self):
        """Label of the first variant whose call pushed the count past
        ``expected`` (None when ok): names the drifting parameter."""
        for label, after in self.per_variant:
            if after > self.expected:
                return label
        return None


def sweep(call, variants, expected: int, *, counter=None) -> SweepReport:
    """Run ``call(variant)`` for every ``(label, variant)`` pair and read
    ``counter`` (a :class:`SignatureCounter` or any object with a
    ``.count`` or ``.compiles`` int attribute, e.g. a ``PipelineCache``)
    after each. ``expected`` is the number of DISTINCT keys in the sweep;
    a larger count means some variant drifted off an existing key."""
    def _read() -> int:
        for attr in ("count", "compiles"):
            v = getattr(counter, attr, None)
            if isinstance(v, int):
                return v
        raise TypeError("counter must expose .count or .compiles")

    base = _read()
    per_variant = []
    for label, variant in variants:
        call(variant)
        per_variant.append((str(label), _read() - base))
    return SweepReport(traces=_read() - base, expected=expected,
                       per_variant=tuple(per_variant))


def diagnose_drift(report: SweepReport) -> str:
    """Human-readable verdict for a failed sweep: what a contract
    violation message carries."""
    if report.ok:
        return (f"ok: {report.traces} signature(s) for "
                f"{report.expected} key(s)")
    return (f"{report.traces} signatures for {report.expected} distinct "
            f"key(s) (+{report.extra} unexpected); first offender: "
            f"{report.first_offender()!r}. Usual causes: dtype drift (an "
            "int64 tensor where int32 belongs, a python scalar where a "
            "0-d tensor belongs), a None member that became a tensor, or a "
            "structure that changed between calls.")
