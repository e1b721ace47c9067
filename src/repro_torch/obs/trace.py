"""Span/trace — wall-clock attribution with explicit device fencing.
Port of ``repro/obs/trace.py``.

CUDA launches return before the card finishes: ``t1 - t0`` around a launch
measures the enqueue. A :class:`Span` therefore exposes ``fence(x)``, which
waits for the card (``torch.cuda.synchronize``) when any tensor in ``x``
lies on it, so the recorded duration covers the device work that produced
the stage's output:

    with trace(registry, "stream_compaction_seconds") as sp:
        new = sp.fence(rebuild())

Durations come from ``time.perf_counter`` and land in the registry
histogram named by ``name`` with the given labels (default bounds:
``LATENCY_BUCKETS``). A span records on exit even when the body raises.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.obs.registry import LATENCY_BUCKETS, MetricRegistry

__all__ = ["Span", "trace", "fence"]


def _cuda_devices(x, out: set) -> set:
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _cuda_devices(getattr(x, f.name), out)
    return out


def fence(x):
    """Wait until the card has computed every tensor in ``x`` (tensors,
    dicts, lists, tuples and dataclasses of them); returns ``x``. Tensors on
    the CPU need no wait."""
    for dev in _cuda_devices(x, set()):
        torch.cuda.synchronize(dev)
    return x


class Span:
    """Context manager timing one stage into a registry histogram.

    Attributes after exit: ``seconds`` (the recorded duration). Reentrant
    use is not supported — make a new Span per stage.
    """

    def __init__(self, registry: MetricRegistry, name: str,
                 labels: dict | None = None, bounds=LATENCY_BUCKETS):
        self._hist = registry.histogram(name, labels, bounds)
        self.name = name
        self.labels = dict(labels or {})
        self.seconds: float | None = None
        self._t0: float | None = None

    def fence(self, x):
        """:func:`fence` on this stage's output; returns it."""
        return fence(x)

    def __enter__(self) -> "Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.seconds = time.perf_counter() - self._t0
        self._hist.observe(self.seconds)
        return False


def trace(registry: MetricRegistry, name: str, *, bounds=LATENCY_BUCKETS,
          **labels) -> Span:
    """Sugar: ``with trace(reg, "serve_stage_seconds", stage="gather") as
    sp`` — labels are keyword arguments."""
    return Span(registry, name, labels or None, bounds)
