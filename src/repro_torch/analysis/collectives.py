"""Collective record: what crosses ranks during a call, by kind and bytes.
Port of the collective profile of ``repro/analysis/hlo.py``.

The reference reads the compiled program's collective ops. Here the op
recorder (``analysis/trace.py``) sees every ``torch.distributed``
collective as a ``c10d`` op, however it was called (``dist.all_gather``,
``all_gather_into_tensor``, a DeviceMesh helper), and every functional
collective a DTensor's redistribution issues (``_c10d_functional``), and
:func:`note` keeps
one :class:`Collective` a call: its kind as the reference names it
(``"all-gather"``, ``"all-reduce"``, ...), the ``torch.distributed``
function it stands for, and the bytes of its result tensors on this rank
(a gather's whole output, a reduce's tensor), as the reference counts the
result bytes of each collective.

:class:`CollectiveRecorder` records one block of code alone:
``with CollectiveRecorder() as rec: ...; rec.calls`` ->
``[("all_gather", bytes), ("all_reduce", bytes)]``.
"""
from __future__ import annotations

import dataclasses

import torch

#: c10d op -> (the reference's kind, the torch.distributed function)
_KINDS = {
    "allgather_": ("all-gather", "all_gather"),
    "_allgather_base_": ("all-gather", "all_gather_into_tensor"),
    "allgather_coalesced_": ("all-gather", "all_gather_coalesced"),
    "allgather_into_tensor_coalesced_": ("all-gather",
                                         "all_gather_into_tensor"),
    "allreduce_": ("all-reduce", "all_reduce"),
    "allreduce_coalesced_": ("all-reduce", "all_reduce_coalesced"),
    "reduce_scatter_": ("reduce-scatter", "reduce_scatter"),
    "_reduce_scatter_base_": ("reduce-scatter", "reduce_scatter_tensor"),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter",
                                         "reduce_scatter_tensor"),
    "alltoall_": ("all-to-all", "all_to_all"),
    "alltoall_base_": ("all-to-all", "all_to_all_single"),
    "send": ("collective-permute", "send"),
    "recv_": ("collective-permute", "recv"),
    "recv_any_source_": ("collective-permute", "recv"),
    "broadcast_": ("broadcast", "broadcast"),
    "reduce_": ("reduce", "reduce"),
    "gather_": ("gather", "gather"),
    "scatter_": ("scatter", "scatter"),
    "barrier": ("barrier", "barrier"),
    # the functional collectives (DTensor's redistributions)
    "all_reduce": ("all-reduce", "all_reduce"),
    "all_reduce_coalesced": ("all-reduce", "all_reduce_coalesced"),
    "all_gather_into_tensor": ("all-gather", "all_gather_into_tensor"),
    "all_gather_into_tensor_coalesced": ("all-gather",
                                         "all_gather_into_tensor"),
    "reduce_scatter_tensor": ("reduce-scatter", "reduce_scatter_tensor"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter",
                                        "reduce_scatter_tensor"),
    "all_to_all_single": ("all-to-all", "all_to_all_single"),
    "broadcast": ("broadcast", "broadcast"),
}

#: the functional collectives' namespaces
_FUNCTIONAL = ("_c10d_functional", "c10d_functional")


def is_collective(namespace: str, op_name: str) -> bool:
    """Whether an op (its namespace and name, ``"c10d.allreduce_.default"``)
    is a collective: a ``c10d`` op, or a functional collective (not its
    ``wait_tensor`` or tensor wrappers)."""
    if namespace == "c10d":
        return True
    return namespace in _FUNCTIONAL and op_name.split(".")[1] in _KINDS


@dataclasses.dataclass(frozen=True)
class Collective:
    kind: str        # the reference's name: "all-gather", "all-reduce", ...
    api: str         # the torch.distributed function: "all_gather", ...
    bytes: int       # result bytes on this rank


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


def note(record: list, op_name: str, out) -> None:
    """Append the Collective of one c10d op (``"c10d.allgather_.default"``)
    whose result is ``out`` to ``record``."""
    base = op_name.split(".")[1] if "." in op_name else op_name
    kind, api = _KINDS.get(base, (base, base))
    record.append(Collective(kind, api, _tensor_bytes(out)))


def profile(record) -> dict:
    """{kind: bytes} summed over a record: the reference's per-kind
    collective profile."""
    out: dict = {}
    for c in record:
        out[c.kind] = out.get(c.kind, 0) + c.bytes
    return out


class CollectiveRecorder:
    """The collectives of a ``with`` block: ``.record`` (Collective
    entries) and ``.calls`` ((torch.distributed function, bytes) pairs, in
    call order)."""

    def __init__(self):
        from repro_torch.analysis.trace import CallTrace
        self._trace = CallTrace()
        self._mode = None

    @property
    def record(self) -> list:
        return list(self._trace.collectives)

    @property
    def calls(self) -> list:
        return [(c.api, c.bytes) for c in self._trace.collectives]

    def __enter__(self):
        from repro_torch.analysis.trace import _OpRecorder
        self._mode = _OpRecorder(self._trace)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)
