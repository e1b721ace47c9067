"""The ONE dispatch site for EmbeddingBag (the weighted sum of each bag's
table rows: DIEN's history sum, ``models/recsys.dien_apply``). A CPU tensor
takes the plain version (ref.py); a CUDA tensor launches the hand-written
kernel (embedding_bag.cu) or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import (LAUNCHES, billing, card_scope,
                                 card_stream, check_launch, holds_no_data,
                                 on_card)
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PLAN_KEYS = ("vec_bytes", "vec_elems", "cols", "group", "slots",
              "col_chunks")


def bag_plan(D: int, dtype: torch.dtype) -> dict[str, int]:
    """The kernel's lanes at row width D for a fp32 or bf16 table whose
    pointer (and the output's) is 16-byte aligned: a row is ``cols``
    vectors of ``vec_bytes`` (the widest of 16, 8, 4 and, for bf16, 2 bytes
    that divides the row's bytes), a group of ``group`` = min(cols, 32)
    lanes takes one slot, a warp ``slots`` = 32 // group slots a step, and
    rows past 32 vectors go in ``col_chunks`` chunks of 32. The C side
    narrows the vector where a pointer is aligned to less."""
    es = 4 if dtype == torch.float32 else 2
    vb = 16
    while vb > es and (D * es) % vb:
        vb //= 2
    cols = D // (vb // es)
    group = min(cols, 32)
    return dict(zip(_PLAN_KEYS, (vb, vb // es, cols, group, 32 // group,
                                 -(-cols // 32))))


@functools.cache
def _lib():
    """The kernel's C entry, built and loaded at first use."""
    from repro_torch.kernels import _build
    lib = _build.load("embedding_bag")
    lib.embedding_bag_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.embedding_bag_launch.restype = ctypes.c_int
    return lib


def plan_export(D: int, dtype: torch.dtype) -> dict[str, int]:
    """The C side's own plan (embedding_bag_plan, on the card), keyed as
    :func:`bag_plan`."""
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    fn = _lib().embedding_bag_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    check_launch("embedding_bag_plan",
                 fn(D, _DTYPES[dtype], ctypes.addressof(out)))
    return dict(zip(_PLAN_KEYS, out))


def kernel_attrs() -> dict[str, int]:
    """The most registers and local (spill) bytes a thread of any of the
    kernel's instantiations takes (embedding_bag_attrs, on the card)."""
    out = (ctypes.c_longlong * 2)()
    fn = _lib().embedding_bag_attrs
    fn.argtypes = [ctypes.c_void_p]
    check_launch("embedding_bag_attrs", fn(ctypes.addressof(out)))
    return dict(zip(("registers", "spill_bytes"), out))


def cost(N: int, P: int, V: int, D: int, *, itemsize: int = 4,
         rows: int | None = None) -> dict:
    """The work of one launch: a multiply and an add an element of each
    looked-up row (2·N·P·D operations); the ids and weights read once,
    each distinct table row it touches once (``rows``, which the data
    decides: by default every slot a distinct row, as many as the table
    has), the [N, D] output written once."""
    rows = min(N * P, V) if rows is None else rows
    row = D * itemsize
    return {"flops": 2 * N * P * D, "bytes": N * P * 8 + rows * row + N * row}


def embedding_bag(ids, weights, table):
    """Launch the CUDA kernel: ids [N, P] int32 (a negative id is a pad),
    weights [N, P] float32, table [V, D] float32 or bfloat16, all on the
    card, any strides (copied to contiguous) -> [N, D] in the table's dtype,
    accumulated in fp32. An id >= V adds nothing (the plain version raises
    on it). Raises under a gradient (grad mode on and the weights or the
    table requiring grad): the kernel has no backward."""
    if not on_card(ids, weights, table):
        raise ValueError("embedding_bag launches on CUDA tensors only")
    if ids.ndim != 2 or ids.dtype != torch.int32:
        raise ValueError(f"embedding_bag: ids must be [N, P] int32, got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    if weights.dtype != torch.float32 or weights.shape != ids.shape:
        raise ValueError(f"embedding_bag: weights must be float32 "
                         f"{tuple(ids.shape)}, got {weights.dtype} "
                         f"{tuple(weights.shape)}")
    if table.ndim != 2 or table.dtype not in _DTYPES:
        raise ValueError(f"embedding_bag: table must be [V, D] float32 or "
                         f"bfloat16, got {table.dtype} "
                         f"{tuple(table.shape)}")
    if torch.is_grad_enabled() and (weights.requires_grad
                                    or table.requires_grad):
        raise ValueError("embedding_bag has no backward kernel: call it "
                         "under torch.no_grad() or torch.inference_mode() "
                         "(its output would carry no gradient to the table)")
    N, P = ids.shape
    V, D = table.shape
    if P >= 2 ** 31 or D >= 2 ** 31:
        raise ValueError(f"embedding_bag: P {P} and D {D} must fit int32")
    with billing("embedding_bag", lambda: cost(
            N, P, V, D, itemsize=table.element_size())):
        return _launch(ids, weights, table, N, P, V, D)


def _launch(ids, weights, table, N, P, V, D):
    """Allocate the output and launch; tensors without data stop before
    the launch (the fake path)."""
    dev = table.device
    out = torch.empty((N, D), dtype=table.dtype, device=dev)
    if out.numel() == 0:
        return out
    ids, weights, table = (ids.contiguous(), weights.contiguous(),
                           table.contiguous())
    if holds_no_data(ids, weights, table):
        return out
    stream = card_stream(dev)
    with card_scope(dev):
        err = _lib().embedding_bag_launch(
            ids.data_ptr(), weights.data_ptr(), table.data_ptr(), N, P, V,
            D, _DTYPES[table.dtype], out.data_ptr(), stream)
    check_launch("embedding_bag", err)
    LAUNCHES["embedding_bag"] += 1
    return out


def bag_lookup_reduce(ids, weights, table):
    """ids [N, P] (pad -1), weights [N, P], table [V, D] -> [N, D]: the
    kernel on the card, the plain version on the CPU (the reference's
    wrapper; its ``tb`` tile has no meaning here). See
    :func:`embedding_bag`."""
    if not on_card(ids, weights, table):
        with billing("embedding_bag", lambda: cost(
                *ids.shape, *table.shape, itemsize=table.element_size())):
            return embedding_bag_ref(ids, weights, table)
    return embedding_bag(ids, weights, table)
