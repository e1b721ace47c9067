"""The ONE dispatch site for EmbeddingBag (the weighted sum of each bag's
table rows: DIEN's history sum, ``models/recsys.dien_apply``). A CPU tensor
takes the plain version (ref.py); a CUDA tensor launches the hand-written
kernel (embedding_bag.cu) or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, check_launch, on_card
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def embedding_bag(ids, weights, table):
    """Launch the CUDA kernel: ids [N, P] int32 (a negative id is a pad),
    weights [N, P] float32, table [V, D] float32 or bfloat16, all on the
    card, any strides (copied to contiguous) -> [N, D] in the table's dtype,
    accumulated in fp32. An id >= V adds nothing (the plain version raises
    on it)."""
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
    N, P = ids.shape
    V, D = table.shape
    if P >= 2 ** 31 or D >= 2 ** 31:
        raise ValueError(f"embedding_bag: P {P} and D {D} must fit int32")
    dev = table.device
    out = torch.empty((N, D), dtype=table.dtype, device=dev)
    if out.numel() == 0:
        return out
    ids, weights, table = (ids.contiguous(), weights.contiguous(),
                           table.contiguous())
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
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
        return embedding_bag_ref(ids, weights, table)
    return embedding_bag(ids, weights, table)
