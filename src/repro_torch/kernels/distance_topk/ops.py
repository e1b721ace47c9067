"""The ONE dispatch site for the masked distance + top-k rerank (dense
mode's rerank, ``core/query.rerank`` and the ``exact_topk`` oracle). A CPU
tensor takes the plain version (ref.py); a CUDA tensor launches the
hand-written kernel (distance_topk.cu) or raises.

Both return raw top-k positions; :func:`rerank_topk` pins the serving
contract on top, as the reference's wrapper does: a slot whose score is not
finite had no surviving candidate, and its id is -1.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, check_launch, on_card
from repro_torch.kernels.distance_topk.ref import distance_topk_ref

#: squared norms are taken this many corpus rows at a time, so an l2 call
#: never holds a [L, d] temporary
NORM_CHUNK = 65_536


@functools.cache
def _lib():
    """The kernel's C entries, built and loaded at first use."""
    from repro_torch.kernels import _build
    lib = _build.load("distance_topk")
    lib.distance_topk_splits.argtypes = [ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_int)]
    lib.distance_topk_splits.restype = ctypes.c_int
    lib.distance_topk_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5)
    lib.distance_topk_launch.restype = ctypes.c_int
    return lib


def mask_rows(mask, Q: int, L: int):
    """A mask broadcastable to [Q, L] -> (rows uint8 [1 or Q, L]
    contiguous, row stride 0 or L). One row shared by every query (a [L] or
    [1, L] mask, or a stride-0 expanded view such as ``~tombstone[None, :]
    .expand(Q, L)``) stays one row: no [Q, L] mask is materialised."""
    mask = torch.as_tensor(mask)
    if mask.ndim == 1:
        mask = mask[None]
    if mask.ndim != 2 or mask.shape[-1] != L or mask.shape[0] not in (1, Q):
        raise ValueError(f"distance_topk: mask of shape {tuple(mask.shape)} "
                         f"does not broadcast to [{Q}, {L}]")
    shared = mask.shape[0] == 1 or mask.stride(0) == 0
    rows = mask[:1] if shared else mask
    if rows.dtype != torch.bool:
        rows = rows > 0
    return rows.contiguous().view(torch.uint8), 0 if shared else L


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    """Σ x² per row, as ``core/query.pairwise_sim`` takes it, a chunk of
    rows at a time."""
    return torch.cat([(x[s:s + NORM_CHUNK] ** 2).sum(1)
                      for s in range(0, x.shape[0], NORM_CHUNK)])


def splits(Q: int, L: int, k: int, device) -> int:
    """The kernel's number of L splits at (Q, L, k): one wave of blocks on
    the card (distance_topk.cu, distance_topk_splits)."""
    out = ctypes.c_int()
    with torch.cuda.device(device):
        check_launch("distance_topk_splits",
                     _lib().distance_topk_splits(Q, L, k, ctypes.byref(out)))
    return out.value


def distance_topk(queries, base, mask, *, k: int, metric: str = "dot"):
    """Launch the CUDA kernel: queries [Q, d], base [L, d] float32, mask
    broadcastable to [Q, L] (bool or numeric, entries > 0 keep), all on the
    card -> (vals [Q, k] f32, ids [Q, k] int32), jax.lax.top_k's order;
    slots past the survivors hold -inf (their ids are not positions). Any
    Q, L and 1 <= k <= L; k > 31 keeps its lists in device memory.
    Holds O(Q·k·splits) scratch, never the [Q, L] similarities."""
    if not on_card(queries, base, torch.as_tensor(mask)):
        raise ValueError("distance_topk launches on CUDA tensors only")
    if queries.ndim != 2 or base.ndim != 2 \
            or queries.shape[1] != base.shape[1]:
        raise ValueError(f"distance_topk: queries [Q, d] and base [L, d], "
                         f"got {tuple(queries.shape)}, {tuple(base.shape)}")
    if queries.dtype != torch.float32 or base.dtype != torch.float32:
        raise ValueError(f"distance_topk: float32 queries and base, got "
                         f"{queries.dtype}, {base.dtype}")
    if metric not in ("dot", "l2"):
        raise ValueError(f"distance_topk: metric must be 'dot' or 'l2', got "
                         f"{metric!r}")
    (Q, d), L = queries.shape, base.shape[0]
    if not 1 <= k <= L:
        raise ValueError(f"distance_topk: k={k} must lie in [1, L={L}]")
    if L >= 2 ** 31 - 1 or -(-Q // 128) > 65535:
        raise ValueError(f"distance_topk: Q={Q}, L={L} exceed the grid")
    rows, ld = mask_rows(mask, Q, L)
    dev = queries.device
    vals = torch.empty((Q, k), dtype=torch.float32, device=dev)
    ids = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return vals, ids
    queries, base = queries.contiguous(), base.contiguous()
    l2 = metric == "l2"
    qn = squared_norms(queries) if l2 else None
    bn = squared_norms(base) if l2 else None
    s = splits(Q, L, k, dev)
    part_v = torch.empty((s, Q, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((s, Q, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().distance_topk_launch(
            queries.data_ptr(), base.data_ptr(), rows.data_ptr(), ld,
            None if qn is None else qn.data_ptr(),
            None if bn is None else bn.data_ptr(), Q, L, d, k, int(l2), s,
            part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(),
            ids.data_ptr(), stream)
    check_launch("distance_topk", err)
    LAUNCHES["distance_topk"] += 1
    return vals, ids


def rerank_topk(queries, base, mask, *, k: int, metric: str = "dot"):
    """Masked true-distance top-k: queries [Q, d], base [L, d], mask
    broadcastable to [Q, L] -> (scores [Q, k] f32, ids [Q, k] int32, -1
    where the score is not finite). The kernel on the card (no [Q, L]
    table), the plain version on the CPU."""
    mask = torch.as_tensor(mask)
    if not on_card(queries, base, mask):
        vals, ids = distance_topk_ref(queries, base, mask, k=k,
                                      metric=metric)
    else:
        vals, ids = distance_topk(queries, base, mask, k=k, metric=metric)
    return vals, torch.where(torch.isfinite(vals), ids,
                             torch.full_like(ids, -1))
