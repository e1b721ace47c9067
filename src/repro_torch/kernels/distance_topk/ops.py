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

from repro_torch.kernels import (H100_SMS, LAUNCHES, billing, check_launch,
                                 holds_no_data, on_card, tma_operand)
from repro_torch.kernels.distance_topk.ref import distance_topk_ref

#: squared norms are taken this many corpus rows at a time, so an l2 call
#: never holds a [L, d] temporary
NORM_CHUNK = 65_536
#: the kernel's footprint (distance_topk.cu): one block an SM, whose dynamic
#: shared memory holds 1024 bytes of alignment slack, the ring (4 stages of
#: a 128-row x 32-deep fp32 corpus slice, 16 KB each), the query tile
#: transposed ([ceil32(d)][128] fp32) while it fits beside them (d <= 288;
#: past that each stage also holds the query tile's slice, 32 KB a stage),
#: the warps' one-row staging areas (8 x 128 floats), the rows' counts and
#: thresholds (key and value) and, while they fit, the [128, k] (value, id)
#: lists
STAGES, SLICE, STAGE_BYTES = 4, 32, 16_384
SMEM_BYTES = 232_448 - 128                # a block's limit, less its barriers
_FIXED = 8 * 128 * 4 + 3 * 128 * 4
MAX_SPLITS = 1024


@functools.cache
def _lib():
    """The kernel's C entries, built and loaded at first use."""
    from repro_torch.kernels import _build
    lib = _build.load("distance_topk")
    lib.distance_topk_attrs.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_longlong)]
    lib.distance_topk_attrs.restype = ctypes.c_int
    lib.distance_topk_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_void_p,
                                 ctypes.c_longlong] + [ctypes.c_void_p] * 2
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


def _qtile_bytes(d: int) -> int:
    return -(-d // SLICE) * SLICE * 128 * 4


def query_resident(d: int) -> bool:
    """Whether the kernel keeps its transposed query tile in shared memory
    for its whole walk (d <= 288); else each ring stage also brings the
    tile's slice, from the queries' transpose."""
    return 1024 + STAGES * STAGE_BYTES + _qtile_bytes(d) + _FIXED \
        <= SMEM_BYTES


def _base_bytes(d: int) -> int:
    if query_resident(d):
        return 1024 + STAGES * STAGE_BYTES + _qtile_bytes(d) + _FIXED
    return 1024 + STAGES * 2 * STAGE_BYTES + _FIXED


def lists_in_smem(d: int, k: int) -> bool:
    """Whether the kernel keeps its [128, k] lists in shared memory at
    query width d (k <= 108 at d = 96, k <= 92 past d = 288); else in its
    slice of the partial outputs in device memory."""
    return _base_bytes(d) + 128 * k * 8 <= SMEM_BYTES


def smem_bytes(d: int, k: int) -> int:
    """The kernel's dynamic shared memory a block (distance_topk.cu
    smem_bytes)."""
    return _base_bytes(d) + (128 * k * 8 if lists_in_smem(d, k) else 0)


def blocks_per_sm(d: int, k: int) -> int:
    """Blocks of the kernel one SM holds at (d, k): one (its registers, up
    to 255 a thread, allow one; its shared memory fits one block at any
    d and k)."""
    return int(smem_bytes(d, k) <= SMEM_BYTES)


def split_count(Q: int, L: int, k: int, sms: int, per_sm: int) -> int:
    """The number of L splits: one wave of blocks (query tiles x splits <=
    SMs x blocks an SM: a block past the wave would double the time), at
    most one split a 128-column tile and MAX_SPLITS, and no empty split."""
    q_tiles, tiles = -(-Q // 128), -(-L // 128)
    s = sms * max(per_sm, 1) // q_tiles
    s = max(1, min(s, tiles, MAX_SPLITS))
    tps = -(-tiles // s)
    return -(-tiles // tps)


def splits(Q: int, L: int, k: int, device, d: int = 96) -> int:
    """The kernel's number of L splits at (Q, L, k) and query width d on
    this card (one wave of blocks)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return split_count(Q, L, k, sms, blocks_per_sm(d, k))


def kernel_attrs(d: int = 96, k: int = 10) -> dict[str, int]:
    """The C side's own account at (d, k) (distance_topk_attrs, on the
    card): dynamic shared memory, lists in shared memory (0/1), blocks an
    SM by the occupancy query, ring stages, slice depth, the query tile
    resident (0/1), then registers and local (spill) bytes a thread of the
    dot and of the l2 kernel, with the query tile resident and (stream_)
    streamed."""
    out = (ctypes.c_longlong * 14)()
    check_launch("distance_topk_attrs",
                 _lib().distance_topk_attrs(d, k, out))
    keys = ("smem_bytes", "lists_in_smem", "blocks_per_sm", "stages",
            "slice_depth", "query_resident", "registers", "spill_bytes",
            "l2_registers", "l2_spill_bytes", "stream_registers",
            "stream_spill_bytes", "stream_l2_registers",
            "stream_l2_spill_bytes")
    return dict(zip(keys, out))


def cost(Q: int, L: int, d: int, k: int, *, mask_rows: int = 1,
         l2: bool = False) -> dict:
    """The work of one launch: the similarities' 2·Q·L·d operations; the
    base rows and the queries read once, ``mask_rows`` rows of the [L]
    uint8 mask (1: one row shared by every query; Q: a row each), the k
    values and ids written once, and with l2 the norms of both sides."""
    return {"flops": 2 * Q * L * d,
            "bytes": (L + Q) * d * 4 + mask_rows * L + Q * k * 8
            + ((L + Q) * 4 if l2 else 0)}


def _mask_rows(mask, Q: int) -> int:
    m = torch.as_tensor(mask)
    return 1 if m.ndim == 1 or m.shape[0] == 1 or m.stride(0) == 0 else Q


def distance_topk(queries, base, mask, *, k: int, metric: str = "dot"):
    """Launch the CUDA kernel: queries [Q, d], base [L, d] float32, mask
    broadcastable to [Q, L] (bool or numeric, entries > 0 keep), all on the
    card -> (vals [Q, k] f32, ids [Q, k] int32), jax.lax.top_k's order;
    slots past the survivors hold -inf (their ids are not positions). Any
    Q, L, d and 1 <= k <= L; query_resident and lists_in_smem decide where
    the query tile and the lists live. Holds O(Q·k·splits) scratch (and,
    past d = 288, the queries' [d, Q] transpose), never the [Q, L]
    similarities."""
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
    with billing("distance_topk", lambda: cost(
            Q, L, d, k, mask_rows=1 if ld == 0 else Q, l2=metric == "l2")):
        return _launch(queries, base, rows, ld, Q, L, d, k, metric)


def _launch(queries, base, rows, ld, Q, L, d, k, metric):
    """Allocate the outputs, the splits' partial lists (and the norms and
    the queries' transpose where the walk takes them) and launch; tensors
    without data stop before the launch (the fake path, which plans the
    splits for an H100's SMs)."""
    dev = queries.device
    vals = torch.empty((Q, k), dtype=torch.float32, device=dev)
    ids = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return vals, ids
    queries = queries.contiguous()
    qt = None if query_resident(d) else tma_operand(queries.T[None])[0]
    base = tma_operand(base[None])[0]
    l2 = metric == "l2"
    qn = squared_norms(queries) if l2 else None
    bn = squared_norms(base) if l2 else None
    fake = holds_no_data(queries, base, rows)
    s = (split_count(Q, L, k, H100_SMS, blocks_per_sm(d, k)) if fake
         else splits(Q, L, k, dev, d))
    part_v = torch.empty((s, Q, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((s, Q, k), dtype=torch.int32, device=dev)
    if fake:
        return vals, ids
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().distance_topk_launch(
            queries.data_ptr(), None if qt is None else qt.data_ptr(),
            0 if qt is None else qt.stride(0), base.data_ptr(),
            base.stride(0),
            rows.data_ptr(), ld,
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
        with billing("distance_topk", lambda: cost(
                queries.shape[0], base.shape[0], base.shape[1], k,
                mask_rows=_mask_rows(mask, queries.shape[0]),
                l2=metric == "l2")):
            vals, ids = distance_topk_ref(queries, base, mask, k=k,
                                          metric=metric)
    else:
        vals, ids = distance_topk(queries, base, mask, k=k, metric=metric)
    return vals, torch.where(torch.isfinite(vals), ids,
                             torch.full_like(ids, -1))


# ------------------------------------------------------- static contracts --
from repro_torch.analysis import contracts as _C  # noqa: E402


def _dist_fixture():
    from repro_torch.analysis import fixtures as _FX
    return _FX.distance_topk_fixture()


def _dist_naive_control():
    from repro_torch.analysis import fixtures as _FX
    return _FX.distance_topk_fixture(naive=True)


_C.register(_C.Contract(
    id="kernels.distance_topk.no_pairwise_broadcast",
    site="repro_torch.kernels.distance_topk.ops.rerank_topk",
    description="the masked rerank scores via pairwise_sim's expansion "
                "form — no [Q, L, D] difference tensor (the naive "
                "broadcast-l2 control materializes one); the [Q, L] "
                "similarity table itself is this op's contract and must "
                "be sighted (held on chip by distance_topk on the card)",
    fixture=_dist_fixture,
    checks=[
        _C.forbid_dims("Q", "L", "D"),
        _C.require_dims("Q", "L", on_chip="distance_topk"),
    ],
    control=_dist_naive_control,
))
