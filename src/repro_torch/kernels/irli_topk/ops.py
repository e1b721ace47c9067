"""The ONE dispatch site for the fused scorer GEMM + top-m (the query
path's top_m stage, core/query._stage_topm). A CPU tensor takes the
plain version (ref.py); a CUDA tensor launches the hand-written kernel
(irli_topk.cu) or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import (H100_SMS, LAUNCHES, billing, check_launch,
                                 holds_no_data, on_card, tma_operand)
from repro_torch.kernels.irli_topk.ref import irli_topk_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: widest top-m the kernel's per-thread lists hold (irli_topk.cuh kMaxM);
#: a wider m runs the kernel's radix-select variant
MAX_M = 64
#: the tile routine (irli_topk.cuh): ring stages, bytes a stage, slice
#: depth by dtype (one 128-byte row of h a slice)
STAGES = 3
STAGE_BYTES = 32_768
SLICE_DEPTH = {torch.float32: 32, torch.bfloat16: 64}
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [
    ctypes.c_int] * 8 + [ctypes.c_void_p] * 3


@functools.cache
def _lib():
    """The kernel's C entries, built and loaded at first use."""
    from repro_torch.kernels import _build
    lib = _build.load("irli_topk")
    lib.irli_topk_launch.argtypes = _ARGS + [ctypes.c_void_p]
    lib.irli_topk_launch.restype = ctypes.c_int
    lib.irli_topk_wide_launch.argtypes = _ARGS + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.irli_topk_wide_launch.restype = ctypes.c_int
    lib.irli_topk_attrs.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_longlong)]
    lib.irli_topk_attrs.restype = ctypes.c_int
    return lib


def tile_smem_bytes(m: int) -> int:
    """Shared memory of one tile worker running the scorer tile at m
    (irli_topk.cuh topk_tile_smem_bytes, a multiple of 1024): the ring
    (STAGES x STAGE_BYTES; each column tile's [128, 129] logits reuse it),
    two [128] log-sum-exp halves and 256 half-row lists of m (value,
    column) pairs. The one Python owner of this footprint: mega_query's
    model adds two of them."""
    return STAGES * STAGE_BYTES + 2 * 128 * 4 + 256 * m * 8


def smem_bytes(m: int) -> int:
    """The kernel's dynamic shared memory a block at m <= MAX_M: one tile
    worker plus 1024 bytes to align the swizzled slices."""
    return 1024 + tile_smem_bytes(m)


def kernel_attrs(dtype=torch.float32, m: int = 5) -> dict[str, int]:
    """The C side's own account (irli_topk_attrs, on the card): ring
    stages, slice depth, bytes a stage; registers a thread, local (spill)
    bytes a thread and dynamic shared memory of the m <= 64 kernel at m and
    of the m > 64 variant."""
    out = (ctypes.c_longlong * 9)()
    check_launch("irli_topk_attrs",
                 _lib().irli_topk_attrs(_DTYPES[dtype], m, out))
    keys = ("stages", "slice_depth", "stage_bytes", "registers",
            "spill_bytes", "smem_bytes", "wide_registers",
            "wide_spill_bytes", "wide_smem_bytes")
    return dict(zip(keys, out))


def wide_grid(G: int, Q: int, dev) -> int:
    """Blocks of the m > MAX_M variant: one a (rep, 128-query) tile, at
    most one an SM (an H100's when ``dev`` is None); each holds a [128, B]
    fp32 slab of scratch."""
    sms = (H100_SMS if dev is None
           else torch.cuda.get_device_properties(dev).multi_processor_count)
    return max(1, min(G * -(-Q // 128), sms))


def cost(G: int, Q: int, H: int, B: int, m: int, *, itemsize: int = 4,
         lse: bool = False) -> dict:
    """The work of one launch: the output GEMM's 2·G·Q·H·B operations;
    h [G, Q, H], w2 [G, H, B] and b2 [G, B] read once, the top-m values
    and ids (and the log-sum-exp) written once."""
    return {"flops": 2 * G * Q * H * B,
            "bytes": (G * Q * H + G * H * B + G * B) * itemsize
            + G * Q * m * 8 + (G * Q * 4 if lse else 0)}


def _cost_of(h, w2, m: int, lse: bool) -> dict:
    G = h.shape[0] if h.ndim == 3 else 1
    return cost(G, h.shape[-2], h.shape[-1], w2.shape[-1], m,
                itemsize=h.element_size(), lse=lse)


def irli_topk(h, w2, b2, *, m: int, lse: bool = False):
    """Launch the CUDA kernel. h [Q, H] or [G, Q, H], w2 [H, B] or
    [G, H, B], b2 [B] or [G, B], one dtype (float32 or bfloat16), on the
    card -> (vals [.., Q, m] f32, idx [.., Q, m] int32) and, with ``lse``,
    lse [.., Q] f32. Any 1 <= m <= B: m <= MAX_M keeps sorted lists in
    shared memory; a wider m runs the radix-select variant, which holds one
    [128, B] slab of logits a block (``wide_grid`` blocks), never the
    [.., Q, B] logits."""
    if not on_card(h, w2, b2):
        raise ValueError("irli_topk launches on CUDA tensors only")
    single = h.ndim == 2
    if single:
        h, w2, b2 = h[None], w2[None], b2[None]
    if h.ndim != 3 or w2.ndim != 3 or b2.ndim != 2:
        raise ValueError(f"irli_topk: h [G, Q, H], w2 [G, H, B], b2 [G, B] "
                         f"(or without G), got {tuple(h.shape)}, "
                         f"{tuple(w2.shape)}, {tuple(b2.shape)}")
    G, Q, H = h.shape
    B = w2.shape[2]
    if tuple(w2.shape) != (G, H, B) or tuple(b2.shape) != (G, B):
        raise ValueError(f"irli_topk: shapes disagree: h {tuple(h.shape)}, "
                         f"w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)}")
    if h.dtype not in _DTYPES or w2.dtype != h.dtype or b2.dtype != h.dtype:
        raise ValueError(f"irli_topk: h, w2 and b2 must share one dtype of "
                         f"{list(_DTYPES)}, got {h.dtype}, {w2.dtype}, "
                         f"{b2.dtype}")
    if not 1 <= m <= B:
        raise ValueError(f"irli_topk: m={m} must lie in [1, B={B}]")
    if G > 65535:
        raise ValueError(f"irli_topk: {G} reps exceed the grid's 65535")
    with billing("irli_topk", lambda: cost(G, Q, H, B, m,
                                           itemsize=h.element_size(),
                                           lse=lse)):
        vals, idx, out_lse = _launch(h, w2, b2, G, Q, H, B, m, lse)
    out = (vals, idx) + ((out_lse,) if lse else ())
    return tuple(t[0] for t in out) if single else out


def _launch(h, w2, b2, G, Q, H, B, m, lse):
    """Allocate the outputs (and the m > MAX_M variant's scratch) and
    launch; tensors without data stop before the launch (the fake
    path)."""
    dev = h.device
    vals = torch.empty((G, Q, m), dtype=torch.float32, device=dev)
    idx = torch.empty((G, Q, m), dtype=torch.int32, device=dev)
    out_lse = (torch.empty((G, Q), dtype=torch.float32, device=dev)
               if lse else None)
    if Q == 0:
        return vals, idx, out_lse
    h, w2 = tma_operand(h), tma_operand(w2)
    b2 = b2.contiguous()
    fake = holds_no_data(h, w2, b2)
    scratch = None
    if m > MAX_M:
        grid = wide_grid(G, Q, None if fake else dev)
        scratch = torch.empty((grid, 128, B), dtype=torch.float32,
                              device=dev)
    if fake:
        return vals, idx, out_lse
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (h.data_ptr(), w2.data_ptr(), b2.data_ptr(), _DTYPES[h.dtype],
            G, Q, H, B, m, h.stride(1), w2.stride(1), vals.data_ptr(),
            idx.data_ptr(), None if out_lse is None else out_lse.data_ptr())
    with torch.cuda.device(dev):
        if m <= MAX_M:
            err = _lib().irli_topk_launch(*args, stream)
        else:
            err = _lib().irli_topk_wide_launch(
                *args, scratch.data_ptr(), scratch.shape[0], stream)
    check_launch("irli_topk", err)
    LAUNCHES["irli_topk"] += 1
    return vals, idx, out_lse


def scorer_topk(h, w2, b2, *, m: int, lse: bool = False):
    """The scorer's output layer and its top-m: h [.., Q, H], w2
    [.., H, B], b2 [.., B] -> (vals [.., Q, m] f32, bucket ids [.., Q, m]
    int32) and, with ``lse``, the rows' log-sum-exp [.., Q]. The kernel on
    the card never allocates the [.., Q, B] logits; the plain version on the
    CPU does."""
    if not on_card(h, w2, b2):
        with billing("irli_topk", lambda: _cost_of(h, w2, m, lse)):
            return irli_topk_ref(h, w2, b2, m=m, lse=lse)
    return irli_topk(h, w2, b2, m=m, lse=lse)


# ------------------------------------------------------- static contracts --
from repro_torch.analysis import contracts as _C  # noqa: E402


def _irli_fixture():
    from repro_torch.analysis import fixtures as _FX
    return _FX.irli_topk_fixture()


def _irli_naive_control():
    from repro_torch.analysis import fixtures as _FX
    return _FX.irli_topk_fixture(naive=True)


_C.register(_C.Contract(
    id="kernels.irli_topk.no_onehot_select",
    site="repro_torch.kernels.irli_topk.ops.scorer_topk",
    description="fused scoring + top-m selects with a top-k over the "
                "[Q, B] logits (held on chip by irli_topk on the card) — "
                "never a [Q, m, B] one-hot stack (the naive control builds "
                "one)",
    fixture=_irli_fixture,
    checks=[
        _C.forbid_dims("Q", "B", "m"),
        _C.require_dims("Q", "B", on_chip="irli_topk"),
    ],
    control=_irli_naive_control,
))
