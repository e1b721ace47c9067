"""The ONE dispatch site for the fused scorer GEMM + top-m (the query
path's scorer stage, core/query.QueryPipeline.top_m). A CPU tensor takes the
plain version (ref.py); a CUDA tensor launches the hand-written kernel
(irli_topk.cu) or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, check_launch, on_card
from repro_torch.kernels.irli_topk.ref import irli_topk_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: widest top-m the kernel's per-thread lists hold (irli_topk.cuh kMaxM);
#: a wider m runs the kernel's radix-select variant
MAX_M = 64
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


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
    return lib


def wide_grid(G: int, Q: int, dev) -> int:
    """Blocks of the m > MAX_M variant: one a (rep, 128-query) tile, at
    most one an SM; each holds a [128, B] fp32 slab of scratch."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(G * -(-Q // 128), sms))


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
    dev = h.device
    vals = torch.empty((G, Q, m), dtype=torch.float32, device=dev)
    idx = torch.empty((G, Q, m), dtype=torch.int32, device=dev)
    out_lse = (torch.empty((G, Q), dtype=torch.float32, device=dev)
               if lse else None)
    if Q > 0:
        h, w2, b2 = (t.contiguous() for t in (h, w2, b2))
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (h.data_ptr(), w2.data_ptr(), b2.data_ptr(), _DTYPES[h.dtype],
                G, Q, H, B, m, vals.data_ptr(), idx.data_ptr(),
                None if out_lse is None else out_lse.data_ptr())
        with torch.cuda.device(dev):
            if m <= MAX_M:
                err = _lib().irli_topk_launch(*args, stream)
            else:
                grid = wide_grid(G, Q, dev)
                scratch = torch.empty((grid, 128, B), dtype=torch.float32,
                                      device=dev)
                err = _lib().irli_topk_wide_launch(
                    *args, scratch.data_ptr(), grid, stream)
        check_launch("irli_topk", err)
        LAUNCHES["irli_topk"] += 1
    out = (vals, idx) + ((out_lse,) if lse else ())
    return tuple(t[0] for t in out) if single else out


def scorer_topk(h, w2, b2, *, m: int, lse: bool = False):
    """The scorer's output layer and its top-m: h [.., Q, H], w2
    [.., H, B], b2 [.., B] -> (vals [.., Q, m] f32, bucket ids [.., Q, m]
    int32) and, with ``lse``, the rows' log-sum-exp [.., Q]. The kernel on
    the card never allocates the [.., Q, B] logits; the plain version on the
    CPU does."""
    if not on_card(h, w2, b2):
        return irli_topk_ref(h, w2, b2, m=m, lse=lse)
    return irli_topk(h, w2, b2, m=m, lse=lse)
