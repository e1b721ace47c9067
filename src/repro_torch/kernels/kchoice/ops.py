"""The ONE dispatch site for the exact power-of-K re-assignment
(core/repartition.kchoice_exact and repartition_topk). A CPU tensor takes
the plain version (ref.py); a CUDA tensor launches the hand-written kernel
(kchoice.cu) or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, check_launch, on_card
from repro_torch.kernels.kchoice.ref import kchoice_ref

#: dynamic shared memory one block may use on the H100 (sm_90)
SMEM_BYTES = 227 * 1024


def smem_bytes(B: int, K: int) -> int:
    """The kernel's shared memory: the [B] loads and two staged chunks of
    256 labels' K candidates and ids (kchoice.cu)."""
    return (B + 2 * 256 * (K + 1)) * 4


@functools.cache
def _launcher():
    """The kernel's C entry, built and loaded at first use."""
    from repro_torch.kernels import _build
    fn = _build.load("kchoice").kchoice_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kchoice(topk_idx, order, load0=None, weights=None, *, B: int):
    """Launch the CUDA kernel: topk_idx [G, L, K] int32 bucket ids < B,
    order [G, L] int32 (a permutation per rep), load0 [G, B] or [B] f32 or
    None, weights [L] f32 or None, all on the card -> assign [G, L] int32.
    Raises where the [B] loads and the staged chunks pass one block's
    shared memory (B <= ~55,000 at K = 10)."""
    if not on_card(topk_idx, order, load0, weights):
        raise ValueError("kchoice launches on CUDA tensors only")
    if topk_idx.ndim != 3 or topk_idx.dtype != torch.int32:
        raise ValueError(f"kchoice: topk_idx must be [G, L, K] int32, got "
                         f"{topk_idx.dtype} {tuple(topk_idx.shape)}")
    G, L, K = topk_idx.shape
    if order.dtype != torch.int32 or tuple(order.shape) != (G, L):
        raise ValueError(f"kchoice: order must be int32 {(G, L)}, got "
                         f"{order.dtype} {tuple(order.shape)}")
    stride = 0
    if load0 is not None:
        if load0.dtype != torch.float32 or load0.shape[-1] != B or not (
                load0.ndim == 1 or tuple(load0.shape) == (G, B)):
            raise ValueError(f"kchoice: load0 must be float32 [B] or "
                             f"{(G, B)}, got {load0.dtype} "
                             f"{tuple(load0.shape)}")
        stride = B if load0.ndim == 2 else 0
        load0 = load0.contiguous()
    if weights is not None and (weights.dtype != torch.float32
                                or tuple(weights.shape) != (L,)):
        raise ValueError(f"kchoice: weights must be float32 [{L}], got "
                         f"{weights.dtype} {tuple(weights.shape)}")
    if smem_bytes(B, K) > SMEM_BYTES:
        raise ValueError(f"kchoice: B={B}, K={K} need {smem_bytes(B, K)} B "
                         f"of shared memory, over the {SMEM_BYTES} B one "
                         f"block may use")
    if G > 2 ** 31 - 1:
        raise ValueError(f"kchoice: {G} reps exceed the grid")
    dev = topk_idx.device
    out = torch.empty((G, L), dtype=torch.int32, device=dev)
    if L == 0 or G == 0:
        return out
    topk_idx, order = topk_idx.contiguous(), order.contiguous()
    if weights is not None:
        weights = weights.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _launcher()(
            topk_idx.data_ptr(), order.data_ptr(),
            None if load0 is None else load0.data_ptr(), stride,
            None if weights is None else weights.data_ptr(), G, L, K, B,
            out.data_ptr(), stream)
    check_launch("kchoice", err)
    LAUNCHES["kchoice"] += 1
    return out


def kchoice_assign(topk_idx, order, load0=None, weights=None, *, B: int):
    """Sequential least-loaded-of-top-K insertion for G reps at once:
    topk_idx [G, L, K], order [G, L] -> assign [G, L] int32. The kernel on
    the card, the plain version on the CPU."""
    if not on_card(topk_idx, order, load0, weights):
        return kchoice_ref(topk_idx, order, load0, weights, B=B)
    return kchoice(topk_idx.to(torch.int32), order.to(torch.int32),
                   None if load0 is None else load0.to(torch.float32),
                   None if weights is None else weights.to(torch.float32),
                   B=B)


def step_cycles(device, n: int = 4096) -> tuple[float, float]:
    """The SM clocks of the two dependent operations a step of the walk
    chains, measured on the card over n-long chains: (a shared-memory
    read-add-write whose read waits for the last write, one level of a
    shuffle-and-min reduction). For the kernel's latency bound
    (kchoice.cu); counts no launch."""
    from repro_torch.kernels import _build
    fn = _build.load("kchoice").kchoice_step_cycles
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_double),
                   ctypes.POINTER(ctypes.c_double)]
    fn.restype = ctypes.c_int
    rmw, level = ctypes.c_double(), ctypes.c_double()
    with torch.cuda.device(device):
        check_launch("kchoice_step_cycles", fn(n, ctypes.byref(rmw),
                                               ctypes.byref(level)))
    return rmw.value, level.value
