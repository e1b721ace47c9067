"""The ONE dispatch site for the exact power-of-K re-assignment
(core/repartition.kchoice_exact and repartition_topk). A CPU tensor takes
the plain version (ref.py); a CUDA tensor launches the hand-written kernel
(kchoice.cu) or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import (LAUNCHES, billing, check_launch,
                                 holds_no_data, on_card)
from repro_torch.kernels.kchoice import ref
from repro_torch.kernels.kchoice.ref import kchoice_ref

#: dynamic shared memory one block may use on the H100 (sm_90)
SMEM_BYTES = 227 * 1024


def smem_bytes(B: int, K: int) -> int:
    """The kernel's shared memory: the [B] float32 loads, the [B] one-byte
    claim table and a ring of three staged chunks of 256 labels' K
    candidates, ids and weights (kchoice.cu)."""
    return 5 * B + 3 * 256 * (K + 2) * 4


def cost(G: int, L: int, K: int, B: int, *, slots: int = 1,
         load0: int = 0, weights: bool = False) -> dict:
    """The work of one launch: a compare a candidate and an add a pick
    (G·L·(K + 1)·slots operations, far below any peak: the kernel is
    bound by its sequential walk, chip_smoke.py's latency bound); the
    [G, L, K] candidates, the [G, L] order, ``load0`` initial loads and
    the [L] weights read once, the [G, L, slots] assignment written
    once."""
    return {"flops": G * L * (K + 1) * slots,
            "bytes": G * L * K * 4 + G * L * 4 + load0 * 4
            + (L * 4 if weights else 0) + G * L * slots * 4}


@functools.cache
def _launcher():
    """The kernel's C entry, built and loaded at first use."""
    from repro_torch.kernels import _build
    fn = _build.load("kchoice").kchoice_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kchoice(topk_idx, order, load0=None, weights=None, *, B: int,
            rounds=None, slots: int = 1):
    """Launch the CUDA kernel: topk_idx [G, L, K] int32 bucket ids < B,
    order [G, L] int32 (a permutation per rep), load0 [G, B] or [B] f32 or
    None, weights [L] f32 or None, all on the card -> assign [G, L] int32,
    or [G, L, slots] with ``slots`` > 1 (each label's ``slots`` distinct
    picks in turn, as ref.kchoice_ref; K <= ref.WALK_MAX_K).
    ``rounds``, a [G] int32 tensor on the card or None, receives each
    rep's sequential rounds: its 32-label windows and its in-register
    steps, one a label walked (a diagnostic, compared with
    ref.kchoice_windows). The walk's policy, ref.WALK_BELOW and
    ref.WALK_MAX_K, goes to the kernel with each launch. Raises where the
    [B] loads, the claim table and the staged ring pass one block's shared
    memory (B <= ~39,000 at K = 10)."""
    if not on_card(topk_idx, order, load0, weights, rounds):
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
    if not 1 <= slots <= K or (slots > 1 and K > ref.WALK_MAX_K):
        raise ValueError(f"kchoice: slots={slots} must lie in [1, K={K}], "
                         f"and K <= {ref.WALK_MAX_K} for slots > 1")
    if rounds is not None and (rounds.dtype != torch.int32
                               or tuple(rounds.shape) != (G,)):
        raise ValueError(f"kchoice: rounds must be int32 [{G}], got "
                         f"{rounds.dtype} {tuple(rounds.shape)}")
    if G > 2 ** 31 - 1:
        raise ValueError(f"kchoice: {G} reps exceed the grid")
    with billing("kchoice", lambda: cost(
            G, L, K, B, slots=slots,
            load0=0 if load0 is None else load0.numel(),
            weights=weights is not None)):
        return _launch(topk_idx, order, load0, weights, rounds, G, L, K, B,
                       slots, stride)


def _launch(topk_idx, order, load0, weights, rounds, G, L, K, B, slots,
            stride):
    """Allocate the assignment and launch; tensors without data stop
    before the launch (the fake path)."""
    dev = topk_idx.device
    out = torch.empty((G, L) + ((slots,) if slots > 1 else ()),
                      dtype=torch.int32, device=dev)
    if L == 0 or G == 0:
        return out
    topk_idx, order = topk_idx.contiguous(), order.contiguous()
    if weights is not None:
        weights = weights.contiguous()
    if holds_no_data(topk_idx, order, load0, weights, rounds):
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _launcher()(
            topk_idx.data_ptr(), order.data_ptr(),
            None if load0 is None else load0.data_ptr(), stride,
            None if weights is None else weights.data_ptr(), G, L, K, B,
            slots, ref.WALK_BELOW, ref.WALK_MAX_K, out.data_ptr(),
            None if rounds is None else rounds.data_ptr(), stream)
    check_launch("kchoice", err)
    LAUNCHES["kchoice"] += 1
    return out


def kchoice_assign(topk_idx, order, load0=None, weights=None, *, B: int,
                   slots: int = 1):
    """Sequential least-loaded-of-top-K insertion for G reps at once:
    topk_idx [G, L, K], order [G, L] -> assign [G, L] int32 ([G, L, slots]
    with ``slots`` > 1). The kernel on the card, the plain version on the
    CPU."""
    if not on_card(topk_idx, order, load0, weights):
        G, L, K = topk_idx.shape
        with billing("kchoice", lambda: cost(
                G, L, K, B, slots=slots,
                load0=0 if load0 is None else load0.numel(),
                weights=weights is not None)):
            return kchoice_ref(topk_idx, order, load0, weights, B=B,
                               slots=slots)
    return kchoice(topk_idx.to(torch.int32), order.to(torch.int32),
                   None if load0 is None else load0.to(torch.float32),
                   None if weights is None else weights.to(torch.float32),
                   B=B, slots=slots)


def step_cycles(device, n: int = 4096) -> float:
    """The SM clocks of the cheapest link of a dependence chain, a min of
    two loads and an add in registers, each link waiting on the last,
    measured on the card over an n-long chain. For the kernel's latency
    bound (kchoice.cu); counts no launch."""
    from repro_torch.kernels import _build
    fn = _build.load("kchoice").kchoice_step_cycles
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
    fn.restype = ctypes.c_int
    link = ctypes.c_double()
    with torch.cuda.device(device):
        check_launch("kchoice_step_cycles", fn(n, ctypes.byref(link)))
    return link.value
