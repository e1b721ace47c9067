"""The ONE dispatch site for the quantized coarse rerank (store/rerank calls
here). A CPU tensor takes the plain version (ref.py); a CUDA tensor launches
the hand-written kernel (quant_rerank.cu) or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, check_launch, on_card
from repro_torch.kernels.quant_rerank.ref import quant_rerank_ref

_CODE_DTYPES = {torch.int8: 0, torch.bfloat16: 1}
_METRICS = {"angular": 0, "l2": 1}
#: dynamic shared memory one block may use on the H100 (sm_90)
SMEM_BYTES = 227 * 1024


def smem_bytes(C: int, D: int) -> int:
    """The kernel's shared memory for a pass of C candidate slots at width
    D: the int64 sort keys padded to a power of two, the f32 scores, the
    query."""
    Cp = 1
    while Cp < C:
        Cp *= 2
    return Cp * 8 + (C + D) * 4


def pass_slots(C: int, D: int) -> int:
    """Slots the kernel takes a pass: all C (padded to a power of two) where
    their keys, scores and query fit one block's shared memory, else the
    largest power of two that fits; the passes then merge into a running
    top-k' in scratch."""
    P = 1
    while P < C:
        P *= 2
    while P > 32 and smem_bytes(min(P, C), D) > SMEM_BYTES:
        P //= 2
    if smem_bytes(min(P, C), D) > SMEM_BYTES:
        raise ValueError(f"quant_rerank: width D={D} leaves no room for a "
                         f"pass of slots in {SMEM_BYTES} B of shared memory")
    return P


@functools.cache
def _launcher():
    """The kernel's C entry, built and loaded at first use."""
    from repro_torch.kernels import _build
    fn = _build.load("quant_rerank").quant_rerank_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"quant_rerank: {name} must be {dtype} "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def quant_rerank(queries, codes, scales, cand_ids, cand_counts, *, tau: int,
                 k: int, metric: str = "angular"):
    """Launch the CUDA kernel. queries [Q, D] f32, codes [L, D] int8|bf16,
    scales [L, D/block] f32 (None for bf16), cand_ids [Q, C] int32 (pad -1,
    every id < L), cand_counts [Q, C] f32 -> (ids [Q, k'] int32 with -1
    where no survivor, coarse scores [Q, k'] f32, -inf there),
    k' = min(k, C). The slots run in passes of ``pass_slots(C, D)``: one
    pass while their sort keys fit one block's shared memory (C <= 16384
    at D <= 8960), else passes merged into a running top-k' in scratch."""
    if not on_card(queries, codes, scales, cand_ids, cand_counts):
        raise ValueError("quant_rerank launches on CUDA tensors only")
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if codes.dtype not in _CODE_DTYPES or codes.ndim != 2:
        raise ValueError(f"codes must be [L, D] int8 or bfloat16, got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    L, D = codes.shape
    Q, C = cand_ids.shape
    _check("queries", queries, torch.float32, (Q, D))
    _check("cand_ids", cand_ids, torch.int32, (Q, C))
    _check("cand_counts", cand_counts, torch.float32, (Q, C))
    if (scales is None) != (codes.dtype == torch.bfloat16):
        raise ValueError("int8 codes need scales; bf16 codes take none")
    n_blocks = block = 1
    if scales is not None:
        n_blocks = scales.shape[1]
        block = D // n_blocks
        _check("scales", scales, torch.float32, (L, n_blocks))
        if n_blocks * block != D:
            raise ValueError(f"{n_blocks} scale blocks do not divide D={D}")
    P = pass_slots(C, D)
    kp = min(k, C)
    dev = cand_ids.device
    ids = torch.empty((Q, kp), dtype=torch.int32, device=dev)
    vals = torch.empty((Q, kp), dtype=torch.float32, device=dev)
    if kp < 1 or Q == 0:
        return ids, vals
    queries, codes, cand_ids, cand_counts = (
        t.contiguous() for t in (queries, codes, cand_ids, cand_counts))
    scales_ptr = None
    if scales is not None:
        scales = scales.contiguous()
        scales_ptr = scales.data_ptr()
    run = (torch.empty((Q, 2, kp), dtype=torch.int64, device=dev)
           if P < C else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _launcher()(
            queries.data_ptr(), codes.data_ptr(), _CODE_DTYPES[codes.dtype],
            scales_ptr, n_blocks, block, cand_ids.data_ptr(),
            cand_counts.data_ptr(), Q, C, P, D, float(tau), kp,
            _METRICS[metric], None if run is None else run.data_ptr(),
            ids.data_ptr(), vals.data_ptr(), stream)
    check_launch("quant_rerank", err)
    LAUNCHES["quant_rerank"] += 1
    return ids, vals


def quant_coarse_topk(queries, codes, scales, cand_ids, cand_counts, *,
                      tau: int, k: int, metric: str = "angular"):
    """Coarse top-k' over quantized code rows -> (ids [Q, k'] with -1 pads,
    coarse scores [Q, k']). ``scales=None`` means scale-less (bf16) codes."""
    if not on_card(queries, codes, scales, cand_ids, cand_counts):
        return quant_rerank_ref(queries, codes, scales, cand_ids,
                                cand_counts, tau=tau, k=k, metric=metric)
    return quant_rerank(queries, codes, scales, cand_ids, cand_counts,
                        tau=tau, k=k, metric=metric)
