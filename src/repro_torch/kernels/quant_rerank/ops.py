"""The ONE dispatch site for the quantized coarse rerank (store/rerank calls
here). A CPU tensor takes the plain version (ref.py); a CUDA tensor launches
the hand-written kernel (quant_rerank.cu) or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import (LAUNCHES, billing, card_scope,
                                 card_stream, check_launch, holds_no_data,
                                 on_card)
from repro_torch.kernels.quant_rerank.ref import quant_rerank_ref

_CODE_DTYPES = {torch.int8: 0, torch.bfloat16: 1}
_METRICS = {"angular": 0, "l2": 1}
#: dynamic shared memory one block may use on the H100 (sm_90)
SMEM_BYTES = 227 * 1024
#: the kernel's shared ints beside the keys and the query: a tile's valid
#: ids and positions (2 x 1024), the radix select's 256 bins, 64 ints of
#: block-prefix scratch and 4 of the select's result
FIXED_INTS = 2 * 1024 + 256 + 64 + 4


def smem_bytes(C: int, D: int) -> int:
    """The kernel's shared memory for a pass of C candidate slots at width
    D: the int64 keys of the pass's valid slots, room padded to a power of
    two (the sort of the selected keys pads them), the fixed ints, the
    query."""
    Cp = 1
    while Cp < C:
        Cp *= 2
    return Cp * 8 + (FIXED_INTS + D) * 4


@functools.cache
def pass_slots(C: int, D: int) -> int:
    """Slots the kernel takes a pass: all C (padded to a power of two) where
    their keys and the query fit one block's shared memory, else the
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


def kernel_attrs() -> dict[str, int]:
    """The C side's account of the kernel (quant_rerank_attrs, on the card):
    the most registers and local (spill) bytes a thread of any of its
    instantiations takes, and its shared bytes outside the keys and the
    query (``FIXED_INTS`` x 4)."""
    from repro_torch.kernels import _build
    fn = _build.load("quant_rerank").quant_rerank_attrs
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 3)()
    check_launch("quant_rerank_attrs", fn(ctypes.addressof(out)))
    return dict(zip(("registers", "spill_bytes", "fixed_smem_bytes"), out))


def cost(Q: int, C: int, D: int, k: int, L: int, *, n_blocks: int = 1,
         code_bytes: int = 1, valid: int | None = None,
         rows: int | None = None) -> dict:
    """The work of one launch: 2·D operations a valid slot (dequantize
    and score), the queries and the [Q, C] ids and counts read once, each
    distinct valid row's codes and scales once, the [Q, k'] ids and scores
    written once. ``valid`` (slots whose count reaches tau) and ``rows``
    (distinct ids among them) depend on the data: by default every slot
    is valid and distinct, as many as the store has rows."""
    valid = Q * C if valid is None else valid
    rows = min(valid, L) if rows is None else rows
    scales = n_blocks * 4 if code_bytes == 1 else 0
    return {"flops": valid * 2 * D,
            "bytes": Q * D * 4 + Q * C * 8 + rows * (D * code_bytes + scales)
            + Q * min(k, C) * 8}


def _cost_of(queries, codes, scales, cand_ids, k: int) -> dict:
    Q, C = cand_ids.shape
    L, D = codes.shape
    return cost(Q, C, D, k, L,
                n_blocks=1 if scales is None else scales.shape[1],
                code_bytes=codes.element_size())


def _check(name, t, dtype, shape):
    if t.dtype != dtype or t.shape != shape:
        raise ValueError(f"quant_rerank: {name} must be {dtype} "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def quant_rerank(queries, codes, scales, cand_ids, cand_counts, *, tau: int,
                 k: int, metric: str = "angular"):
    """Launch the CUDA kernel. queries [Q, D] f32, codes [L, D] int8|bf16,
    scales [L, D/block] f32 (None for bf16), cand_ids [Q, C] int32 (pad -1,
    every id < L), cand_counts [Q, C] f32 -> (ids [Q, k'] int32 with -1
    where no survivor, coarse scores [Q, k'] f32, -inf there),
    k' = min(k, C). The slots run in passes of ``pass_slots(C, D)``: one
    pass while their keys fit one block's shared memory (C <= 16384 at
    D <= 22972), else passes merged into a running top-k' in scratch."""
    if not on_card(queries, codes, scales, cand_ids, cand_counts):
        raise ValueError("quant_rerank launches on CUDA tensors only")
    if metric not in _METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if codes.dtype not in _CODE_DTYPES or codes.ndim != 2:
        raise ValueError(f"codes must be [L, D] int8 or bfloat16, got "
                         f"{codes.dtype} {tuple(codes.shape)}")
    L, D = codes.shape
    Q, C = cand_ids.shape
    if (queries.dtype != torch.float32 or queries.shape != (Q, D)
            or cand_ids.dtype != torch.int32
            or cand_counts.dtype != torch.float32
            or cand_counts.shape != (Q, C)):       # one test on the hot path
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
    with billing("quant_rerank", lambda: cost(
            Q, C, D, k, L, n_blocks=n_blocks,
            code_bytes=codes.element_size())):
        return _launch(queries, codes, scales, cand_ids, cand_counts, Q, C,
                       D, n_blocks, block, tau, k, metric)


def _launch(queries, codes, scales, cand_ids, cand_counts, Q, C, D,
            n_blocks, block, tau, k, metric):
    """Allocate the outputs (and the passes' running top-k' scratch) and
    launch; tensors without data stop before the launch (the fake
    path)."""
    P = pass_slots(C, D)
    kp = min(k, C)
    dev = cand_ids.device
    # one allocation for both outputs: at tau = 2 the kernel is shorter
    # than its call's host time, of which torch.empty is a large share
    out = torch.empty((2, Q, kp), dtype=torch.int32, device=dev)
    ids, vals = out[0], out[1].view(torch.float32)
    if kp < 1 or Q == 0:
        return ids, vals
    queries, codes = queries.contiguous(), codes.contiguous()
    cand_ids, cand_counts = cand_ids.contiguous(), cand_counts.contiguous()
    if scales is not None:
        scales = scales.contiguous()
    run = (torch.empty((Q, 2, kp), dtype=torch.int64, device=dev)
           if P < C else None)
    if holds_no_data(queries, codes, scales, cand_ids, cand_counts):
        return ids, vals
    stream = card_stream(dev)
    with card_scope(dev):
        err = _launcher()(
            queries.data_ptr(), codes.data_ptr(), _CODE_DTYPES[codes.dtype],
            None if scales is None else scales.data_ptr(), n_blocks, block,
            cand_ids.data_ptr(), cand_counts.data_ptr(), Q, C, P, D,
            float(tau), kp, _METRICS[metric],
            None if run is None else run.data_ptr(), ids.data_ptr(),
            vals.data_ptr(), stream)
    check_launch("quant_rerank", err)
    LAUNCHES["quant_rerank"] += 1
    return ids, vals


def quant_coarse_topk(queries, codes, scales, cand_ids, cand_counts, *,
                      tau: int, k: int, metric: str = "angular",
                      chunk: int | None = None):
    """Coarse top-k' over quantized code rows -> (ids [Q, k'] with -1 pads,
    coarse scores [Q, k']). ``scales=None`` means scale-less (bf16) codes.
    On the CPU the plain version dequantizes ``chunk`` candidates a query
    at a time (None: k of them; an fp32 working set of [Q, chunk, D], as
    the reference's chunked path); the kernel on the card holds no
    dequantized row in device memory and takes no chunk."""
    if not on_card(queries, codes, scales, cand_ids, cand_counts):
        with billing("quant_rerank", lambda: _cost_of(
                queries, codes, scales, cand_ids, k)):
            return quant_rerank_ref(queries, codes, scales, cand_ids,
                                    cand_counts, tau=tau, k=k, metric=metric,
                                    chunk=k if chunk is None else chunk)
    return quant_rerank(queries, codes, scales, cand_ids, cand_counts,
                        tau=tau, k=k, metric=metric)


# ------------------------------------------------------- static contracts --
from repro_torch.analysis import contracts as _C  # noqa: E402


def _quant_fixture():
    from repro_torch.analysis import fixtures as _FX
    return _FX.quant_rerank_fixture()


def _quant_fullwidth_control():
    from repro_torch.analysis import fixtures as _FX
    return _FX.quant_rerank_fixture(chunk=80)   # chunk = C: full-width dequant


_C.register(_C.Contract(
    id="kernels.quant_rerank.coarse_dequant_bounded",
    site="repro_torch.kernels.quant_rerank.ops.quant_coarse_topk",
    description="the coarse stage's fp32 dequant working set is [Q, chunk, "
                "D] (on the card the kernel holds it on chip), never the "
                "full [Q, C, D] candidate width (the control runs the plain "
                "version with chunk=C and must materialize it)",
    fixture=_quant_fixture,
    checks=[
        _C.forbid_dims("Q", "C", "D", dtype="float32"),
        _C.require_dims("Q", "chunk", "D", dtype="float32",
                        on_chip="quant_rerank"),
    ],
    control=_quant_fullwidth_control,
))
