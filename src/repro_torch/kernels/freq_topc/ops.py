"""The ONE dispatch site for FrequentOnes top-C (core/query.frequency_topC).

A CPU tensor takes the plain version (ref.py); a CUDA tensor launches the
hand-written kernel (freq_topc.cu) or raises. Rows up to ``MAX_WIDTH`` wide
sort in one block's shared memory; wider rows (the paper's per-node shard
gathers C0 ~ 268k) launch the kernel's wide variant, which sorts in global
scratch. (The reference sends such rows to its plain version, on the TPU
too.)
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, check_launch, on_card
from repro_torch.kernels.freq_topc.ref import freq_topc_ref

#: widest candidate row whose packed (count, position) keys fit int32 and
#: whose sort fits one block's shared memory (wider rows: the wide variant)
MAX_WIDTH = 32768


@functools.cache
def _lib():
    """The kernel's C entries, built and loaded at first use."""
    from repro_torch.kernels import _build
    lib = _build.load("freq_topc")
    head = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
    out = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.freq_topc_launch.argtypes = head + out
    lib.freq_topc_launch.restype = ctypes.c_int
    lib.freq_topc_wide_launch.argtypes = head + [ctypes.c_void_p] + out
    lib.freq_topc_wide_launch.restype = ctypes.c_int
    return lib


def sort_width(C0: int) -> int:
    """The kernel's padded row width: the next power of two >= C0 (>= 32)."""
    n = 32
    while n < C0:
        n *= 2
    return n


def freq_topc(cands: torch.Tensor, *, C: int):
    """Launch the CUDA kernel: cands [Q, C0] int32 on the card (pad -1)
    -> (ids [Q, C] int32, counts [Q, C] float32). Rows wider than
    ``MAX_WIDTH`` take the wide variant (sorts in global scratch)."""
    if not on_card(cands):
        raise ValueError("freq_topc launches on a CUDA tensor only")
    if cands.dtype != torch.int32 or cands.ndim != 2:
        raise ValueError(f"cands must be [Q, C0] int32, got "
                         f"{cands.dtype} {tuple(cands.shape)}")
    if C < 1:
        raise ValueError(f"C must be >= 1, got {C}")
    Q, C0 = cands.shape
    if C0 > 2 ** 30:
        raise ValueError(f"candidate width {C0} > 2^30")
    cands = cands.contiguous()
    dev = cands.device
    ids = torch.empty((Q, C), dtype=torch.int32, device=dev)
    cnt = torch.empty((Q, C), dtype=torch.float32, device=dev)
    if C0 == 0:
        return ids.fill_(-1), cnt.zero_()
    n = sort_width(C0)
    scratch = torch.empty((Q, n), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        if n <= MAX_WIDTH:
            err = _lib().freq_topc_launch(
                cands.data_ptr(), Q, C0, n, C, scratch.data_ptr(),
                ids.data_ptr(), cnt.data_ptr(), stream)
        else:
            keys = torch.empty((Q, n), dtype=torch.int64, device=dev)
            err = _lib().freq_topc_wide_launch(
                cands.data_ptr(), Q, C0, n, C, scratch.data_ptr(),
                keys.data_ptr(), ids.data_ptr(), cnt.data_ptr(), stream)
    check_launch("freq_topc", err)
    LAUNCHES["freq_topc"] += 1
    return ids, cnt


def frequent_topc(cands: torch.Tensor, *, C: int):
    """cands [Q, C0] int32 (pad -1) -> (ids [Q, C] int32, counts [Q, C] f32):
    the C most frequent ids per row, count-descending, ties toward the
    smaller id; -1/0 past the distinct-candidate count. The kernel on the
    card, the plain version on the CPU."""
    if not on_card(cands):
        return freq_topc_ref(cands, C=C)
    return freq_topc(cands, C=C)
