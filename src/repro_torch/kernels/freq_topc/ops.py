"""The ONE dispatch site for FrequentOnes top-C (core/query.frequency_topC).

A CPU tensor takes the plain version (ref.py). A CUDA tensor launches the
hand-written kernel (freq_topc.cu) or raises: a row wider than its sort width
``MAX_WIDTH`` raises on the card until the wide-row kernel lands (ROADMAP,
kernel queue item 1).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, check_launch, on_card
from repro_torch.kernels.freq_topc.ref import freq_topc_ref

#: widest candidate row whose packed (count, position) keys fit int32 and
#: whose sort fits one block's shared memory
MAX_WIDTH = 32768


@functools.cache
def _launcher():
    """The kernel's C entry, built and loaded at first use."""
    from repro_torch.kernels import _build
    fn = _build.load("freq_topc").freq_topc_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sort_width(C0: int) -> int:
    """The kernel's padded row width: the next power of two >= C0 (>= 32)."""
    n = 32
    while n < C0:
        n *= 2
    return n


def freq_topc(cands: torch.Tensor, *, C: int):
    """Launch the CUDA kernel: cands [Q, C0] int32 on the card (pad -1,
    C0 <= MAX_WIDTH) -> (ids [Q, C] int32, counts [Q, C] float32)."""
    if not on_card(cands):
        raise ValueError("freq_topc launches on a CUDA tensor only")
    if cands.dtype != torch.int32 or cands.ndim != 2:
        raise ValueError(f"cands must be [Q, C0] int32, got "
                         f"{cands.dtype} {tuple(cands.shape)}")
    if C < 1:
        raise ValueError(f"C must be >= 1, got {C}")
    Q, C0 = cands.shape
    if C0 > MAX_WIDTH:
        raise ValueError(
            f"candidate width {C0} > MAX_WIDTH {MAX_WIDTH}: rows this wide "
            f"need the wide-row freq_topc kernel (ROADMAP, kernel queue item "
            f"1); lower m, the corpus per card or max_load")
    cands = cands.contiguous()
    ids = torch.empty((Q, C), dtype=torch.int32, device=cands.device)
    cnt = torch.empty((Q, C), dtype=torch.float32, device=cands.device)
    if C0 == 0:
        return ids.fill_(-1), cnt.zero_()
    n = sort_width(C0)
    scratch = torch.empty((Q, n), dtype=torch.int32, device=cands.device)
    stream = torch.cuda.current_stream(cands.device).cuda_stream
    with torch.cuda.device(cands.device):
        err = _launcher()(cands.data_ptr(), Q, C0, n, C, scratch.data_ptr(),
                          ids.data_ptr(), cnt.data_ptr(), stream)
    check_launch("freq_topc", err)
    LAUNCHES["freq_topc"] += 1
    return ids, cnt


def frequent_topc(cands: torch.Tensor, *, C: int):
    """cands [Q, C0] int32 (pad -1) -> (ids [Q, C] int32, counts [Q, C] f32):
    the C most frequent ids per row, count-descending, ties toward the
    smaller id; -1/0 past the distinct-candidate count."""
    if not on_card(cands):
        return freq_topc_ref(cands, C=C)
    return freq_topc(cands, C=C)
