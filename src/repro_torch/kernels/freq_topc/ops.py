"""The ONE dispatch site for FrequentOnes top-C (core/query.frequency_topC).

A CPU tensor takes the plain version (ref.py); a CUDA tensor launches the
hand-written kernel (freq_topc.cu) or raises. The kernel sorts each row by
LSD radix passes with the row's ids in registers: rows up to ``CHUNK`` wide
in one block, rows up to MAX_CLUSTER chunks (the stream cell's 65,280) in a
thread block cluster of one block a chunk, which scatters keys into each
other's shared memory. Wider rows (the paper's per-node shard gathers C0 ~
268k) take the wide variant, one block a row passing its chunks between two
global scratch rows. (The reference sends rows past 32,768 to its plain
version, on the TPU too.) ``radix_plan`` is the launch plan the C side
computes, for the CPU tests and chip_smoke.py.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import (LAUNCHES, billing, check_launch,
                                 holds_no_data, on_card)
from repro_torch.kernels.freq_topc.ref import (CHUNK, DIGIT_BITS, KEYS,
                                               freq_topc_ref, sort_passes)

#: widest candidate row of the fused query kernel's bitonic sort
#: (mega_query.cu's phase 3 keeps freq_topc.cuh's bitonic routines)
MAX_WIDTH = 32768
#: bins of a ranking pass, ints of reduction scratch (freq_topc.cuh) and
#: of a block's cluster exchange area (freq_topc.cu)
BINS, RED = 1 << DIGIT_BITS, 64
#: blocks a cluster of the row kernel (chunks a row); wider rows take the
#: wide kernel
MAX_CLUSTER = 8
#: threads a block of the wide kernel (its chunks: WIDE_THREADS x KEYS)
WIDE_THREADS = 256
EXCHANGE = 3 * BINS + 3 + MAX_CLUSTER * (BINS + 2)
#: the widest row the kernel takes
MAX_C0 = 2 ** 30


@functools.cache
def _lib():
    """The kernel's C entries, built and loaded at first use."""
    from repro_torch.kernels import _build
    lib = _build.load("freq_topc")
    lib.freq_topc_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.freq_topc_launch.restype = ctypes.c_int
    lib.freq_topc_plan.argtypes = [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
    lib.freq_topc_plan.restype = ctypes.c_int
    lib.freq_topc_attrs.argtypes = [ctypes.c_void_p]
    lib.freq_topc_attrs.restype = ctypes.c_int
    return lib


def sort_width(C0: int) -> int:
    """The fused query kernel's padded row width: the next power of two
    >= C0 (>= 32)."""
    n = 32
    while n < C0:
        n *= 2
    return n


_PLAN_KEYS = ("wide", "cluster", "threads", "chunks", "slots",
              "smem_bytes", "scratch_ints", "passes", "digit_bits")


def radix_plan(C0: int, max_id: int) -> dict[str, int]:
    """The launch plan of a row C0 wide whose largest id is max_id (-1: no
    real id). wide 0: the row kernel, a cluster of ``cluster`` blocks a
    row, each a chunk of CHUNK slots (one block of ``threads`` for rows up
    to CHUNK); wide 1, rows past MAX_CLUSTER chunks: the wide kernel, one
    block a row passing chunks of WIDE_THREADS x KEYS slots through global
    scratch. Then threads a block, chunks, slots (keys sorted, pads
    included), dynamic shared bytes a block, global scratch ints a row, the
    id sort's radix passes and digit bits (the C side's
    ``freq_topc_plan``)."""
    if not 1 <= C0 <= MAX_C0:
        raise ValueError(f"candidate width {C0} outside [1, 2^30]")
    passes, bits = sort_passes(max_id + 1)

    def padded(p):                   # a padded row: a pad word every 64
        return p + p // 64

    def counter_words(threads):      # 16-bit (digit, thread) counters
        return BINS * threads // 2 + BINS * threads // 32

    chunks = -(-C0 // CHUNK)
    wide = int(chunks > MAX_CLUSTER)
    if wide:
        threads = WIDE_THREADS
        chunks = -(-C0 // (threads * KEYS))
        slots = chunks * threads * KEYS
        smem = (padded(threads * KEYS) + counter_words(threads) + 2 * BINS
                + RED) * 4
        scratch = 2 * slots + BINS * chunks
    else:
        threads = (CHUNK // KEYS if chunks > 1
                   else -(-C0 // (32 * KEYS)) * 32)
        slots = chunks * CHUNK if chunks > 1 else threads * KEYS
        smem = (padded(min(slots, CHUNK)) + counter_words(threads) + RED
                + EXCHANGE) * 4
        scratch = 0
    cluster = 1 if wide else chunks
    return dict(zip(_PLAN_KEYS, (wide, cluster, threads, chunks, slots,
                                 smem, scratch, passes, bits)))


def plan_export(C0: int, max_id: int) -> dict[str, int]:
    """The C side's own plan (freq_topc_plan, on the card), keyed as
    ``radix_plan``."""
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    check_launch("freq_topc_plan", _lib().freq_topc_plan(C0, max_id, out))
    return dict(zip(_PLAN_KEYS, out))


def kernel_attrs() -> dict[str, int]:
    """The C side's account of both kernels (freq_topc_attrs, on the card):
    registers and local (spill) bytes a thread and the largest dynamic
    shared bytes of the row kernel and of the wide kernel (``wide_``)."""
    out = (ctypes.c_longlong * 6)()
    check_launch("freq_topc_attrs", _lib().freq_topc_attrs(out))
    keys = ("registers", "spill_bytes", "smem_bytes", "wide_registers",
            "wide_spill_bytes", "wide_smem_bytes")
    return dict(zip(keys, out))


def cost(Q: int, C0: int, C: int) -> dict:
    """The work of one launch: no arithmetic worth a peak (the radix
    passes' ranks and scatters); the [Q, C0] int32 candidates read once
    and the [Q, C] ids and counts written once."""
    return {"flops": 0, "bytes": Q * C0 * 4 + Q * C * 8}


def freq_topc(cands: torch.Tensor, *, C: int):
    """Launch the CUDA kernel: cands [Q, C0] int32 on the card (pad: any
    negative id) -> (ids [Q, C] int32, counts [Q, C] float32). One launch;
    rows past MAX_CLUSTER chunks take the wide variant, which needs
    ``radix_plan``'s scratch ints a row."""
    if not on_card(cands):
        raise ValueError("freq_topc launches on a CUDA tensor only")
    if cands.dtype != torch.int32 or cands.ndim != 2:
        raise ValueError(f"cands must be [Q, C0] int32, got "
                         f"{cands.dtype} {tuple(cands.shape)}")
    if C < 1:
        raise ValueError(f"C must be >= 1, got {C}")
    Q, C0 = cands.shape
    if C0 > MAX_C0:
        raise ValueError(f"candidate width {C0} > 2^30")
    with billing("freq_topc", lambda: cost(Q, C0, C)):
        return _launch(cands, Q, C0, C)


def _launch(cands, Q, C0, C):
    """Allocate the outputs (and the wide variant's scratch) and launch;
    tensors without data stop before the launch (the fake path)."""
    cands = cands.contiguous()
    dev = cands.device
    ids = torch.empty((Q, C), dtype=torch.int32, device=dev)
    cnt = torch.empty((Q, C), dtype=torch.float32, device=dev)
    if C0 == 0:
        return ids.fill_(-1), cnt.zero_()
    need = radix_plan(C0, -1)["scratch_ints"]
    scratch = (torch.empty((Q, need), dtype=torch.int32, device=dev)
               if need else None)
    if holds_no_data(cands):
        return ids, cnt
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().freq_topc_launch(
            cands.data_ptr(), Q, C0, C,
            None if scratch is None else scratch.data_ptr(),
            ids.data_ptr(), cnt.data_ptr(), stream)
    check_launch("freq_topc", err)
    LAUNCHES["freq_topc"] += 1
    return ids, cnt


def frequent_topc(cands: torch.Tensor, *, C: int):
    """cands [Q, C0] int32 (pad -1) -> (ids [Q, C] int32, counts [Q, C] f32):
    the C most frequent ids per row, count-descending, ties toward the
    smaller id; -1/0 past the distinct-candidate count. The kernel on the
    card, the plain version on the CPU."""
    if not on_card(cands):
        with billing("freq_topc", lambda: cost(*cands.shape, C)):
            return freq_topc_ref(cands, C=C)
    return freq_topc(cands, C=C)


# ------------------------------------------------------- static contracts --
from repro_torch.analysis import contracts as _C  # noqa: E402


def _freq_fixture():
    from repro_torch.analysis import fixtures as _FX
    return _FX.freq_topc_fixture()


def _freq_dense_control():
    from repro_torch.analysis import fixtures as _FX
    return _FX.freq_topc_fixture(dense=True)


_C.register(_C.Contract(
    id="kernels.freq_topc.no_dense_histogram",
    site="repro_torch.kernels.freq_topc.ops.frequent_topc",
    description="FrequentOnes top-C counts candidates by sort + run-length, "
                "never via a [Q, L] histogram (the control builds one)",
    fixture=_freq_fixture,
    checks=[_C.forbid_dims("Q", "L"), _C.require_dims("Q", "C")],
    control=_freq_dense_control,
))
