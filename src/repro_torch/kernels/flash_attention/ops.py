"""The ONE dispatch site for causal attention (``models/attention.
attend_train`` for ``kind="full"``, no logit cap, positions 0..S-1: every
layer of ``models/transformer.lm_backbone``). A CPU tensor takes the plain
version (ref.py); a CUDA tensor launches the hand-written kernel
(flash_attention.cu) or raises.

:func:`flash_plan` computes the kernel's launch geometry (tiles, threads,
shared memory, grid, and for bf16 each operand's TMA tensor map) as plain
Python, so that the CPU tests reach it; the C entry checks the plan against
its own constants before it launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import (LAUNCHES, aligned16, billing, check_launch,
                                 holds_no_data, on_card)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

#: the plain version's query chunk on the CPU: its scores are [B, H,
#: PLAIN_Q_CHUNK, S] at most
PLAIN_Q_CHUNK = 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# flash_attention.cu's constants. bf16 (Bf16Tile): 128 query rows a block
# (two consumer warpgroups of 64), BK keys a tile in a ring of 2 stages,
# 384 threads (a producer warpgroup and two consumers), 64-column boxes of
# 128 bytes (the 128-byte swizzle). fp32: 16 query rows, 32-key tiles,
# 256 threads.
BQ = 128
STAGES = 2
THREADS = 384
BOX_COLS = 64
SMEM_LIMIT = 232_448           # dynamic shared memory a block can have
_F32 = {"BQ": 16, "BK": 32, "threads": 256}


@dataclasses.dataclass(frozen=True)
class TmaMap:
    """One operand's TMA tensor map: ``dims`` innermost first (D, S,
    heads, B), the byte ``strides`` of S, heads and B, and the ``box`` that
    one load copies (64 columns by a tile's rows)."""
    dims: tuple[int, int, int, int]
    strides: tuple[int, int, int]
    box: tuple[int, int, int, int]


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """One launch of the kernel: head dimension padded to ``DT``, ``BQ``
    query rows a block, ``BK`` keys a tile, ``stages`` ring stages,
    ``threads`` a block, ``smem`` dynamic shared-memory bytes a block,
    ``grid`` blocks; ``maps`` the q, k, v and o tensor maps (bf16 only:
    o's box is one consumer warpgroup's 64 rows)."""
    B: int
    H: int
    Hkv: int
    S: int
    D: int
    DT: int
    BQ: int
    BK: int
    stages: int
    threads: int
    smem: int
    grid: int
    maps: tuple[TmaMap, TmaMap, TmaMap, TmaMap] | None

    def work(self, block: int) -> tuple[int, int, int]:
        """Block ``block``'s (batch, head, query tile), as the kernel's
        ``block_work``: query tiles longest first, every head's tile t
        before any head's tile t - 1."""
        bh = self.B * self.H
        n_qtiles = self.grid // bh
        return ((block % bh) // self.H, block % bh % self.H,
                n_qtiles - 1 - block // bh)

    def as_array(self) -> list[int]:
        """The PLAN_LEN values the C entry takes: DT, BQ, BK, stages,
        threads, smem, grid, then each map's dims, strides and box (zeros
        for fp32)."""
        head = [self.DT, self.BQ, self.BK, self.stages, self.threads,
                self.smem, self.grid]
        if self.maps is None:
            return head + [0] * (PLAN_LEN - len(head))
        return head + [x for m in self.maps
                       for x in (*m.dims, *m.strides, *m.box)]


#: values in FlashPlan.as_array: 7 of geometry, 11 a tensor map (q, k, v, o)
PLAN_LEN = 7 + 4 * 11


def _contiguous_strides(n_heads: int, S: int, D: int):
    return (n_heads * S * D, S * D, D)


def flash_plan(B: int, H: int, Hkv: int, S: int, D: int, dtype,
               strides=None) -> FlashPlan:
    """The launch plan for q [B, H, S, D], k, v [B, Hkv, S, D] and the
    output o [B, H, S, D] of ``dtype`` (torch.bfloat16 or torch.float32).
    ``strides``: the element strides (batch, head, position) of q, k, v
    and o, four triples; contiguous when None. Raises when the grid passes
    2**31 - 1 blocks."""
    if strides is None:
        strides = (_contiguous_strides(H, S, D),
                   _contiguous_strides(Hkv, S, D),
                   _contiguous_strides(Hkv, S, D),
                   _contiguous_strides(H, S, D))
    if dtype not in _DTYPES:
        raise ValueError(f"flash_attention: float32 or bfloat16, got {dtype}")
    if dtype == torch.bfloat16:
        DT = 64 if D <= 64 else 128 if D <= 128 else 256
        BK = 64 if DT == 256 else 128
        bq, stages, threads = BQ, STAGES, THREADS
        # Q and the K and V rings, the barriers (1 + 4 a stage, 8 bytes
        # each) and 1024 bytes to align the swizzled tiles
        smem = 1024 + BQ * DT * 2 + 2 * STAGES * BK * DT * 2 \
            + 8 * (1 + 4 * STAGES)
        maps = tuple(
            TmaMap(dims=(D, S, heads, B),
                   strides=(2 * ss, 2 * sh, 2 * sb),
                   box=(BOX_COLS, rows, 1, 1))
            for (sb, sh, ss), heads, rows in zip(
                strides, (H, Hkv, Hkv, H), (BQ, BK, BK, BQ // 2)))
    else:
        DT, bq, BK, stages = D, _F32["BQ"], _F32["BK"], 1
        threads, maps = _F32["threads"], None
        smem = (bq * D + BK * (D + 1) + BK * D) * 4
    grid = -(-S // bq) * B * H
    if grid >= 2 ** 31:
        raise ValueError(f"flash_attention: {grid} blocks (B·H·S/{bq}) "
                         f"exceed the grid")
    return FlashPlan(B=B, H=H, Hkv=Hkv, S=S, D=D, DT=DT, BQ=bq, BK=BK,
                     stages=stages, threads=threads, smem=smem, grid=grid,
                     maps=maps)


@functools.cache
def _lib():
    """The kernel's C entry, built and loaded at first use."""
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention")
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong)] * 2 + [ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_attrs.argtypes = [ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_longlong)]
    lib.flash_attention_attrs.restype = ctypes.c_int
    return lib


def kernel_attrs() -> dict[int, dict[str, int]]:
    """The bf16 kernel's registers a thread (at launch), local (spill)
    bytes a thread and dynamic shared memory a block, for DT = 64, 128 and
    256, from cudaFuncGetAttributes on the card."""
    out = {}
    for dt in (64, 128, 256):
        vals = (ctypes.c_longlong * 3)()
        check_launch("flash_attention_attrs",
                     _lib().flash_attention_attrs(dt, vals))
        out[dt] = {"registers": vals[0], "spill_bytes": vals[1],
                   "smem_bytes": vals[2]}
    return out


@functools.lru_cache(maxsize=64)
def _launch_arrays(B, H, Hkv, S, D, dtype, strides):
    """The C entry's element strides (q, k, v, o) and plan, as ctypes
    arrays, for one call signature: cached, since a prefill repeats its
    signature in every layer and building them is most of the wrapper's
    host time. Raises as flash_plan does."""
    plan = flash_plan(B, H, Hkv, S, D, dtype, strides)
    return ((ctypes.c_longlong * 12)(*(x for st in strides for x in st)),
            (ctypes.c_longlong * PLAN_LEN)(*plan.as_array()))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself when the kernel can read it in 16-byte pieces (unit stride
    on D, the other strides and the address multiples of 16 bytes, as TMA
    requires, and none of them 0), else a contiguous copy in a new
    (aligned) allocation."""
    per16 = 16 // t.element_size()
    if t.stride(3) == 1 and aligned16(t) \
            and all(s % per16 == 0 and s > 0 for s in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def cost(B: int, H: int, Hkv: int, S: int, D: int, *,
         itemsize: int = 2) -> dict:
    """The work of one launch: QKᵀ and PV over the causal pairs (keys <=
    query), 2·B·H·S·(S + 1)·D operations; q and o moved once each, k and v
    read once."""
    return {"flops": 2 * B * H * S * (S + 1) * D,
            "bytes": (2 * B * H + 2 * B * Hkv) * S * D * itemsize}


def flash_attention(q, k, v):
    """Launch the CUDA kernel: q [B, H, S, D], k, v [B, Hkv, S, D], one
    dtype (float32 or bfloat16), all on the card, any strides (a
    ``[B, S, H, D]`` tensor's ``transpose(1, 2)`` is read in place) -> o
    [B, H, S, D] in q's dtype and layout. D a multiple of 16 up to 256, any
    S, H a multiple of Hkv. Allocates only the output."""
    if not on_card(q, k, v):
        raise ValueError("flash_attention launches on CUDA tensors only")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 \
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"flash_attention: q [B, H, S, D] and k, v [B, "
                         f"Hkv, S, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: float32 or bfloat16 inputs of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if D % 16 or not 16 <= D <= 256:
        raise ValueError(f"flash_attention: head_dim {D} must be a multiple "
                         f"of 16 in [16, 256]")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: {H} query heads over {Hkv} KV "
                         f"heads")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise ValueError("flash_attention has no backward kernel: call it "
                         "under torch.no_grad() or torch.inference_mode()")
    with billing("flash_attention", lambda: cost(
            B, H, Hkv, S, D, itemsize=q.element_size())):
        return _launch(q, k, v, B, H, Hkv, S, D)


def _launch(q, k, v, B, H, Hkv, S, D):
    """Align the operands, allocate the output and launch; tensors without
    data stop before the launch (the fake path)."""
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(q)
    strides, plan_arr = _launch_arrays(
        B, H, Hkv, S, D, q.dtype,
        tuple(t.stride()[:3] for t in (q, k, v, o)))
    if o.numel() == 0 or holds_no_data(q, k, v):
        return o
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPES[q.dtype], B, H, Hkv, S, D, strides, plan_arr, stream)
    check_launch("flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    return o


def causal_attention(q, k, v):
    """Causal softmax attention: q [B, H, S, D], k, v [B, Hkv, S, D] -> o
    [B, H, S, D] in q's dtype. The kernel on the card (one launch, no score
    tensor), the plain version on the CPU."""
    if not on_card(q, k, v):
        with billing("flash_attention", lambda: cost(
                *q.shape[:2], k.shape[1], *q.shape[2:],
                itemsize=q.element_size())):
            return flash_attention_ref(q, k, v, q_chunk=PLAIN_Q_CHUNK)
    return flash_attention(q, k, v)
