"""The ONE dispatch site for causal attention (``models/attention.
attend_train`` for ``kind="full"``, no logit cap, positions 0..S-1: every
layer of ``models/transformer.lm_backbone``). A CPU tensor takes the plain
version (ref.py); a CUDA tensor launches the hand-written kernel
(flash_attention.cu) or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, check_launch, on_card
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

#: the plain version's query chunk on the CPU: its scores are [B, H,
#: PLAIN_Q_CHUNK, S] at most
PLAIN_Q_CHUNK = 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib():
    """The kernel's C entry, built and loaded at first use."""
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention")
    lib.flash_attention_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself when the kernel can read it in 16-byte pieces (unit stride
    on D, the other strides and the address multiples of 16 bytes), else a
    contiguous copy in a new (aligned) allocation."""
    per16 = 16 // t.element_size()
    if t.stride(3) == 1 and t.data_ptr() % 16 == 0 \
            and all(s % per16 == 0 for s in t.stride()[:3]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


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
    if -(-S // 16) * B * H >= 2 ** 31:
        raise ValueError(f"flash_attention: B·H·S/16 = "
                         f"{-(-S // 16) * B * H} exceeds the grid")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, o) for i in range(3)))
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPES[q.dtype], B, H, Hkv, S, D, strides, stream)
    check_launch("flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    return o


def causal_attention(q, k, v):
    """Causal softmax attention: q [B, H, S, D], k, v [B, Hkv, S, D] -> o
    [B, H, S, D] in q's dtype. The kernel on the card (one launch, no score
    tensor), the plain version on the CPU."""
    if not on_card(q, k, v):
        return flash_attention_ref(q, k, v, q_chunk=PLAIN_Q_CHUNK)
    return flash_attention(q, k, v)
