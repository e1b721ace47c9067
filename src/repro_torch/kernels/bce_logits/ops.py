"""The ONE dispatch site for the fused sigmoid-BCE loss + gradient (the
fit's ``sigmoid_bce`` loss, core/network.scorer_loss_parts). A CPU tensor
takes the plain version (ref.py); a CUDA tensor launches the hand-written
kernel (bce_logits.cu) or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, check_launch, on_card
from repro_torch.kernels.bce_logits.ref import weighted_bce_ref


@functools.cache
def _lib():
    """The kernel's C entries, built and loaded at first use."""
    from repro_torch.kernels import _build
    lib = _build.load("bce_logits")
    lib.bce_logits_grid.argtypes = [ctypes.c_longlong]
    lib.bce_logits_grid.restype = ctypes.c_int
    fn = lib.bce_logits_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def bce_logits(logits, targets, weights=None, *, scale: float):
    """Launch the CUDA kernel: logits, targets [rows, B] f32 on the card,
    weights [n] f32 or None (rows a multiple of n) -> (loss 0-d f32 =
    scale · Σ_i w[i mod n] · Σ_b bce, grad [rows, B] f32 = scale ·
    w[i mod n] · (σ(x) - y))."""
    if not on_card(logits, targets, weights):
        raise ValueError("bce_logits launches on CUDA tensors only")
    if logits.ndim != 2 or logits.dtype != torch.float32:
        raise ValueError(f"bce_logits: logits must be [rows, B] float32, "
                         f"got {logits.dtype} {tuple(logits.shape)}")
    if targets.dtype != torch.float32 or targets.shape != logits.shape:
        raise ValueError(f"bce_logits: targets must be float32 "
                         f"{tuple(logits.shape)}, got {targets.dtype} "
                         f"{tuple(targets.shape)}")
    rows, B = logits.shape
    if weights is not None and (weights.ndim != 1 or weights.dtype
                                != torch.float32 or weights.shape[0] < 1
                                or rows % weights.shape[0]):
        raise ValueError(f"bce_logits: weights must be [n] float32 with "
                         f"{rows} rows a multiple of n, got {weights.dtype} "
                         f"{tuple(weights.shape)}")
    dev = logits.device
    grad = torch.empty_like(logits)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    if rows == 0 or B == 0:
        return loss.zero_(), grad
    logits, targets = logits.contiguous(), targets.contiguous()
    if weights is not None:
        weights = weights.contiguous()
    lib = _lib()
    partials = torch.empty(lib.bce_logits_grid(rows), dtype=torch.float64,
                           device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.bce_logits_launch(
            logits.data_ptr(), targets.data_ptr(),
            None if weights is None else weights.data_ptr(),
            0 if weights is None else weights.shape[0], rows, B,
            float(scale), grad.data_ptr(), partials.data_ptr(),
            loss.data_ptr(), stream)
    check_launch("bce_logits", err)
    LAUNCHES["bce_logits"] += 1
    return loss, grad


def weighted_bce(logits, targets, weights=None, *, scale: float = 1.0):
    """The fit's weighted form: the kernel on the card, the plain version
    on the CPU. See :func:`bce_logits`."""
    if not on_card(logits, targets, weights):
        return weighted_bce_ref(logits, targets, weights, scale)
    return bce_logits(logits, targets, weights, scale=scale)


def fused_bce(logits, targets):
    """logits/targets [N, B] -> (mean loss Σ loss / N, dlogits / N): the
    reference's ``ops.fused_bce``."""
    return weighted_bce(logits, targets, None, scale=1.0 / logits.shape[0])


class _SigmoidBCE(torch.autograd.Function):
    """Loss forward and gradient in one pass; only the gradient is saved,
    and the backward scales it by ``grad_output`` in place (so the graph
    may be run backward once)."""

    @staticmethod
    def forward(ctx, logits, targets, weights, scale):
        loss, grad = weighted_bce(logits.detach(), targets, weights,
                                  scale=scale)
        ctx.save_for_backward(grad)
        return loss

    @staticmethod
    def backward(ctx, grad_output):
        (grad,) = ctx.saved_tensors
        return grad.mul_(grad_output), None, None, None


def sigmoid_bce_loss(logits, targets, weights=None, *, scale: float = 1.0):
    """Differentiable ``scale · Σ_r Σ_n w_n Σ_b bce(logits, targets)``:
    logits, targets [R, N, B] (or [rows, B]), weights [N] or None. Holds no
    [R, N, B] tensor for backward beyond the gradient itself."""
    B = logits.shape[-1]
    return _SigmoidBCE.apply(logits.reshape(-1, B),
                             targets.reshape(-1, B), weights, scale)
