"""Hand-written Hopper kernels and the one device rule every wrapper follows.

Each kernel lives in ``kernels/<name>/``: ``<name>.cu`` (CUDA C++ for
``sm_90a`` behind a plain C interface, built by ``_build.py``) with, where
another kernel shares its device routines, ``<name>.cuh``; ``ref.py`` (the
plain PyTorch version of the same function) and ``ops.py`` (the wrapper,
the ONE dispatch site).

The device rule (:func:`on_card`): a tensor on the CPU takes the plain
version; a CUDA tensor launches the kernel or raises. There is no fallback
from a failed build or launch to the plain version.

``LAUNCHES`` counts kernel launches per kernel name. A wrapper adds one
exactly where it launches its kernel, so a run can show that the main path
went through the kernels (``reset_launches`` before, read after).

Kernels that read an operand by TMA take it as :func:`tma_operand` gives it.
"""
from __future__ import annotations

import contextlib

import torch

#: launches per kernel
LAUNCHES: dict[str, int] = {"irli_topk": 0, "freq_topc": 0,
                             "quant_rerank": 0, "mega_query": 0,
                             "bce_logits": 0, "kchoice": 0,
                             "distance_topk": 0, "flash_attention": 0,
                             "embedding_bag": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def on_card(*tensors) -> bool:
    """True when every given tensor lies on a CUDA device, False when every
    one lies on the CPU; raises on a mix or any other device."""
    n = n_cuda = n_cpu = 0
    for t in tensors:                  # attribute reads: a wrapper's hot path
        if t is not None:
            n += 1
            n_cuda += t.is_cuda
            n_cpu += t.is_cpu
    if n and n_cuda == n:
        return True
    if n and n_cpu == n:
        return False
    kinds = {t.device.type for t in tensors if t is not None}
    raise ValueError(f"kernel inputs must all be on cuda or all on cpu, "
                     f"got devices {sorted(kinds)}")


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """An entry point's device: ``cuda`` unless the caller asks for the
    CPU. Raises when CUDA is asked for and no card is present; it never
    falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


_NO_SCOPE = contextlib.nullcontext()


def card_scope(dev: torch.device):
    """The context a launch on card ``dev`` runs in: none when ``dev`` is
    the current device already (the usual case; entering and leaving
    ``torch.cuda.device`` costs a short kernel's call host time), else
    ``torch.cuda.device(dev)``."""
    if dev.index == torch.cuda.current_device():
        return _NO_SCOPE
    return torch.cuda.device(dev)


def card_stream(dev: torch.device) -> int:
    """The current CUDA stream of card ``dev``, as the int a kernel's C
    entry takes: torch's raw-stream query, which its own compiled kernels
    launch with; ``torch.cuda.current_stream(dev).cuda_stream`` builds a
    Stream object first, a large share of a short kernel's call."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def check_launch(name: str, err: int) -> None:
    """Raise when a kernel's C entry returned a non-zero cudaError_t (the
    value of cudaGetLastError() right after its launch)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError "
                           f"{err}")


def tma_operand(t: torch.Tensor) -> torch.Tensor:
    """t [G, rows, cols] laid out as a TMA tensor map reads it: unit stride
    on cols, 16-byte aligned base, a row stride ld whose bytes are a
    multiple of 16, and a rep stride of rows·ld. t itself when it is so
    already (a contiguous tensor whose rows are a multiple of 16 bytes);
    else a copy into a zero-padded [G, rows, ld] buffer, viewed as [G, rows,
    cols]. The kernel reads the row stride from ``stride(1)``."""
    G, rows, cols = t.shape
    per16 = 16 // t.element_size()
    ld = t.stride(1)
    if (t.stride(2) == 1 and t.data_ptr() % 16 == 0 and ld % per16 == 0
            and ld >= cols and t.stride(0) == rows * ld):
        return t
    ld = -(-cols // per16) * per16
    buf = torch.zeros((G, rows, ld), dtype=t.dtype, device=t.device)
    buf[..., :cols] = t
    return buf[..., :cols]
