"""Hand-written Hopper kernels and the one device rule every wrapper follows.

Each kernel lives in ``kernels/<name>/``: ``<name>.cu`` (CUDA C++ for
``sm_90a`` behind a plain C interface, built by ``_build.py``), ``ref.py``
(the plain PyTorch version of the same function) and ``ops.py`` (the
wrapper, the ONE dispatch site).

The device rule (:func:`on_card`): a tensor on the CPU takes the plain
version; a CUDA tensor launches the kernel or raises. There is no fallback
from a failed build or launch to the plain version.

``LAUNCHES`` counts kernel launches per kernel name. A wrapper adds one
exactly where it launches its kernel, so a run can show that the main path
went through the kernels (``reset_launches`` before, read after).
"""
from __future__ import annotations

import torch

#: launches per kernel
LAUNCHES: dict[str, int] = {"freq_topc": 0, "quant_rerank": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def on_card(*tensors) -> bool:
    """True when every given tensor lies on a CUDA device, False when every
    one lies on the CPU; raises on a mix or any other device."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
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


def check_launch(name: str, err: int) -> None:
    """Raise when a kernel's C entry returned a non-zero cudaError_t (the
    value of cudaGetLastError() right after its launch)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError "
                           f"{err}")
