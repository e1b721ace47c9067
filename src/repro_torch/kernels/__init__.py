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

The cost model (``analysis/cost.py``) bills a kernel call by the work it
declares, its ops module's ``cost()``, not by its plain version's ops:
each entry runs inside :func:`billing`, which costs nothing while no
recorder is active. A tensor without data (a fake tensor of
``FakeTensorMode``, or a meta tensor; :func:`holds_no_data`) takes the
wrapper's fake path: the outputs and workspaces the launch would
allocate, and no launch. That is the dry run's path
(``launch/dryrun.py``), never a fallback: a real CUDA tensor still
launches the kernel or raises.
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


#: streaming multiprocessors of the H100 SXM: the grid of a fake path, which
#: has no card to ask
H100_SMS = 132


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


#: whether tensors without data on the meta device stand for the card's
#: (:func:`stand_in_card`)
_STAND_IN = [False]


@contextlib.contextmanager
def stand_in_card():
    """Inside, META tensors (tensors without data) count as the card's in
    :func:`on_card`: the dry run's tensors where torch is built without
    CUDA, whose fake ``cuda`` tensors neither index (their bindings open a
    CUDA device guard) nor run a backward (the autograd engine asks for an
    accelerator). A tensor with data is never affected."""
    _STAND_IN[0] = True
    try:
        yield
    finally:
        _STAND_IN[0] = False


def on_card(*tensors) -> bool:
    """True when every given tensor lies on a CUDA device (or, inside
    :func:`stand_in_card`, on the meta device), False when every one lies
    on the CPU; raises on a mix or any other device."""
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
    if n and _STAND_IN[0] and all(t.is_meta for t in tensors
                                  if t is not None):
        return True
    kinds = {t.device.type for t in tensors if t is not None}
    raise ValueError(f"kernel inputs must all be on cuda or all on cpu, "
                     f"got devices {sorted(kinds)}")


#: the tensor types that always hold data (a wrapper's hot path skips the
#: fake-tensor test for them)
_WITH_DATA = (torch.Tensor, torch.nn.Parameter)


def holds_no_data(*tensors) -> bool:
    """True when a given tensor has no data: a fake tensor (of
    ``FakeTensorMode``) or a meta tensor. A wrapper then takes its fake
    path."""
    for t in tensors:
        if t is None:
            continue
        if t.is_meta:
            return True
        if type(t) not in _WITH_DATA:
            from torch._subclasses.fake_tensor import FakeTensor
            if isinstance(t, FakeTensor):
                return True
    return False


def aligned16(t: torch.Tensor) -> bool:
    """Whether ``t``'s first element lies on a 16-byte boundary: its
    address on the card; for a tensor without data, its offset into a
    storage (the caching allocator aligns every block to 512 bytes)."""
    if holds_no_data(t):
        return t.storage_offset() * t.element_size() % 16 == 0
    return t.data_ptr() % 16 == 0


#: the active cost recorders (analysis/cost.CostRecorder), innermost last
RECORDERS: list = []


class _Billing:
    """One kernel call's scope for the active recorders: the outermost
    scope bills ``cost`` once, and no op inside is counted as work."""

    __slots__ = ("name", "cost")

    def __init__(self, name: str, cost: dict):
        self.name, self.cost = name, cost

    def __enter__(self):
        for r in RECORDERS:
            r.enter_kernel(self.name, self.cost)
        return self

    def __exit__(self, *exc):
        for r in RECORDERS:
            r.exit_kernel()
        return False


def billing(name: str, cost_fn):
    """The scope of one call of kernel ``name``: while a cost recorder is
    active, ``cost_fn()`` (its ops module's ``cost()`` at the call's
    shapes, ``{"flops", "bytes"}``) is billed once to it and the ops inside
    (the plain version's, or the launch's allocations) count no work;
    with none active, nothing (``cost_fn`` is not called)."""
    if not RECORDERS:
        return _NO_SCOPE
    return _Billing(name, cost_fn())


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
    if (t.stride(2) == 1 and aligned16(t) and ld % per16 == 0
            and ld >= cols and t.stride(0) == rows * ld):
        return t
    ld = -(-cols // per16) * per16
    buf = torch.zeros((G, rows, ld), dtype=t.dtype, device=t.device)
    buf[..., :cols] = t
    return buf[..., :cols]
