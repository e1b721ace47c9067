"""The architecture registry: ``--arch <id>`` resolution. Port of
``repro/configs/registry.py``; each id names a ``repro_torch.configs``
module whose ``get_arch()`` gives its ``ArchDef``."""
from __future__ import annotations

import importlib

ARCHS = {
    # LM family
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick",
    # GNN
    "schnet": "repro_torch.configs.schnet",
    # RecSys
    "dien": "repro_torch.configs.dien",
    "dlrm-mlperf": "repro_torch.configs.dlrm_mlperf",
    "bst": "repro_torch.configs.bst",
    "xdeepfm": "repro_torch.configs.xdeepfm",
    # the paper's own production config (bonus cells)
    "irli-deep1b": "repro_torch.configs.irli_deep1b",
}

_CACHE: dict = {}


def get_arch(name: str):
    """The ``ArchDef`` of arch ``name`` (built once, then cached)."""
    if name not in _CACHE:
        if name not in ARCHS:
            raise KeyError(f"unknown arch {name!r}; choices: {sorted(ARCHS)}")
        _CACHE[name] = importlib.import_module(ARCHS[name]).get_arch()
    return _CACHE[name]


def all_cells(include_irli: bool = True):
    """[(arch, shape)] for every defined cell (skip-marked included)."""
    out = []
    for name in ARCHS:
        if not include_irli and name == "irli-deep1b":
            continue
        arch = get_arch(name)
        for shape in arch.cells:
            out.append((name, shape))
    return out
