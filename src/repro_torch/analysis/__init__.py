"""repro_torch.analysis — static contracts over recorded PyTorch calls.
Port of ``repro/analysis``.

The analysers and the contract DSL:

  * :mod:`repro_torch.analysis.trace`       — the op recorder: which
    intermediates a call materialises (views excluded), its peak bytes,
    its top-level kernel dispatch sites, the port's launch counters and,
    on the card, the CUDA kernels torch.profiler sees
  * :mod:`repro_torch.analysis.collectives` — the collectives a call
    issues, by kind and bytes
  * :mod:`repro_torch.analysis.recompile`   — distinct argument signatures
    per entry point / PipelineCache under parameter sweeps (dtype drift)
  * :mod:`repro_torch.analysis.contracts`   — the DSL (forbid_dims,
    require_dims, max_intermediate_bytes, max_dispatches,
    require_dtype_free, require_donated, max_trace_count,
    allowed_collectives), the process-wide
    :data:`~repro_torch.analysis.contracts.REGISTRY`, and ``audit()``
  * :mod:`repro_torch.analysis.cost`        — the cost model of one call
    (the reference's ``hlo.py`` ``analyze_hlo``): FLOPs, unfused HBM
    bytes, collectives, argument / temporary / peak bytes, kernel
    launches billed by their declared work, host reads; the dry run's
    recorder (``launch/dryrun.py``)

Contracts are declared beside the entry points they govern; importing those
modules is what populates the registry — :func:`load_all` imports them all,
so the audit CLI and tests see the full set.
"""
from repro_torch.analysis.contracts import (Contract, ContractRegistry,
                                            Fixture, REGISTRY,
                                            allowed_collectives, audit,
                                            forbid_dims, max_dispatches,
                                            max_intermediate_bytes,
                                            max_trace_count, register,
                                            require_dims, require_donated,
                                            require_dtype_free)

__all__ = [
    "Contract", "ContractRegistry", "Fixture", "REGISTRY",
    "allowed_collectives", "audit", "forbid_dims", "load_all",
    "max_dispatches", "max_intermediate_bytes", "max_trace_count",
    "register", "require_dims", "require_donated", "require_dtype_free",
]

#: every module that declares contracts at import time — load_all() imports
#: them so REGISTRY is complete (keep in sync when adding a declaration site)
_CONTRACT_MODULES = (
    "repro_torch.core.query",
    "repro_torch.core.search_api",
    "repro_torch.core.distributed",
    "repro_torch.store.rerank",
    "repro_torch.fit.engine",
    "repro_torch.online.refit",
    "repro_torch.kernels.freq_topc.ops",
    "repro_torch.kernels.quant_rerank.ops",
    "repro_torch.kernels.distance_topk.ops",
    "repro_torch.kernels.irli_topk.ops",
    "repro_torch.kernels.mega_query.ops",
)


def load_all() -> list:
    """Import every contract-declaring module and return the registered
    contract ids. Idempotent (imports cache; registration is keyed)."""
    import importlib

    for mod in _CONTRACT_MODULES:
        importlib.import_module(mod)
    return REGISTRY.ids()
