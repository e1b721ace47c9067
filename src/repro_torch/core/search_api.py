"""Typed search API: :class:`SearchParams` in, :class:`SearchResult` out.
Port of ``repro/core/search_api.py`` (the reference's PipelineCache, its
counters and the deprecated kwarg shims are not part of this slice).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

from repro_torch.core import query as Q
from repro_torch.store.quantized import QuantizedStore, check_scales

_METRICS = ("angular", "l2")
_MODES = ("auto", "dense", "compact", "mega")
_STORE_DTYPES = ("fp32", "int8", "bf16")


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Everything a caller may tune about one search request. Same fields
    and validation as the reference. ``mode="auto"`` is resolved against the
    corpus and batch size by :meth:`resolve` before a pipeline is built."""
    m: int = 5                 # probe width: top-m buckets per rep
    tau: int = 1               # frequency threshold (FrequentOnes)
    k: int = 10                # final top-k
    topC: int = 1024           # compact-mode candidate budget per query
    metric: str = "angular"    # "angular" | "l2"
    mode: str = "auto"         # "auto" | "dense" | "compact" | "mega"
    store_dtype: str = "fp32"  # vector tier: "fp32" | "int8" | "bf16"
    refine_k: int = 0          # exact-refine depth k' (0 = auto: max(4k,32))
    adaptive_m: bool = False   # per-query probe count m(q)
    probe_mass: float = 1.0    # cumulative top-m mass per rep; 1.0 = all
    hot_replicas: bool = False  # hot-bucket replica segments (none served
    #                            by this slice: a no-op, as in the reference
    #                            when the snapshot carries none)

    def __post_init__(self):
        for name in ("m", "tau", "k", "topC"):
            v = getattr(self, name)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(
                    f"SearchParams.{name} must be an int >= 1, got {v!r}")
        if self.metric not in _METRICS:
            raise ValueError(f"SearchParams.metric must be one of {_METRICS},"
                             f" got {self.metric!r}")
        if self.mode not in _MODES:
            raise ValueError(f"SearchParams.mode must be one of {_MODES}, "
                             f"got {self.mode!r}")
        if self.store_dtype not in _STORE_DTYPES:
            raise ValueError(f"SearchParams.store_dtype must be one of "
                             f"{_STORE_DTYPES}, got {self.store_dtype!r}")
        rk = self.refine_k
        if not isinstance(rk, int) or isinstance(rk, bool) or rk < 0:
            raise ValueError(
                f"SearchParams.refine_k must be an int >= 0, got {rk!r}")
        for name in ("adaptive_m", "hot_replicas"):
            if not isinstance(getattr(self, name), bool):
                raise ValueError(f"SearchParams.{name} must be a bool, got "
                                 f"{getattr(self, name)!r}")
        pm = self.probe_mass
        if not isinstance(pm, (int, float)) or isinstance(pm, bool) \
                or not 0.0 < float(pm) <= 1.0:
            raise ValueError(
                f"SearchParams.probe_mass must be in (0, 1], got {pm!r}")
        if self.mode == "dense" and self.store_dtype != "fp32":
            raise ValueError(
                "mode='dense' cannot serve a quantized store "
                f"(store_dtype={self.store_dtype!r}): the dense rerank "
                "would decode the whole [L, D] corpus back to fp32")

    def replace(self, **kw) -> "SearchParams":
        return dataclasses.replace(self, **kw)

    def resolve(self, n_labels: int, q_batch: int = 512) -> "SearchParams":
        """Materialize ``mode="auto"`` by ``query.select_mode`` with this
        request's knobs: dense while the [q_batch, n_labels] tables fit the
        budget and the store is fp32; otherwise the fused "mega" when its
        (m, topC, refine_k, k) footprint fits the card
        (kernels/mega_query/ops.mega_fits); compact as the fallback."""
        if self.mode != "auto":
            return self
        return self.replace(mode=Q.select_mode(
            n_labels, q_batch, store_dtype=self.store_dtype, m=self.m,
            topC=self.topC, refine_k=self.refine_k, k=self.k))

    def pipeline(self) -> Q.QueryPipeline:
        """The QueryPipeline realizing these params. Resolve first."""
        if self.mode == "auto":
            raise ValueError("resolve() SearchParams before building a "
                             "pipeline — mode='auto' is not executable")
        return Q.QueryPipeline(m=self.m, tau=self.tau, k=self.k,
                               mode=self.mode, topC=self.topC,
                               metric=self.metric,
                               store_dtype=self.store_dtype,
                               refine_k=self.refine_k,
                               adaptive_m=self.adaptive_m,
                               probe_mass=float(self.probe_mass))


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """ids/scores [Q, k] (ids -1 where fewer than k candidates survived),
    ``n_candidates`` the per-query survivor count, ``epoch`` the snapshot
    served (0 for frozen indexes), ``mode`` the backend that ran."""
    ids: Any
    scores: Any
    n_candidates: Any
    epoch: int = 0
    mode: str = "compact"


@runtime_checkable
class Searcher(Protocol):
    """Anything that serves a typed search request."""

    def search(self, queries, params: SearchParams) -> SearchResult:
        ...


@dataclasses.dataclass
class _FnSearcher:
    fn: Any

    def search(self, queries, params: SearchParams) -> SearchResult:
        return self.fn(queries, params)


def as_searcher(fn) -> Searcher:
    """Wrap ``fn(queries, params) -> SearchResult`` into a Searcher."""
    return _FnSearcher(fn)


def check_store(surface: str, params: SearchParams, base) -> None:
    """Fail fast when the ``store_dtype`` knob and the base payload
    disagree."""
    if isinstance(base, QuantizedStore):
        check_scales(base)
        if params.store_dtype != base.dtype:
            raise ValueError(
                f"{surface}: params.store_dtype={params.store_dtype!r} but "
                f"the base store holds {base.dtype!r} codes — build the "
                f"params with store_dtype={base.dtype!r}")
    elif params.store_dtype != "fp32":
        raise ValueError(
            f"{surface}: params.store_dtype={params.store_dtype!r} needs a "
            "QuantizedStore base — encode the corpus once with "
            "repro_torch.store.quantized.encode(base, dtype=...)")


def check_params(surface: str, params) -> SearchParams:
    """Reject a non-SearchParams value in the params slot."""
    if not isinstance(params, SearchParams):
        raise TypeError(
            f"{surface} takes a SearchParams in its params slot, got "
            f"{type(params).__name__}")
    return params
