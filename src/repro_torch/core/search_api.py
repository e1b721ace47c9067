"""Typed search API: :class:`SearchParams` in, :class:`SearchResult` out,
a :class:`Searcher` protocol, the :class:`PipelineCache` every serving
surface shares and the deprecated kwarg shim. Port of
``repro/core/search_api.py``.
"""
from __future__ import annotations

import dataclasses
import threading
import warnings
from typing import Any, Protocol, runtime_checkable

from repro_torch.analysis.recompile import signature
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
    hot_replicas: bool = False  # gather the snapshot's hot-bucket replica
    #                            segments (repro_torch.online.policy) with
    #                            the delta members; a no-op without them

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


# ------------------------------------------------------------------- cache --
class _Entry:
    """One cache entry: the resolved pipeline, and the argument signatures
    it has run on. The first run of each signature
    (``analysis.recompile.signature``: the shapes and dtypes of its
    tensors, its structure, None where nothing was passed) counts as a
    compile — where the reference's ``jax.jit`` traces (a new
    delta/tombstone presence, a member matrix resized by compaction)."""

    def __init__(self, cache: "PipelineCache", pipe: Q.QueryPipeline):
        self._cache = cache
        self.pipe = pipe
        self._seen: set = set()

    def __call__(self, scorer_params, members, base, queries,
                 delta_members=None, tombstone=None):
        sig = signature((scorer_params, members, base, queries,
                         delta_members, tombstone))
        cache = self._cache
        with cache._lock:
            if sig not in self._seen:
                self._seen.add(sig)
                cache.compiles += 1
                cache.registry.counter("cache_compiles_total").inc()
        return self.pipe.search(scorer_params, members, base, queries,
                                delta_members, tombstone)


class PipelineCache:
    """Pipeline cache keyed on ``(resolved SearchParams, n_labels,
    q_bucket)``, the reference's key.

    PyTorch runs eagerly, so an entry is the resolved pipeline itself (a
    CUDA graph a key would stand in for ``jax.jit``; the stable top-k's
    host sync rules out its capture today). Looking a key up again returns
    the SAME entry. ``hits``/``misses`` count lookups; ``compiles`` counts
    the first run of each (entry, argument signature), the reference's
    trace count. Thread-safe. Lookups mirror into the
    ``cache_{hits,misses,compiles}_total`` counters of ``registry`` (the
    process-wide ``obs.DEFAULT_REGISTRY`` when None), and :meth:`search`
    times the first run of every fresh entry, fenced, into the
    ``cache_compile_seconds`` histogram.
    """

    def __init__(self, registry=None):
        self._fns: dict = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.compiles = 0
        self._registry = registry

    @property
    def registry(self):
        """The metrics registry this cache records into (resolved lazily,
        so a cache built before obs configuration lands in the default)."""
        from repro_torch import obs
        return obs.get_registry(self._registry)

    def __len__(self) -> int:
        return len(self._fns)

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "compiles": self.compiles, "entries": len(self._fns)}

    def clear(self) -> None:
        with self._lock:
            self._fns.clear()

    def _lookup(self, params: SearchParams, n_labels: int, q_bucket: int):
        """:meth:`get` plus a freshness bit -> (entry, fresh)."""
        if params.mode == "auto":
            raise ValueError("PipelineCache keys need resolved params — "
                             "call params.resolve(n_labels, q_batch) first")
        key = (params, int(n_labels), int(q_bucket))
        with self._lock:
            fn = self._fns.get(key)
            if fn is not None:
                self.hits += 1
                self.registry.counter("cache_hits_total").inc()
                return fn, False
            self.misses += 1
            self.registry.counter("cache_misses_total").inc()
            fn = _Entry(self, params.pipeline())
            self._fns[key] = fn
            return fn, True

    def get(self, params: SearchParams, n_labels: int, q_bucket: int):
        """The search fn for one resolved-params/corpus/batch key:
        ``fn(scorer_params, members, base, queries, delta_members,
        tombstone) -> (ids, scores, n_candidates)``."""
        return self._lookup(params, n_labels, q_bucket)[0]

    def search(self, params: SearchParams, scorer_params, members, base,
               queries, delta_members=None, tombstone=None, *,
               epoch: int = 0, staged: bool = False) -> SearchResult:
        """Resolve params against this corpus/batch, fetch or build the
        pipeline, run it, and wrap the typed result. ``base`` is the raw
        [L, d] corpus or a QuantizedStore over it.

        ``staged=True`` routes through the per-stage debug mode
        (``QueryPipeline.search_staged``): the same calls, each stage
        fenced and timed into this cache's registry under
        ``serve_stage_seconds{stage=...}``. Results are bit-identical to
        the unstaged path."""
        check_store("PipelineCache.search", params, base)
        resolved = params.resolve(int(base.shape[0]), int(queries.shape[0]))
        if staged:
            ids, scores, n_cand = resolved.pipeline().search_staged(
                scorer_params, members, base, queries, delta_members,
                tombstone, registry=self.registry)
            return SearchResult(ids=ids, scores=scores, n_candidates=n_cand,
                                epoch=epoch, mode=resolved.mode)
        fn, fresh = self._lookup(resolved, base.shape[0], queries.shape[0])
        if fresh:
            from repro_torch import obs
            with obs.trace(self.registry, "cache_compile_seconds") as sp:
                ids, scores, n_cand = sp.fence(
                    fn(scorer_params, members, base, queries, delta_members,
                       tombstone))
        else:
            ids, scores, n_cand = fn(scorer_params, members, base, queries,
                                     delta_members, tombstone)
        return SearchResult(ids=ids, scores=scores, n_candidates=n_cand,
                            epoch=epoch, mode=resolved.mode)


#: Process-wide default cache: surfaces that are not handed a private cache
#: (a bare ``idx.search``) all share this one.
DEFAULT_CACHE = PipelineCache()


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


# ------------------------------------------------------------- deprecation --
_LEGACY_DEFAULTS = {"m": 5, "tau": 1, "k": 10, "topC": 1024,
                    "metric": "angular", "mode": "auto"}


def params_from_legacy_kwargs(surface: str, *, stacklevel: int = 3,
                              **kw) -> SearchParams:
    """Build SearchParams from an old-style kwarg call and warn.

    ``kw`` values of None mean "not passed" and take the shared defaults,
    so the shim is the typed path with those params. ``stacklevel=3``
    attributes the DeprecationWarning to the shim's caller."""
    filled = {name: (default if kw.get(name) is None else kw[name])
              for name, default in _LEGACY_DEFAULTS.items()}
    warnings.warn(
        f"{surface} with bare m=/tau=/k=/metric=/mode=/topC= kwargs is "
        f"deprecated; pass SearchParams(m={filled['m']}, tau={filled['tau']},"
        f" k={filled['k']}, ...) instead",
        DeprecationWarning, stacklevel=stacklevel)
    return SearchParams(**filled)


# ------------------------------------------------------- static contracts --
# compiles exactly once per (resolved params, corpus, batch bucket) key —
# audited over a sweep that repeats every key (repro_torch.launch.audit).
from repro_torch.analysis import contracts as _C  # noqa: E402


def _cache_sweep_fixture():
    from repro_torch.analysis import fixtures as _FX
    return _FX.pipeline_cache_sweep()


_C.register(_C.Contract(
    id="search.cache_compiles_once",
    site="repro_torch.core.search_api.PipelineCache",
    description="a SearchParams sweep with 4 distinct resolved keys, each "
                "hit twice, runs exactly 4 argument signatures — more mean "
                "cache-key drift (dtype drift, an unstable structure)",
    fixture=_cache_sweep_fixture,
    checks=[_C.max_trace_count(4)],
))
