"""repro_torch.obs — the port's metrics and tracing substrate (the
reference's ``repro.obs``): the registry, the trace spans, the JSONL
logger, the sampled query log, the quality monitors and the HTTP
exposition.

One :class:`MetricRegistry` per deployment surface plus a process-wide
:data:`DEFAULT_REGISTRY` for call sites that are not handed one (mirrors
``search_api.DEFAULT_CACHE``). A leaf of the package: it imports nothing
from ``repro_torch.core`` or ``repro_torch.stream``.
"""
from repro_torch.obs.logger import MetricsLogger
from repro_torch.obs.qlog import DrainedLog, QueryLog
from repro_torch.obs.registry import (COUNT_BUCKETS, LATENCY_BUCKETS,
                                      Counter, Gauge, Histogram,
                                      MetricRegistry, VectorCounter,
                                      bucket_index, load_balance_stats,
                                      log_buckets, merge_snapshots)
from repro_torch.obs.trace import Span, fence, trace

#: Process-wide default registry: surfaces that are not handed a private
#: registry record here (e.g. ``search_api.DEFAULT_CACHE``'s counters).
DEFAULT_REGISTRY = MetricRegistry()


def get_registry(registry: "MetricRegistry | None" = None) -> MetricRegistry:
    """The registry to record into: the one given, else the default."""
    return registry if registry is not None else DEFAULT_REGISTRY


from repro_torch.obs.exposition import start_metrics_server  # noqa: E402
# quality resolves get_registry lazily, so import it after DEFAULT_REGISTRY
from repro_torch.obs.quality import (CRITICAL, OK,  # noqa: E402
                                     RECALL_BUCKETS, STATE_NAMES, WARN,
                                     DriftDetector, QuerySketch,
                                     ShadowAuditor, SLOMonitor, SLOSpec,
                                     chi_square, kl_divergence, recall_rows,
                                     uptime_source)

__all__ = [
    "Counter", "Gauge", "Histogram", "VectorCounter", "MetricRegistry",
    "MetricsLogger", "Span", "trace", "fence", "log_buckets", "bucket_index",
    "merge_snapshots", "load_balance_stats", "LATENCY_BUCKETS",
    "COUNT_BUCKETS", "DEFAULT_REGISTRY", "get_registry",
    "start_metrics_server", "QueryLog", "DrainedLog",
    "RECALL_BUCKETS", "QuerySketch", "DriftDetector", "ShadowAuditor",
    "SLOSpec", "SLOMonitor", "recall_rows", "kl_divergence", "chi_square",
    "OK", "WARN", "CRITICAL", "STATE_NAMES", "uptime_source",
]
