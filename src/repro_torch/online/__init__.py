"""repro_torch.online — query-aware background re-partitioning. Port of
``repro/online``.

An :class:`OnlineRefitLoop` drains the server's sampled query stream
(obs.QueryLog) and probe-frequency counters, runs incremental fit rounds
against that live traffic, seals the result as a versioned
:class:`repro_torch.artifact.IndexArtifact`, and swaps it into the serving
index (MutableIRLIIndex.install_artifact — a pointer flip; readers pin a
snapshot per batch). The query-aware policies (hot-bucket replication)
live in :mod:`repro_torch.online.policy`.
"""
from repro_torch.online.policy import build_replicas, hot_buckets
from repro_torch.online.refit import OnlineRefitLoop, RefitConfig

__all__ = ["OnlineRefitLoop", "RefitConfig", "build_replicas", "hot_buckets"]
