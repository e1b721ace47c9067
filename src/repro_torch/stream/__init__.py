"""Streaming mutable index: online insert/delete over a fitted IRLI index
without retraining (paper §3.3), via delta segments + tombstones + exact
compaction. Port of ``repro/stream``."""
from repro_torch.stream.compaction import compact_snapshot
from repro_torch.stream.delta import (DeltaState, default_delta_len,
                                      delta_append, delta_init)
from repro_torch.stream.mutable_index import MutableIRLIIndex, StreamSnapshot

__all__ = ["MutableIRLIIndex", "StreamSnapshot", "DeltaState",
           "delta_append", "delta_init", "default_delta_len",
           "compact_snapshot"]
