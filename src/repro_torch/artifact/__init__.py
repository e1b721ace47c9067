"""repro_torch.artifact — the one versioned index artifact. Port of
``repro/artifact``.

Scorer params + assignment, the streaming snapshot's member matrix, delta,
tombstones and vectors, and the QuantizedStore, under one immutable,
checksummed, monotonically versioned unit with atomic persistence through
CheckpointManager. Every swap surface (MutableIRLIIndex.install_artifact,
IRLIIndex.install_artifact, the OnlineRefitLoop) moves these.
"""
from repro_torch.artifact.artifact import (ArtifactIntegrityError,
                                           IndexArtifact, rebuild_members)

__all__ = ["IndexArtifact", "ArtifactIntegrityError", "rebuild_members"]
