"""Live index mutation (port of ``repro.index``): delta buffer,
tombstones, versioned snapshots, the crash-safety pair (mutation WAL +
snapshot recovery), and the background re-clustering pipeline
(two-phase rebuild publish)."""
from repro_torch.core.ivf import DeltaView
from repro_torch.index.delta import (DeltaBuffer, DeltaFull, Tombstones,
                                     assign_clusters)
from repro_torch.index.live import LiveIndex, relayout
from repro_torch.index.rebuild import (DriftTracker, RebuildCrash, Rebuilder,
                                       RebuildReport, resolve_pending_rebuild)
from repro_torch.index.registry import (IndexRegistry, IndexVersion,
                                        StaleEpochError, version_from_arrays,
                                        version_of)
from repro_torch.index.wal import (EPOCH_OPS, MUTATION_OPS, MutationWAL,
                                   OP_REBUILD_ABORT, OP_REBUILD_BEGIN,
                                   OP_REBUILD_COMMIT, ReplayReport,
                                   WALCorruptError, WALRecord)
