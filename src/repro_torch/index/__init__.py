"""Live index: delta buffer, tombstones, ``merge_delta`` and versioned
snapshots (port of ``repro.index``).  The mutation WAL, snapshot
persistence and background rebuilds come with the durability slice."""
from repro_torch.core.ivf import DeltaView
from repro_torch.index.delta import (DeltaBuffer, DeltaFull, Tombstones,
                                     assign_clusters)
from repro_torch.index.live import LiveIndex, relayout
from repro_torch.index.registry import (IndexRegistry, IndexVersion,
                                        StaleEpochError, version_from_arrays,
                                        version_of)
