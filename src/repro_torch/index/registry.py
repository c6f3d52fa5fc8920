"""Versioned snapshot registry: atomic publish/subscribe of index state
(port of ``repro.index.registry``; ``save``/``restore``/``recover`` come
with the durability slice).

``search()``/``WaveScheduler`` read an :class:`IndexVersion` (immutable
snapshot of main index + delta view + dead lookup, all on one device);
the mutation path publishes a fresh one whenever state changes.
Readers pick up the new version between waves — never mid-wave — so
every in-flight probe loop sees one coherent (index, delta, tombstones)
triple.  :func:`version_from_arrays` takes the arrays the reference's
``IndexRegistry.save`` writes, as host arrays, which fixes the snapshot
schema the durability slice will persist.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.ivf import (DeltaView, IVFIndex, check_same_device,
                                  index_from_arrays)


class StaleEpochError(RuntimeError):
    """A publish carried an epoch older than the registry's current one.

    A ``merge_delta`` (or any publisher) computed against a pre-rebuild
    index must not clobber a re-clustered, epoch-bumped version: the
    loser re-reads ``registry.current()`` and redoes its work against
    the new epoch.
    """


@dataclass(frozen=True)
class IndexVersion:
    """One immutable, publishable snapshot of the live index; the delta
    view and the dead lookup lie on the index's device."""
    version: int
    index: IVFIndex
    delta: DeltaView
    dead: torch.Tensor         # (id_capacity,) bool tombstone lookup
    next_id: int
    seq: int = -1              # LiveIndex mutation counter at snapshot
    merges: int = 0            # LiveIndex merge counter at snapshot
    epoch: int = 0             # centroid generation (bumped by rebuild)

    def __post_init__(self):
        check_same_device(self.index.docs.device, "a version's delta view "
                          "or dead lookup", *self.delta, self.dead)


def version_of(live, *, version: Optional[int] = None) -> IndexVersion:
    """Snapshot a :class:`repro_torch.index.live.LiveIndex`."""
    return IndexVersion(
        version=live.seq if version is None else version,
        index=live.index,
        delta=live.delta_view(),
        dead=live.dead_lookup(),
        next_id=live.next_id,
        seq=live.seq,
        merges=live.version,
        epoch=live.epoch)


def version_from_arrays(centroids, docs, doc_ids, offsets, sizes,
                        list_pad: int, dvecs, dids, dassign, dead,
                        next_id: int, seq: int, merges: int, epoch: int, *,
                        version: Optional[int] = None,
                        device: DeviceLike = None) -> IndexVersion:
    """An :class:`IndexVersion` on ``device`` (CUDA unless
    ``device="cpu"``) from the host arrays of a snapshot — the arrays
    ``repro.index.registry.IndexRegistry.save`` writes (``offsets`` /
    ``sizes`` are the index's cluster offsets and sizes, ``dvecs`` /
    ``dids`` / ``dassign`` the delta view, ``dead`` the tombstone
    lookup).  ``version`` defaults to ``seq``, as ``version_of`` does."""
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.from_numpy(np.array(a, dtype)).to(dev)

    return IndexVersion(
        version=int(seq if version is None else version),
        index=index_from_arrays(centroids, docs, doc_ids, offsets, sizes,
                                list_pad, device=dev),
        delta=DeltaView(put(dvecs, np.float32), put(dids, np.int32),
                        put(dassign, np.int32)),
        dead=put(dead, np.bool_), next_id=int(next_id), seq=int(seq),
        merges=int(merges), epoch=int(epoch))


class IndexRegistry:
    """Thread-safe single-slot publish/subscribe for IndexVersions."""

    def __init__(self, initial: Optional[IndexVersion] = None):
        self._lock = threading.Lock()
        self._current: Optional[IndexVersion] = None
        self.swaps = 0
        if initial is not None:
            self.publish(initial)

    def publish(self, ver: IndexVersion) -> IndexVersion:
        with self._lock:
            cur = self._current
            if cur is not None and ver.epoch < cur.epoch:
                raise StaleEpochError(
                    f"publish of version {ver.version} carries epoch "
                    f"{ver.epoch} but the registry is at epoch "
                    f"{cur.epoch} — a rebuild published first; re-read "
                    f"current() and redo the mutation against the new "
                    f"index")
            if cur is not None and ver.version <= cur.version:
                ver = IndexVersion(cur.version + 1, ver.index, ver.delta,
                                   ver.dead, ver.next_id, ver.seq,
                                   ver.merges, ver.epoch)
            self._current = ver
            self.swaps += 1
            return ver

    def current(self) -> IndexVersion:
        with self._lock:
            if self._current is None:
                raise RuntimeError("registry holds no published version")
            return self._current
