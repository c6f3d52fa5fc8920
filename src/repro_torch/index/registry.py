"""Versioned snapshot registry: atomic publish/subscribe of index state
(port of ``repro.index.registry``).

``search()``/``WaveScheduler`` read an :class:`IndexVersion` (immutable
snapshot of main index + delta view + dead lookup, all on one device);
the mutation path publishes a fresh one whenever state changes.
Readers pick up the new version between waves — never mid-wave — so
every in-flight probe loop sees one coherent (index, delta, tombstones)
triple.

Snapshots round-trip through ``repro_torch.checkpoint.CheckpointManager``
in the reference's schema (``_SNAPSHOT_KEYS``, the same dtypes), so
either package restores a snapshot the other saved;
:func:`version_from_arrays` turns its host arrays into a version on the
device.  With a mutation WAL (``repro_torch.index.wal``) the pair is
crash-safe: ``recover()`` loads the latest snapshot and replays every
logged mutation past it, rebuilding a LiveIndex bit-identical to the one
that crashed.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.checkpoint.manager import CheckpointError
from repro_torch.core.ivf import (DeltaView, IVFIndex, check_same_device,
                                  index_from_arrays)
from repro_torch.trace import span

_SNAPSHOT_KEYS = ("centroids", "docs", "doc_ids", "offsets", "sizes",
                  "dvecs", "dids", "dassign", "dead", "meta")


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
        """Make ``ver`` the current version (a ``registry.publish``
        span under a profiler)."""
        with span("registry.publish"), self._lock:
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

    # -- persistence ---------------------------------------------------------
    def save(self, manager) -> str:
        """Write the current version through a CheckpointManager, in the
        reference's schema: f32 vecs; i32 ids, offsets, sizes and
        assign; bool dead; int64 meta ``[list_pad, version, next_id,
        seq, merges, epoch]``."""
        ver = self.current()
        ix = ver.index
        tree = {
            "centroids": ix.centroids.float(), "docs": ix.docs.float(),
            "doc_ids": ix.doc_ids.int(), "offsets": ix.cluster_offsets.int(),
            "sizes": ix.cluster_sizes.int(),
            "dvecs": ver.delta.vecs.float(), "dids": ver.delta.ids.int(),
            "dassign": ver.delta.assign.int(), "dead": ver.dead.bool(),
            "meta": np.asarray(
                [ix.list_pad, ver.version, ver.next_id, ver.seq,
                 ver.merges, ver.epoch], np.int64),
        }
        return manager.save(ver.version, tree)

    @staticmethod
    def restore(manager, step: Optional[int] = None, *,
                device: DeviceLike = None
                ) -> Tuple["IndexRegistry", IndexVersion]:
        """The snapshot at ``step`` (the latest by default) as a version
        on ``device`` (CUDA unless ``device="cpu"``), and a registry
        holding it."""
        step, arrs = manager.load_arrays(step)
        missing = [k for k in _SNAPSHOT_KEYS if k not in arrs]
        if missing:
            raise CheckpointError(
                f"index snapshot at step {step} under {manager.root!r} "
                f"is missing arrays {missing} — expected the schema "
                f"written by IndexRegistry.save: {list(_SNAPSHOT_KEYS)} "
                f"(was this checkpoint written by a different tree?)")
        meta = np.asarray(arrs["meta"]).ravel()
        if meta.size < 3:
            raise CheckpointError(
                f"index snapshot at step {step} under {manager.root!r} "
                f"has a malformed 'meta' array of size {meta.size} — "
                f"expected >= 3 entries [list_pad, version, next_id"
                f"(, seq, merges)]")
        list_pad, version, next_id = (int(x) for x in meta[:3])
        seq = int(meta[3]) if meta.size > 3 else version
        merges = int(meta[4]) if meta.size > 4 else 0
        epoch = int(meta[5]) if meta.size > 5 else 0
        ver = version_from_arrays(
            arrs["centroids"], arrs["docs"], arrs["doc_ids"],
            arrs["offsets"], arrs["sizes"], list_pad, arrs["dvecs"],
            arrs["dids"], arrs["dassign"], arrs["dead"], next_id, seq,
            merges, epoch, version=version, device=device)
        return IndexRegistry(ver), ver

    @staticmethod
    def recover(manager, wal=None, *, step: Optional[int] = None,
                align: int = 64, round_total_to: int = 4096,
                device: DeviceLike = None):
        """Crash recovery: latest snapshot + WAL replay past it.

        Returns ``(registry, live, replay_report)`` where ``live`` is a
        :class:`repro_torch.index.live.LiveIndex` on ``device``,
        bit-identical (top-k ids, phi history, probe counts) to the
        instance that crashed, and the registry holds its freshly
        published current version.  ``replay_report`` is None when no
        WAL is given.

        A background rebuild in flight at crash time is resolved first
        (``resolve_pending_rebuild``): a durable ``REBUILD_COMMIT`` whose
        staged snapshot was not promoted gets its promote redone; an open
        epoch is aborted and its staging cleaned, so recovery lands on
        the pre-rebuild snapshot + full replay.
        """
        from repro_torch.index.live import LiveIndex
        from repro_torch.index.rebuild import resolve_pending_rebuild
        promoted = aborted = False
        if wal is not None:
            promoted, aborted = resolve_pending_rebuild(manager, wal)
        _, ver = IndexRegistry.restore(manager, step, device=device)
        live = LiveIndex.from_version(ver, align=align,
                                      round_total_to=round_total_to,
                                      wal=wal)
        if wal is not None:
            wal.note_durable(live.seq)   # restored snapshot is durable
        report = wal.replay_into(live) if wal is not None else None
        if report is not None:
            report.rebuild_promoted = promoted
            report.rebuild_aborted = aborted
        reg = IndexRegistry(version_of(live))
        return reg, live, report
