"""Background re-clustering: crash-safe two-phase rebuild of the index
(port of ``repro.index.rebuild``).

``merge_delta`` keeps centroids fixed, so sustained churn drifts the
corpus away from its cluster structure and erodes the recall that
patience-based early exit depends on.  The :class:`Rebuilder` re-trains
the centroids off the serving path, on the index's device, and swaps
the re-clustered index in without pausing reads or losing a mutation.

Pipeline (one stage per ``tick()``, so the serving loop can interleave
waves):

    begin    fence the WAL (``REBUILD_BEGIN [epoch, fence_seq]``) and
             snapshot the net corpus (base + delta − tombstones) plus
             fence-time next_id / tombstone lookup, on the device.
    retrain  warm-start Lloyd (``core.kmeans.retrain``) from the
             serving centroids — cluster count stays fixed.
    layout   assign the snapshot to the new centroids and re-layout a
             candidate index (``relayout``); entries overflowing
             ``list_pad`` spill into the candidate's delta buffer
             (merge_delta rule: first-come keeps the slot), found with
             a stable sort by cluster and each entry's rank in it.
    catchup  replay WAL records with ``seq > fence_seq`` onto the
             candidate (``MutationWAL.replay_into``): adds re-assign to
             the NEW centroids, ids allocate from the fence-time next_id.
    publish  two-phase commit, then an epoch-bumped registry publish.

Two-phase publish:

    1. save the candidate snapshot into ``<root>/rebuild_staging/``;
    2. append ``REBUILD_COMMIT [epoch, step]`` to the WAL, fsync'd —
       THE atomic commit point;
    3. promote: ``os.replace`` the staged step dir into the main
       snapshot root;
    4. compact the WAL past the candidate's sequence, drop snapshots
       beyond the manager's ``keep`` (the log no longer reaches back to
       them), and publish the epoch-bumped version through the registry.

``resolve_pending_rebuild`` (called by ``IndexRegistry.recover`` before
restoring) lands every crash window bit-identically: before step 2 the
epoch is aborted and recovery is the pre-rebuild snapshot + full
replay; between 2 and 3 the promote is redone; after 3 there is nothing
to resolve.  A version of a lower epoch can no longer be published
(``StaleEpochError``), and ``WaveScheduler`` drains in-flight lanes
before it adopts a higher epoch.
"""
from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import kmeans
from repro_torch.index.delta import DeltaBuffer, _on, assign_clusters
from repro_torch.index.live import LiveIndex, relayout
from repro_torch.index.registry import IndexRegistry, IndexVersion, version_of
from repro_torch.index.wal import (MUTATION_OPS, OP_REBUILD_ABORT,
                                   OP_REBUILD_BEGIN, OP_REBUILD_COMMIT)

#: staged (uncommitted) candidate snapshots live here, under the main
#: CheckpointManager root — ``all_steps`` never lists them
STAGING_DIR = "rebuild_staging"

#: ordered pipeline stages (``Rebuilder.stage`` walks this list)
STAGES = ("begin", "retrain", "layout", "catchup", "publish")

#: failpoint names accepted by ``Rebuilder(failpoint=...)`` — each
#: simulates a crash at one boundary of the protocol (chaos drills)
FAILPOINTS = ("begin", "retrain", "catchup", "staged", "commit",
              "promote")


class RebuildCrash(RuntimeError):
    """Simulated crash at a rebuild failpoint (chaos drills only): state
    is left exactly as a real crash would leave it."""


@dataclass
class RebuildReport:
    epoch: int = 0
    fence_seq: int = 0
    corpus: int = 0              # net docs snapshotted at the fence
    spilled: int = 0             # overflow entries -> candidate delta
    caught_up: int = 0           # WAL records replayed onto candidate
    moved: int = 0               # docs whose cluster changed
    step: int = -1               # promoted snapshot step (-1: no mgr)
    published_version: int = -1
    reason: str = "manual"


def first_come_keep(assign: torch.Tensor, n_clusters: int,
                    list_pad: int) -> torch.Tensor:
    """(n,) bool: whether each entry keeps a list slot when entries are
    taken in order and a cluster holds at most ``list_pad`` of them —
    the rank of each entry within its cluster (a stable sort by cluster)
    below ``list_pad``."""
    assign = assign.long()
    order = torch.sort(assign, stable=True).indices
    counts = torch.bincount(assign, minlength=n_clusters)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=assign.device) \
        - starts[assign[order]]
    return rank < list_pad


def mean_nearest_sq_dist(vecs: torch.Tensor, centroids: torch.Tensor, *,
                         block: int = 4096) -> float:
    """Mean over rows of min_c |x - c|^2, in f32 row blocks on the
    centroids' device (no (N, C) matrix is formed), summed in f64."""
    n = vecs.shape[0]
    if n == 0:
        return 0.0
    c_sq = (centroids * centroids).sum(1)
    total = torch.zeros((), dtype=torch.float64, device=centroids.device)
    for s in range(0, n, block):
        vb = vecs[s: s + block]
        sims = vb @ centroids.T - 0.5 * c_sq[None, :]
        total += ((vb * vb).sum(1) - 2.0 * sims.max(1).values).double().sum()
    return float(total) / n


class DriftTracker:
    """Centroid-drift trigger: mean nearest-centroid squared distance
    of recently *added* vectors, as a ratio over the same statistic of
    the corpus at (re)build time.  A ratio persistently above
    ``threshold`` means new documents land far from every centroid.
    ``observe`` smooths with an EMA so one odd batch does not trigger.
    The distances are computed on the centroids' device (a tensor's
    own, else ``device``: CUDA unless ``device="cpu"``)."""

    def __init__(self, centroids, baseline_vecs=None, *,
                 ema: float = 0.9, threshold: float = 1.5,
                 device: DeviceLike = None):
        if not 0.0 <= ema < 1.0:
            raise ValueError(f"ema must be in [0, 1), got {ema}")
        self._ema = float(ema)
        self.threshold = float(threshold)
        self.device = centroids.device \
            if isinstance(centroids, torch.Tensor) else resolve_device(device)
        self.rebase(centroids, baseline_vecs)

    def _mean_dist(self, vecs) -> float:
        return mean_nearest_sq_dist(
            _on(self.device, vecs, torch.float32, "vecs"), self.centroids)

    def rebase(self, centroids, baseline_vecs=None) -> None:
        """Reset after a rebuild: new centroids, fresh baseline."""
        self.centroids = _on(self.device, centroids, torch.float32,
                             "centroids")
        self.baseline: Optional[float] = None
        if baseline_vecs is not None:
            self.baseline = max(self._mean_dist(baseline_vecs), 1e-12)
        self.current: Optional[float] = None

    def observe(self, vecs) -> float:
        """Fold one batch of added vectors in; returns the ratio.
        The first batch seeds the baseline when none was given."""
        d = self._mean_dist(vecs)
        if self.baseline is None:
            self.baseline = max(d, 1e-12)
        self.current = d if self.current is None else \
            self._ema * self.current + (1.0 - self._ema) * d
        return self.ratio

    @property
    def ratio(self) -> float:
        if self.current is None or self.baseline is None:
            return 0.0
        return self.current / self.baseline

    @property
    def triggered(self) -> bool:
        return self.ratio > self.threshold


def resolve_pending_rebuild(manager, wal) -> Tuple[bool, bool]:
    """Resolve an interrupted two-phase rebuild before restore.

    Returns ``(promoted, aborted)``: whether a durable COMMIT's
    promote was redone, and whether an open epoch was aborted.
    Idempotent — running it twice (or on a clean log) is a no-op.
    """
    records = wal.scan()
    begun, committed, closed = {}, {}, set()
    last_seq = 0
    for r in records:
        if r.op in MUTATION_OPS:
            last_seq = max(last_seq, r.seq)
            continue
        pl = np.asarray(r.payload).ravel()
        e = int(pl[0])
        if r.op == OP_REBUILD_BEGIN:
            begun[e] = r
        elif r.op == OP_REBUILD_COMMIT:
            committed[e] = int(pl[1]) if pl.size > 1 else -1
            closed.add(e)
        elif r.op == OP_REBUILD_ABORT:
            closed.add(e)
    promoted = aborted = False
    staging = os.path.join(manager.root, STAGING_DIR)
    # 1. redo the promote for any committed candidate still staged
    for e, step in committed.items():
        if step < 0:
            continue
        src = os.path.join(staging, f"step_{step:08d}")
        dst = os.path.join(manager.root, f"step_{step:08d}")
        if os.path.isdir(src):
            if os.path.isdir(dst):       # promoted AND staged: stale copy
                shutil.rmtree(src, ignore_errors=True)
            else:
                os.replace(src, dst)
                promoted = True
    # 2. abort any epoch still open (crash before its COMMIT)
    for e in begun:
        if e in closed:
            continue
        wal.append(OP_REBUILD_ABORT, last_seq,
                   np.asarray([e, 0], np.int64), force=True)
        aborted = True
    # any staging left over belongs to a closed epoch now — drop it
    if os.path.isdir(staging):
        shutil.rmtree(staging, ignore_errors=True)
    return promoted, aborted


class Rebuilder:
    """Online background re-clustering with two-phase crash-safe publish.

    One ``tick()`` runs one pipeline stage, so a serving loop can
    interleave waves between stages; ``run_once()`` drives a whole
    rebuild synchronously.  ``manager`` (CheckpointManager) and the
    live index's ``wal`` are optional: without them the rebuild is
    in-memory only, and then no mutations may arrive between ``begin``
    and ``publish``.  ``failpoint`` names a protocol boundary at which
    to raise :class:`RebuildCrash` (see :data:`FAILPOINTS`).
    ``on_publish(new_live, report)`` fires after the registry swap so
    the mutation stream can rebind its LiveIndex handle.  Every stage
    runs on the live index's device.
    """

    def __init__(self, live: LiveIndex, registry: Optional[IndexRegistry]
                 = None, manager=None, *, n_iters: int = 4,
                 block: int = 4096,
                 on_publish: Optional[Callable] = None,
                 failpoint: Optional[str] = None):
        if failpoint is not None and failpoint not in FAILPOINTS:
            raise ValueError(
                f"unknown failpoint {failpoint!r}; expected one of "
                f"{FAILPOINTS}")
        self.live = live
        self.registry = registry
        self.manager = manager
        self.n_iters = int(n_iters)
        self.block = int(block)
        self.on_publish = on_publish
        self.failpoint = failpoint
        self.stage: str = "idle"
        self.epochs_published = 0
        self.last_report: Optional[RebuildReport] = None
        self._reset()

    # -- control -------------------------------------------------------------
    @property
    def active(self) -> bool:
        return self.stage != "idle"

    def request(self, reason: str = "manual") -> bool:
        """Arm a rebuild; returns False if one is already in flight."""
        if self.active:
            return False
        self._reset()
        self._reason = reason
        self.stage = STAGES[0]
        return True

    def tick(self) -> Optional[str]:
        """Run ONE pipeline stage; returns its name (None when idle).
        A real error aborts the rebuild (epoch closed, staging
        cleaned) and re-raises; a :class:`RebuildCrash` failpoint
        propagates raw, leaving crash-consistent state behind."""
        if not self.active:
            return None
        stage = self.stage
        try:
            getattr(self, "_stage_" + stage)()
        except RebuildCrash:
            raise
        except Exception:
            self.abort()
            raise
        return stage

    def run_once(self, reason: str = "manual"
                 ) -> Optional[RebuildReport]:
        """Drive a full rebuild synchronously; returns its report."""
        if not self.request(reason) and not self.active:
            return None
        while self.active:
            self.tick()
        return self.last_report

    def abort(self) -> None:
        """Close the epoch (``REBUILD_ABORT``) and drop staged state.
        Safe to call at any point before publish; idempotent."""
        if self._begun and self.live.wal is not None:
            self.live.wal.append(
                OP_REBUILD_ABORT, self.live.seq,
                np.asarray([self._epoch, 0], np.int64), force=True)
        if self.manager is not None:
            shutil.rmtree(os.path.join(self.manager.root, STAGING_DIR),
                          ignore_errors=True)
        self._reset()

    def _reset(self) -> None:
        self.stage = "idle"
        self._reason = "manual"
        self._begun = False
        self._epoch = 0
        self._fence_seq = 0
        self._snap_vecs = self._snap_ids = None
        self._fence_next_id = 0
        self._fence_dead = None
        self._new_centroids = None
        self._assign = None
        self._candidate: Optional[LiveIndex] = None
        self._spilled = 0
        self._caught_up = 0
        self._step = -1

    def _maybe_crash(self, point: str) -> None:
        if self.failpoint == point:
            raise RebuildCrash(f"simulated crash at rebuild "
                               f"failpoint {point!r}")

    # -- stages --------------------------------------------------------------
    def _stage_begin(self) -> None:
        live = self.live
        self._epoch = live.epoch + 1
        self._fence_seq = live.seq
        if live.wal is not None:
            live.wal.append(
                OP_REBUILD_BEGIN, self._fence_seq,
                np.asarray([self._epoch, self._fence_seq], np.int64),
                force=True)
        self._begun = True
        self._maybe_crash("begin")
        self._snap_vecs, self._snap_ids = live.net_corpus()
        self._fence_next_id = live.next_id
        self._fence_dead = live.dead_lookup().clone()
        self.stage = "retrain"

    def _stage_retrain(self) -> None:
        self._maybe_crash("retrain")
        self._new_centroids, self._assign = kmeans.retrain(
            self._snap_vecs, self.live.index.centroids,
            n_iters=self.n_iters, block=self.block)
        self.stage = "layout"

    def _stage_layout(self) -> None:
        live = self.live
        dev = live.device
        lp = live.index.list_pad
        vecs, assign = self._snap_vecs, self._assign
        ids = torch.as_tensor(self._snap_ids, device=dev)
        # merge_delta's spill rule under the new assignment: within a
        # cluster, earlier corpus entries keep their list slot; the
        # overflow past list_pad spills to the candidate's buffer
        keep = first_come_keep(assign, self._new_centroids.shape[0], lp)
        spill = torch.nonzero(~keep).flatten()
        n_spill = spill.numel()
        if n_spill > live.delta.capacity:
            raise RuntimeError(
                f"rebuild would spill {n_spill} overflow entries "
                f"but the delta buffer holds {live.delta.capacity}; "
                f"raise list_pad or delta capacity")
        cand_index = relayout(vecs[keep], ids[keep], assign[keep],
                              self._new_centroids, list_pad=lp,
                              align=live.align,
                              round_total_to=live.round_total_to)
        buf = DeltaBuffer(live.index.dim, live.delta.capacity, device=dev)
        if n_spill:
            buf.add(vecs[spill], ids[spill], assign[spill])
        ver = IndexVersion(
            version=self._fence_seq, index=cand_index, delta=buf.view(),
            dead=self._fence_dead, next_id=self._fence_next_id,
            seq=self._fence_seq, merges=live.version, epoch=self._epoch)
        self._candidate = LiveIndex.from_version(
            ver, align=live.align, round_total_to=live.round_total_to)
        self._spilled = int(n_spill)
        self.stage = "catchup"

    def _stage_catchup(self) -> None:
        self._maybe_crash("catchup")
        self._caught_up = self._do_catchup()
        self.stage = "publish"

    def _do_catchup(self) -> int:
        """Replay WAL records past the candidate's sequence onto it
        (mutations that landed while the rebuild ran).  Deterministic,
        so recovery replays to the bit-identical candidate."""
        cand, live = self._candidate, self.live
        if cand.seq >= live.seq:
            return 0
        if live.wal is None:
            raise RuntimeError(
                f"{live.seq - cand.seq} mutations arrived during an "
                f"in-memory rebuild (no WAL to catch up from); attach "
                f"a MutationWAL or quiesce writes across run_once()")
        live.wal.flush()
        rep = live.wal.replay_into(cand)
        return rep.applied

    def _stage_publish(self) -> None:
        live, cand = self.live, self._candidate
        self._caught_up += self._do_catchup()    # close any late gap
        wal = live.wal
        if self.manager is not None and wal is not None:
            # two-phase commit: stage -> COMMIT record -> promote
            from repro_torch.checkpoint.manager import CheckpointManager
            self.manager.wait()
            self._step = max(self.manager.latest_step() or -1,
                             self.registry.current().version
                             if self.registry is not None else -1,
                             cand.seq) + 1
            staging = CheckpointManager(
                os.path.join(self.manager.root, STAGING_DIR),
                keep=self.manager.keep, async_save=False)
            IndexRegistry(version_of(cand, version=self._step)
                          ).save(staging)
            self._maybe_crash("staged")
            wal.append(OP_REBUILD_COMMIT, cand.seq,
                       np.asarray([self._epoch, self._step], np.int64),
                       force=True)              # THE atomic commit point
            self._maybe_crash("commit")
            os.replace(
                os.path.join(staging.root, f"step_{self._step:08d}"),
                os.path.join(self.manager.root, f"step_{self._step:08d}"))
            shutil.rmtree(staging.root, ignore_errors=True)
            self._maybe_crash("promote")
            wal.note_durable(cand.seq)
            wal.truncate_upto(cand.seq)
            # the log now starts past the candidate: older snapshots
            # cannot be replayed forward any more
            self.manager._gc()
        elif wal is not None:
            # no snapshot manager: the rebuild cannot be made durable,
            # so close the epoch on the log — a crash after this
            # publish recovers to pre-rebuild centroids + full replay
            wal.append(OP_REBUILD_ABORT, cand.seq,
                       np.asarray([self._epoch, 0], np.int64),
                       force=True)
        cand.wal = wal
        report = RebuildReport(
            epoch=self._epoch, fence_seq=self._fence_seq,
            corpus=int(self._snap_vecs.shape[0]), spilled=self._spilled,
            caught_up=self._caught_up,
            moved=self._count_moved(), step=self._step,
            reason=self._reason)
        if self.registry is not None:
            pub = self.registry.publish(version_of(cand))
            report.published_version = pub.version
        self.live = cand
        self.epochs_published += 1
        self.last_report = report
        self.stage = "idle"
        if self.on_publish is not None:
            self.on_publish(cand, report)

    def _count_moved(self) -> int:
        """Docs whose cluster changed under the new centroids (the
        snapshot portion only).  ``self.live`` still points at the
        pre-publish index here."""
        if self._snap_vecs is None or not self._snap_vecs.shape[0]:
            return 0
        prev = assign_clusters(self._snap_vecs, self.live.index.centroids)
        return int((self._assign != prev).sum())
