"""LiveIndex: streaming mutations over a frozen cluster-major IVF index
(port of ``repro.index.live``).

Write path (host-coordinated, cheap):
  * ``add``    -> vectors land in the :class:`DeltaBuffer` on the
                  index's device, pre-assigned to their nearest centroid.
  * ``delete`` -> main-index docs get their stored id burned to -1
                  (the tombstone every scan path masks) in a copy of the
                  id column; buffered docs get their slot cleared.  The
                  external id is recorded in the cumulative
                  :class:`Tombstones` set.
  * ``merge_delta`` -> compaction: re-layout the net corpus (survivors +
                  buffered adds) into a fresh ``IVFIndex`` with the SAME
                  centroids, on the device, respecting the ``align``
                  padding contract.  Entries that would overflow a full
                  list spill back into the buffer.

Read path: ``live.search(...)`` == ``core.search(index, ..., delta=
view)``, bit-identical to a freshly rebuilt index holding the net
corpus (``rebuild_equivalent``) for every exit policy on every path.
Centroids never change under mutation within an *epoch*, which keeps
probe order — and mid-flight lane state — valid across ``merge_delta``
version swaps.  Only a background re-clustering
(``repro_torch.index.rebuild``) retrains them, bumping ``epoch``.

With a mutation WAL (``wal=``, :class:`repro_torch.index.wal.MutationWAL`)
every mutation appends one record *before* any state changes, its
arguments validated first so a logged record always replays; the WAL
bytes are the reference's (an add logs its host f32 vectors).

The host keeps an id -> row ``int64`` array (-1 for "absent") in place
of the reference's dict, for ``delete``; everything that walks the
index's rows (``merge_delta``, the oracles) runs on the device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.ivf import (DeltaView, IVFIndex, check_same_device,
                                  search as core_search,
                                  validate_alignment)
from repro_torch.index.delta import (DeltaBuffer, Tombstones, _on,
                                     assign_clusters)
from repro_torch.index.wal import OP_ADD, OP_DELETE, OP_MERGE
from repro_torch.trace import span


#: rows a re-layout moves at a time: beside the old and the new index a
#: merge holds one such chunk of vectors (2^18 x 768 x 4 B = 0.8 GB)
RELAYOUT_CHUNK_ROWS = 1 << 18


class Rows(NamedTuple):
    """Rows ``at`` of the tables ``vecs`` and ``ids`` (every row where
    ``at`` is None), in that order: one source of a re-layout's input,
    read by index so that it is never gathered whole."""
    vecs: torch.Tensor
    ids: torch.Tensor
    at: Optional[torch.Tensor] = None

    def __len__(self) -> int:
        return self.vecs.shape[0] if self.at is None else self.at.numel()

    def take(self, table: torch.Tensor, s: int, e: int) -> torch.Tensor:
        """Input rows ``s:e`` of this source, read from ``table`` (its
        ``vecs`` or its ``ids``)."""
        if self.at is None:
            return table[s:e]
        return table.index_select(0, self.at[s:e])


def relayout(vecs, ids, assign, centroids, *, list_pad: int,
             align: int = 64, round_total_to: Optional[int] = None,
             device: DeviceLike = None) -> IVFIndex:
    """Cluster-major re-layout of an already-assigned corpus, on the
    centroids' device (a tensor's own device, else ``device``).

    Same physical format as ``build_index`` (``align``-aligned list
    offsets, ``list_pad`` slack tail) but with fixed centroids and
    caller-provided assignments — the primitive under ``merge_delta``
    and the rebuild-equivalence oracle.  The within-cluster order of
    the input is preserved (stable sort), so ties resolve like the
    insertion order the live overlay sees.  ``round_total_to`` pads the
    total row count up to a multiple.  Rows are moved, never rescored:
    a stable sort of the assignments on the device gives each row its
    destination.

    The input is ``vecs`` and ``ids``, or, with ``ids`` None, the
    concatenation of the :class:`Rows` sources that ``vecs`` lists,
    each read by index where it lies (``merge_delta`` lays out the old
    index's survivors and the buffer's merged slots so).  Rows move
    ``RELAYOUT_CHUNK_ROWS`` at a time: beside the new index a re-layout
    holds one chunk of vectors and a few int64 columns of the input's
    length.
    """
    if align <= 0:
        raise ValueError(f"align must be positive, got {align}")
    if list_pad % align:
        raise ValueError(
            f"list_pad={list_pad} must be a multiple of align={align}")
    if isinstance(centroids, torch.Tensor):
        dev = centroids.device
        if device is not None:
            check_same_device(torch.device(device), "the centroids",
                              centroids)
    else:
        dev = resolve_device(device)
    centroids = _on(dev, centroids, torch.float32, "centroids")
    if ids is None:
        sources = list(vecs)
        check_same_device(dev, "a re-layout's source",
                          *(t for src in sources for t in src
                            if t is not None))
    else:
        sources = [Rows(_on(dev, vecs, torch.float32, "vecs"),
                        _on(dev, ids, torch.int32, "ids"))]
    assign = _on(dev, assign, torch.int64, "assign")
    n = sum(len(src) for src in sources)
    if n != assign.numel():
        raise ValueError(f"{n} input rows but {assign.numel()} "
                         f"assignments")
    c, d = centroids.shape
    sizes_t = torch.bincount(assign, minlength=c)
    sizes = sizes_t.cpu().numpy().astype(np.int32)
    over = np.nonzero(sizes > list_pad)[0]
    if over.size:
        raise ValueError(
            f"cluster {int(over[0])} would hold {int(sizes[over[0]])} "
            f"docs > list_pad={list_pad}; spill the overflow back to "
            f"the delta buffer (merge_delta does) or rebuild offline")
    aligned = ((sizes + align - 1) // align) * align
    offsets = np.zeros(c, np.int32)
    offsets[1:] = np.cumsum(aligned)[:-1].astype(np.int32)
    total = int(aligned.sum()) + list_pad
    if round_total_to:
        total = -(-total // round_total_to) * round_total_to
    offsets_t = torch.as_tensor(offsets, device=dev)
    # row of each input: its list's offset plus its rank inside the list
    order = torch.sort(assign, stable=True).indices
    starts = torch.cumsum(sizes_t, 0) - sizes_t
    dst = torch.empty_like(order)
    dst[order] = torch.arange(order.numel(), device=dev) \
        - starts[assign[order]]
    dst += offsets_t[assign]
    sorted_docs = torch.zeros((total, d), dtype=torch.float32, device=dev)
    sorted_ids = torch.full((total,), -1, dtype=torch.int32, device=dev)
    first, step = 0, RELAYOUT_CHUNK_ROWS
    for src in sources:
        for s in range(0, len(src), step):
            e = min(len(src), s + step)
            to = dst[first + s: first + e]
            # each chunk is freed as its copy returns: one at a time
            sorted_docs.index_copy_(
                0, to, src.take(src.vecs, s, e).to(torch.float32))
            sorted_ids.index_copy_(
                0, to, src.take(src.ids, s, e).to(torch.int32))
        first += len(src)
    return IVFIndex(centroids, sorted_docs, sorted_ids, offsets_t,
                    torch.as_tensor(sizes, device=dev), list_pad)


class LiveIndex:
    """Mutable front over an immutable IVFIndex + delta + tombstones, all
    on the index's device."""

    def __init__(self, index: IVFIndex, *, delta_cap: int = 1024,
                 align: int = 64, round_total_to: int = 4096, wal=None):
        validate_alignment(index, blk_l=align)
        self.index = index
        self.device = index.docs.device
        self.align = align
        self.round_total_to = round_total_to
        self._refresh_mirrors()
        self.next_id = self._row_of.size       # largest stored id + 1
        self.delta = DeltaBuffer(index.dim, delta_cap, device=self.device)
        self.tombs = Tombstones(self.next_id, device=self.device)
        self.version = 0                 # bumped by merge_delta
        self.seq = 0                     # bumped by every mutation
        self.epoch = 0                   # bumped by a rebuild publish
        self.wal = wal
        self._replaying = False

    @classmethod
    def from_version(cls, ver, *, align: int = 64,
                     round_total_to: int = 4096, wal=None) -> "LiveIndex":
        """A LiveIndex from a published snapshot
        (:class:`repro_torch.index.registry.IndexVersion`).  The delta
        buffer and tombstone set are rebuilt slot for slot, so replaying
        the same mutations yields the same state as the original."""
        self = cls.__new__(cls)
        self.index = ver.index
        self.device = ver.index.docs.device
        self.align = align
        self.round_total_to = round_total_to
        self._refresh_mirrors()
        self.next_id = int(ver.next_id)
        dvecs, dids, dassign = ver.delta
        buf = DeltaBuffer(dvecs.shape[1], dvecs.shape[0], device=self.device)
        buf.vecs[: dvecs.shape[0]] = dvecs
        buf.ids[: dids.shape[0]] = dids
        buf.assign[: dassign.shape[0]] = dassign
        # assign >= 0 marks every consumed slot (delete burns only the
        # id; compact_keep resets assign) -> append pointer position
        buf.count = int((dassign >= 0).sum())
        buf._slot_of = {i: s for s, i in enumerate(dids.tolist()) if i >= 0}
        self.delta = buf
        dead = ver.dead.cpu().numpy()
        tombs = Tombstones(dead.shape[0], device=self.device)
        tombs._dead[: dead.shape[0]] = dead
        tombs.count = int(dead.sum())
        self.tombs = tombs
        self.version = int(ver.merges)
        self.seq = int(ver.seq) if ver.seq >= 0 else int(ver.version)
        self.epoch = int(ver.epoch)
        self.wal = wal
        self._replaying = False
        return self

    def _log(self, op: int, payload: Optional[np.ndarray] = None) -> None:
        if self.wal is not None and not self._replaying:
            # merge is a compaction boundary: force the group-commit
            # batch to disk before the re-layout runs
            self.wal.append(op, self.seq + 1, payload,
                            force=(op == OP_MERGE))

    # -- host mirror and the layout ------------------------------------------
    def _refresh_mirrors(self) -> None:
        doc_ids = self.index.doc_ids.cpu().numpy()
        rows = np.nonzero(doc_ids >= 0)[0]
        self._row_of = np.full(int(doc_ids.max(initial=-1)) + 1, -1,
                               np.int64)
        self._row_of[doc_ids[rows]] = rows
        self._n_main = rows.size

    def _main_rows(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows, clusters) of the live main docs, in row order, on the
        device.  Row -> cluster comes from the layout (offsets are
        sorted; empty clusters share the next offset and own no rows)."""
        rows = torch.nonzero(self.index.doc_ids >= 0).flatten()
        clusters = torch.searchsorted(self.index.cluster_offsets.long(),
                                      rows, right=True) - 1
        return rows, clusters

    # -- mutations ----------------------------------------------------------
    @property
    def n_live(self) -> int:
        return self._n_main + len(self.delta)

    def add(self, vecs) -> np.ndarray:
        """Stage new vectors; returns their external doc ids.
        Raises :class:`DeltaFull` when the buffer is out of slots.
        A ``live.add`` span under a profiler."""
        with span("live.add"):
            return self._add(vecs)

    def _add(self, vecs) -> np.ndarray:
        host = None
        if not isinstance(vecs, torch.Tensor):
            # a host payload is logged as given (the reference's bytes)
            host = np.asarray(vecs, np.float32).reshape(-1, self.index.dim)
            vecs = host
        vecs = _on(self.device, vecs, torch.float32, "vecs") \
            .reshape(-1, self.index.dim)
        m = vecs.shape[0]
        self.delta.ensure_room(m)        # validate BEFORE logging
        if self.wal is not None and not self._replaying:
            self._log(OP_ADD, host if host is not None
                      else vecs.cpu().numpy())
        ids = np.arange(self.next_id, self.next_id + m, dtype=np.int32)
        self.delta.add(vecs, ids, assign_clusters(vecs, self.index.centroids))
        self.next_id += m
        self.tombs.ensure_capacity(self.next_id)
        self.seq += 1
        return ids

    def delete(self, ids) -> None:
        """Tombstone documents by external id (idempotent).  A
        ``live.delete`` span under a profiler."""
        with span("live.delete"):
            self._delete(ids)

    def _delete(self, ids) -> None:
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        bad = ids[(ids < 0) | (ids >= self.next_id)]
        if bad.size:
            raise ValueError(f"doc id {int(bad[0])} was never allocated")
        self._log(OP_DELETE, ids)
        burn_rows = []
        for i in ids.tolist():
            if i in self.tombs:
                continue
            self.tombs.add((i,))
            if not self.delta.delete(i):
                burn_rows.append(int(self._row_of[i]))
                self._row_of[i] = -1
        if burn_rows:
            rows = np.asarray(burn_rows)
            self._n_main -= rows.size
            # a copy of the id column: published versions keep theirs
            doc_ids = self.index.doc_ids.clone()
            doc_ids[torch.as_tensor(rows, device=self.device)] = -1
            self.index = dataclasses.replace(self.index, doc_ids=doc_ids)
        self.seq += 1

    def merge_delta(self) -> int:
        """Fold the delta buffer into a fresh immutable main index.

        Buffered entries are appended to their assigned cluster's list
        after the surviving docs; entries that would push a list past
        ``list_pad`` spill back into the buffer (the newest of a
        cluster first).  Returns the new version number.

        The new layout is written straight from the old index's
        surviving rows and the merged slots (:class:`Rows` sources of
        :func:`relayout`), so a merge holds the old index, the new one
        and one chunk of rows.  Under a profiler it is a ``live.merge``
        span holding ``live.merge.layout`` (the re-layout) and
        ``live.merge.mirrors`` (the host's id -> row array).
        """
        with span("live.merge"):
            return self._merge_delta()

    def _merge_delta(self) -> int:
        self._log(OP_MERGE)
        lp = self.index.list_pad
        rows, assign_main = self._main_rows()
        fill = torch.bincount(assign_main, minlength=self.index.n_clusters
                              ).cpu().numpy()
        slots = self.delta.live_slots()
        cl = self.delta.assign.cpu().numpy()[slots]
        # entries of a cluster are taken in insertion order until its
        # list is full: the first lp - fill of them
        order = np.argsort(cl, kind="stable")
        first = np.searchsorted(cl[order], cl[order], side="left")
        rank = np.empty(cl.size, np.int64)
        rank[order] = np.arange(cl.size) - first
        take = rank < lp - fill[cl]
        merged = torch.as_tensor(slots[take], device=self.device)
        with span("live.merge.layout"):
            self.index = relayout(
                self._sources(rows, merged), None,
                torch.cat([assign_main, self.delta.assign[merged].long()]),
                self.index.centroids, list_pad=lp, align=self.align,
                round_total_to=self.round_total_to)
        self.delta.compact_keep(slots[~take])
        with span("live.merge.mirrors"):
            self._refresh_mirrors()
        self.version += 1
        self.seq += 1
        return self.version

    def _sources(self, rows: torch.Tensor, slots: torch.Tensor
                 ) -> Tuple[Rows, Rows]:
        """The main index's ``rows``, then the buffer's ``slots``: a
        re-layout's input, read where it lies."""
        return (Rows(self.index.docs, self.index.doc_ids, rows),
                Rows(self.delta.vecs, self.delta.ids, slots))

    # -- read path ----------------------------------------------------------
    def delta_view(self) -> DeltaView:
        return self.delta.view()

    def dead_lookup(self) -> torch.Tensor:
        return self.tombs.lookup()

    def search(self, queries, policy, **kwargs):
        """Adaptive search over (main index + delta + tombstones)."""
        return core_search(self.index, queries, policy,
                           delta=self.delta_view(), **kwargs)

    # -- oracles (tests / offline maintenance) ------------------------------
    def net_corpus(self) -> Tuple[torch.Tensor, np.ndarray]:
        """(vecs on the device, external ids) of every live doc: main
        survivors in id order, then buffered adds in insertion order."""
        rows, _ = self._main_rows()
        rows = rows[torch.sort(self.index.doc_ids[rows], stable=True).indices]
        slots = torch.as_tensor(self.delta.live_slots(), device=self.device)
        vecs = torch.cat([self.index.docs[rows], self.delta.vecs[slots]])
        ids = torch.cat([self.index.doc_ids[rows], self.delta.ids[slots]])
        return vecs, ids.cpu().numpy()

    def rebuild_equivalent(self) -> IVFIndex:
        """Fresh from-scratch re-layout of the net corpus with the same
        centroids: the rebuild-equivalence oracle.  Searching it must be
        bit-identical to the live overlay view for every policy."""
        rows, assign_main = self._main_rows()
        slots = torch.as_tensor(self.delta.live_slots(), device=self.device)
        assign = torch.cat([assign_main, self.delta.assign[slots].long()])
        # spilled entries can push a logical cluster past list_pad (that
        # is what spilling is for); the oracle grows the tile so the
        # rebuilt index can hold them.  Extra rows are masked padding,
        # so per-probe candidate sets — and results — are unchanged.
        sizes = torch.bincount(assign, minlength=self.index.n_clusters)
        biggest = int(sizes.max()) if sizes.numel() else 0
        lp = max(self.index.list_pad,
                 -(-biggest // self.align) * self.align)
        return relayout(self._sources(rows, slots), None, assign,
                        self.index.centroids, list_pad=lp, align=self.align)
