"""Wave-scheduled serving: per-query early exit turned into batch
throughput (port of ``repro.core.serving``).

The scheduler advances a wave of W lanes by fixed probe chunks, then
*compacts*: exited lanes are refilled with queued queries, so the cost
per query approaches the paper's mean C instead of the batch's max C.
Lane state is a tuple of (W, ...) tensors on the index's device;
admission and the chunk advance are tensor ops there, and the host loop
only moves query ids.  The fused path advances a wave with ONE
``ivf_scan_merge`` launch per chunk, the live index's delta buffer
riding it as its delta stream.

With a version registry (``repro_torch.index.IndexRegistry``) the
scheduler serves the live index: it adopts the registry's current
version between waves, scrubs tombstoned ids out of running top-k
state, and drains in-flight lanes before adopting a new epoch.
Deadlines (the degradation ladder) and background rebuilds come with
the serving and durability slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike
from repro_torch.core.ivf import (DeltaView, IVFIndex, _as_queries,
                                  _is_dead, _merge_topk, _probe_rows,
                                  _scrub_dead,
                                  check_same_device, index_device,
                                  intersection_pct, top_k,
                                  validate_alignment)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ivf_scan import score_rows


class LaneState(NamedTuple):
    qvec: torch.Tensor          # (W, d) admitted query vectors
    cluster_rank: torch.Tensor  # (W, N) int64
    h: torch.Tensor             # (W,) int32 per-lane next probe rank
    topk_scores: torch.Tensor   # (W, k)
    topk_ids: torch.Tensor      # (W, k) int32
    patience: torch.Tensor      # (W,) int32
    active: torch.Tensor        # (W,) bool — lane holds a live query
    qid: torch.Tensor           # (W,) int32 external id, -1 empty


def _empty_state(w: int, d: int, n: int, k: int,
                 device: torch.device) -> LaneState:
    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)
    return LaneState(
        qvec=full((w, d), 0.0, torch.float32),
        cluster_rank=full((w, n), 0, torch.int64),
        h=full((w,), 0, torch.int32),
        topk_scores=full((w, k), float("-inf"), torch.float32),
        topk_ids=full((w, k), -1, torch.int32),
        patience=full((w,), 0, torch.int32),
        active=full((w,), False, torch.bool),
        qid=full((w,), -1, torch.int32))


def _admit(state: LaneState, centroids: torch.Tensor, new_q: torch.Tensor,
           new_qid: torch.Tensor, n_probe: int) -> LaneState:
    """Fill empty lanes with up to len(new_q) queries (vectorised)."""
    free = ~state.active                                  # (W,)
    # slot j of new_q goes to the j-th free lane
    free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    take = free & (free_rank < new_q.shape[0])
    src = free_rank.clamp(0, new_q.shape[0] - 1).long()
    _, rank = top_k(new_q @ centroids.T, n_probe)

    def fill(old, new_full):
        m = take.reshape((-1,) + (1,) * (old.dim() - 1))
        return torch.where(m, new_full[src], old)

    return LaneState(
        qvec=fill(state.qvec, new_q),
        cluster_rank=fill(state.cluster_rank, rank.long()),
        h=torch.where(take, 0, state.h),
        topk_scores=torch.where(take[:, None], float("-inf"),
                                state.topk_scores),
        topk_ids=torch.where(take[:, None], -1, state.topk_ids),
        patience=torch.where(take, 0, state.patience),
        active=state.active | take,
        qid=torch.where(take, new_qid[src], state.qid))


def _advance(index: IVFIndex, state: LaneState,
             dview: Optional[DeltaView] = None,
             dead: Optional[torch.Tensor] = None, *, lane_delta: int,
             lane_cap: int, chunk: int, k: int, n_probe: int, phi: float,
             use_fused: bool = True) -> LaneState:
    """Advance every active lane by up to ``chunk`` probes.

    ``lane_delta``/``lane_cap`` are the exit knobs — the patience
    threshold and the probe budget.  (The reference takes them per lane
    for its deadline ladder, which comes with the serving slice.)  The
    fused path issues ONE ``ivf_scan_merge`` launch
    for the whole chunk and rolls lane state forward slot by slot from
    the kernel's per-probe snapshots, so mid-chunk exits land on the
    exact probe they would on the per-probe path.

    ``dview``/``dead`` (live index, ``repro_torch.index``): delta
    entries are scored once per wave — inside the fused kernel, or by
    ``delta_scan`` on the per-probe path — and merged into a lane's
    running top-k at the probe of their assigned cluster (the rule of
    ``core.search``); ``dead`` is the cumulative tombstone lookup,
    scrubbing running top-k entries deleted after they were merged,
    which lanes that span a version swap need.
    """
    if dead is not None:
        # scrub once per wave: a lane's carry may predate a deletion
        ts0, ti0 = _scrub_dead(state.topk_scores, state.topk_ids, dead)
        state = state._replace(topk_scores=ts0, topk_ids=ti0)

    if dview is not None:
        # burn tombstoned buffer entries to id -1 up front: both paths
        # then mask them exactly like empty slots
        d_ids_eff = dview.ids if dead is None \
            else torch.where(_is_dead(dview.ids, dead), -1, dview.ids)
        if not use_fused:
            d_sc = kops.delta_scan(state.qvec, dview.vecs)    # (W, cap)
            d_valid = (d_ids_eff >= 0)[None, :]
            d_ids = d_ids_eff[None, :].expand(d_sc.shape[0], -1)

    def slot(st: LaneState, ms, mi, phi_v) -> LaneState:
        act = st.active[:, None]
        ts = torch.where(act, ms, st.topk_scores)
        ti = torch.where(act, mi, st.topk_ids)
        ctr = torch.where(st.active & (st.h >= 1) & (phi_v >= phi),
                          st.patience + 1, 0)
        h = torch.where(st.active, st.h + 1, st.h)
        exited = st.active & ((ctr >= lane_delta) | (h >= lane_cap))
        return st._replace(h=h, topk_scores=ts, topk_ids=ti, patience=ctr,
                           active=st.active & ~exited)

    if use_fused:
        rel = torch.arange(chunk, device=state.h.device)[None, :]
        idx = (state.h[:, None] + rel).clamp(0, n_probe - 1)
        cids = torch.gather(state.cluster_rank, 1, idx.long())
        # inactive lanes and slots past the probe budget merge nothing
        slot_ok = ((state.h[:, None] + rel) < n_probe) \
            & state.active[:, None]
        sizes = torch.where(slot_ok, index.cluster_sizes[cids], 0)
        # the delta buffer rides the kernel as its delta stream, gated
        # per slot on the assigned cluster (see core.ivf.search)
        dargs = () if dview is None else (
            dview.vecs, d_ids_eff, dview.assign,
            torch.where(slot_ok, cids, -2))
        snap_s, snap_i, cnts = kops.ivf_scan_merge(
            state.qvec, index.docs, index.doc_ids,
            index.cluster_offsets[cids], sizes, state.topk_scores,
            state.topk_ids, *dargs, k=k, list_pad=index.list_pad,
            chunk=chunk)
        st = state
        for t in range(chunk):
            phi_v = 100.0 * (k - cnts[:, t]).to(torch.float32) / k
            st = slot(st, snap_s[:, t], snap_i[:, t], phi_v)
        return st

    st = state
    for _ in range(chunk):
        hv = st.h.clamp(max=n_probe - 1).long()
        cids = torch.gather(st.cluster_rank, 1, hv[:, None])[:, 0]
        rows, ids, mask = _probe_rows(index, cids)
        sc = torch.where(mask, score_rows(st.qvec, index.docs, rows),
                         float("-inf"))
        if dview is not None:
            gate = d_valid & (dview.assign[None, :] == cids[:, None])
            sc = torch.cat([sc, torch.where(gate, d_sc, float("-inf"))], 1)
            ids = torch.cat([ids, torch.where(gate, d_ids, -1)], 1)
        ms, mi = _merge_topk(st.topk_scores, st.topk_ids, sc, ids, k)
        ti = torch.where(st.active[:, None], mi, st.topk_ids)
        st = slot(st, ms, mi, intersection_pct(st.topk_ids, ti))
    return st


@dataclasses.dataclass
class ServeReport:
    results: Dict[int, np.ndarray]
    probes: Dict[int, int]
    waves: int
    occupancy: float            # mean fraction of busy lanes per wave
    lane_steps: int             # total lane-probe slots spent
    epoch_swaps: int = 0        # higher-epoch versions adopted (drained)
    drain_waves: int = 0        # waves spent draining before a swap


class WaveScheduler:
    """Throughput-oriented serving loop over the adaptive search, on the
    index's device (a ``device`` that names another raises; the index
    is never copied).

    ``registry`` (optional, ``repro_torch.index.IndexRegistry``):
    between waves the scheduler re-reads ``registry.current()`` and
    advances against that version's (index, delta view, tombstones) — an
    atomic swap point.  Mid-flight lanes stay correct across swaps:
    probes already taken saw buffered docs through the delta overlay,
    probes still to come see them inside the merged lists (centroids are
    fixed under mutation, so each lane's cluster_rank stays valid), and
    the per-wave tombstone scrub evicts results deleted after they were
    merged.  A version of a HIGHER epoch carries other centroids, so the
    scheduler drains: it keeps the pinned version, stops admitting,
    finishes in-flight lanes, and adopts the new epoch once no lane is
    active.  Every version must lie on the scheduler's device.
    """

    def __init__(self, index: IVFIndex, *, wave_size: int = 64,
                 chunk: int = 8, k: int = 100, n_probe: int = 80,
                 delta: int = 7, phi: float = 95.0, use_fused: bool = True,
                 registry=None, device: DeviceLike = None):
        self.device = index_device(index, device)
        if use_fused:
            validate_alignment(index)
        self.index = index
        self.w = wave_size
        self.chunk = chunk
        self.k = k
        self.n = min(n_probe, index.n_clusters)
        self.delta = delta
        self.phi = phi
        self.use_fused = use_fused
        self.registry = registry
        self._pinned = None        # version lanes are probing against

    def _refresh_pin(self, active_any: bool) -> Tuple[bool, bool]:
        """Adopt the registry's current version if lanes allow it.

        Same-epoch updates (merge_delta, mutations) adopt at once — the
        wave-granular swap mid-flight lanes tolerate.  A higher-epoch
        version only lands once no lane is active; until then the
        scheduler reports *drain* and the caller stops admitting.
        Returns ``(draining, swapped)``.
        """
        if self.registry is None:
            return False, False
        cur = self.registry.current()
        if cur.epoch == self._pinned.epoch:
            self._pinned = cur
            return False, False
        if active_any:
            return True, False     # drain: finish lanes on the old epoch
        self._pinned = cur
        return False, True

    def _version(self):
        if self.registry is None:
            return self.index, None, None
        ver = self._pinned
        check_same_device(self.device, "a published version",
                          ver.index.docs)
        return ver.index, ver.delta, ver.dead

    def serve(self, queries, *, compact: bool = True,
              on_wave: Optional[Callable[[int], None]] = None
              ) -> ServeReport:
        """Serve every query; ``on_wave(w)`` runs on the host after wave
        ``w`` (1-based) — the hook a mutation stream publishes from."""
        queries = _as_queries(queries, self.device)
        nq, d = queries.shape
        state = _empty_state(self.w, d, self.n, self.k, self.device)
        next_q = 0
        results: Dict[int, np.ndarray] = {}
        probes: Dict[int, int] = {}
        waves = 0
        occ = []
        lane_steps = 0
        epoch_swaps = drain_waves = 0
        prev_active = np.zeros(self.w, bool)
        prev_qids = np.full(self.w, -1, np.int32)
        self._pinned = None if self.registry is None \
            else self.registry.current()
        while True:
            active = state.active.cpu().numpy()
            # harvest exits: lanes that flipped active->inactive
            done = np.nonzero(prev_active & ~active)[0]
            if done.size:
                lanes = torch.as_tensor(done, device=self.device)
                ids = state.topk_ids[lanes].cpu().numpy()
                hs = state.h[lanes].cpu().numpy()
                for j, lane in enumerate(done):
                    qid = int(prev_qids[lane])
                    results[qid] = ids[j]
                    probes[qid] = int(hs[j])
            # epoch-fenced version adoption
            draining, swapped = self._refresh_pin(bool(active.any()))
            epoch_swaps += swapped
            drain_waves += draining
            index, dview, dead = self._version()
            if (compact or not active.any()) and not draining \
                    and next_q < nq and (~active).any():
                room = int((~active).sum())
                batch = queries[next_q: next_q + room]
                qids = torch.arange(next_q, next_q + batch.shape[0],
                                    dtype=torch.int32, device=self.device)
                # admissions rank clusters against the epoch they probe
                state = _admit(state, index.centroids, batch, qids, self.n)
                next_q += batch.shape[0]
                active = state.active.cpu().numpy()
            if not active.any() and next_q >= nq:
                break
            occ.append(active.mean())
            lane_steps += self.w * self.chunk
            prev_active = active
            prev_qids = state.qid.cpu().numpy()
            state = _advance(index, state, dview, dead,
                             lane_delta=self.delta, lane_cap=self.n,
                             chunk=self.chunk, k=self.k, n_probe=self.n,
                             phi=self.phi, use_fused=self.use_fused)
            waves += 1
            if on_wave is not None:
                on_wave(waves)
        return ServeReport(results, probes, waves,
                           float(np.mean(occ)) if occ else 0.0, lane_steps,
                           epoch_swaps=epoch_swaps, drain_waves=drain_waves)
