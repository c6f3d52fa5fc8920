"""Wave-scheduled serving: per-query early exit turned into batch
throughput (port of ``repro.core.serving``).

The scheduler advances a wave of W lanes by fixed probe chunks, then
*compacts*: exited lanes are refilled with queued queries, so the cost
per query approaches the paper's mean C instead of the batch's max C.
Lane state is a tuple of (W, ...) tensors on the index's device;
admission and the chunk advance are tensor ops there, and the host loop
only moves query ids.  The fused path advances a wave with ONE
``ivf_scan_merge`` launch per chunk, the live index's delta buffer
riding it as its delta stream, and ONE ``slot_roll`` launch.

With a version registry (``repro_torch.index.IndexRegistry``) the
scheduler serves the live index: it adopts the registry's current
version between waves, scrubs tombstoned ids out of running top-k
state, and drains in-flight lanes before adopting a new epoch.  With a
``rebuilder`` (``repro_torch.index.Rebuilder``) it runs one background
rebuild stage between waves.  With a ``deadline_ms`` it budgets every
query from its admission and walks the degradation ladder
(``core.policies.DegradationLadder``) instead of blowing the budget,
and pauses those rebuild ticks while a lane is close to its deadline.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike
from repro_torch.core.ivf import (DeltaView, IVFIndex, _as_queries,
                                  _is_dead, _merge_topk, _probe_rows,
                                  _scrub_dead,
                                  check_same_device, index_device,
                                  intersection_pct, top_k,
                                  validate_alignment)
from repro_torch.core.policies import (RUNG_CAP, RUNG_FORCE, RUNG_NONE,
                                       RUNG_TIGHTEN, DegradationLadder)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.slot_roll import Lanes, slot_step
from repro_torch.trace import span


class LaneState(NamedTuple):
    qvec: torch.Tensor          # (W, d) admitted query vectors
    cluster_rank: torch.Tensor  # (W, N) int64
    h: torch.Tensor             # (W,) int32 per-lane next probe rank
    topk_scores: torch.Tensor   # (W, k)
    topk_ids: torch.Tensor      # (W, k) int32
    patience: torch.Tensor      # (W,) int32
    active: torch.Tensor        # (W,) bool — lane holds a live query
    qid: torch.Tensor           # (W,) int32 external id, -1 empty


def _lanes(st: LaneState) -> Lanes:
    return Lanes(h=st.h, patience=st.patience, active=st.active,
                 topk_scores=st.topk_scores, topk_ids=st.topk_ids)


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
             dead: Optional[torch.Tensor] = None, *,
             lane_delta: torch.Tensor, lane_cap: torch.Tensor, chunk: int,
             k: int, n_probe: int, phi: float,
             use_fused: bool = True) -> LaneState:
    """Advance every active lane by up to ``chunk`` probes.

    ``lane_delta``/``lane_cap`` are per-lane (W,) int32 exit knobs on
    the lanes' device: the patience threshold and the probe budget.
    Without a deadline both are constant (the scheduler's
    ``delta``/``n_probe``); under deadline pressure the degradation
    ladder lowers them per lane, so a struggling lane exits earlier
    while its neighbours run the full policy.  The fused path issues ONE
    ``ivf_scan_merge`` launch for the whole chunk and ONE ``slot_roll``
    launch that rolls lane state forward slot by slot from that kernel's
    per-probe snapshots, so mid-chunk exits land on the exact probe they
    would on the per-probe path.  Its slots are budgeted by ``n_probe``,
    not ``lane_cap``: a capped lane's later slots are scanned and then
    discarded by the slot roll, so fused stays equal to per-probe.  The per-probe path
    runs the kernel pair (``ivf_scan`` + ``topk_merge``; their plain
    versions on the CPU): on the card only the pair scores and ranks in
    the fused kernel's order, so the two paths agree bit for bit there
    too.

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
        return state._replace(**kops.slot_roll(
            snap_s, snap_i, cnts, _lanes(state), lane_delta, lane_cap, k=k,
            chunk=chunk, phi=phi)._asdict())

    st = state
    for _ in range(chunk):
        hv = st.h.clamp(max=n_probe - 1).long()
        cids = torch.gather(st.cluster_rank, 1, hv[:, None])[:, 0]
        _, ids, _ = _probe_rows(index, cids)
        sc = kops.ivf_scan(st.qvec, index.docs, index.cluster_offsets[cids],
                           index.cluster_sizes[cids],
                           list_pad=index.list_pad)
        sc = torch.where(ids >= 0, sc, float("-inf"))
        if dview is not None:
            gate = d_valid & (dview.assign[None, :] == cids[:, None])
            sc = torch.cat([sc, torch.where(gate, d_sc, float("-inf"))], 1)
            ids = torch.cat([ids, torch.where(gate, d_ids, -1)], 1)
        ms, mi = _merge_topk(st.topk_scores, st.topk_ids, sc, ids, k,
                             use_kernel=True)
        ti = torch.where(st.active[:, None], mi, st.topk_ids)
        st = st._replace(**slot_step(
            _lanes(st), ms, mi, intersection_pct(st.topk_ids, ti), phi=phi,
            lane_delta=lane_delta, lane_cap=lane_cap)._asdict())
    return st


#: ordering of degradation reasons — a stronger rung overwrites a weaker
_REASON_RANK = {"tightened_patience": 1, "capped_probes": 2,
                "forced_exit": 3, "shed": 4}


@dataclasses.dataclass
class ServeReport:
    results: Dict[int, np.ndarray]
    probes: Dict[int, int]
    waves: int
    occupancy: float            # mean fraction of busy lanes per wave
    lane_steps: int             # total lane-probe slots spent
    # -- deadline/degradation accounting (empty when deadline_ms unset) --
    degraded: Dict[int, str] = dataclasses.field(default_factory=dict)
    latency_ms: Dict[int, float] = dataclasses.field(default_factory=dict)
    deadline_ms: Optional[float] = None
    # EMA of a wave's host ms, from the clock read after the wave's first
    # device read to the return of _advance and on_wave: the wave's
    # advance on the device is not waited for
    wave_cost_ms: float = 0.0
    # -- background rebuild accounting (zero without a rebuilder) --
    epoch_swaps: int = 0        # higher-epoch versions adopted (drained)
    drain_waves: int = 0        # waves spent draining before a swap
    rebuild_ticks: int = 0      # rebuild stages run between waves
    rebuild_throttled: int = 0  # ticks skipped under deadline pressure
    # -- device-to-host reads (each waits for the device's queued work) --
    host_syncs: int = 0         # reads made
    sync_wait_ms: float = 0.0   # host ms spent in them
    # -- the on_wave hook: host ms spent in it (0.0 without a hook) --
    hook_ms: float = 0.0

    @property
    def degraded_fraction(self) -> float:
        return len(self.degraded) / max(len(self.results), 1)

    def shed_ids(self) -> List[int]:
        return [q for q, r in self.degraded.items() if r == "shed"]


class _HostReads:
    """The device-to-host reads of one ``serve()`` call: each is a
    ``serve.sync`` span, counted, and timed on the host clock (the wait
    for the device's queued work and the copy)."""

    def __init__(self):
        self.count = 0
        self.wait_ms = 0.0

    def __call__(self, t: torch.Tensor) -> np.ndarray:
        with span("serve.sync"):
            t0 = time.perf_counter()
            out = t.cpu().numpy()
            self.wait_ms += 1e3 * (time.perf_counter() - t0)
        self.count += 1
        return out


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
    active.  Every version must lie on the scheduler's device.  The
    scheduler then keeps no index of its own: the one it was built on
    serves only to read the device and the probe budget, so a merge
    that replaces it frees its storage.

    ``rebuilder`` (optional, ``repro_torch.index.Rebuilder``): while it
    is armed, the scheduler runs ONE rebuild pipeline stage after each
    wave — unless the degradation ladder's ``throttle_rebuild`` says a
    lane is too close to its deadline to absorb the stall.
    """

    def __init__(self, index: IVFIndex, *, wave_size: int = 64,
                 chunk: int = 8, k: int = 100, n_probe: int = 80,
                 delta: int = 7, phi: float = 95.0, use_fused: bool = True,
                 registry=None, deadline_ms: Optional[float] = None,
                 ladder: Optional[DegradationLadder] = None,
                 clock: Optional[Callable[[], float]] = None,
                 rebuilder=None, device: DeviceLike = None):
        """``deadline_ms``: per-query latency budget, counted from lane
        admission.  When set, the scheduler walks the
        :class:`repro_torch.core.policies.DegradationLadder` instead of
        blowing the budget: tighten patience -> cap remaining probes ->
        force-exit with the partial top-k -> shed admissions.  Every
        affected query carries a reason in ``ServeReport.degraded``.

        ``clock``: ms-resolution monotonic clock (injectable for
        deterministic tests and the chaos harness); defaults to
        ``time.monotonic() * 1000``.
        """
        self.device = index_device(index, device)
        # both paths read blk_l-aligned lists through the kernels
        validate_alignment(index)
        # with a registry every wave reads its pinned version, and a
        # merge that replaces this index must be able to free it
        self.index = index if registry is None else None
        self.w = wave_size
        self.chunk = chunk
        self.k = k
        self.n = min(n_probe, index.n_clusters)
        self.delta = delta
        self.phi = phi
        self.use_fused = use_fused
        self.registry = registry
        self.deadline_ms = deadline_ms
        self.ladder = ladder or DegradationLadder()
        self._now = clock or (lambda: time.monotonic() * 1000.0)
        self.rebuilder = rebuilder
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

    @staticmethod
    def _flag(degraded: Dict[int, str], qid: int, reason: str) -> None:
        old = degraded.get(qid)
        if old is None or _REASON_RANK[reason] > _REASON_RANK[old]:
            degraded[qid] = reason

    def serve(self, queries, *, compact: bool = True,
              on_wave: Optional[Callable[[int], None]] = None
              ) -> ServeReport:
        """Serve every query; ``on_wave(w)`` runs on the host after wave
        ``w`` (1-based) — the hook a mutation stream publishes from.

        Under a torch profiler the call is a ``serve`` span holding
        ``serve.harvest``, ``serve.admit`` and ``serve.advance`` spans,
        and every device-to-host read is a ``serve.sync`` span
        (``repro_torch.trace``); each ``on_wave`` call is a
        ``serve.hook`` span, and ``ServeReport.hook_ms`` sums its host
        ms."""
        with span("serve"):
            return self._serve(queries, compact, on_wave)

    def _serve(self, queries, compact: bool,
               on_wave: Optional[Callable[[int], None]]) -> ServeReport:
        read = _HostReads()
        queries = _as_queries(queries, self.device)
        nq, d = queries.shape
        state = _empty_state(self.w, d, self.n, self.k, self.device)
        next_q = 0
        results: Dict[int, np.ndarray] = {}
        probes: Dict[int, int] = {}
        degraded: Dict[int, str] = {}
        latency: Dict[int, float] = {}
        waves = 0
        occ = []
        lane_steps = 0
        epoch_swaps = drain_waves = 0
        rebuild_ticks = rebuild_throttled = 0
        prev_active = np.zeros(self.w, bool)
        # qid is constant across an advance: the qids read after
        # admission are the lanes' qids at the next wave's top
        prev_qids = np.full(self.w, -1, np.int32)
        lane_admit = np.zeros(self.w, np.float64)   # admit timestamp, ms
        full_delta = torch.full((self.w,), self.delta, dtype=torch.int32,
                                device=self.device)
        full_cap = torch.full((self.w,), self.n, dtype=torch.int32,
                              device=self.device)
        wave_cost = 0.0                              # EMA of wave ms
        hook_ms = 0.0
        self._pinned = None if self.registry is None \
            else self.registry.current()
        while True:
            with span("serve.harvest"):
                active = read(state.active)
                now = self._now()
                # harvest exits: lanes that flipped active->inactive
                done = np.nonzero(prev_active & ~active)[0]
                if done.size:
                    lanes = torch.as_tensor(done, device=self.device)
                    ids = read(state.topk_ids[lanes])
                    hs = read(state.h[lanes])
                    for j, lane in enumerate(done):
                        qid = int(prev_qids[lane])
                        results[qid] = ids[j]
                        probes[qid] = int(hs[j])
                        latency[qid] = now - lane_admit[lane]
            # epoch-fenced version adoption
            draining, swapped = self._refresh_pin(bool(active.any()))
            epoch_swaps += swapped
            drain_waves += draining
            # degradation ladder (deadline-budgeted serving)
            lane_delta, lane_cap = full_delta, full_cap
            if self.deadline_ms is not None:
                remaining = self.deadline_ms - (now - lane_admit)
                rungs = self.ladder.rungs(remaining, max(wave_cost, 1e-9))
                rungs = np.where(active, rungs, RUNG_NONE)
                if (rungs > RUNG_NONE).any():
                    # one read of h a wave, one of the forced lanes' top-k
                    h_np = read(state.h)
                    force = active & (rungs == RUNG_FORCE)
                    if force.any():
                        lanes = np.nonzero(force)[0]
                        tid = read(state.topk_ids[torch.as_tensor(
                            lanes, device=self.device)])
                        for j, lane in enumerate(lanes):
                            qid = int(prev_qids[lane])
                            results[qid] = tid[j]
                            probes[qid] = int(h_np[lane])
                            latency[qid] = now - lane_admit[lane]
                            self._flag(degraded, qid, "forced_exit")
                        active = active & ~force
                        state = state._replace(active=torch.as_tensor(
                            active, device=self.device))
                    for lane in np.nonzero(active
                                           & (rungs >= RUNG_TIGHTEN))[0]:
                        self._flag(degraded, int(prev_qids[lane]),
                                   "capped_probes" if rungs[lane] >= RUNG_CAP
                                   else "tightened_patience")
                    afford = np.floor(
                        np.maximum(remaining, 0.0)
                        / max(wave_cost, 1e-9)).astype(np.int64) \
                        * self.chunk
                    cap_np = np.where(rungs >= RUNG_CAP, h_np + afford,
                                      self.n)
                    cap_np = np.minimum(cap_np, self.n).astype(np.int32)
                    tight = min(self.ladder.tight_delta, self.delta)
                    delta_np = np.where(rungs >= RUNG_TIGHTEN, tight,
                                        self.delta).astype(np.int32)
                    lane_delta = torch.as_tensor(delta_np,
                                                 device=self.device)
                    lane_cap = torch.as_tensor(cap_np, device=self.device)
            index, dview, dead = self._version()
            # admission (with overload shedding)
            if (compact or not active.any()) and not draining \
                    and next_q < nq and (~active).any():
                room = int((~active).sum())
                if self.deadline_ms is not None \
                        and wave_cost > self.deadline_ms:
                    # even a fresh query cannot meet the deadline: shed
                    # instead of admitting to certain death
                    for qid in range(next_q, min(nq, next_q + room)):
                        results[qid] = np.full(self.k, -1, np.int32)
                        probes[qid] = 0
                        latency[qid] = 0.0
                        self._flag(degraded, qid, "shed")
                    next_q = min(nq, next_q + room)
                else:
                    with span("serve.admit"):
                        batch = queries[next_q: next_q + room]
                        qids = torch.arange(next_q,
                                            next_q + batch.shape[0],
                                            dtype=torch.int32,
                                            device=self.device)
                        # admissions rank clusters against the epoch
                        # they probe
                        before = active
                        state = _admit(state, index.centroids, batch,
                                       qids, self.n)
                        next_q += batch.shape[0]
                        active = read(state.active)
                        lane_admit[active & ~before] = now
            if not active.any() and next_q >= nq:
                break
            occ.append(active.mean())
            lane_steps += self.w * self.chunk
            prev_active = active
            prev_qids = read(state.qid)
            with span("serve.advance"):
                state = _advance(index, state, dview, dead,
                                 lane_delta=lane_delta, lane_cap=lane_cap,
                                 chunk=self.chunk, k=self.k,
                                 n_probe=self.n, phi=self.phi,
                                 use_fused=self.use_fused)
            waves += 1
            if on_wave is not None:
                t_hook = time.perf_counter()
                with span("serve.hook"):
                    on_wave(waves)
                hook_ms += 1e3 * (time.perf_counter() - t_hook)
            sample = self._now() - now
            wave_cost = sample if waves == 1 \
                else 0.5 * wave_cost + 0.5 * sample
            # background rebuild tick (throttled under pressure), after
            # the wave-cost sample so the stall never inflates the EMA
            # the ladder budgets against
            if self.rebuilder is not None and self.rebuilder.active:
                throttle = False
                if self.deadline_ms is not None:
                    act_now = read(state.active)
                    rem = (self.deadline_ms
                           - (self._now() - lane_admit))[act_now]
                    throttle = self.ladder.throttle_rebuild(
                        rem, max(wave_cost, 1e-9))
                if throttle:
                    rebuild_throttled += 1
                else:
                    self.rebuilder.tick()
                    rebuild_ticks += 1
        return ServeReport(results, probes, waves,
                           float(np.mean(occ)) if occ else 0.0, lane_steps,
                           degraded=degraded, latency_ms=latency,
                           deadline_ms=self.deadline_ms,
                           wave_cost_ms=wave_cost, epoch_swaps=epoch_swaps,
                           drain_waves=drain_waves,
                           rebuild_ticks=rebuild_ticks,
                           rebuild_throttled=rebuild_throttled,
                           host_syncs=read.count,
                           sync_wait_ms=read.wait_ms, hook_ms=hook_ms)
