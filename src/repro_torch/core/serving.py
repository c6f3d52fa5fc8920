"""Wave-scheduled serving: per-query early exit turned into batch
throughput (port of ``repro.core.serving``).

The scheduler advances a wave of W lanes by fixed probe chunks, then
*compacts*: exited lanes are refilled with queued queries, so the cost
per query approaches the paper's mean C instead of the batch's max C.
Lane state is a tuple of (W, ...) tensors on the index's device;
admission and the chunk advance are tensor ops there, and the host loop
only moves query ids: it blocks once a wave, on the lanes' ``active``
mask, derives admission from its own copy of the lanes, and records a
wave's exits while the card runs the next advance.  The fused path
advances a wave with ONE ``ivf_scan_merge`` launch per chunk, the live
index's delta buffer riding it as its delta stream, and ONE
``slot_roll`` launch.

With a version registry (``repro_torch.index.IndexRegistry``) the
scheduler serves the live index: it adopts the registry's current
version between waves, scrubs tombstoned ids out of running top-k
state, and drains in-flight lanes before adopting a new epoch.  With a
``rebuilder`` (``repro_torch.index.Rebuilder``) it runs one background
rebuild stage between waves.  With a ``deadline_ms`` it budgets every
query from its admission and walks the degradation ladder
(``core.policies.DegradationLadder``) instead of blowing the budget,
and pauses those rebuild ticks while a lane is close to its deadline.

With a learned ``policy`` (``core.policies.classifier`` or
``cascade_patience``) the scheduler serves the paper's cascade: each
lane records what the Table-1 features read as its waves go, and the
wave in which a lane reaches probe ``tau`` walks the Exit/Continue
trees on that slot's snapshot (the stage ``core.ivf.search`` runs, on
the same bits), capping the lanes they exit at ``tau``; patience stops
the rest, never before ``tau``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike
from repro_torch.core.ivf import (DeltaView, IVFIndex, as_queries,
                                  centroid_rank, check_same_device,
                                  index_device, intersection_pct,
                                  merge_topk, probe_candidates,
                                  scan_merge_chunk, scrub_dead,
                                  validate_alignment)
from repro_torch.core.policies import (RUNG_CAP, RUNG_FORCE, RUNG_NONE,
                                       RUNG_TIGHTEN, DegradationLadder,
                                       Policy)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.slot_roll import Lanes, slot_step
from repro_torch.kernels.tau_stage import check_trees
from repro_torch.trace import span


class TauLanes(NamedTuple):
    """What a learned policy's stage at probe ``tau`` reads of a lane
    besides its query and top-k (``core.features.FeatureExtras``),
    recorded as its waves go, and the call's counts of the stage."""
    centroid_sims: torch.Tensor  # (W, tau) f32 sims in probe order
    rs1_ids: torch.Tensor        # (W, k) int32 top-k after probe 1
    phi_hist: torch.Tensor       # (W, tau-1) f32 phi at probes 2..tau
    phi1_hist: torch.Tensor      # (W, tau-1) f32 % of RS_1 kept, same
    clf_exits: torch.Tensor      # () int64 exits at tau, on the device
    ms: float                    # host ms in the serve.tau spans


class LaneState(NamedTuple):
    qvec: torch.Tensor          # (W, d) admitted query vectors
    cluster_rank: torch.Tensor  # (W, N) int64
    lanes: Lanes                # what a slot moves: h, patience, active,
                                # the running top-k
    qid: torch.Tensor           # (W,) int32 external id, -1 empty
    tau: Optional[TauLanes] = None   # with a learned policy only


def _empty_state(w: int, d: int, n: int, k: int, device: torch.device,
                 tau: int = 0) -> LaneState:
    """Empty lanes; with ``tau`` > 0 they record a learned stage's
    inputs (:class:`TauLanes`)."""
    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)
    hist = (w, max(tau - 1, 1))
    return LaneState(
        qvec=full((w, d), 0.0, torch.float32),
        cluster_rank=full((w, n), 0, torch.int64),
        lanes=Lanes(h=full((w,), 0, torch.int32),
                    patience=full((w,), 0, torch.int32),
                    active=full((w,), False, torch.bool),
                    topk_scores=full((w, k), float("-inf"), torch.float32),
                    topk_ids=full((w, k), -1, torch.int32)),
        qid=full((w,), -1, torch.int32),
        tau=None if not tau else TauLanes(
            centroid_sims=full((w, tau), 0.0, torch.float32),
            rs1_ids=full((w, k), -1, torch.int32),
            phi_hist=full(hist, 0.0, torch.float32),
            phi1_hist=full(hist, 0.0, torch.float32),
            clf_exits=torch.zeros((), dtype=torch.int64, device=device),
            ms=0.0))


def _admit(state: LaneState, index: IVFIndex, new_q: torch.Tensor,
           new_qid: torch.Tensor, n_probe: int) -> LaneState:
    """Fill empty lanes with up to len(new_q) queries (vectorised).
    Lanes that record a learned stage's inputs rank the centroids per
    row, as ``core.ivf.search`` does for a learned policy, and keep the
    first ``tau`` sims."""
    ln = state.lanes
    free = ~ln.active                                     # (W,)
    # slot j of new_q goes to the j-th free lane
    free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    take = free & (free_rank < new_q.shape[0])
    src = free_rank.clamp(0, new_q.shape[0] - 1).long()
    sims, rank = centroid_rank(index, new_q, n_probe,
                               per_row=state.tau is not None)

    def fill(old, new_full):
        m = take.reshape((-1,) + (1,) * (old.dim() - 1))
        return torch.where(m, new_full[src], old)

    tau = state.tau
    if tau is not None:
        # RS_1 and every history column are written before the stage
        # reads them (``_tau_stage``): only the sims are the admission's
        tau = tau._replace(centroid_sims=fill(
            tau.centroid_sims, sims[:, :tau.centroid_sims.shape[1]]))
    return LaneState(
        qvec=fill(state.qvec, new_q),
        cluster_rank=fill(state.cluster_rank, rank.long()),
        lanes=Lanes(h=torch.where(take, 0, ln.h),
                    patience=torch.where(take, 0, ln.patience),
                    active=ln.active | take,
                    topk_scores=torch.where(take[:, None], float("-inf"),
                                            ln.topk_scores),
                    topk_ids=torch.where(take[:, None], -1, ln.topk_ids)),
        qid=torch.where(take, new_qid[src], state.qid), tau=tau)


def _tau_stage(policy: Policy, state: LaneState, snap_s: torch.Tensor,
               snap_i: torch.Tensor, cnts: torch.Tensor,
               lane_cap: torch.Tensor, *, k: int, chunk: int, n_probe: int
               ) -> Tuple[LaneState, torch.Tensor]:
    """A learned policy's work in one fused wave, between the chunk's
    scan (its (W, chunk, k) snapshots and (W, chunk) new-entry counts)
    and the slot roll; every lane mask comes from ``h`` on the device.

    Each lane records the slots of the chunk whose probe lies in
    ``search``'s windows: RS_1 after its first probe, phi (from the
    count, as the roll computes it) and the share of RS_1 kept after
    probes 2..tau.  Lanes whose probe ``tau`` falls in this wave read
    the Table-1 features from that slot's snapshot, walk the trees, and
    take ``lane_cap = tau`` where the classifier says Exit: one
    ``tau_stage`` launch on the card.  Returns the lanes, their exits
    counted in ``state.tau``, and the caps."""
    ln, rec = state.lanes, state.tau
    out = kops.tau_stage(
        snap_s, snap_i, cnts, ln.h, ln.active, state.qvec,
        rec.centroid_sims, rec.rs1_ids, rec.phi_hist, rec.phi1_hist,
        rec.clf_exits, lane_cap, policy.clf, tau=policy.tau, k=k,
        chunk=chunk, n_probe=n_probe, threshold=policy.clf_threshold)
    return (state._replace(tau=rec._replace(
        rs1_ids=out.rs1_ids, phi_hist=out.phi_hist,
        phi1_hist=out.phi1_hist, clf_exits=out.clf_exits)), out.lane_cap)


def _advance(index: IVFIndex, state: LaneState,
             dview: Optional[DeltaView] = None,
             dead: Optional[torch.Tensor] = None, *,
             lane_delta: torch.Tensor, lane_cap: torch.Tensor, chunk: int,
             k: int, n_probe: int, phi: float, use_fused: bool = True,
             policy: Optional[Policy] = None) -> LaneState:
    """Advance every active lane by up to ``chunk`` probes.

    ``lane_delta``/``lane_cap`` are per-lane (W,) int32 exit knobs on
    the lanes' device: the patience threshold and the probe budget.
    Without a deadline both are constant (the scheduler's
    ``delta``/``n_probe``); under deadline pressure the degradation
    ladder lowers them per lane, so a struggling lane exits earlier
    while its neighbours run the full policy.  The fused path issues ONE
    ``ivf_scan_merge`` launch for the whole chunk
    (``core.ivf.scan_merge_chunk``) and ONE ``slot_roll`` launch that
    rolls lane state forward slot by slot from that kernel's per-probe
    snapshots, so mid-chunk exits land on the exact probe they would on
    the per-probe path.  No lane's patience exits before ``policy``'s
    ``min_probes`` probes; lanes that record a learned policy's inputs
    (``state.tau``) run its stage (:func:`_tau_stage`) between the scan
    and the roll, on the fused path only.  Its slots are budgeted by
    ``n_probe``, not
    ``lane_cap``: a capped lane's later slots are scanned and then
    discarded by the slot roll, so fused stays equal to per-probe.  The
    per-probe path runs the kernel pair (``core.ivf.probe_candidates``
    on ``ivf_scan``, then ``topk_merge``; their plain versions on the
    CPU): on the card only the pair scores and ranks in the fused
    kernel's order, so the two paths agree bit for bit there too.

    ``dview``/``dead`` (live index, ``repro_torch.index``): delta
    entries are scored once per wave — inside the fused kernel, or by
    ``delta_scan`` on the per-probe path — and merged into a lane's
    running top-k at the probe of their assigned cluster (the rule of
    ``core.search``); ``dead`` is the cumulative tombstone lookup,
    scrubbing running top-k entries deleted after they were merged,
    which lanes that span a version swap need.
    """
    ln = state.lanes
    min_probes = 1 if policy is None else policy.min_probes
    if dead is not None:
        # scrub once per wave: a lane's carry may predate a deletion
        ts0, ti0 = scrub_dead(ln.topk_scores, ln.topk_ids, dead)
        ln = ln._replace(topk_scores=ts0, topk_ids=ti0)
        if dview is not None:
            # burn tombstoned buffer entries to id -1 up front: both
            # paths then mask them exactly like empty slots
            dview = dview.burn_dead(dead)

    if use_fused:
        rel = torch.arange(chunk, device=ln.h.device)[None, :]
        slot = ln.h[:, None] + rel
        cids = torch.gather(state.cluster_rank, 1,
                            slot.clamp(0, n_probe - 1).long())
        # inactive lanes and slots past the probe budget merge nothing
        slot_ok = (slot < n_probe) & ln.active[:, None]
        snap_s, snap_i, cnts = scan_merge_chunk(
            index, state.qvec, cids, slot_ok, ln.topk_scores, ln.topk_ids,
            dview, k=k, chunk=chunk)
        if state.tau is not None:
            t0 = time.perf_counter()
            with span("serve.tau"):
                state, lane_cap = _tau_stage(
                    policy, state, snap_s, snap_i, cnts, lane_cap, k=k,
                    chunk=chunk, n_probe=n_probe)
            state = state._replace(tau=state.tau._replace(
                ms=state.tau.ms + 1e3 * (time.perf_counter() - t0)))
        return state._replace(lanes=kops.slot_roll(
            snap_s, snap_i, cnts, ln, lane_delta, lane_cap, k=k,
            chunk=chunk, phi=phi, min_probes=min_probes))

    if state.tau is not None:
        raise ValueError("a learned policy's stage runs on the fused path")
    d_sc = None if dview is None \
        else kops.delta_scan(state.qvec, dview.vecs)          # (W, cap)
    for _ in range(chunk):
        hv = ln.h.clamp(max=n_probe - 1).long()
        cids = torch.gather(state.cluster_rank, 1, hv[:, None])[:, 0]
        sc, ids = probe_candidates(index, state.qvec, cids, use_kernel=True,
                                   delta=dview, delta_scores=d_sc)
        ms, mi = merge_topk(ln.topk_scores, ln.topk_ids, sc, ids, k,
                            use_kernel=True)
        ti = torch.where(ln.active[:, None], mi, ln.topk_ids)
        ln = slot_step(ln, ms, mi, intersection_pct(ln.topk_ids, ti),
                       phi=phi, lane_delta=lane_delta, lane_cap=lane_cap,
                       min_probes=min_probes)
    return state._replace(lanes=ln)


#: the scheduler's exit knobs where neither a keyword nor a policy sets one
_KNOBS = {"k": 100, "n_probe": 80, "delta": 7, "phi": 95.0}

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
    # device read to the return of _advance, the recording of the last
    # harvest's exits and on_wave: the wave's advance on the device is
    # not waited for
    wave_cost_ms: float = 0.0
    # -- background rebuild accounting (zero without a rebuilder) --
    epoch_swaps: int = 0        # higher-epoch versions adopted (drained)
    drain_waves: int = 0        # waves spent draining before a swap
    rebuild_ticks: int = 0      # rebuild stages run between waves
    rebuild_throttled: int = 0  # ticks skipped under deadline pressure
    # -- device-to-host reads (each waits for the device's queued work) --
    host_syncs: int = 0         # reads and waits for a copy made
    sync_wait_ms: float = 0.0   # host ms spent in them
    # -- the on_wave hook: host ms spent in it (0.0 without a hook) --
    hook_ms: float = 0.0
    # -- a learned policy's stage at tau (zero without one) --
    clf_exits: int = 0          # queries the classifier exited at tau
    tau_ms: float = 0.0         # host ms in the serve.tau spans

    @property
    def degraded_fraction(self) -> float:
        return len(self.degraded) / max(len(self.results), 1)

    def shed_ids(self) -> List[int]:
        return [q for q, r in self.degraded.items() if r == "shed"]


class _HostReads:
    """The device-to-host reads of one ``serve()`` call.  :meth:`stage`
    enqueues a tensor's copy to pinned host memory behind an event and
    does not block; :meth:`wait` waits for the event and returns the
    copy as an array of its own.  Each wait is a ``serve.sync`` span,
    counted, and timed on the host clock (the wait for the device's
    queued work and the copy).  Off the card the tensor is on the host
    already and there is no event."""

    def __init__(self):
        self.count = 0
        self.wait_ms = 0.0

    @staticmethod
    def stage(t: torch.Tensor
              ) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        if not t.is_cuda:
            return t, None
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(t.device))
        return out, event

    def wait(self, staged: Tuple[torch.Tensor, Optional[torch.cuda.Event]]
             ) -> np.ndarray:
        out, event = staged
        with span("serve.sync"):
            t0 = time.perf_counter()
            if event is not None:
                event.synchronize()
            # its own memory: the pinned block goes back to the pool
            arr = out.numpy().copy()
            self.wait_ms += 1e3 * (time.perf_counter() - t0)
        self.count += 1
        return arr

    def __call__(self, t: torch.Tensor) -> np.ndarray:
        return self.wait(self.stage(t))


class _Call:
    """The bookkeeping of one ``serve()`` call: the ``ServeReport`` it
    fills as the waves go (answers, reasons, latency, the wave-cost EMA,
    the counters), the host's copy of the lanes, the device-to-host
    reads and the exits staged for recording; :meth:`report` completes
    the report."""

    def __init__(self, w: int, deadline_ms: Optional[float]):
        self.rep = ServeReport({}, {}, 0, 0.0, 0, deadline_ms=deadline_ms)
        self.lane_admit = np.zeros(w, np.float64)   # admit timestamp, ms
        self.prev_active = np.zeros(w, bool)        # active at the advance
        self.prev_active_dev: Optional[torch.Tensor] = None  # its tensor
        # the lanes' qids as admission set them (``_admit``'s rule)
        self.lane_qid = np.full(w, -1, np.int32)
        self.next_q = 0                             # first queued query
        self.occ: List[float] = []                  # busy share a wave
        self.read = _HostReads()
        # (staged rows, qids, latency ms) of the exits a harvest staged
        self.exits: Optional[tuple] = None

    def flag(self, qid: int, reason: str) -> None:
        old = self.rep.degraded.get(qid)
        if old is None or _REASON_RANK[reason] > _REASON_RANK[old]:
            self.rep.degraded[qid] = reason

    def answer(self, qids, ids: np.ndarray, probes, latency,
               reason: Optional[str] = None) -> None:
        """Record the answers of ``qids``: row j of ``ids`` and entry j
        of ``probes`` and ``latency`` (ms) are query j's; ``reason``,
        if given, flags each of them degraded."""
        rep = self.rep
        qids = np.asarray(qids).tolist()
        rep.results.update(zip(qids, ids))
        rep.probes.update(zip(qids, np.asarray(probes).tolist()))
        rep.latency_ms.update(zip(qids, np.asarray(latency).tolist()))
        if reason is not None:
            for qid in qids:
                self.flag(qid, reason)

    def stage_exits(self, lanes: Lanes, done: np.ndarray,
                    now: float) -> None:
        """Enqueue the answers of the exited lanes ``done`` without
        waiting: one gather of their top-k ids and probe counts into an
        (n, k + 1) int32 tensor, staged for a read.  The lanes are found
        on the device, in ``done``'s ascending order.  Their qids and
        latencies are taken now, before admission overwrites the
        lanes."""
        sel = torch.nonzero_static(self.prev_active_dev & ~lanes.active,
                                   size=done.size)[:, 0]
        rows = torch.cat([lanes.topk_ids, lanes.h[:, None]], 1)[sel]
        self.exits = (self.read.stage(rows), self.lane_qid[done],
                      now - self.lane_admit[done])

    def record_exits(self) -> None:
        """Wait for the staged exits' copy and record their answers."""
        if self.exits is None:
            return
        staged, qids, latency = self.exits
        self.exits = None
        with span("serve.answer"):
            out = self.read.wait(staged)
            self.answer(qids, out[:, :-1], out[:, -1], latency)

    def report(self, wave_slots: int,
               tau: Optional[TauLanes]) -> ServeReport:
        """The completed report; ``wave_slots`` lane-probe slots are
        spent a wave.  A learned stage's exits (``tau``) are read here,
        once."""
        rep = self.rep
        if tau is not None:
            rep.clf_exits = int(self.read(tau.clf_exits))
            rep.tau_ms = tau.ms
        rep.occupancy = float(np.mean(self.occ)) if self.occ else 0.0
        rep.lane_steps = rep.waves * wave_slots
        rep.host_syncs = self.read.count
        rep.sync_wait_ms = self.read.wait_ms
        return rep


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

    ``policy`` (optional, ``core.policies``): ``patience(...)`` (served
    as without one, its ``min_probes`` kept), ``classifier(...)`` or
    ``cascade_patience(...)``; the scheduler takes its ``k`` and
    ``n_probe``, and with patience its ``delta`` and ``phi``, and any of
    them also given as a keyword must be the policy's.  A learned policy
    serves on the fused path, without a registry or a deadline, and
    answers as ``core.ivf.search`` under it with the same chunk, bit for
    bit.  A REG stage is refused.
    """

    def __init__(self, index: IVFIndex, *, wave_size: int = 64,
                 chunk: int = 8, k: Optional[int] = None,
                 n_probe: Optional[int] = None, delta: Optional[int] = None,
                 phi: Optional[float] = None, use_fused: bool = True,
                 registry=None, deadline_ms: Optional[float] = None,
                 ladder: Optional[DegradationLadder] = None,
                 clock: Optional[Callable[[], float]] = None,
                 rebuilder=None, device: DeviceLike = None,
                 policy: Optional[Policy] = None):
        """``k``, ``n_probe``, ``delta``, ``phi``: the exit knobs, a
        ``policy``'s where it holds them, else 100, 80, 7 and 95.0 unless
        given.

        ``deadline_ms``: per-query latency budget, counted from lane
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
        self.policy = policy
        knobs = {key: v for key, v in (("k", k), ("n_probe", n_probe),
                                       ("delta", delta), ("phi", phi))
                 if v is not None}
        if policy is not None:
            knobs = self._policy_knobs(knobs)
        knobs = dict(_KNOBS, **knobs)
        self.k = knobs["k"]
        self.n = min(knobs["n_probe"], index.n_clusters)
        self.delta = knobs["delta"]
        self.phi = knobs["phi"]
        self.use_fused = use_fused
        self.registry = registry
        self.deadline_ms = deadline_ms
        self.ladder = ladder or DegradationLadder()
        self._now = clock or (lambda: time.monotonic() * 1000.0)
        self.rebuilder = rebuilder
        self._pinned = None        # version lanes are probing against
        if self._learned:
            self._check_learned(index.centroids.shape[1])

    def _policy_knobs(self, given: dict) -> dict:
        """The exit knobs ``self.policy`` holds (its ``k`` and
        ``n_probe``, with patience its ``delta`` and ``phi``), after
        checking that each knob ``given`` as a keyword equals it."""
        pol = self.policy
        if pol.use_reg:
            raise ValueError(f"WaveScheduler serves no REG stage; policy "
                             f"{pol.name!r} has one")
        keys = ("k", "n_probe") + (("delta", "phi") if pol.use_patience
                                   else ())
        off = [f"{key} {getattr(pol, key)!r} (the scheduler's {v!r})"
               for key, v in given.items()
               if key in keys and getattr(pol, key) != v]
        if off:
            raise ValueError(f"policy {pol.name!r} disagrees with the "
                             f"scheduler's knobs: {', '.join(off)}")
        return dict(given, **{key: getattr(pol, key) for key in keys})

    def _check_learned(self, dim: int) -> None:
        """Raise unless the learned ``self.policy`` is one the scheduler
        serves (the class docstring) and its trees split on the Table-1
        features of ``dim``-wide queries."""
        pol = self.policy
        for what, on in (("deadline_ms", self.deadline_ms is not None),
                         ("registry", self.registry is not None),
                         ("use_fused=False", not self.use_fused)):
            if on:
                raise ValueError(f"a learned policy ({pol.name!r}) is "
                                 f"served without {what}")
        if not 1 <= pol.tau <= self.n or pol.min_probes != pol.tau:
            raise ValueError(
                f"policy {pol.name!r}: tau {pol.tau} must lie in [1, "
                f"{self.n}] and min_probes ({pol.min_probes}) equal it")
        clf = pol.clf
        check_same_device(self.device, "a tree of the policy", clf.feat,
                          clf.thresh, clf.left, clf.right, clf.value,
                          clf.base)
        check_trees(clf, dim, pol.tau)

    @property
    def _learned(self) -> bool:
        return self.policy is not None and self.policy.learned

    def _pin(self, call: _Call, active_any: bool) -> bool:
        """Adopt the registry's current version if lanes allow it.

        Same-epoch updates (merge_delta, mutations) adopt at once — the
        wave-granular swap mid-flight lanes tolerate.  A higher-epoch
        version only lands once no lane is active; until then the
        scheduler *drains* and the caller stops admitting.  Returns
        whether it drains; counts swaps and drain waves on ``call``.
        """
        if self.registry is None:
            return False
        cur = self.registry.current()
        swap = cur.epoch != self._pinned.epoch
        if swap and active_any:
            # drain: finish lanes on the old epoch
            call.rep.drain_waves += 1
            return True
        call.rep.epoch_swaps += swap
        self._pinned = cur
        return False

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
        ``w`` (1-based) — the hook a mutation stream publishes from.

        Under a torch profiler the call is a ``serve`` span holding
        ``serve.harvest``, ``serve.admit``, ``serve.advance`` and
        ``serve.answer`` (the recording of a harvest's exits) spans, and
        every device-to-host read or wait for a copy is a ``serve.sync``
        span (``repro_torch.trace``); each ``on_wave`` call is a
        ``serve.hook`` span, and ``ServeReport.hook_ms`` sums its host
        ms.  With a learned policy each ``serve.advance`` holds a
        ``serve.tau`` span (``ServeReport.tau_ms``), and the call ends
        with one read of ``ServeReport.clf_exits``."""
        with span("serve"):
            return self._serve(queries, compact, on_wave)

    def _serve(self, queries, compact: bool,
               on_wave: Optional[Callable[[int], None]]) -> ServeReport:
        """The wave loop: each wave harvests exits, pins a version, walks
        the deadline ladder, admits queued queries, advances the lanes
        and runs the hook, then one rebuild stage."""
        call = _Call(self.w, self.deadline_ms)
        queries = as_queries(queries, self.device)
        nq, d = queries.shape
        state = _empty_state(self.w, d, self.n, self.k, self.device,
                             self.policy.tau if self._learned else 0)
        # the exit knobs (lane_delta, lane_cap) of a lane under no
        # pressure; a policy without patience never reaches its delta
        delta = self.delta if self.policy is None \
            or self.policy.use_patience else self.n + 1
        full = tuple(torch.full((self.w,), v, dtype=torch.int32,
                                device=self.device)
                     for v in (delta, self.n))
        self._pinned = None if self.registry is None \
            else self.registry.current()
        while True:
            active, now = self._harvest(call, state)
            draining = self._pin(call, bool(active.any()))
            state, active, knobs = self._degrade(call, state, active, now,
                                                 full)
            version = self._version()
            if (compact or not active.any()) and not draining \
                    and call.next_q < nq and (~active).any():
                state, active = self._admit_queued(
                    call, state, active, queries, version[0], now)
            if not active.any() and call.next_q >= nq:
                break
            state = self._advance_wave(call, state, active, version, knobs,
                                       on_wave, now)
            self._rebuild_tick(call, state)
        call.record_exits()         # the last harvest's
        return call.report(self.w * self.chunk, state.tau)

    def _harvest(self, call: _Call, state: LaneState
                 ) -> Tuple[np.ndarray, float]:
        """Read which lanes are active, the wave's one blocking read, take
        the wave's clock reading and stage the answers of the lanes that
        went inactive in the last advance (``_advance_wave`` records
        them).  Returns (active, now)."""
        with span("serve.harvest"):
            active = call.read(state.lanes.active)
            now = self._now()
            done = np.nonzero(call.prev_active & ~active)[0]
            if done.size:
                call.stage_exits(state.lanes, done, now)
        return active, now

    def _degrade(self, call: _Call, state: LaneState, active: np.ndarray,
                 now: float, full: Tuple[torch.Tensor, torch.Tensor]
                 ) -> Tuple[LaneState, np.ndarray,
                            Tuple[torch.Tensor, torch.Tensor]]:
        """The degradation ladder of a deadline-budgeted serve: force
        out the lanes at the last rung with their partial top-k, flag
        the rest, and lower their patience and probe budget.  Returns
        the lanes, the host's active mask and the (lane_delta,
        lane_cap) knobs; ``full`` where no lane is under pressure."""
        if self.deadline_ms is None:
            return state, active, full
        remaining = self.deadline_ms - (now - call.lane_admit)
        cost = max(call.rep.wave_cost_ms, 1e-9)
        rungs = np.where(active, self.ladder.rungs(remaining, cost),
                         RUNG_NONE)
        if not (rungs > RUNG_NONE).any():
            return state, active, full
        # one read of h a wave, one of the forced lanes' top-k
        h_np = call.read(state.lanes.h)
        force = active & (rungs == RUNG_FORCE)
        if force.any():
            lanes = np.nonzero(force)[0]
            tid = call.read(state.lanes.topk_ids[torch.as_tensor(
                lanes, device=self.device)])
            call.answer(call.lane_qid[lanes], tid, h_np[lanes],
                        now - call.lane_admit[lanes], "forced_exit")
            active = active & ~force
            state = state._replace(lanes=state.lanes._replace(
                active=torch.as_tensor(active, device=self.device)))
        for lane in np.nonzero(active & (rungs >= RUNG_TIGHTEN))[0]:
            call.flag(int(call.lane_qid[lane]),
                      "capped_probes" if rungs[lane] >= RUNG_CAP
                      else "tightened_patience")
        afford = np.floor(np.maximum(remaining, 0.0) / cost) \
            .astype(np.int64) * self.chunk
        cap_np = np.where(rungs >= RUNG_CAP, h_np + afford, self.n)
        cap_np = np.minimum(cap_np, self.n).astype(np.int32)
        tight = min(self.ladder.tight_delta, self.delta)
        delta_np = np.where(rungs >= RUNG_TIGHTEN, tight,
                            self.delta).astype(np.int32)
        return state, active, (torch.as_tensor(delta_np, device=self.device),
                               torch.as_tensor(cap_np, device=self.device))

    def _admit_queued(self, call: _Call, state: LaneState,
                      active: np.ndarray, queries: torch.Tensor,
                      index: IVFIndex, now: float
                      ) -> Tuple[LaneState, np.ndarray]:
        """Fill the free lanes from the queue, ranking clusters against
        the epoch (``index``) they will probe; under a deadline no wave
        can meet, shed them instead.  Returns the lanes and the active
        mask."""
        room = int((~active).sum())
        if self.deadline_ms is not None \
                and call.rep.wave_cost_ms > self.deadline_ms:
            # even a fresh query cannot meet the deadline: shed
            # instead of admitting to certain death
            n = min(len(queries) - call.next_q, room)
            call.answer(range(call.next_q, call.next_q + n),
                        np.full((n, self.k), -1, np.int32), [0] * n,
                        [0.0] * n, "shed")
            call.next_q += n
            return state, active
        with span("serve.admit"):
            batch = queries[call.next_q: call.next_q + room]
            n = batch.shape[0]
            qids = torch.arange(call.next_q, call.next_q + n,
                                dtype=torch.int32, device=self.device)
            state = _admit(state, index, batch, qids, self.n)
            # _admit's rule on the host: the j-th free lane takes query
            # next_q + j, so nothing need be read back
            take = np.nonzero(~active)[0][:n]
            call.lane_qid[take] = np.arange(call.next_q, call.next_q + n)
            call.lane_admit[take] = now
            call.next_q += n
            admitted = active.copy()
            admitted[take] = True
        return state, admitted

    def _advance_wave(self, call: _Call, state: LaneState,
                      active: np.ndarray, version, knobs, on_wave,
                      now: float) -> LaneState:
        """Advance the lanes by one chunk against the pinned ``version``
        with the (lane_delta, lane_cap) ``knobs``, record the last
        harvest's exits while the card runs the advance, run ``on_wave``
        and fold the wave's host ms into the wave-cost EMA."""
        call.occ.append(active.mean())
        call.prev_active = active
        call.prev_active_dev = state.lanes.active
        index, dview, dead = version
        lane_delta, lane_cap = knobs
        with span("serve.advance"):
            state = _advance(index, state, dview, dead,
                             lane_delta=lane_delta, lane_cap=lane_cap,
                             chunk=self.chunk, k=self.k, n_probe=self.n,
                             phi=self.phi, use_fused=self.use_fused,
                             policy=self.policy)
        call.rep.waves += 1
        call.record_exits()
        if on_wave is not None:
            t_hook = time.perf_counter()
            with span("serve.hook"):
                on_wave(call.rep.waves)
            call.rep.hook_ms += 1e3 * (time.perf_counter() - t_hook)
        sample = self._now() - now
        call.rep.wave_cost_ms = sample if call.rep.waves == 1 \
            else 0.5 * call.rep.wave_cost_ms + 0.5 * sample
        return state

    def _rebuild_tick(self, call: _Call, state: LaneState) -> None:
        """One background rebuild stage, after the wave-cost sample so
        the stall never inflates the EMA the ladder budgets against;
        skipped (throttled) while a lane is close to its deadline."""
        if self.rebuilder is None or not self.rebuilder.active:
            return
        throttle = False
        if self.deadline_ms is not None:
            act_now = call.read(state.lanes.active)
            rem = (self.deadline_ms
                   - (self._now() - call.lane_admit))[act_now]
            throttle = self.ladder.throttle_rebuild(
                rem, max(call.rep.wave_cost_ms, 1e-9))
        if throttle:
            call.rep.rebuild_throttled += 1
        else:
            self.rebuilder.tick()
            call.rep.rebuild_ticks += 1
