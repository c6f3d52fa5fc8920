"""Chaos harness (port of ``repro.runtime.chaos``): deterministic seeded
fault injection over a live serving stack, measuring how gracefully it
degrades.

Four drills, one JSON report (``artifacts/BENCH_resilience_torch.json``
via ``python -m repro_torch.launch.serve --chaos``):

* **Crash / recovery** — a seeded mutation stream (adds, deletes,
  merges) runs against a WAL-backed :class:`repro_torch.index.LiveIndex`
  with periodic snapshots; :class:`SimulatedFailure` is injected at
  mutation boundaries, the process state is abandoned, and
  ``IndexRegistry.recover`` rebuilds it from snapshot + log replay.
  Reported: crash count, recovery wall time, replayed records, and a
  ``bit_identical`` bool (recovered results vs an uncrashed oracle,
  on the per-probe kernel pair AND the fused kernel).
* **Deadline sweep** — the query set is served under several
  ``deadline_ms`` budgets while a simulated clock injects latency
  spikes; the degradation ladder (tighten -> cap -> force -> shed) is
  the actuator.  Reported: recall-vs-deadline curve with degraded
  fractions and max budget overshoot.
* **Shard faults** — ``search_with_retry`` fan-out with seeded shard
  failures; retries/backoff/skips and residual recall are reported.
* **Rebuild** — a crash at every two-phase-publish boundary of a
  background rebuild, a merge racing the publish, and a drift-triggered
  rebuild restoring recall.

Everything is driven by one seed, so a chaos run is reproducible, and
runs where the index lies (the drift drill's own index on ``device``:
CUDA unless ``device="cpu"``).  The per-probe half of each bit-identity
check runs the kernel pair (``ivf_scan`` + ``topk_merge``, the buffer
by ``delta_scan``); the reference's per-probe path runs its Pallas
``delta_scan`` there too.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import build_index, metrics, policies
from repro_torch.core.distributed_ivf import (ShardFault, search_with_retry,
                                              shard_index)
from repro_torch.core.ivf import index_device
from repro_torch.core.serving import WaveScheduler
from repro_torch.index import (DeltaFull, DriftTracker, IndexRegistry,
                               LiveIndex, MutationWAL, RebuildCrash,
                               Rebuilder, StaleEpochError, version_of)
from repro_torch.index.rebuild import FAILPOINTS
from repro_torch.runtime.fault import SimulatedFailure
from repro_torch.runtime.straggler import RetryPolicy

# the two search paths every bit-identity verdict compares on
PATHS = ({"use_scan_kernel": True, "use_topk_kernel": True},
         {"use_fused_kernel": True, "chunk": 4})


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    seed: int = 0
    # crash/recovery drill
    mutation_steps: int = 24       # mutation-boundary steps in the stream
    adds_per_step: int = 8
    crash_every: int = 7           # crash at every Nth boundary (0 = off)
    snapshot_every: int = 5        # registry.save cadence (boundaries)
    # deadline drill
    base_wave_ms: float = 1.0
    spike_rate: float = 0.15       # P(wave hits a latency spike)
    spike_ms: float = 8.0
    # shard drill
    n_shards: int = 4
    shard_fault_rate: float = 0.3  # P(one dispatch raises ShardFault)


class SimClock:
    """Deterministic ms clock, advanced explicitly by the harness."""

    def __init__(self, start_ms: float = 0.0):
        self.ms = float(start_ms)

    def __call__(self) -> float:
        return self.ms

    def advance(self, ms: float) -> None:
        self.ms += ms


class ChaosMonkey:
    """Seeded event source shared by the drills."""

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.clock = SimClock()
        self.spikes = 0
        self.shard_faults = 0

    def wave_ms(self) -> float:
        ms = self.cfg.base_wave_ms
        if self.rng.random() < self.cfg.spike_rate:
            self.spikes += 1
            ms += self.cfg.spike_ms
        return ms

    def tick_wave(self, wave: int) -> None:
        """on_wave hook: advance simulated time by one wave's cost."""
        self.clock.advance(self.wave_ms())

    def shard_fault(self, shard: int, attempt: int) -> None:
        """fault hook for ``search_with_retry``."""
        if self.rng.random() < self.cfg.shard_fault_rate:
            self.shard_faults += 1
            raise ShardFault(
                f"chaos: shard {shard} fault (attempt {attempt})")


# ---------------------------------------------------------------------------
# drill 1: crash + WAL recovery over a live mutation stream
# ---------------------------------------------------------------------------

def _mutation_stream(cfg: ChaosConfig, docs: np.ndarray):
    """Deterministic (op, payload) list: adds of noisy corpus copies,
    deletes of previously added ids, periodic merges."""
    rng = np.random.default_rng(cfg.seed + 1)
    ops = []
    for step in range(cfg.mutation_steps):
        src = rng.integers(0, docs.shape[0], cfg.adds_per_step)
        noise = rng.normal(scale=0.05,
                           size=(cfg.adds_per_step, docs.shape[1]))
        ops.append(("add", (docs[src] + noise).astype(np.float32)))
        if step % 3 == 2:
            ops.append(("delete_recent", int(cfg.adds_per_step // 2)))
        if step % 6 == 5:
            ops.append(("merge", None))
    return ops


def _apply(live, op, payload, added: List[int]):
    if op == "add":
        try:
            added.extend(int(i) for i in live.add(payload))
        except DeltaFull:
            live.merge_delta()
            added.extend(int(i) for i in live.add(payload))
    elif op == "delete_recent":
        if len(added) >= payload:
            doomed = [added.pop() for _ in range(payload)]
            live.delete(doomed)
    else:
        live.merge_delta()


def _search_identical(a_live, b_live, queries, *, k: int,
                      n_probe: int) -> bool:
    """Bit-identity of two LiveIndexes on the per-probe kernel pair AND
    the fused kernel."""
    q = torch.as_tensor(np.asarray(queries, np.float32),
                        device=a_live.device)
    pol = policies.patience(n_probe, delta=2, phi=90.0, k=k, tau=3)
    same = True
    for kw in PATHS:
        a = a_live.search(q, pol, **kw)
        b = b_live.search(q, pol, **kw)
        same &= bool(
            torch.equal(a.topk_ids, b.topk_ids)
            and torch.equal(a.probes, b.probes)
            and torch.allclose(a.phi_hist, b.phi_hist, rtol=0, atol=1e-4))
    return same


def run_crash_recovery(index, docs: np.ndarray, queries: np.ndarray,
                       cfg: ChaosConfig, workdir: str, *, k: int = 10,
                       n_probe: int = 16) -> Dict:
    """Kill-and-replay drill on the index's device.  Returns recovery
    metrics including the bit-identity verdict against an uncrashed
    oracle."""
    dev = index_device(index)
    # group commit on: durability batched across mutations, forced at
    # merge/snapshot boundaries — the drill proves recovery semantics
    # (torn tail, replay, bit-identity) are unchanged under batching
    wal = MutationWAL(os.path.join(workdir, "mutations.wal"),
                      group_commit_n=8, group_commit_ms=50.0)
    live = LiveIndex(index, delta_cap=4096, wal=wal)
    oracle = LiveIndex(index, delta_cap=4096)
    mgr = CheckpointManager(os.path.join(workdir, "snapshots"),
                            async_save=False, keep=2)
    reg = IndexRegistry(version_of(live))
    reg.save(mgr)                      # base snapshot (seq 0)

    crashes = 0
    recovery_ms: List[float] = []
    replayed = 0
    added_live: List[int] = []
    added_oracle: List[int] = []
    ops = _mutation_stream(cfg, docs)
    for step, (op, payload) in enumerate(ops):
        _apply(live, op, payload, added_live)
        _apply(oracle, op, payload, added_oracle)
        if cfg.crash_every and (step + 1) % cfg.crash_every == 0:
            crashes += 1
            try:
                raise SimulatedFailure(f"chaos crash @ boundary {step}")
            except SimulatedFailure:
                pass                   # process "dies" here
            t0 = time.monotonic()
            _, live, rep = IndexRegistry.recover(mgr, wal, device=dev)
            recovery_ms.append((time.monotonic() - t0) * 1000.0)
            replayed += rep.applied
        if cfg.snapshot_every and (step + 1) % cfg.snapshot_every == 0:
            wal.flush()                # snapshot must not outrun the log
            reg = IndexRegistry(version_of(live))
            reg.save(mgr)
            wal.truncate_upto(live.seq)

    # bit-identity: recovered-and-continued live vs uncrashed oracle,
    # on both kernel paths
    identical = _search_identical(live, oracle, queries, k=k,
                                  n_probe=n_probe)
    wal.close()
    return {
        "crashes": crashes,
        "mutations": len(ops),
        "replayed_records": replayed,
        "mean_recovery_ms": float(np.mean(recovery_ms))
        if recovery_ms else 0.0,
        "max_recovery_ms": float(np.max(recovery_ms))
        if recovery_ms else 0.0,
        "final_seq": live.seq,
        "bit_identical": identical,
    }


# ---------------------------------------------------------------------------
# drill 2: recall-vs-deadline curve under latency spikes
# ---------------------------------------------------------------------------

def run_deadline_sweep(index, queries: np.ndarray,
                       exact_ids: np.ndarray, cfg: ChaosConfig,
                       deadlines_ms: List[float], *, k: int = 10,
                       n_probe: int = 16, delta: int = 3,
                       phi: float = 90.0, wave_size: int = 32,
                       chunk: int = 1) -> List[Dict]:

    curve = []
    for dl in list(deadlines_ms) + [None]:     # None = no deadline row
        monkey = ChaosMonkey(cfg)              # fresh RNG per point
        ws = WaveScheduler(index, wave_size=wave_size, chunk=chunk,
                           k=k, n_probe=n_probe, delta=delta, phi=phi,
                           deadline_ms=dl, clock=monkey.clock)
        rep = ws.serve(queries, on_wave=monkey.tick_wave)
        nq = queries.shape[0]
        ids = np.stack([rep.results[i] for i in range(nq)])
        over = [rep.latency_ms[i] - dl for i in range(nq)
                if dl is not None and rep.latency_ms[i] > dl]
        reasons: Dict[str, int] = {}
        for r in rep.degraded.values():
            reasons[r] = reasons.get(r, 0) + 1
        curve.append({
            "deadline_ms": dl,
            "recall": round(metrics.r_star_at_k(ids, exact_ids), 4),
            "degraded_fraction": round(rep.degraded_fraction, 4),
            "reasons": reasons,
            "max_overshoot_ms": round(max(over, default=0.0), 3),
            "wave_cost_ms": round(rep.wave_cost_ms, 3),
            "waves": rep.waves,
            "spikes": monkey.spikes,
        })
    return curve


# ---------------------------------------------------------------------------
# drill 3: shard faults through the retry/backoff data plane
# ---------------------------------------------------------------------------

def run_shard_drill(index, queries: np.ndarray, exact_ids: np.ndarray,
                    cfg: ChaosConfig, *, k: int = 10,
                    n_probe: int = 16) -> Dict:
    dev = index_device(index)
    monkey = ChaosMonkey(cfg)
    sh = shard_index(index, cfg.n_shards)
    _, ids_clean, _ = search_with_retry(
        sh, queries, k=k, n_probe=n_probe, sleep=monkey.clock.advance,
        device=dev)
    _, ids_chaos, rep = search_with_retry(
        sh, queries, k=k, n_probe=n_probe,
        retry=RetryPolicy(max_retries=3, base_ms=1.0),
        fault=monkey.shard_fault, sleep=monkey.clock.advance, device=dev)
    return {
        "n_shards": cfg.n_shards,
        "fault_rate": cfg.shard_fault_rate,
        "injected_faults": monkey.shard_faults,
        "attempts": rep.attempts,
        "retries": rep.retries,
        "skipped_shards": rep.skipped_shards,
        "lost_clusters": rep.lost_clusters,
        "backoff_ms": round(rep.backoff_ms, 3),
        "recall_clean": round(metrics.r_star_at_k(ids_clean, exact_ids), 4),
        "recall_chaos": round(metrics.r_star_at_k(ids_chaos, exact_ids), 4),
    }


# ---------------------------------------------------------------------------
# drill 4: background rebuild — crash boundaries, swap race, drift repair
# ---------------------------------------------------------------------------

def _drive_rebuild(index, docs, cfg: ChaosConfig, workdir: str, tag: str,
                   failpoint: Optional[str]):
    """One scripted rebuild run: pre-mutations -> begin -> mid
    mutations -> retrain/layout/catchup -> late mutations + a racing
    ``merge_delta`` -> publish, crashing at ``failpoint`` (None = run
    to completion).  The schedule is deterministic, so a crashed run
    and its oracle (same schedule, no failpoint) see identical WAL
    streams up to the crash boundary.  Returns
    ``(wal, rebuilder, live, manager, registry, crashed_stage)``.
    """
    wdir = os.path.join(workdir, f"rebuild_{tag}")
    os.makedirs(wdir, exist_ok=True)
    wal = MutationWAL(os.path.join(wdir, "mutations.wal"),
                      group_commit_n=8, group_commit_ms=50.0)
    live = LiveIndex(index, delta_cap=4096, wal=wal)
    mgr = CheckpointManager(os.path.join(wdir, "snapshots"),
                            async_save=False, keep=2)
    reg = IndexRegistry(version_of(live))
    reg.save(mgr)
    wal.note_durable(live.seq)

    rng = np.random.default_rng(cfg.seed + 11)

    def batch(n):
        src = rng.integers(0, docs.shape[0], n)
        noise = rng.normal(scale=0.05, size=(n, docs.shape[1]))
        return (docs[src] + noise).astype(np.float32)

    added: List[int] = []
    added.extend(int(i) for i in live.add(batch(cfg.adds_per_step)))
    live.delete([added.pop(), added.pop()])
    reg.publish(version_of(live))

    rb = Rebuilder(live, reg, mgr, n_iters=3, failpoint=failpoint)
    rb.request("chaos-drill")
    crashed = None
    try:
        while rb.active:
            stage = rb.tick()
            # mutations land after specific stages: post-begin ones
            # exercise the catch-up replay, post-catchup ones (plus a
            # merge_delta computed against the OLD centroids, i.e. a
            # merge racing the publish) exercise the publish-time
            # late-gap close
            if stage in ("begin", "catchup"):
                added.extend(int(i)
                             for i in live.add(batch(cfg.adds_per_step)))
                live.delete([added.pop()])
                if stage == "catchup":
                    live.merge_delta()
                reg.publish(version_of(live))
    except RebuildCrash:
        crashed = rb.stage
    return wal, rb, live, mgr, reg, crashed


def run_rebuild_drill(index, docs: np.ndarray, queries: np.ndarray,
                      cfg: ChaosConfig, workdir: str, *, k: int = 10,
                      n_probe: int = 16) -> Dict:
    """Rebuild lifecycle drill: crash at every two-phase-publish
    boundary (bit-identical recovery), epoch-fence a merge racing the
    publish (no lost mutations, no stale clobber), and show the
    drift-triggered rebuild restoring recall under sustained churn."""
    dev = index_device(index)
    out: Dict = {}

    # -- 4a. crash at every rebuild boundary -------------------------------
    #    pre-COMMIT crashes must recover to the no-rebuild state;
    #    post-COMMIT crashes must recover to the post-rebuild state.
    boundaries = []
    for fp in FAILPOINTS:
        wal, rb, live, mgr, reg, crashed = _drive_rebuild(
            index, docs, cfg, workdir, f"crash_{fp}", fp)
        t0 = time.monotonic()
        _, recovered, rep = IndexRegistry.recover(mgr, wal, device=dev)
        rec_ms = (time.monotonic() - t0) * 1000.0
        # a recovered epoch above the serving handle's means the crash
        # landed after the COMMIT record — the rebuild happened
        committed = recovered.epoch > live.epoch
        if committed:
            # oracle: the same scripted run, minus the crash (kmeans
            # and the mutation schedule are deterministic)
            owal, orb, _, _, _, _ = _drive_rebuild(
                index, docs, cfg, workdir, f"oracle_{fp}", None)
            owal.close()
            oracle = orb.live
        else:
            # recovery aborted the epoch, so it must land exactly on
            # the no-rebuild state — which the in-memory serving
            # handle still IS (only the Rebuilder crashed)
            oracle = live
        boundaries.append({
            "failpoint": fp,
            "crashed_stage": crashed,
            "resolution": "committed" if committed else "aborted",
            "promote_redone": bool(rep.rebuild_promoted),
            "abort_appended": bool(rep.rebuild_aborted),
            "recovered_epoch": int(recovered.epoch),
            "replayed_records": int(rep.applied),
            "recovery_ms": round(rec_ms, 2),
            "bit_identical": _search_identical(
                recovered, oracle, queries, k=k, n_probe=n_probe),
        })
        wal.close()
    out["crash_boundaries"] = boundaries

    # -- 4b. swap race: merge_delta vs rebuild publish ----------------------
    #    the scripted run merges the stale handle's delta between the
    #    catchup and publish ticks; the publish-stage late catch-up
    #    must fold that racing merge into the candidate, and the stale
    #    handle's own publish afterwards must be epoch-fenced.
    wal, rb, live, mgr, reg, _ = _drive_rebuild(
        index, docs, cfg, workdir, "race", None)
    stale_ver = version_of(live)     # epoch 0, pre-rebuild centroids
    try:
        reg.publish(stale_ver)
        fenced = False
    except StaleEpochError:
        fenced = True
    cur = reg.current()
    # no lost mutations: every id the stale handle knows is serving
    new_ids = set(int(i) for i in rb.live.net_corpus()[1])
    old_ids = set(int(i) for i in live.net_corpus()[1])
    # crash right after the race: recovery must land on the rebuilt
    # epoch, bit-identical to the post-publish serving state
    _, recovered, _ = IndexRegistry.recover(mgr, wal, device=dev)
    out["swap_race"] = {
        "fenced": fenced,
        "stale_epoch": int(stale_ver.epoch),
        "current_epoch": int(cur.epoch),
        "lost_mutations": len(old_ids - new_ids),
        "recovered_epoch": int(recovered.epoch),
        "recovered_bit_identical": _search_identical(
            recovered, rb.live, queries, k=k, n_probe=n_probe),
    }
    wal.close()

    # -- 4c. drift: churn shifts the corpus off its centroids --------------
    out["drift"] = run_drift_drill(cfg, k=k, device=dev)
    return out


def run_drift_drill(cfg: ChaosConfig, *, k: int = 10, dim: int = 32,
                    n_clusters: int = 32, eval_probes: int = 8,
                    device: DeviceLike = None) -> Dict:
    """Sustained churn replaces the corpus with a blob mixture living
    in the OTHER half of the embedding space; each new doc also
    carries a small residual in the old half, so under FIXED centroids
    the blobs scatter across stale clusters in an order that is pure
    noise — a capped probe budget then finds only the few lists it
    happens to rank first and recall collapses.  A drift-triggered
    rebuild re-trains centroids onto the blobs, the probe ranking
    becomes informative again, and the same budget restores recall.
    Self-contained corpus (the geometry is the point), seeded by
    ``cfg.seed``, its index built on ``device`` (CUDA unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    half = dim // 2
    rng = np.random.default_rng(cfg.seed + 23)
    # original corpus lives in the FIRST half of the embedding space
    base = np.zeros((2048, dim), np.float32)
    base[:, :half] = rng.normal(size=(2048, half))
    index = build_index(base, n_clusters=n_clusters, list_pad=256,
                        seed=cfg.seed, align=64, device=dev)
    centers = rng.normal(scale=4.0, size=(8, half)).astype(np.float32)
    doomed = rng.permutation(2048)

    def blob_batch(rng, n=128):
        which = rng.integers(0, 8, n)
        out = np.zeros((n, dim), np.float32)
        out[:, :half] = 0.3 * rng.normal(size=(n, half))
        out[:, half:] = centers[which] + \
            rng.normal(scale=0.3, size=(n, half))
        return out

    def churn(live, tracker=None, rebuilder=None):
        rng = np.random.default_rng(cfg.seed + 29)
        trigger_ratio = 0.0
        for step in range(8):
            add = blob_batch(rng)
            live.add(add)
            live.delete(doomed[step * 192: (step + 1) * 192])
            live.merge_delta()
            if tracker is not None:
                tracker.observe(add)
                # trigger once drift is persistent (EMA warmed up),
                # late enough that the blob mass can anchor retrain
                if step >= 3 and tracker.triggered \
                        and rebuilder is not None \
                        and not rebuilder.epochs_published:
                    trigger_ratio = tracker.ratio
                    rebuilder.live = live
                    rebuilder.run_once("drift")
                    live = rebuilder.live
                    tracker.rebase(live.index.centroids)
        return live, trigger_ratio

    def eval_recall(live):
        rng = np.random.default_rng(cfg.seed + 31)
        q = np.zeros((64, dim), np.float32)
        q[:, :half] = 0.3 * rng.normal(size=(64, half))
        q[:, half:] = centers[rng.integers(0, 8, 64)] + \
            rng.normal(scale=0.3, size=(64, half))
        vecs, ids = live.net_corpus()
        exact = ids[np.argsort(-(q @ vecs.cpu().numpy().T), axis=1)[:, :k]]
        pol = policies.patience(min(eval_probes, n_clusters),
                                delta=2, phi=90.0, k=k, tau=3)
        res = live.search(torch.as_tensor(q, device=dev), pol)
        return (metrics.r_star_at_k(res.topk_ids.cpu().numpy(), exact),
                float(res.probes.float().mean()))

    fixed, _ = churn(LiveIndex(index, delta_cap=4096))
    recall_fixed, probes_fixed = eval_recall(fixed)

    live = LiveIndex(index, delta_cap=4096)
    tracker = DriftTracker(live.index.centroids, base, ema=0.5,
                           threshold=2.0)
    rb = Rebuilder(live, n_iters=8)
    rebuilt, trigger_ratio = churn(live, tracker, rb)
    recall_rebuilt, probes_rebuilt = eval_recall(rebuilt)

    return {
        "trigger_ratio": round(trigger_ratio, 2),
        "post_rebuild_ratio": round(tracker.ratio, 2),
        "rebuilds_triggered": rb.epochs_published,
        "recall_fixed": round(recall_fixed, 4),
        "recall_rebuilt": round(recall_rebuilt, 4),
        "mean_probes_fixed": round(probes_fixed, 1),
        "mean_probes_rebuilt": round(probes_rebuilt, 1),
        "recall_restored": recall_rebuilt > recall_fixed,
    }


# ---------------------------------------------------------------------------

def run_chaos(index, docs: np.ndarray, queries: np.ndarray,
              exact_ids: np.ndarray, cfg: ChaosConfig, workdir: str, *,
              k: int = 10, n_probe: int = 16,
              deadlines_ms: Optional[List[float]] = None,
              device: DeviceLike = None) -> Dict:
    """All four drills, where ``index`` lies (a ``device`` that names
    another raises); the returned dict is the
    ``BENCH_resilience_torch.json`` payload."""
    index_device(index, device)
    deadlines_ms = deadlines_ms or [2.0, 5.0, 10.0, 25.0]
    t0 = time.monotonic()
    out = {
        "config": dataclasses.asdict(cfg),
        "recovery": run_crash_recovery(index, docs, queries, cfg,
                                       workdir, k=k, n_probe=n_probe),
        "deadline_curve": run_deadline_sweep(index, queries, exact_ids,
                                             cfg, deadlines_ms, k=k,
                                             n_probe=n_probe),
        "shard_faults": run_shard_drill(index, queries, exact_ids, cfg,
                                        k=k, n_probe=n_probe),
        "rebuild": run_rebuild_drill(index, docs, queries, cfg, workdir,
                                     k=k, n_probe=n_probe),
    }
    out["wall_s"] = round(time.monotonic() - t0, 1)
    return out
