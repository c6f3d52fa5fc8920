"""Retrieval serving driver (port of ``repro.launch.serve``, static
index): build an IVF index over a synthetic corpus, pick a policy,
stream the query log through the wave scheduler and report the paper's
effectiveness/efficiency metrics.

    PYTHONPATH=src python -m repro_torch.launch.serve --policy patience \
        --n-docs 50000 --queries 1024

Live index (``repro_torch.index``): ``--mutation-rate R`` injects R
document adds per wave (plus R//4 deletes of previously added docs)
*while the query stream is in flight*, through a ``LiveIndex`` +
``IndexRegistry`` pair; ``--merge-every M`` folds the delta buffer into
a fresh index version every M waves.  The driver then prints the live
row: live-vs-static recall, adds/deletes/merges, versions and swaps.

Background re-clustering (``repro_torch.index.rebuild``):
``--rebuild-every N`` requests a crash-safe centroid rebuild every N
waves; ``--rebuild-drift R`` instead arms a ``DriftTracker`` that
requests one when added docs drift R x off the build-time baseline.
The live index then logs every mutation to a WAL and snapshots into a
temporary directory; rebuild stages interleave with serving waves and
the swap is epoch-fenced.  The row gains rebuilds, epoch, epoch swaps,
drain waves, rebuild ticks and (with ``--rebuild-drift``) the drift
ratio:

    PYTHONPATH=src python -m repro_torch.launch.serve --mutation-rate 64 \
        --merge-every 16 --rebuild-every 16

Deadlines: ``--deadline-ms`` serves the stream under a real per-query
latency budget through the degradation ladder (tighten patience, cap
probes, force-exit, shed); the summary gains the degraded fraction and
the final wave-cost estimate, and the live row's ``rebuild_throttled``
counts the rebuild ticks the ladder paused.

Chaos mode (``repro_torch.runtime.chaos``): ``--chaos`` runs the
seeded resilience drills — crash + WAL recovery over a mutation
stream, recall-vs-deadline curve under latency spikes, shard-fault
retry/skip, and the rebuild crash/race/drift drills — and writes
``artifacts/BENCH_resilience_torch.json`` with the backend, the
device's name and its power limit:

    PYTHONPATH=src python -m repro_torch.launch.serve --chaos \
        --n-docs 4000 --queries 64 --clusters 32

Runs on the CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.benchmarks.common import ARTIFACTS, device_info
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import brute_force, build_index, metrics, policies, \
    search
from repro_torch.core.serving import WaveScheduler
from repro_torch.data.synthetic import clustered_corpus
from repro_torch.index import (DeltaFull, DriftTracker, IndexRegistry,
                               LiveIndex, MutationWAL, Rebuilder, version_of)
from repro_torch.kernels import _build


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _serve(ws: WaveScheduler, queries: torch.Tensor, dev: torch.device, *,
           compact: bool, on_wave=None):
    _sync(dev)
    t1 = time.perf_counter()
    rep = ws.serve(queries, compact=compact, on_wave=on_wave)
    _sync(dev)
    wall = (time.perf_counter() - t1) * 1000
    n = queries.shape[0]
    ids = np.stack([rep.results[i] for i in range(n)])
    probes = np.array([rep.probes[i] for i in range(n)])
    return rep, ids, probes, wall


class MutationStream:
    """The ``on_wave`` hook of a live serve, and its counters (``stats``):
    after each wave add ``rate`` noisy copies of corpus docs (a full
    buffer merges instead), delete ``rate // 4`` earlier adds, merge
    every ``merge_every`` waves, and publish a version.  The same
    arguments give the same stream.

    Once ``rebuilder`` is set (a ``repro_torch.index.Rebuilder`` built
    with :meth:`on_publish` as its hook, which rebinds the stream to the
    rebuilt index and rebases the tracker) it requests a rebuild every
    ``rebuild_every`` waves, or when ``tracker`` (a ``DriftTracker`` fed
    every batch it adds) triggers."""

    def __init__(self, live: LiveIndex, reg: IndexRegistry,
                 docs: np.ndarray, *, rate: int, merge_every: int,
                 noise: float, rebuild_every: int = 0):
        self.live, self.reg, self.docs = live, reg, docs
        self.rate, self.merge_every, self.noise = rate, merge_every, noise
        self.rebuild_every = rebuild_every
        self.rebuilder: Optional[Rebuilder] = None
        self.tracker: Optional[DriftTracker] = None
        self.rng = np.random.default_rng(1)
        self.added: list = []
        self.stats = {"adds": 0, "deletes": 0, "merges": 0}

    def on_publish(self, new_live: LiveIndex, report) -> None:
        self.live = new_live             # rebind the mutation stream
        if self.tracker is not None:
            self.tracker.rebase(new_live.index.centroids)

    def __call__(self, wave: int) -> None:
        live, rng, docs, rate = self.live, self.rng, self.docs, self.rate
        # corpus-like churn: noisy copies of existing docs, so added
        # vectors score on the same scale as the static corpus
        src = rng.integers(0, docs.shape[0], rate)
        new = (docs[src] + rng.normal(scale=self.noise,
                                      size=(rate, docs.shape[1]))
               ).astype(np.float32)
        try:
            self.added.extend(int(i) for i in live.add(new))
            self.stats["adds"] += rate
            if self.tracker is not None:
                self.tracker.observe(new)
        except DeltaFull:
            live.merge_delta()
            self.stats["merges"] += 1
        n_del = rate // 4
        if n_del and len(self.added) > n_del:
            doomed = [self.added.pop(rng.integers(len(self.added)))
                      for _ in range(n_del)]
            live.delete(doomed)
            self.stats["deletes"] += n_del
        if self.merge_every and wave % self.merge_every == 0 \
                and len(live.delta):
            live.merge_delta()
            self.stats["merges"] += 1
        self.reg.publish(version_of(live))
        rb = self.rebuilder
        if rb is not None and not rb.active:
            if self.rebuild_every and wave % self.rebuild_every == 0:
                rb.request(f"every-{self.rebuild_every}")
            elif self.tracker is not None and self.tracker.triggered:
                rb.request(f"drift>{self.tracker.threshold}")


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="patience",
                    choices=["fixed", "patience"])
    ap.add_argument("--n-docs", type=int, default=50_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--clusters", type=int, default=256)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--n-probe", type=int, default=48)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--delta", type=int, default=5)
    ap.add_argument("--phi", type=float, default=95.0)
    ap.add_argument("--wave-size", type=int, default=128)
    ap.add_argument("--no-compact", action="store_true")
    ap.add_argument("--mutation-rate", type=int, default=0,
                    help="doc adds per wave (deletes at rate//4) "
                         "streamed against the live index")
    ap.add_argument("--merge-every", type=int, default=16,
                    help="fold the delta buffer into a new index "
                         "version every N waves")
    ap.add_argument("--delta-cap", type=int, default=4096,
                    help="delta buffer capacity (slots)")
    ap.add_argument("--rebuild-every", type=int, default=0,
                    help="request a background centroid rebuild every "
                         "N waves of the live stream (0 = off); stages "
                         "interleave with serving waves and the swap "
                         "is epoch-fenced")
    ap.add_argument("--rebuild-drift", type=float, default=0.0,
                    help="drift-ratio threshold that triggers a "
                         "rebuild (0 = off): mean nearest-centroid "
                         "distance of added docs vs the build-time "
                         "baseline")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-query latency budget; under pressure the "
                         "scheduler walks the degradation ladder "
                         "instead of blowing it")
    ap.add_argument("--chaos", action="store_true",
                    help="run the seeded resilience drills and write "
                         "artifacts/BENCH_resilience_torch.json")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--chaos-crash-every", type=int, default=7,
                    help="inject a crash at every Nth mutation "
                         "boundary (0 = off)")
    ap.add_argument("--chaos-shard-fault-rate", type=float, default=0.3)
    ap.add_argument("--chaos-spike-rate", type=float, default=0.15)
    ap.add_argument("--chaos-deadlines", default="2,5,10,25",
                    help="comma-separated deadline_ms sweep")
    ap.add_argument("--chaos-out", default=None,
                    help="output JSON path (default "
                         "artifacts/BENCH_resilience_torch.json)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs the plain versions of the kernels)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # build the kernels before any clock starts: a first wave that
        # compiled them would cost seconds, and under --deadline-ms that
        # estimate would shed every query
        _build.library()

    t0 = time.time()
    c = clustered_corpus(n_docs=args.n_docs, dim=args.dim,
                         n_components=args.clusters,
                         n_queries=args.queries, seed=0)
    index = build_index(c.docs, args.clusters, list_pad=256, n_iters=6,
                        device=dev)
    print(f"index built: {index.n_clusters} clusters "
          f"({time.time() - t0:.1f}s)")
    queries = torch.as_tensor(c.queries, device=dev)
    _, exact = brute_force(torch.as_tensor(c.docs, device=dev), queries,
                           args.k)
    exact = exact.cpu().numpy()

    if args.chaos:
        from repro_torch.runtime.chaos import ChaosConfig, run_chaos
        cfg = ChaosConfig(seed=args.chaos_seed,
                          crash_every=args.chaos_crash_every,
                          shard_fault_rate=args.chaos_shard_fault_rate,
                          spike_rate=args.chaos_spike_rate)
        deadlines = [float(x) for x in
                     args.chaos_deadlines.split(",") if x]
        with tempfile.TemporaryDirectory(prefix="chaos_") as workdir:
            payload = run_chaos(index, c.docs, c.queries, exact, cfg,
                                workdir, k=args.k, n_probe=args.n_probe,
                                deadlines_ms=deadlines)
        payload.update(device_info(dev))
        out = args.chaos_out or os.path.join(ARTIFACTS,
                                             "BENCH_resilience_torch.json")
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(payload, f, indent=2)
        print(json.dumps({"recovery": payload["recovery"],
                          "shard_faults": payload["shard_faults"]},
                         indent=2))
        print(f"wrote {out}")
        return payload

    if args.policy == "fixed":
        res = search(index, queries, policies.fixed(args.n_probe, k=args.k))
        summ = metrics.summarize(res.topk_ids.cpu().numpy(),
                                 res.probes.cpu().numpy(), exact,
                                 c.relevant)
        print(summ)
        return summ

    ws = WaveScheduler(index, wave_size=args.wave_size, chunk=4, k=args.k,
                       n_probe=args.n_probe, delta=args.delta, phi=args.phi,
                       deadline_ms=args.deadline_ms)
    rep, ids, probes, wall = _serve(ws, queries, dev,
                                    compact=not args.no_compact)
    summ = metrics.summarize(ids, probes, exact, c.relevant, wall)
    summ["occupancy"] = rep.occupancy
    summ["waves"] = rep.waves
    if args.deadline_ms is not None:
        summ["degraded_fraction"] = rep.degraded_fraction
        summ["wave_cost_ms"] = rep.wave_cost_ms
    print({k: round(v, 4) if isinstance(v, float) else v
           for k, v in summ.items()})
    if args.mutation_rate <= 0:
        return summ

    # --- mixed query/mutation stream over the live index ------------------
    rebuild_on = args.rebuild_every > 0 or args.rebuild_drift > 0
    rb_tmp = wal = mgr = None
    if rebuild_on:
        # a durable rebuild needs a WAL (catch-up across stages) and a
        # snapshot root (two-phase publish); both are scratch here
        rb_tmp = tempfile.TemporaryDirectory(prefix="serve_rebuild_")
        wal = MutationWAL(os.path.join(rb_tmp.name, "mutations.wal"),
                          group_commit_n=8, group_commit_ms=50.0)
        mgr = CheckpointManager(os.path.join(rb_tmp.name, "snapshots"),
                                async_save=False)
    live = LiveIndex(index, delta_cap=args.delta_cap, wal=wal)
    reg = IndexRegistry(version_of(live))
    stream = MutationStream(live, reg, c.docs, rate=args.mutation_rate,
                            merge_every=args.merge_every, noise=0.05,
                            rebuild_every=args.rebuild_every)
    if rebuild_on:
        reg.save(mgr)
        wal.note_durable(live.seq)
        stream.rebuilder = Rebuilder(live, reg, mgr,
                                     on_publish=stream.on_publish)
        if args.rebuild_drift > 0:
            stream.tracker = DriftTracker(index.centroids, c.docs,
                                          threshold=args.rebuild_drift)
    ws_live = WaveScheduler(index, wave_size=args.wave_size, chunk=4,
                            k=args.k, n_probe=args.n_probe,
                            delta=args.delta, phi=args.phi, registry=reg,
                            deadline_ms=args.deadline_ms,
                            rebuilder=stream.rebuilder)
    rep_l, ids_l, probes_l, wall_l = _serve(
        ws_live, queries, dev, compact=not args.no_compact, on_wave=stream)
    live = stream.live
    r_static = metrics.r_star_at_k(ids, exact)
    r_live = metrics.r_star_at_k(ids_l, exact)
    row = {"mode": "live", "mutation_rate": args.mutation_rate,
           "merge_every": args.merge_every, **stream.stats,
           "versions": live.version, "swaps": reg.swaps,
           "delta_occupancy": round(live.delta.occupancy(), 3),
           "recall_static": round(r_static, 4),
           "recall_live": round(r_live, 4),
           "recall_gap": round(abs(r_static - r_live), 4),
           "latency_ms": round(wall_l, 1),
           "mean_probes": round(float(probes_l.mean()), 2)}
    if stream.rebuilder is not None:
        row.update({"rebuilds": stream.rebuilder.epochs_published,
                    "epoch": live.epoch,
                    "epoch_swaps": rep_l.epoch_swaps,
                    "drain_waves": rep_l.drain_waves,
                    "rebuild_ticks": rep_l.rebuild_ticks,
                    "rebuild_throttled": rep_l.rebuild_throttled})
        if stream.tracker is not None:
            row["drift_ratio"] = round(stream.tracker.ratio, 3)
    print(row)
    if rb_tmp is not None:
        wal.close()
        rb_tmp.cleanup()
    return {**summ, **row}


if __name__ == "__main__":
    main()
