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

Runs on the CUDA card unless ``--device cpu`` is given.  The chaos,
deadline and rebuild flags of the reference driver come with the
serving and durability slices of the port.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import brute_force, build_index, metrics, policies, \
    search
from repro_torch.core.serving import WaveScheduler
from repro_torch.data.synthetic import clustered_corpus
from repro_torch.index import DeltaFull, IndexRegistry, LiveIndex, version_of


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


def mutation_stream(live: LiveIndex, reg: IndexRegistry, docs: np.ndarray, *,
                    rate: int, merge_every: int, noise: float):
    """The ``on_wave`` hook of a live serve, and its counters: after each
    wave add ``rate`` noisy copies of corpus docs (a full buffer merges
    instead), delete ``rate // 4`` earlier adds, merge every
    ``merge_every`` waves, and publish a version.  The same arguments
    give the same stream."""
    rng = np.random.default_rng(1)
    added: list = []
    stats = {"adds": 0, "deletes": 0, "merges": 0}

    def mutate(wave: int) -> None:
        # corpus-like churn: noisy copies of existing docs, so added
        # vectors score on the same scale as the static corpus
        src = rng.integers(0, docs.shape[0], rate)
        new = (docs[src] + rng.normal(scale=noise, size=(rate,
                                                          docs.shape[1]))
               ).astype(np.float32)
        try:
            added.extend(int(i) for i in live.add(new))
            stats["adds"] += rate
        except DeltaFull:
            live.merge_delta()
            stats["merges"] += 1
        n_del = rate // 4
        if n_del and len(added) > n_del:
            doomed = [added.pop(rng.integers(len(added)))
                      for _ in range(n_del)]
            live.delete(doomed)
            stats["deletes"] += n_del
        if merge_every and wave % merge_every == 0 and len(live.delta):
            live.merge_delta()
            stats["merges"] += 1
        reg.publish(version_of(live))

    return mutate, stats


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs the plain versions of the kernels)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

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

    if args.policy == "fixed":
        res = search(index, queries, policies.fixed(args.n_probe, k=args.k))
        summ = metrics.summarize(res.topk_ids.cpu().numpy(),
                                 res.probes.cpu().numpy(), exact,
                                 c.relevant)
        print(summ)
        return summ

    ws = WaveScheduler(index, wave_size=args.wave_size, chunk=4, k=args.k,
                       n_probe=args.n_probe, delta=args.delta, phi=args.phi)
    rep, ids, probes, wall = _serve(ws, queries, dev,
                                    compact=not args.no_compact)
    summ = metrics.summarize(ids, probes, exact, c.relevant, wall)
    summ["occupancy"] = rep.occupancy
    summ["waves"] = rep.waves
    print({k: round(v, 4) if isinstance(v, float) else v
           for k, v in summ.items()})
    if args.mutation_rate <= 0:
        return summ

    # --- mixed query/mutation stream over the live index ------------------
    live = LiveIndex(index, delta_cap=args.delta_cap)
    reg = IndexRegistry(version_of(live))
    ws_live = WaveScheduler(index, wave_size=args.wave_size, chunk=4,
                            k=args.k, n_probe=args.n_probe,
                            delta=args.delta, phi=args.phi, registry=reg)
    mutate, stats = mutation_stream(live, reg, c.docs,
                                    rate=args.mutation_rate,
                                    merge_every=args.merge_every,
                                    noise=0.05)
    rep_l, ids_l, probes_l, wall_l = _serve(
        ws_live, queries, dev, compact=not args.no_compact, on_wave=mutate)
    r_static = metrics.r_star_at_k(ids, exact)
    r_live = metrics.r_star_at_k(ids_l, exact)
    row = {"mode": "live", "mutation_rate": args.mutation_rate,
           "merge_every": args.merge_every, **stats,
           "versions": live.version, "swaps": reg.swaps,
           "delta_occupancy": round(live.delta.occupancy(), 3),
           "recall_static": round(r_static, 4),
           "recall_live": round(r_live, 4),
           "recall_gap": round(abs(r_static - r_live), 4),
           "latency_ms": round(wall_l, 1),
           "mean_probes": round(float(probes_l.mean()), 2)}
    print(row)
    return {**summ, **row}


if __name__ == "__main__":
    main()
