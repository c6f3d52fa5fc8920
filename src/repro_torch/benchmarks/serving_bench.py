"""Wave-scheduler throughput on the port (port of
``benchmarks.serving_bench``): lane occupancy and effective probes per
query with and without compaction — how per-query early exit becomes
batch throughput — plus the live-mutation overlay cost: serving against
a partially full delta buffer, and a mixed query/mutation stream with
background merges (``repro_torch.index``).  The live rows report recall
against the static exact oracle; the stream row's ``recall_gap`` is the
acceptance signal (it must stay within 0.01 of the static run).

    PYTHONPATH=src python -m repro_torch.benchmarks.serving_bench
        [--smoke] [--device cpu]

It writes ``artifacts/BENCH_serving_torch.json`` with the backend, the
device's name and its power limit.  The baseline and compact rows
advance lanes on the per-probe path, every other row on the fused
kernel (one ``ivf_scan_merge`` launch a wave, the live rows with the
delta stream); each wall is the host clock around the serve and a
``torch.cuda.synchronize``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np

from repro_torch import DeviceLike, resolve_device
from repro_torch.benchmarks.common import (ARTIFACTS, K, device_info,
                                           load_bench, sync)
from repro_torch.core import metrics
from repro_torch.core.serving import WaveScheduler
from repro_torch.index import DeltaFull, IndexRegistry, LiveIndex, version_of


def _run(ws, qs, *, compact=True, on_wave=None, exact=None) -> Dict:
    n = qs.shape[0]
    sync(ws.device)
    t0 = time.perf_counter()
    rep = ws.serve(qs, compact=compact, on_wave=on_wave)
    sync(ws.device)
    wall = time.perf_counter() - t0
    probes = np.array([rep.probes[i] for i in range(n)])
    row = {"occupancy": rep.occupancy, "waves": rep.waves,
           "lane_steps": rep.lane_steps,
           "lane_steps_per_query": rep.lane_steps / n,
           "mean_probes": float(probes.mean()), "wall_s": wall}
    if exact is not None:
        ids = np.stack([rep.results[i] for i in range(n)])
        row["recall"] = metrics.r_star_at_k(ids, exact[:n])
    return row


def _corpus_like(rng, docs, m):
    src = rng.integers(0, len(docs), m)
    return (docs[src] + rng.normal(scale=0.05, size=(m, docs.shape[1]))
            ).astype(np.float32)


def main(encoder: str = "star-like", n_queries: int = 512,
         smoke: bool = False, device: DeviceLike = None,
         out: Optional[str] = os.path.join(ARTIFACTS,
                                           "BENCH_serving_torch.json")
         ) -> Dict:
    dev = resolve_device(device)
    b = load_bench(encoder, smoke=smoke, device=dev)
    if smoke:
        n_queries = min(n_queries, 128)
    qs = b.corpus.queries[:n_queries]
    exact = b.exact_ids
    out_rows: Dict = {}

    def ws(registry=None, fused=True):
        return WaveScheduler(b.index, wave_size=64, chunk=4, k=K,
                             n_probe=b.n_probe, delta=4, phi=95.0,
                             use_fused=fused, registry=registry)

    # rows: compaction off/on with the per-probe advance, then
    # compaction on with the fused scan+merge kernel launch
    cases = [("baseline", False, False), ("compact", True, False),
             ("fused", True, True)]
    for tag, compact, fused in cases:
        out_rows[tag] = _run(ws(fused=fused), qs, compact=compact,
                             exact=exact)
        r = out_rows[tag]
        print(f"{tag:14s} occ={r['occupancy']:.2f} waves={r['waves']:4d} "
              f"lane_steps/q={r['lane_steps_per_query']:6.1f} "
              f"C={r['mean_probes']:5.1f} R*@k={r['recall']:.3f} "
              f"wall={r['wall_s']:.3f}s")

    # delta-buffer occupancy sweep: how much does scanning a fuller
    # buffer cost, and does the overlay keep recall?
    cap = 256 if smoke else 512
    for frac in ([0.5] if smoke else [0.25, 0.5, 1.0]):
        live = LiveIndex(b.index, delta_cap=cap)
        rng = np.random.default_rng(17)
        live.add(_corpus_like(rng, b.corpus.docs, int(frac * cap)))
        reg = IndexRegistry(version_of(live))
        tag = f"delta_occ_{frac:.2f}"
        out_rows[tag] = _run(ws(registry=reg), qs, exact=exact)
        out_rows[tag]["delta_occupancy"] = live.delta.occupancy()
        r = out_rows[tag]
        print(f"{tag:14s} occ={r['occupancy']:.2f} "
              f"C={r['mean_probes']:5.1f} R*@k={r['recall']:.3f} "
              f"wall={r['wall_s']:.3f}s")

    # mixed query/mutation stream: adds+deletes per wave, background
    # merge_delta every few waves, atomic version swaps mid-stream
    live = LiveIndex(b.index, delta_cap=cap)
    reg = IndexRegistry(version_of(live))
    rng = np.random.default_rng(23)
    added: list = []
    stats = {"adds": 0, "deletes": 0, "merges": 0}
    rate = 4 if smoke else 8

    def mutate(wave: int) -> None:
        try:
            added.extend(int(i)
                         for i in live.add(_corpus_like(rng, b.corpus.docs,
                                                        rate)))
            stats["adds"] += rate
        except DeltaFull:
            live.merge_delta()
            stats["merges"] += 1
        if len(added) > rate:
            live.delete([added.pop(rng.integers(len(added)))
                         for _ in range(rate // 4)])
            stats["deletes"] += rate // 4
        if wave % 8 == 0 and len(live.delta):
            live.merge_delta()
            stats["merges"] += 1
        reg.publish(version_of(live))

    row = _run(ws(registry=reg), qs, on_wave=mutate, exact=exact)
    row.update(stats)
    row["versions"] = live.version
    row["swaps"] = reg.swaps
    row["recall_static"] = out_rows["fused"]["recall"]
    row["recall_gap"] = abs(row["recall"] - out_rows["fused"]["recall"])
    out_rows["live_stream"] = row
    print(f"{'live_stream':14s} adds={stats['adds']} "
          f"dels={stats['deletes']} merges={stats['merges']} "
          f"R*@k={row['recall']:.3f} gap={row['recall_gap']:.4f} "
          f"wall={row['wall_s']:.3f}s")

    sp = out_rows["baseline"]["lane_steps"] / out_rows["compact"]["lane_steps"]
    print(f"compaction device-time speedup: {sp:.2f}x")
    same = out_rows["fused"]["mean_probes"] \
        == out_rows["compact"]["mean_probes"]
    print(f"fused advance mean probes match: {same}")
    out_rows["speedup"] = sp
    if out is not None:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump({**device_info(dev), "smoke": smoke, **out_rows}, f,
                      indent=2)
        print(f"wrote {os.path.relpath(out)}")
    return out_rows


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(smoke=args.smoke, device=args.device)
