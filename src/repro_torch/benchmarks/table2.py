"""Paper Table 2 on the port (port of ``benchmarks.table2``):
effectiveness/efficiency of every early-exit strategy on three
encoder-like corpora.  Prints one block per encoder with R*@1,
R@100(->R@K), mRR@10, mean probes C, wall ms and speedup vs A-kNN95,
and writes ``artifacts/BENCH_table2_torch.json`` with the backend, the
device's name and its power limit.

    PYTHONPATH=src python -m repro_torch.benchmarks.table2 [--quick]
        [--smoke] [--device cpu]

Every strategy runs ``search`` on the fused path (one ``ivf_scan_merge``
launch per 4 probes); its wall is the host clock around the call and a
``torch.cuda.synchronize``, after one warm call (which builds the
kernels).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.benchmarks.common import (ARTIFACTS, ENCODERS, K, TAU,
                                           device_info, load_bench, sync)
from repro_torch.core import metrics, policies, search
from repro_torch.core.training import train_policy_models

# patience settings per encoder (tuned like the paper: larger delta for
# harder encoders)
DELTAS = {"star-like": 4, "contriever-like": 5, "tasb-like": 6}
PHI = 95.0
EXIT_W = 3.0
CHUNK = 4


def strategies(n: int, pm, delta: int, *, k: int = K, tau: int = TAU,
               phi: float = PHI, exit_w: float = EXIT_W) -> Dict:
    """Table 2's eight strategies, in its order, from trained models."""
    return {
        f"A-kNN95(N={n})": policies.fixed(n, k=k, tau=tau),
        "Reg": policies.regression(n, pm.reg, with_intersections=False,
                                   k=k, tau=tau),
        "Reg+int": policies.regression(n, pm.reg_int,
                                       with_intersections=True, k=k,
                                       tau=tau),
        f"Patience(d={delta})": policies.patience(n, delta, phi, k=k,
                                                  tau=tau),
        "Classifier": policies.classifier(n, pm.clf, k=k, tau=tau),
        f"Classifier(w={exit_w:.0f})": policies.classifier(
            n, pm.clf_weighted, k=k, tau=tau),
        "+Reg+int": policies.cascade_regression(
            n, pm.clf_weighted, pm.reg_int, k=k, tau=tau),
        f"+Patience(d={delta})": policies.cascade_patience(
            n, pm.clf_weighted, delta, phi, k=k, tau=tau),
    }


def timed_search(index, queries: torch.Tensor, pol, reps: int):
    """One warm call, then ``reps`` timed calls of the fused search:
    (result, mean wall ms)."""
    dev = queries.device
    res = search(index, queries, pol, use_fused_kernel=True, chunk=CHUNK)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        res = search(index, queries, pol, use_fused_kernel=True,
                     chunk=CHUNK)
    sync(dev)
    return res, (time.perf_counter() - t0) / reps * 1000


def run_encoder(name: str, *, quick: bool = False, smoke: bool = False,
                device: DeviceLike = None) -> List[Dict]:
    b = load_bench(name, smoke=smoke, device=device)
    dev = b.index.docs.device
    sp = b.splits
    n = b.n_probe
    q_test = torch.as_tensor(b.corpus.queries[sp["test"]], device=dev)
    exact = b.exact_ids[sp["test"]]
    relevant = b.corpus.relevant[sp["test"]]
    pm = train_policy_models(
        b.index, b.corpus.docs, b.corpus.queries[sp["train"]],
        b.corpus.queries[sp["valid"]], n_probe=n, k=K, tau=TAU,
        exit_weight=EXIT_W,
        n_trees=10 if smoke else (30 if quick else 80),
        max_depth=3 if smoke else 5)
    rows = []
    base_t = None
    for pname, pol in strategies(n, pm, DELTAS[name]).items():
        res, wall = timed_search(b.index, q_test, pol, 1 if quick else 3)
        summ = metrics.summarize(res.topk_ids.cpu().numpy(),
                                 res.probes.cpu().numpy(), exact, relevant,
                                 wall)
        if base_t is None:
            base_t = wall
        summ["Sp"] = base_t / wall
        summ["encoder"] = name
        summ["strategy"] = pname
        rows.append(summ)
    return rows


def main(quick: bool = False, smoke: bool = False,
         device: DeviceLike = None,
         out: Optional[str] = os.path.join(ARTIFACTS,
                                           "BENCH_table2_torch.json")
         ) -> List[Dict]:
    dev = resolve_device(device)
    all_rows = []
    encoders = ["star-like"] if smoke else list(ENCODERS)
    for enc in encoders:
        rows = run_encoder(enc, quick=quick, smoke=smoke, device=dev)
        print(f"\n== {enc} (N={rows[0]['strategy']}) ==")
        hdr = f"{'strategy':22s} {'R*@1':>6s} {'R@K':>6s} {'mRR@10':>7s} " \
              f"{'C':>7s} {'T(ms)':>8s} {'Sp':>5s}"
        print(hdr)
        for r in rows:
            print(f"{r['strategy']:22s} {r['R*@1']:6.3f} {r['R@100']:6.3f} "
                  f"{r['mRR@10']:7.3f} {r['C']:7.1f} {r['T_ms']:8.1f} "
                  f"{r['Sp']:5.2f}")
        all_rows += rows
    if out is not None:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            json.dump({**device_info(dev), "quick": quick, "smoke": smoke,
                       "rows": all_rows}, f, indent=2)
        print(f"wrote {os.path.relpath(out)}")
    return all_rows


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(quick=args.quick, smoke=args.smoke, device=args.device)
