"""Serving scenario (the paper's own kind of system): batched query
streams against an IVF index, cascade early-exit policy, wave-scheduler
compaction (port of ``examples/serve_early_exit.py``; searches and
waves run the fused ``ivf_scan_merge`` kernel on the card).

    PYTHONPATH=src python -m repro_torch.examples.serve_early_exit \
        [--device cpu]
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.core import brute_force, build_index, metrics, policies, search
from repro_torch.core.serving import WaveScheduler
from repro_torch.core.training import choose_n_probe, train_policy_models
from repro_torch.data.synthetic import clustered_corpus


def main(*, n_docs=50_000, dim=64, n_clusters=384, n_queries=2048,
         n_train=768, n_valid=256, n_trees=40, k=50, tau=5, device=None):
    """Returns each policy's (R*@1, C) and each serve's occupancy."""
    dev = resolve_device(device)
    print("corpus + index...")
    c = clustered_corpus(n_docs=n_docs, dim=dim, n_components=n_clusters,
                         n_queries=n_queries, spread=0.3, seed=1)
    index = build_index(c.docs, n_clusters, list_pad=256, n_iters=6,
                        device=dev)
    cut = n_train + n_valid
    train_q, valid_q, test_q = (c.queries[:n_train],
                                c.queries[n_train:cut], c.queries[cut:])
    n = choose_n_probe(index, c.docs, valid_q, rho=0.95, k=k,
                       n_max=n_clusters)
    print(f"N (R*@1>=0.95) = {n}")

    print("training Exit/Continue classifier + REG (GBDT + SMOTE)...")
    pm = train_policy_models(index, c.docs, train_q, valid_q, n_probe=n,
                             k=k, tau=tau, exit_weight=3.0, n_trees=n_trees,
                             max_depth=5)

    test_t = torch.from_numpy(test_q).to(dev)
    _, exact = brute_force(torch.from_numpy(c.docs).to(dev), test_t, k)
    exact = exact.cpu().numpy()
    out = {}
    print("\npolicy comparison on the test stream:")
    for pol in (policies.fixed(n, k=k, tau=tau),
                policies.patience(n, 4, 95.0, k=k, tau=tau),
                policies.cascade_patience(n, pm.clf_weighted, 4, 95.0,
                                          k=k, tau=tau)):
        res = search(index, test_t, pol, use_fused_kernel=True, chunk=4)
        ids, probes = res.topk_ids.cpu().numpy(), res.probes.cpu().numpy()
        r1 = metrics.r_star_at_1(ids, exact[:, 0])
        out[pol.name] = (r1, float(probes.mean()))
        print(f"  {pol.name:20s} R*@1={r1:.3f} "
              f"mRR@10={metrics.mrr_at_10(ids, c.relevant[cut:]):.3f} "
              f"C={probes.mean():5.1f}")

    print("\nwave-scheduled serving (batched requests, compaction):")
    ws = WaveScheduler(index, wave_size=128, chunk=4, k=k, n_probe=n,
                       delta=4, phi=95.0)
    for compact in (False, True):
        t0 = time.time()
        rep = ws.serve(test_t, compact=compact)
        out[f"compact={compact}"] = rep.occupancy
        print(f"  compact={compact!s:5s} occupancy={rep.occupancy:.2f} "
              f"waves={rep.waves} lane_steps/q="
              f"{rep.lane_steps / len(test_q):5.1f} "
              f"wall={time.time() - t0:.1f}s")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    main(device=ap.parse_args().device)
