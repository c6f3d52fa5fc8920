"""Quickstart: build an IVF index, search with early exit, compare to
brute force (port of ``examples/quickstart.py``; the searches run the
fused ``ivf_scan_merge`` kernel on the card).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core import (brute_force, build_index, metrics, policies,
                              search)
from repro_torch.data.synthetic import clustered_corpus


def main(*, n_docs=30_000, dim=64, n_clusters=256, n_queries=512,
         n_probe=48, device=None):
    """Returns each policy's (R*@1, mean probes)."""
    dev = resolve_device(device)
    print(f"generating corpus ({n_docs} docs, {dim}-d)...")
    c = clustered_corpus(n_docs=n_docs, dim=dim, n_components=n_clusters,
                         n_queries=n_queries, seed=0)
    print(f"building IVF index ({n_clusters} clusters)...")
    index = build_index(c.docs, n_clusters, list_pad=256, n_iters=6,
                        device=dev)

    queries = torch.from_numpy(c.queries).to(dev)
    _, exact = brute_force(torch.from_numpy(c.docs).to(dev), queries, 10)
    exact = exact.cpu().numpy()

    out = {}
    for pol in (policies.fixed(n_probe, k=10, tau=5),
                policies.patience(n_probe, delta=4, phi=95.0, k=10, tau=5)):
        res = search(index, queries, pol, use_fused_kernel=True, chunk=4)
        ids = res.topk_ids.cpu().numpy()
        probes = res.probes.cpu().numpy()
        r1 = metrics.r_star_at_1(ids, exact[:, 0])
        out[pol.name] = (r1, float(probes.mean()))
        print(f"{pol.name:12s} R*@1={r1:.3f} "
              f"mean probes={probes.mean():5.1f} "
              f"(max {probes.max()})")
    print("patience reaches near-fixed recall with a fraction of the "
          "probes — the paper's core claim.")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    main(device=ap.parse_args().device)
