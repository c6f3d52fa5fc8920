"""Paper §Classification on the port (port of
``benchmarks.clabel_dist``): C(q) follows a power law — ~half the
queries find their 1-NN in the first probed cluster; ~80% within ~tau
probes.

    PYTHONPATH=src python -m repro_torch.benchmarks.clabel_dist \
        [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch import DeviceLike
from repro_torch.benchmarks.common import K, load_bench
from repro_torch.core import min_probes_labels, probe_trace


def main(encoder: str = "star-like", device: DeviceLike = None) -> dict:
    b = load_bench(encoder, device=device)
    traj, _ = probe_trace(b.index, b.corpus.queries[:2048], b.n_probe, K)
    labels = min_probes_labels(traj, b.exact_ids[:2048, 0], b.n_probe)
    out = {}
    print(f"C(q) distribution ({encoder}, N={b.n_probe})")
    for c in (1, 2, 5, 10, 20, b.n_probe):
        frac = float(np.mean(labels <= c))
        out[c] = frac
        print(f"  C(q) <= {c:3d}: {frac:6.1%}")
    # log-log slope as a power-law proxy
    cs = np.arange(1, 21)
    counts = np.array([(labels == c).sum() for c in cs]) + 1e-9
    slope = np.polyfit(np.log(cs), np.log(counts), 1)[0]
    print(f"  log-log slope over C in [1,20]: {slope:.2f} "
          f"(power law <=> strongly negative)")
    out["slope"] = slope
    return out


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    main(device=ap.parse_args().device)
