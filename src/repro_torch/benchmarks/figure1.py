"""Paper Figure 1 on the port (port of ``benchmarks.figure1``): phi_h
saturation, overall and split by Exit/Continue label at tau.  Prints an
ASCII table of mean/p5/p95 per probe rank.

    PYTHONPATH=src python -m repro_torch.benchmarks.figure1 [--device cpu]
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch import DeviceLike
from repro_torch.benchmarks.common import K, TAU, load_bench
from repro_torch.core import min_probes_labels, probe_trace


def main(encoder: str = "star-like", n_plot: int = 40,
         device: DeviceLike = None) -> Dict:
    b = load_bench(encoder, device=device)
    traj, phi = probe_trace(b.index, b.corpus.queries[:1024], n_plot, K)
    exact1 = b.exact_ids[:1024, 0]
    labels = min_probes_labels(traj, exact1, n_plot)
    exit_m = labels <= TAU
    print(f"phi_h saturation ({encoder}); Exit fraction at tau={TAU}: "
          f"{exit_m.mean():.2f}")
    print(f"{'h':>3s} {'mean':>6s} {'p5':>6s} {'p95':>6s} "
          f"{'Exit':>6s} {'Cont':>6s}")
    out = {"h": [], "mean": [], "exit": [], "cont": []}
    for h in range(1, phi.shape[0] + 1, max(1, phi.shape[0] // 20)):
        row = phi[h - 1]
        out["h"].append(h + 1)
        out["mean"].append(float(row.mean()))
        out["exit"].append(float(row[exit_m].mean()))
        out["cont"].append(float(row[~exit_m].mean()))
        print(f"{h + 1:3d} {row.mean():6.1f} "
              f"{np.percentile(row, 5):6.1f} "
              f"{np.percentile(row, 95):6.1f} "
              f"{row[exit_m].mean():6.1f} {row[~exit_m].mean():6.1f}")
    # the paper's two claims:
    if not out["mean"][-1] > out["mean"][0]:
        raise AssertionError("phi must climb")
    gaps = [e - c for e, c in zip(out["exit"][:6], out["cont"][:6])]
    print(f"early-probe Exit-Continue separation: "
          f"{np.mean(gaps):.1f} pts")
    return out


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    main(device=ap.parse_args().device)
