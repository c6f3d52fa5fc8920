"""§Roofline (port of ``benchmarks/roofline.py``): three-term analysis
per (arch × shape × mesh) from the port's dry-run records
(``python -m repro_torch.launch.dryrun`` writes
``artifacts/dryrun_torch/*.json``).

    compute_s    = flops_per_device / 989e12      (bf16 peak, H100 SXM)
    memory_s     = bytes_per_device / 3.35e12     (HBM3)
    collective_s = collective_bytes_per_device / 450e9 (NVLink, one way)

The rates are the data sheet's (``launch.cost_analysis``).  The counts
are one device's (rank 0's program); the MODEL_FLOPS / counted ratio
uses the global MODEL_FLOPS / (per-device flops * n_devices).  The
port's flops are products and attention only, where XLA's also count
elementwise work (``launch.cost_analysis``).

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline [single|multi]
"""
from __future__ import annotations

import glob
import json
import os
import sys
from typing import Dict, List, Optional

from repro_torch.launch.cost_analysis import roofline_terms

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "artifacts", "dryrun_torch")


def load_records(mesh: str = "single", art: Optional[str] = None
                 ) -> List[Dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(art or ART,
                                              f"*__{mesh}.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def analyse(rec: Dict) -> Dict:
    if rec.get("status") != "ok" or "cost" not in rec:
        return {**rec, "ok": False}
    flops = rec["cost"]["flops"]
    bts = rec["cost"]["bytes"]
    coll = rec.get("collectives", {}).get("total_bytes", 0)
    terms = roofline_terms(flops, bts, coll)
    n_dev = rec["n_devices"]
    mf = rec.get("model_flops_global", 0.0)
    useful = mf / (flops * n_dev) if flops else 0.0
    dom = terms["bottleneck"].replace("_s", "")
    t_dom = terms[terms["bottleneck"]]
    return {
        "cell": f"{rec['arch']}:{rec['shape']}",
        "mesh": rec["mesh"],
        "compute_s": terms["compute_s"],
        "memory_s": terms["memory_s"],
        "collective_s": terms["collective_s"],
        "bottleneck": dom,
        "roofline_frac": terms["compute_s"] / t_dom if t_dom > 0 else 0.0,
        "useful_flops_ratio": useful,
        "peak_gb": rec.get("memory", {}).get("peak_gb", float("nan")),
        "note": rec.get("note", ""),
        "ok": True,
    }


def main(mesh: str = "single", art: Optional[str] = None) -> List[Dict]:
    art = art or ART
    rows = [analyse(r) for r in load_records(mesh, art)]
    ok = [r for r in rows if r.get("ok")]
    bad = [r for r in rows if not r.get("ok")]
    print(f"{'cell':42s} {'comp(ms)':>9s} {'mem(ms)':>9s} {'coll(ms)':>9s} "
          f"{'bound':>10s} {'frac':>6s} {'MF/cnt':>7s} {'peakGB':>7s}")
    for r in sorted(ok, key=lambda r: r["cell"]):
        print(f"{r['cell']:42s} {r['compute_s']*1e3:9.2f} "
              f"{r['memory_s']*1e3:9.2f} {r['collective_s']*1e3:9.2f} "
              f"{r['bottleneck']:>10s} {r['roofline_frac']:6.2f} "
              f"{r['useful_flops_ratio']:7.2f} {r['peak_gb']:7.1f}")
    if bad:
        print(f"\nFAILED cells: {[b.get('arch', '?') + ':' + b.get('shape', '?') for b in bad]}")
    os.makedirs(art, exist_ok=True)
    out_path = os.path.join(art, f"roofline_{mesh}.json")
    with open(out_path, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"\nwrote {out_path}")
    return rows


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "single")
