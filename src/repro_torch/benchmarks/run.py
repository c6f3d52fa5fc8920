"""Benchmark entry point on the port (port of ``benchmarks.run``): one
section per paper table or figure, the serving table and the kernel
benchmark, each on the CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--full] [--smoke]
        [--device cpu]

--full: 3x timing reps and bigger forests in Table 2 (slower).
--smoke: minutes-scale mode — tiny substrate, one encoder, skips the
distribution and figure sections, but still writes every JSON artifact:
``BENCH_kernels_torch.json``, ``BENCH_table2_torch.json`` and
``BENCH_serving_torch.json`` under ``artifacts/``.

Without ``--smoke`` the roofline section reads the port's dry-run
records (``python -m repro_torch.launch.dryrun --all`` writes them to
``artifacts/dryrun_torch/``) through ``benchmarks/roofline.py``.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

from repro_torch import resolve_device
from repro_torch.benchmarks.common import ARTIFACTS


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    smoke = args.smoke
    t0 = time.time()
    print("=" * 72)
    print("## Kernel micro-benchmarks (each kernel beside its plain "
          "version)")
    from repro_torch.benchmarks import kernel_bench
    kernel_bench.main(smoke=smoke, device=dev,
                      out=os.path.join(ARTIFACTS, "BENCH_kernels_torch.json"))

    if not smoke:
        print("=" * 72)
        print("## Paper §Classification: C(q) power law")
        from repro_torch.benchmarks import clabel_dist
        clabel_dist.main("star-like", device=dev)

        print("=" * 72)
        print("## Paper Figure 1: phi_h saturation + Exit/Continue split")
        from repro_torch.benchmarks import figure1
        figure1.main("star-like", device=dev)

    print("=" * 72)
    print("## Paper Table 2: early-exit strategies x 3 encoders")
    from repro_torch.benchmarks import table2
    table2.main(quick=not args.full, smoke=smoke, device=dev,
                out=os.path.join(ARTIFACTS, "BENCH_table2_torch.json"))

    print("=" * 72)
    print("## Beyond-paper: wave scheduler + live-mutation serving")
    from repro_torch.benchmarks import serving_bench
    serving_bench.main("star-like", smoke=smoke, device=dev,
                       out=os.path.join(ARTIFACTS,
                                        "BENCH_serving_torch.json"))

    if not smoke:
        print("=" * 72)
        from repro_torch.benchmarks import roofline
        if roofline.load_records("single"):
            print("## Roofline (single-pod dry-run records)")
            roofline.main("single")
        else:
            print("## Roofline: no dry-run records yet (run python -m "
                  "repro_torch.launch.dryrun --all)")
    print(f"\ntotal bench time: {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
