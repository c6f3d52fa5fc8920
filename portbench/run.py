"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload star-bulk --seed 7 --seconds 20 \
        --trace 0

Run from the root of a checkout.  The cell, its configuration, traffic
mix and metrics are found by name from ``BENCHMARK.json``.  It prints
the set-up, the windows and the check on standard error, the numbers
compared beside their limits last, and as the last line of standard
output one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks``).  It exits non-zero and prints no result without the CUDA
cards the cell asks for, without the program (``src/repro_torch``), or
when JAX or the JAX package was loaded.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the JAX side: none of it may be loaded in this process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age() -> float:
    """Seconds from the process's start to now, from /proc (0 where that
    cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def fixed_caches(root: Path) -> None:
    """Kernel caches in fixed directories inside the checkout (the
    program's own library builds into ``src/repro_torch/build``)."""
    cache = root / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)


def loaded_jax() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    age, t_age = process_age(), time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    fixed_caches(ROOT)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness, spec

    cell = spec.cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"no result: {cell.name} needs {cell.chips} CUDA card(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"no result: the program is not in this checkout ({e})",
              file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    t = time.perf_counter()
    from repro_torch.kernels import _build
    _build.library()
    harness.log(f"kernel library loaded in {time.perf_counter() - t:.3f} s, "
                f"{age + time.perf_counter() - t_age:.3f} s after the "
                f"process started")
    dev = torch.device("cuda", 0)
    out = harness.run(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), dev, t_age, age)
    found = loaded_jax()
    if found:
        print(f"no result: the process loaded {found}", file=sys.stderr)
        return 4
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
